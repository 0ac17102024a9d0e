"""Run one cell several times, each a fresh process of the benchmark's
command, one after another, and summarise the spread of each metric:

    python3 benchmark/repeat.py --workload <cell> --seeds 11,12,13 \\
        --seconds 30 [--trace 1] [--control strand] [--out runs.jsonl]

Each run's result line (or its failure, with the end of its standard
error) is appended to ``--out`` as one JSON object.  The summary gives,
for each metric, the values, the median and the spread: the distance
between the first and third quartiles (``statistics.quantiles(values,
n=4)``) as a share of the median, and each compared number's largest
reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/repeat.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--control", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"),
               "--workload", args.workload, "--seed", seed,
               "--seconds", args.seconds, "--trace", args.trace]
        if args.control:
            cmd += ["--control", args.control]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                               text=True, timeout=args.timeout)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as exc:
            rc, out, err = 124, exc.stdout or "", exc.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        rec = dict(workload=args.workload, seed=int(seed),
                   trace=int(args.trace), control=args.control, rc=rc,
                   wall_s=time.perf_counter() - t0)
        lines = out.strip().splitlines()
        try:
            rec["result"] = json.loads(lines[-1]) if rc == 0 else None
        except (IndexError, json.JSONDecodeError):
            rec["result"] = None
        rec["record"] = next((ln for ln in err.splitlines()
                              if ln.startswith("record ")), None)
        rec["stderr_tail"] = "\n".join(
            ln for ln in err.splitlines()
            if not ln.startswith("record "))[-6000:]
        runs.append(rec)
        print(json.dumps(dict(seed=rec["seed"], rc=rc,
                              wall_s=round(rec["wall_s"], 1),
                              correct=(rec["result"] or {}).get("correct"),
                              metrics={k: v["value"] for k, v in
                                       (rec["result"] or {}).get(
                                           "metrics", {}).items()},
                              checks={k: v["value"] for k, v in
                                      (rec["result"] or {}).get(
                                          "checks", {}).items()})),
              flush=True)
        if rec["result"] is None:
            print(err[-3000:], flush=True)
        if args.out:
            with open(ROOT / args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
    ok = [r["result"] for r in runs if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    summary = {}
    for k in names:
        v = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        summary[k] = dict(values=v, median=statistics.median(v),
                          spread=spread(v))
    worst = {}
    for r in ok:
        for k, c in r["checks"].items():
            if c["value"] is not None:
                worst[k] = max(worst.get(k, c["value"]), c["value"])
    print("summary " + json.dumps(dict(
        workload=args.workload, runs=len(runs), results=len(ok),
        correct=sum(bool(r["correct"]) for r in ok), metrics=summary,
        largest_checks=worst)), flush=True)
    return 0 if len(ok) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
