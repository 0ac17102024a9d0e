"""The benchmark's harness: one run of one cell.

Driven by data.  ``BENCHMARK.json`` names the cells; each cell's parts are
found by name:

- ``benchmark/configs/<config>.json``: the deployment (its builder,
  ``benchmark/builders/<builder>.py``, its sizes, the program's options as
  command-line words, its controls, the reference that judges it);
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters and
  options, read by the generator it names (``benchmark/generators/
  <generator>.py``, ``planted`` by default) and the entry it names,
  ``benchmark/entries/<entry>.py``;
- ``benchmark/metrics/<metric>.py``: one reader a metric, end-to-end or
  per layer, from the run's record;
- ``benchmark/reference/<reference>.py``: the plain reference;
- ``benchmark/limits/<cell>.json``: each compared number's limit.

A run: the deployment from its cache (built there once), the system set
up and warmed up on one block of the cell's queries, then the window,
then the reference's judgement, then one JSON line on standard output.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import deploy

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "spaln_tpu")


class Refused(Exception):
    """A run that cannot give a result (exit code ``code``)."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def _module(kind: str, name: str, base: Path = HERE):
    path = base / kind / f"{name}.py"
    if not path.exists():
        raise Refused(f"no {kind} file {path}")
    return deploy.load_module(path, kind, name)


def _json(kind: str, name: str, base: Path) -> tuple[dict, Path]:
    path = base / kind / f"{name}.json"
    if not path.exists():
        raise Refused(f"no {kind} file {path}")
    return json.loads(path.read_text()), path


def resolve(spec: dict, workload_name: str, base: Path = HERE,
            cache: Path = deploy.CACHE) -> dict:
    """The cell's parts, found by the names in ``spec`` under ``base``
    (this directory); its deployment cached under ``cache``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload_name not in cells:
        raise Refused(f"no workload {workload_name!r} in BENCHMARK.json")
    w = cells[workload_name]
    cfg, cfg_path = _json("configs", w["config"], base)
    traffic, _ = _json("traffic", w["traffic"], base)
    limits, _ = _json("limits", w["name"], base)

    def mine(m):
        return "workloads" not in m or w["name"] in m["workloads"]
    return dict(name=w["name"], chips=w["chips"], base=base, cache=cache,
                cfg=cfg, cfg_path=cfg_path,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def compare(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number compared at or
    under its limit.  A limit of ``null`` reports a number that has no
    upper reading in this cell without comparing it; a number missing
    from the limits, or a limit without its number, is a fault."""
    out, ok = {}, True
    for k, v in checks.items():
        if k.startswith("_"):
            continue
        lim = limits.get(k, "missing")
        out[k] = {"value": v, "limit": lim}
        ok &= lim is None or (lim != "missing" and v <= lim)
    for k in limits:
        if k not in out:
            out[k] = {"value": None, "limit": limits[k]}
            ok = False
    return ok, out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t_proc: float, device: str = "cuda",
             control: str | None = None) -> tuple[dict, dict]:
    """One run of ``cell``; returns (the result line, the run's record).
    ``control`` names one of the configuration's ``controls``: command-
    line words that run the program with a guarantee of the
    configuration broken, for the correctness control."""
    import torch
    cfg, traffic = cell["cfg"], cell["traffic"]
    on_card = device == "cuda"
    base = cell["base"]
    extra = ()
    if control is not None:
        if control not in cfg.get("controls", {}):
            raise Refused(f"no control {control!r} in {cfg['name']}")
        extra = tuple(cfg["controls"][control])
    dep, built = deploy.load(cfg, cell["cfg_path"], cell["cache"], base)
    entry = _module("entries", traffic["entry"], base)
    gen = _module("generators", traffic.get("generator", "planted"), base)
    built |= bool(entry.prepare(dep, cfg, traffic))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    from .system import System
    system = System(cfg, traffic, dep, torch.device(device),
                    entry.SUBCOMMAND, extra)
    entry.setup(system)
    entry.warm(system, gen.warmup_queries(dep, cfg, traffic, seed))
    if on_card:
        torch.cuda.synchronize()
    system.metrics.reset()
    stream = gen.QueryStream(dep, cfg, traffic, seed)
    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer()
        tracer.install()
        system.tracer = tracer
        tracer.start()
    setup_s = time.perf_counter() - t_proc
    res = entry.drive(system, stream, seconds, tracer)
    if tracer is not None:
        tracer.stop()
        tracer.uninstall()
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    failed = system.skipped()
    stages = {k: float(v) for k, v in system.metrics.timings.items()}
    output_s, words = system.output_s, system.words
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    record = dict(entry=traffic["entry"], n=len(res["answers"]),
                  window_s=res["t1"] - res["t0"], setup_s=setup_s,
                  query_s=res["query_s"], stages=stages, output_s=output_s,
                  built=built, cli=words,
                  trace=tracer.summary() if tracer is not None else None)
    ref = _module("reference", cfg["reference"], base)
    t0 = time.perf_counter()
    records = [dict(query=dataclasses.asdict(q), text=text)
               for q, text in res["answers"]]
    if traffic["entry"] == "align":
        order = np.argsort(res["query_s"])[::-1][:5]
        record["slowest"] = [
            (res["answers"][i][0].name, res["answers"][i][0].hi -
             res["answers"][i][0].lo, len(res["answers"][i][0].seq),
             res["query_s"][i]) for i in order]
    checks = ref.judge(records, dep, cfg)
    checks["skipped"] = failed
    record["reference_s"] = time.perf_counter() - t0
    correct, compared = compare(checks, cell["limits"])
    record["info"] = {k: v for k, v in checks.items()
                      if k.startswith("_") and k != "_faults"}
    record["faults"] = checks.get("_faults", [])
    specs = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in specs:
        v = _module("metrics", m["name"], base).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = dict(correct=bool(correct), attempted=record["n"], failed=failed,
                metrics=metrics, device=_device(device, peak, record))
    if trace:
        t = record["trace"]
        line["breakdown"] = dict(
            device_ops=[[k, v] for k, v in t["device_ops"]],
            idle_gaps=[[k, v] for k, v in t["idle_gaps"]])
    line["checks"] = compared
    return line, record


def _device(device: str, peak: int, record: dict) -> dict:
    import torch
    if device == "cuda":
        d = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                 count=1, memory_peak_bytes=peak)
    else:
        d = dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    if record["trace"] is not None:
        d["busy_s"] = record["trace"]["busy_s"]
        d["window_s"] = record["trace"]["window_s"]
    return d


def banned_modules() -> list:
    """Modules loaded in this process whose top-level name is, whole, one
    the port may not bring in."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv: list, t_proc: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    ap.add_argument("--control", default=None,
                    help="run the correctness control of this name (the "
                         "configuration's controls)")
    args = ap.parse_args(argv)
    try:
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        cell = resolve(spec, args.workload)
        import torch
        torch.set_num_threads(1)
        torch.set_num_interop_threads(1)
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark runs on the card "
                          "only")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['name']} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
        try:
            import spaln_tpu_torch  # noqa: F401
        except ImportError as exc:
            raise Refused(f"the program is not in this checkout: {exc}", 3)
        line, record = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), t_proc,
                                control=args.control)
    except Refused as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return exc.code
    bad = banned_modules()
    if bad:
        print(f"benchmark: modules loaded that the port may not use: "
              f"{bad}", file=sys.stderr)
        return 4
    _log(record)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def _log(record: dict) -> None:
    """The run's record, short, on standard error (before the checks)."""
    for f in record["faults"]:
        print(f"fault {f['name']} (locus from {f['lo']}): {f['what']}\n"
              f"{f['text']}", file=sys.stderr)
    keep = {k: v for k, v in record.items()
            if k not in ("query_s", "trace", "faults")}
    if record["query_s"]:
        q = np.asarray(record["query_s"])
        keep["query_s"] = dict(n=len(q), median=float(np.median(q)),
                               p95=float(np.percentile(q, 95)),
                               max=float(q.max()))
    if record["trace"] is not None:
        keep["trace"] = {k: v for k, v in record["trace"].items()
                         if k != "query_kernel_s"}
    print("record " + json.dumps(keep, default=float), file=sys.stderr)
