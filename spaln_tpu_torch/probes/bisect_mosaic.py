"""Build and launch the slab kernel's score mode with pieces of its step
knocked out, on a tiny batch: the H100 counterpart of
scripts/bisect_mosaic.py.

    python -m spaln_tpu_torch.probes.bisect_mosaic [variant ...]
                                     [--device cuda|cpu] [--time]

The script bisects a Mosaic compile failure: it writes textual variants
of spaln_tpu/ops/dp_spliced_pallas.py (the Pallas slab kernel; its
pallas_call at 767) and tries run_spliced_batch_pallas(score_only=True)
in each on B=8 problems (M=96: three 32-nt exons, one 80-nt GT..AG
intron; W=512, L=128).  Here a variant is a build of csrc/spliced_dp.cu
with -DSLAB_ABLATE=n (ablate_pallas.BUILDS), launched through
spliced_slab_score on the same batch: PASS when it built, launched and
raised nothing.  Every variant of the script, its build, and whether its
pattern still occurs in today's dp_spliced_pallas.py:

  variant         build (SLAB_ABLATE)   the script's pattern
  orig            none (0)              no pattern: the production step
  no_ipen_chain   noipen (3)            stale; the penalty chain, here
                                        the lookup, for a constant
  no_close        noclose (4)           present
  no_push         nopush (5)            stale
  no_emis         noemit (6)            present; the script keeps the
                                        emissions and makes their lane
                                        mask data-dependent, the port's
                                        are one lane's stores: noemit
                                        drops them
  static_fills    nofills (9)           stale; lane 0's boundary reads
                                        held at NEV
  static_roll     no counterpart        stale; the window roll: the port
                                        reads the staged operand at the
                                        shifted column
  no_edge         noedge (2)            present
  no_recur        norecur (10)          present
  unsplat         no counterpart        present (fails in Pallas's
                                        interpret mode); splatted vector
                                        constants: CUDA's are immediates
  no_psp          nopsp (11)            present
  all_off         all_off (16)          stale (four of its six parts);
                                        static_roll has no counterpart
  all_off_noedge  all_off_noedge (17)   stale; all_off and no_edge
  min_body        min_body (12)         _cut_body's markers present
  recur_only      recur_only (13)       present
  recur_close     recur_close (14)      present; the candidates start
                                        live, or nvcc drops the close
                                        with the push
  recur_push      recur_push (15)       present; the final row reads the
                                        candidates, or nvcc drops the push

The "orig" build must equal the production kernel, or the module raises.
With --time each build is also timed on time_kernel_pieces' batch (the
bench batch).  The builds run in parallel, one nvcc each.  With --device
cpu only "orig" runs, as its plain version.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..bench import bench_batch
from ..config import Config, CvsG, resolve
from ..ops import dp_spliced_cuda as K
from ..ops.dp_spliced import prepare_spliced_batch
from ..ops.params import DpParams
from ..score.intron import IntronPenalty
from ..score.simmtx import Simmtx
from ..score.splice import build_splice_signals
from ..score.tables import TableDir, find_table_dir
from ..seq.codec import encode_dna
from . import ablate_pallas as AB

# variant -> an ablate_pallas.BUILDS name, or None (no counterpart:
# NO_COUNTERPART says why); the last four are the script's _cut_body cuts
VARIANTS = {"orig": "none", "no_ipen_chain": "noipen",
            "no_close": "noclose", "no_push": "nopush", "no_emis": "noemit",
            "static_fills": "nofills", "static_roll": None,
            "no_edge": "noedge", "no_recur": "norecur", "unsplat": None,
            "no_psp": "nopsp", "all_off": "all_off",
            "all_off_noedge": "all_off_noedge", "min_body": "min_body",
            "recur_only": "recur_only", "recur_close": "recur_close",
            "recur_push": "recur_push"}
CUTS = ("min_body", "recur_only", "recur_close", "recur_push")
NO_COUNTERPART = {
    "static_roll": "the window roll: the port reads the staged operand at "
                   "the shifted column",
    "unsplat": "splatted vector constants: CUDA's constants are "
               "immediates"}
# the variants whose pattern no longer occurs in dp_spliced_pallas.py
STALE = frozenset({"no_ipen_chain", "no_push", "static_fills",
                   "static_roll", "all_off", "all_off_noedge"})


def bisect_batch(device: torch.device | str = "cpu"):
    """(batch, params) of the script: B=8 problems, each a query of three
    32-nt exons and a genome with one 80-nt GT..AG intron after the
    first, from numpy's default_rng(0) as the script draws them; W=512,
    lw = -256, L=128."""
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    tables = TableDir(find_table_dir())
    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))
    B, M, W = 8, 96, 512
    queries, genomes, sigs = [], [], []
    for _ in range(B):
        e = ["".join(rng.choice(bases, M // 3)) for _ in range(3)]
        i1 = "GTAAGT" + "".join(rng.choice(bases, 80)) + "TTTTTAG"
        queries.append(encode_dna("".join(e)))
        genomes.append(encode_dna(e[0] + i1 + e[1] + e[2]))
        sigs.append(build_splice_signals(genomes[-1], cfg, tables))
    bp = prepare_spliced_batch(queries, genomes, prm, sigs=sigs,
                               lw=-(W // 2), up=-(W // 2) + W - 1, L=128,
                               device=device)
    return bp, prm


def bisect(bp, prm, variants) -> dict:
    """Launch each variant's build on the batch: variant -> "PASS",
    "FAIL | reason" or "no counterpart: reason".  Raises if "orig"
    differs from the production kernel."""
    out = {}
    prod = K.spliced_slab_score(bp, prm)
    for v in variants:
        b = VARIANTS[v]
        if b is None:
            out[v] = f"no counterpart: {NO_COUNTERPART[v]}"
            continue
        try:
            got = K.spliced_slab_score(bp, prm, AB.defines(b))
            torch.cuda.synchronize(bp.device)
        except RuntimeError as e:
            out[v] = f"FAIL | {str(e)[:300]}"
            continue
        if b == "none" and not all(torch.equal(x, y)
                                   for x, y in zip(got, prod)):
            raise AssertionError("bisect_mosaic: the orig build differs "
                                 "from the production kernel")
        out[v] = "PASS"
    return out


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spaln_tpu_torch.probes.bisect_mosaic",
        description=__doc__.splitlines()[0])
    p.add_argument("variants", nargs="*", help=f"of {tuple(VARIANTS)}")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--time", action="store_true",
                   help="also time each build on the bench batch")
    args = p.parse_args(argv)
    variants = args.variants or list(VARIANTS)
    if any(v not in VARIANTS for v in variants):
        raise SystemExit(f"variants: of {tuple(VARIANTS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use "
                         "--device cpu to run the plain version)")
    bp, prm = bisect_batch(args.device)
    if args.device == "cpu":
        K.spliced_slab_score(bp, prm)
        print("PASS orig (the plain version on the CPU)")
        return 0
    builds = AB.builds_of(variants, VARIANTS)
    for name, (so, secs, _) in AB.build_all(builds).items():
        print(f"{name}: {so.name}, nvcc {secs:.1f} s", file=sys.stderr)
    res = bisect(bp, prm, variants)
    for v, r in res.items():
        print(f"PASS {v}" if r == "PASS" else f"FAIL {v} {r[5:]}"
              if r.startswith("FAIL") else f"---- {v} | {r}", flush=True)
    if args.time:
        del bp
        tb, tprm = bench_batch(device="cuda")
        ok = [VARIANTS[v] for v in variants if res[v] == "PASS"]
        t = AB.ablate(tb, tprm, ok)["knockouts"]
        for v in variants:
            if res[v] == "PASS":
                r = t[VARIANTS[v]]
                print(f"  {v:15s} {r['ms']:8.3f} ms  {r['ns_per_step']:8.1f} "
                      f"ns/serial step  saves {r['saves_ns']:8.1f}")
    return 1 if any(r.startswith("FAIL") for r in res.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
