"""Time the slab kernel's score mode with pieces of its step knocked out,
at the bench batch: the H100 counterpart of scripts/time_kernel_pieces.py.

    python -m spaln_tpu_torch.probes.time_kernel_pieces [variant ...]
                                     [--device cuda|cpu]

The script writes textual variants of spaln_tpu/ops/dp_spliced_pallas.py
(the Pallas slab kernel; its pallas_call at 767) and times
run_spliced_batch_pallas(score_only=True) in each on bench.py's batch
(B=256, M=512, W=4,096, L=128).  Here a variant is a build of
csrc/spliced_dp.cu with -DSLAB_ABLATE=n (ablate_pallas.BUILDS), timed by
ablate_pallas.ablate on the same batch (spaln_tpu_torch.bench's
bench_batch).  Every variant of the
script, its build, and whether its pattern still occurs in today's
dp_spliced_pallas.py (where it does not, the script asserts "pattern
missing" and prints FAILED):

  variant   build (SLAB_ABLATE)  the script's pattern
  full      none (0)             no pattern: the production step
  no_ipen   noipen (3)           stale; both drop the intron-penalty
                                 lookup for a constant (the script's
                                 -500, the build's 0, an add fewer)
  no_tail   no counterpart       stale; the carried penalty's log tail:
                                 the port gathers the dense table
  no_close  noclose (4)          present
  no_push   nopush (5)           stale
  no_roll   no counterpart       stale; the window roll: the port reads
                                 the staged operand at the shifted
                                 column, and that read is what it times
  no_fills  nofills (9)          stale; lane 0's boundary-row reads
                                 held at NEV (the script's 0)
  chunk512, grp32, grp8, chunk128
            k = 1, 2, 4          stale; the TPU's GRP/CHUNK tilings: the
                                 port's counterpart is k slabs a CTA and
                                 the CTAs a problem, timed on the
                                 production build as chip_smoke.py
                                 --slab-timing forces them
  no_emis   noemit (6)           stale; the script swaps the row and rc
                                 lane reductions for lane reads, the
                                 port's values are one lane's stores:
                                 noemit drops them (and the boundary
                                 rows)

A knocked-out build computes wrong scores: it is for timing only.  The
"full" build must equal the production kernel, and each forced k the
production geometry's outputs; otherwise the module raises.  Prints ms,
ns a serial step (ablate_pallas.serial_steps, the launch's critical path)
and what each variant saves against "full", as the script does.  The
builds run in parallel, one nvcc each.  With --device cpu only "full"
runs, as its plain version.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..bench import bench_batch
from ..ops import dp_spliced_cuda as K
from . import ablate_pallas as AB
from ._cuda import elapsed_ms

TILINGS = (1, 2, 4)
# variant -> an ablate_pallas.BUILDS name, "tiling" (the production build
# at each k of TILINGS) or None (no counterpart: NO_COUNTERPART says why)
VARIANTS = {"full": "none", "no_ipen": "noipen", "no_tail": None,
            "no_close": "noclose", "no_push": "nopush", "no_roll": None,
            "no_fills": "nofills", "chunk512": "tiling", "grp32": "tiling",
            "grp8": "tiling", "chunk128": "tiling", "no_emis": "noemit"}
NO_COUNTERPART = {
    "no_tail": "the carried penalty's log tail: the port gathers the "
               "dense intron-penalty table",
    "no_roll": "the window roll: the port reads the staged operand at "
               "the shifted column, and that read is what it times"}
# the variants whose pattern no longer occurs in dp_spliced_pallas.py
STALE = frozenset(VARIANTS) - {"full", "no_close"}


def report(res: dict, variants, bp) -> None:
    """The script's lines: each variant's build, ms and ns a serial step
    (ablate_pallas.ablate's result), then what each saves against
    full."""
    rows = res["knockouts"]
    print(f"geometry: B={bp.B} T={bp.T} slabs={bp.S} serial steps="
          f"{res['serial_steps']}")
    for v in variants:
        b = VARIANTS[v]
        if b is None:
            print(f"{v:10s} no counterpart: {NO_COUNTERPART[v]}")
            continue
        for name in ([f"k={k}" for k in TILINGS] if b == "tiling" else [b]):
            r = rows[name]
            print(f"{v:10s} {name:14s} {r['ms']:8.3f} ms  "
                  f"{r['ns_per_step']:8.1f} ns/serial step", flush=True)
    for v in variants:
        b = VARIANTS[v]
        if b in (None, "none"):
            continue
        for name in ([f"k={k}" for k in TILINGS] if b == "tiling" else [b]):
            print(f"  {v:10s} {name:14s} saves "
                  f"{rows[name]['saves_ns']:8.1f} ns/step")


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spaln_tpu_torch.probes.time_kernel_pieces",
        description=__doc__.splitlines()[0])
    p.add_argument("variants", nargs="*", help=f"of {tuple(VARIANTS)}")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    variants = args.variants or list(VARIANTS)
    if any(v not in VARIANTS for v in variants):
        raise SystemExit(f"variants: of {tuple(VARIANTS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use "
                         "--device cpu to run the plain version)")
    bp, prm = bench_batch(device=args.device)
    if args.device == "cpu":
        ms = elapsed_ms(lambda: K.spliced_slab_score(bp, prm), bp.device)
        print(f"full (the plain version on the CPU): {ms:.1f} ms")
        return 0
    builds = AB.builds_of(variants, VARIANTS)
    for name, (so, secs, _) in AB.build_all(builds).items():
        print(f"{name}: {so.name}, nvcc {secs:.1f} s", file=sys.stderr)
    ks = TILINGS if "tiling" in (VARIANTS[v] for v in variants) else ()
    report(AB.ablate(bp, prm, builds, ks), variants, bp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
