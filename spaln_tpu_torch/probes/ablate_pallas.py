"""Time the slab kernel's score mode with one piece of its step knocked
out: the H100 counterpart of scripts/ablate_pallas.py.

    python -m spaln_tpu_torch.probes.ablate_pallas [--B 256] [--M 512]
                                     [--W 4096] [--device cuda|cpu]
                                     [--knockouts none,noscore,...]

Builds the script's bench batch (B problems of three 170-nt exons with
300 and 500 nt introns planted between them, one W-wide band at L =
128) and times the score-only entry spliced_slab_score in a build of
csrc/spliced_dp.cu for each knock-out: -DSLAB_ABLATE=n selects the
counterpart of spaln_tpu's SPALN_PALLAS_ABLATE piece
(ops/dp_spliced_pallas.py:215):

  none     the production step (SLAB_ABLATE=0, a build of its own)
  noscore  score = residue code + the class-0 row (358)
  noedge   left = H of the previous step, no band-edge selects (378)
  noipen   no intron-penalty gather (455)
  noclose  no acceptor close (473)
  nopush   no donor push (515)
  noemit   no final-row, right-column or boundary writes (559)

noclose leaves the donor candidates no reader and nopush leaves them
empty, so nvcc drops the other piece with each; two more knock-outs
split them, keeping the other piece's work:

  noclose_live  no acceptor close; the donor push kept live (the
                final-row write reads the last candidate)
  nopush_live   no donor push; the close runs at every acceptor on
                candidates nvcc cannot see

BUILDS continues the enum with the builds of time_kernel_pieces and
bisect_mosaic (SLAB_ABLATE 9-17), whose variant tables map onto it;
ablate also times the production build at a forced k (slabs a CTA runs
at once, forced_k).  A knocked-out build computes wrong scores: it is
for timing only.  The "none" build and each forced k must equal the
production kernel.  Prints ms, ns a serial
step (the launch's critical path, slab_serial_steps) and what each
knock-out saves against "none".  The builds run in parallel, one nvcc
each.  With --device cpu only the production step runs, as its plain
version (the knock-outs exist only as CUDA builds).
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..bench import bench_batch
from ..ops import dp_spliced_cuda as K
from ._cuda import elapsed_ms

SCRIPT = "scripts/ablate_pallas.py:53"
KNOCKOUTS = ("none", "noscore", "noedge", "noipen", "noclose", "nopush",
             "noemit", "noclose_live", "nopush_live")


# every SLAB_ABLATE value of csrc/spliced_dp.cu by name, in the order of
# its enum: PR 9's knock-outs, then those of time_kernel_pieces and
# bisect_mosaic
BUILDS = KNOCKOUTS + (
    "nofills", "norecur", "nopsp", "min_body", "recur_only", "recur_close",
    "recur_push", "all_off", "all_off_noedge")


def defines(build: str) -> tuple[str, ...]:
    """The nvcc defines of a build of spliced_dp.cu."""
    return (f"SLAB_ABLATE={BUILDS.index(build)}",)


@contextlib.contextmanager
def forced_k(k: int | None):
    """Force the slabs a CTA runs at once to min(S, k) (None: the
    production geometry), as chip_smoke.py --slab-timing forces them."""
    orig = K.slab_geometry
    if k is not None:
        K.slab_geometry = (lambda mode, dagp, L, A, S:
                           orig(mode, dagp, L, A, min(S, k)))
    try:
        yield
    finally:
        K.slab_geometry = orig


def serial_steps(bp, prm) -> int:
    """Global steps on the critical path of one score-mode launch over
    the batch (the geometry spliced_slab_score picks)."""
    k, _, _ = K.slab_geometry("score", prm.dagp, bp.L, bp.qprof.shape[2],
                              bp.S)
    ncta = K.slab_ctas(k, bp.S, bp.B, K._n_sm(bp.device))
    return K.slab_serial_steps(bp.T, bp.L, k, bp.S, ncta)


def builds_of(variants, table: dict) -> list:
    """The distinct builds that the variants of ``table`` (variant -> a
    BUILDS name, or another word for no build of its own) run, "none"
    always first."""
    return list(dict.fromkeys(["none"] + [table[v] for v in variants
                                          if table[v] in BUILDS]))


def build_all(builds=KNOCKOUTS) -> dict:
    """Build the production library and each build's, one nvcc each, all
    at once: name -> (library path, nvcc seconds, ptxas log)."""
    names = ("production",) + tuple(builds)
    with ThreadPoolExecutor(len(names)) as pool:
        built = pool.map(
            lambda n: K.build_library(K.SOURCE,
                                      () if n == "production" else defines(n)),
            names)
        return dict(zip(names, built))


def ablate(bp, prm, builds=KNOCKOUTS, ks=(), reps: int = 3) -> dict:
    """Time spliced_slab_score in each build, and in the production build
    at each forced k of ``ks``, on the batch (the median of ``reps``
    launches after a warm-up, CUDA events); the "none" build (always run,
    first) and each k must give the production kernel's (row, rc).
    Returns the serial steps of a launch and, under "knockouts", name ->
    {ms, steps, ns_per_step, saves_ns}: a k's row is "k=<k>", over its own
    serial steps; saves against "none", over its steps."""
    prod = K.spliced_slab_score(bp, prm)
    runs = [(b, defines(b), None)
            for b in dict.fromkeys(("none",) + tuple(builds))]
    runs += [(f"k={k}", (), k) for k in ks]
    out = {}
    for name, d, k in runs:
        with forced_k(k):
            got = K.spliced_slab_score(bp, prm, d)
            if (name == "none" or k is not None) and not all(
                    torch.equal(a, b) for a, b in zip(got, prod)):
                raise AssertionError(f"ablate_pallas: {name} differs from "
                                     f"the production kernel")
            ms = elapsed_ms(lambda: K.spliced_slab_score(bp, prm, d),
                            bp.device, reps)
            steps = serial_steps(bp, prm)
        out[name] = {"ms": ms, "steps": steps,
                     "ns_per_step": ms / steps * 1e6}
    base = out["none"]
    for v in out.values():
        v["saves_ns"] = (base["ms"] - v["ms"]) / base["steps"] * 1e6
    return {"serial_steps": base["steps"], "knockouts": out}


def report(res: dict, bp) -> None:
    cells = bp.B * bp.S * bp.L * bp.W
    print(f"ablate_pallas: B={bp.B} S={bp.S} L={bp.L} W={bp.W} T={bp.T}, "
          f"{res['serial_steps']} serial steps a launch")
    for ko, v in res["knockouts"].items():
        save = ("" if v.get("saves_ns") is None or ko == "none"
                else f"  saves {v['saves_ns']:8.1f} ns/step")
        print(f"  ablate={ko:12s} {v['ms']:9.3f} ms  "
              f"{v['ns_per_step']:8.1f} ns/serial step  "
              f"gcups={cells / v['ms'] / 1e6:.3f}{save}")


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spaln_tpu_torch.probes.ablate_pallas",
        description=__doc__.splitlines()[0])
    p.add_argument("--B", type=int, default=256)
    p.add_argument("--M", type=int, default=512)
    p.add_argument("--W", type=int, default=4096)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--knockouts", default=",".join(KNOCKOUTS))
    args = p.parse_args(argv)
    kos = tuple(args.knockouts.split(","))
    if any(k not in BUILDS for k in kos):
        raise SystemExit(f"--knockouts: of {BUILDS}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use "
                         "--device cpu to run the plain version)")
    bp, prm = bench_batch(args.B, args.M, args.W, args.device)
    if args.device == "cpu":
        ms = elapsed_ms(lambda: K.spliced_slab_score(bp, prm), bp.device)
        print(f"ablate=none (plain version on the CPU): {ms:.1f} ms")
        return 0
    for name, (so, secs, _) in build_all(kos).items():
        print(f"{name}: {so.name}, nvcc {secs:.1f} s", file=sys.stderr)
    report(ablate(bp, prm, kos), bp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
