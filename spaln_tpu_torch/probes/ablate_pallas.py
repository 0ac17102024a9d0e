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

A knocked-out build computes wrong scores: it is for timing only.  The
"none" build must equal the production kernel.  Prints ms, ns a serial
step (the launch's critical path, slab_serial_steps) and what each
knock-out saves against "none".  The builds run in parallel, one nvcc
each.  With --device cpu only the production step runs, as its plain
version (the knock-outs exist only as CUDA builds).
"""
from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config, CvsG, resolve
from ..ops import dp_spliced_cuda as K
from ..ops.dp_spliced import prepare_spliced_batch
from ..ops.params import DpParams
from ..score.intron import IntronPenalty
from ..score.simmtx import Simmtx
from ..score.splice import build_splice_signals
from ..score.tables import TableDir, find_table_dir
from ..seq.codec import encode_dna
from ._cuda import elapsed_ms

SCRIPT = "scripts/ablate_pallas.py:53"
KNOCKOUTS = ("none", "noscore", "noedge", "noipen", "noclose", "nopush",
             "noemit", "noclose_live", "nopush_live")


def defines(knockout: str) -> tuple[str, ...]:
    """The nvcc defines of a knock-out's build of spliced_dp.cu."""
    return (f"SLAB_ABLATE={KNOCKOUTS.index(knockout)}",)


def bench_batch(B: int = 256, M: int = 512, W: int = 4096,
                device: torch.device | str = "cpu"):
    """(batch, params) of the script's bench geometry: B problems, each
    a query of three M//3-nt exons and a genome with a 300 and a 500 nt
    intron (GT..AG) between them, from numpy's default_rng(0) as the
    script draws them; one band of W columns, lw = -(W // 2), L = 128."""
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    tables = TableDir(find_table_dir())
    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))
    queries, genomes, sigs = [], [], []
    for _ in range(B):
        e = ["".join(rng.choice(bases, M // 3)) for _ in range(3)]
        i1 = "GTAAGT" + "".join(rng.choice(bases, 300)) + "TTTTTAG"
        i2 = "GTGAGT" + "".join(rng.choice(bases, 500)) + "TTTCTAG"
        queries.append(encode_dna("".join(e)))
        genomes.append(encode_dna(e[0] + i1 + e[1] + i2 + e[2]))
        sigs.append(build_splice_signals(genomes[-1], cfg, tables))
    lw = -(W // 2)
    bp = prepare_spliced_batch(queries, genomes, prm, sigs=sigs, lw=lw,
                               up=lw + W - 1, L=128, device=device)
    return bp, prm


def serial_steps(bp, prm) -> int:
    """Global steps on the critical path of one score-mode launch over
    the batch (the geometry spliced_slab_score picks)."""
    k, _, _ = K.slab_geometry("score", prm.dagp, bp.L, bp.qprof.shape[2],
                              bp.S)
    ncta = K.slab_ctas(k, bp.S, bp.B, K._n_sm(bp.device))
    return K.slab_serial_steps(bp.T, bp.L, k, bp.S, ncta)


def build_all(knockouts=KNOCKOUTS) -> dict:
    """Build the production library and every knock-out's, one nvcc each,
    all at once: name -> (library path, nvcc seconds)."""
    names = ("production",) + tuple(knockouts)
    with ThreadPoolExecutor(len(names)) as pool:
        built = pool.map(
            lambda n: K.build_library(K.SOURCE,
                                      () if n == "production" else defines(n)),
            names)
        return {n: (so, secs) for n, (so, secs, _) in zip(names, built)}


def ablate(bp, prm, knockouts=KNOCKOUTS, reps: int = 3) -> dict:
    """Time each knock-out's spliced_slab_score on the batch (the median
    of ``reps`` launches after a warm-up, CUDA events); hold the "none"
    build's (row, rc) equal to the production build's.  Returns name ->
    {ms, ns_per_step, saves_ns}, and the serial steps."""
    steps = serial_steps(bp, prm)
    prod = K.spliced_slab_score(bp, prm)
    out = {}
    for ko in knockouts:
        d = defines(ko)
        got = K.spliced_slab_score(bp, prm, d)
        if ko == "none" and not all(torch.equal(a, b)
                                    for a, b in zip(got, prod)):
            raise AssertionError("ablate_pallas: the SLAB_ABLATE=0 build "
                                 "differs from the production kernel")
        ms = elapsed_ms(lambda: K.spliced_slab_score(bp, prm, d),
                        bp.device, reps)
        out[ko] = {"ms": ms, "ns_per_step": ms / steps * 1e6}
    for v in out.values():
        v["saves_ns"] = out["none"]["ns_per_step"] - v["ns_per_step"] \
            if "none" in out else None
    return {"serial_steps": steps, "knockouts": out}


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
    if any(k not in KNOCKOUTS for k in kos):
        raise SystemExit(f"--knockouts: of {KNOCKOUTS}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use "
                         "--device cpu to run the plain version)")
    bp, prm = bench_batch(args.B, args.M, args.W, args.device)
    if args.device == "cpu":
        ms = elapsed_ms(lambda: K.spliced_slab_score(bp, prm), bp.device)
        print(f"ablate=none (plain version on the CPU): {ms:.1f} ms")
        return 0
    for name, (so, secs) in build_all(kos).items():
        print(f"{name}: {so.name}, nvcc {secs:.1f} s", file=sys.stderr)
    report(ablate(bp, prm, kos), bp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
