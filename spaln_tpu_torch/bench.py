"""Benchmark: the spliced DP's score-only throughput on one card, the
counterpart of bench.py at the repository's root.

    python -m spaln_tpu_torch.bench [--B 256] [--M 512] [--W 4096]
                                    [--L 128] [--iters 7]
                                    [--device cuda|cpu]

Workload (bench.py's): B synthetic cDNA x genomic-window problems, each a
query of three M//3-nt exons and a genome with a 300 and a 500 nt GT..AG
intron between them (numpy's default_rng(0)), one W-wide band at
lw = -(W // 2), slabs of L lanes; score-only mode, the inner loop of
genome mapping.  Times spliced_slab_score (K5) over the batch prepared on
the device, each run ended by a synchronize (bench.py times its engine
over the cached operands, blocking on one element): the median of
--iters runs after a warm-up, with the spread.  GCUPS counts the band's
cells, B x slabs x L x W over the time.

Prints ONE JSON line: {"metric": "spliced_dp_gcups_per_chip", "value",
"unit": "GCUPS", "repeats", "spread_gcups": [slowest, fastest],
"device"}.  bench.py's "vs_baseline" divides by a TPU target
(BASELINE.json) and is left out; its SPALN_PALLAS_GRP=32 is a TPU tiling
and has no counterpart.  Before timing, the score launch's (row, rc)
are held once against the plain version's on the same batch (equal:
max_abs_err 0), so are the scores reduced from them (K2e's ends,
collect_batch_results), and every score must be positive.  Nothing
falls back (bench.py benches its scan engine when Pallas fails): a
mismatch, a failed build or no CUDA device exits non-zero with no JSON
line.  --device cpu times the plain version (bench.py's
BENCH_ENGINE=scan) and nothing else.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .config import Config, CvsG, resolve
from .ops import dp_spliced_cuda as K
from .ops.dp_spliced import collect_batch_results, prepare_spliced_batch
from .ops.params import DpParams
from .score.intron import IntronPenalty
from .score.simmtx import Simmtx
from .score.splice import build_splice_signals
from .score.tables import TableDir, find_table_dir
from .seq.codec import encode_dna

METRIC = "spliced_dp_gcups_per_chip"


def bench_batch(B: int = 256, M: int = 512, W: int = 4096,
                device: torch.device | str = "cpu", L: int = 128):
    """(batch, params) of bench.py's geometry: B problems, each a query
    of three M//3-nt exons and a genome with a 300 and a 500 nt intron
    (GT..AG) between them, from numpy's default_rng(0) as bench.py draws
    them; one band of W columns, lw = -(W // 2), slabs of L lanes."""
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
                               up=lw + W - 1, L=L, device=device)
    return bp, prm


def scores_of(bp, prm, row_rc) -> np.ndarray:
    """The batch's scores from the score launch's (row, rc)."""
    scores, _, _ = collect_batch_results(bp, prm, *row_rc)
    return scores


def run_once(bp, prm):
    """One timed run: the score launch, then a synchronize."""
    out = K.spliced_slab_score(bp, prm)
    if bp.device.type == "cuda":
        torch.cuda.synchronize(bp.device)
    return out


def measure(bp, prm, iters: int = 7) -> dict:
    """The bench on a prepared batch (``bench_batch``): the JSON line's
    fields and, under "scores", the batch's scores, "ms" the median run
    and "plain_ms" the plain version's run.  On a card the kernel's (row,
    rc) are first held against the plain version's on the same batch
    ("max_abs_err", AssertionError unless 0), and so are the scores
    reduced from them."""
    got = run_once(bp, prm)                               # the warm-up
    scores = scores_of(bp, prm, got)
    plain_ms = max_abs_err = None
    if bp.device.type == "cuda":
        torch.cuda.synchronize(bp.device)
        t0 = time.perf_counter()
        plain = K.slab_score_plain(bp, prm)
        torch.cuda.synchronize(bp.device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_abs_err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip(got, plain))
        if max_abs_err:
            raise AssertionError(f"bench: the kernel's (row, rc) differ "
                                 f"from the plain version's by up to "
                                 f"{max_abs_err}")
        plain = scores_of(bp, prm, plain)
        if not np.array_equal(scores, plain):
            bad = int(np.flatnonzero(scores != plain)[0])
            raise AssertionError(f"bench: the kernel's score of problem "
                                 f"{bad} is {scores[bad]}, the plain "
                                 f"version's {plain[bad]}")
    if not (scores > 0).all():
        raise AssertionError("bench: the benchmark alignments must score "
                             "positive")
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run_once(bp, prm)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    cells = bp.B * bp.S * bp.L * bp.W

    def gcups(t):
        return cells / t / 1e9
    return {"metric": METRIC, "value": gcups(dt), "unit": "GCUPS",
            "repeats": iters,
            "spread_gcups": [gcups(times[-1]), gcups(times[0])],
            "device": (torch.cuda.get_device_name(bp.device)
                       if bp.device.type == "cuda" else "cpu"),
            "ms": dt * 1e3, "plain_ms": plain_ms,
            "max_abs_err": max_abs_err, "cells": cells,
            "scores": scores}


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m spaln_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--B", type=int, default=256)
    p.add_argument("--M", type=int, default=512)
    p.add_argument("--W", type=int, default=4096)
    p.add_argument("--L", type=int, default=128)
    p.add_argument("--iters", type=int, default=7)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: --device cuda: no CUDA device is available",
              file=sys.stderr)
        return 1
    try:
        bp, prm = bench_batch(args.B, args.M, args.W, args.device, args.L)
        res = measure(bp, prm, args.iters)
    except (AssertionError, RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 1
    print(json.dumps({k: res[k] for k in ("metric", "value", "unit",
                                          "repeats", "spread_gcups",
                                          "device")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
