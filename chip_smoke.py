"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the map, align, search and pair paths from
spaln_tpu_torch/csrc/spliced_dp.cu (thirteen C entries), of the protein
path from spaln_tpu_torch/csrc/tron_dp.cu (three), the step probes
from spaln_tpu_torch/csrc/probes.cu (six) and the step skeletons from
spaln_tpu_torch/csrc/mosaic_repro.cu (one entry, 30 instances), one nvcc
per source, started together, then:

1. kernels: one bucket at main-path shapes (B=8, L=128, W=1152, 2 slabs,
   planted introns) through each kernel and its plain PyTorch version on
   the card; outputs must be exactly equal (integer DP: tolerance 0).
   K4 (links), K1's retrace of slab 1 from K4's snapshot (against the
   full K1 planes of slab 1) and K3's strip mode (spliced_tb_strips)
   included; the walks' steps and tile loads (their kernels' stats)
   equal to the CPU model's (walk_stats) on the same records.  K2e at
   both widths (a warp and a CTA a problem) and the plane path's fused
   entry (spliced_ends_tb_walk: K2e then K3 in one launch) against
   their plain versions and walk_stats, on K1's rows and on tie-heavy
   rows (tie_rows), here and on the tetrapod-width bucket below.  Then the
   same for the double-affine (-yl3) entries on a bucket of the same
   shape whose genes also carry 30-90 nt in-exon indels (some path cell
   must be won by a long-gap state), and the score-only entry on that
   bucket and on a protein batch of the search (B=64, L=128, full band).
   Then a bucket of 17 slabs (B=4, L=128, W=256, queries of different
   lengths), where the slab kernel's rounds of k slabs in flight wrap
   twice and end part-full: every slab entry, single and double affine,
   exactly equal to its plain version (run on CPU copies in parallel
   processes, beside K6's modes at main-path shapes: K1, K1-dagp, K4
   and K4-dagp local with a -yJ bonus on half of phase 1's bucket, and
   K1 with the local emission on a batch of search_protein_local, B=64,
   L=64; each timed beside the entry with K6 off on the same shape),
   the retrace of slabs 2..16 equal to K1's planes, and the
   UDH path on that bucket as it runs (every path's slab run in one
   retrace launch, every strip in one spliced_tb_strips launch, exact
   against its plain version) with the same op streams as the one-slab
   path (one problem-slab a retrace launch) and as run_bucket.  Then the
   UDH path of a bucket in K6's modes (phase 1's, local with a -yJ bonus
   on half the problems, single and double affine) as it runs: every
   (problem, slab) pair in one spliced_slab_retrace_pairs launch and
   every strip in one spliced_tb_strips launch (a slab a walk), each
   exactly equal to its plain version on the card, the pairs' planes to
   the one-slab launches of spliced_slab_retrace, the walks' steps and
   tile loads to the model's; the pairs launch timed against those
   one-slab launches.  Last
   timing-only buckets at tetrapod width (B=32, L=128, W=16,384, 12
   slabs) and of a one-problem align window (B=1, W=65,536, 12 slabs):
   K1, K4 and the retrace (one slab; slabs 1..11; all 12 slabs of every
   problem, as the UDH path launches them, at its own k and at k = 1, 2,
   3, 4, 7; every (problem, slab) pair in one launch of the retrace of
   pairs, with the CTAs an SM holds), each retrace's planes equal to
   K1's; ms per launch, k, CTAs per problem, serial steps per launch and
   us per global step.  Last
   the tron batch at phase 8's shapes (B=4 planted protein genes of
   330-384 aa with 2-6 kb introns, the map's 128 lanes: 3 slabs, the
   bands prepare_tron_job gives them: W = 15,744): K7 with 3 and 5
   states, Smith-Waterman local on and off, exactly equal to its plain
   version (run on CPU copies in 6 processes while phases 2-8 run,
   compared at the end) at the rule's geometry, and at the forced sweep
   of k = 1, 2, 3 (1, 2 double affine) slabs a CTA x 1, 2, 3 CTAs per
   problem equal to the rule's outputs; K8 on each to its plain version
   on the card, its steps and tile loads to the model's
   (tron_walk_stats); then K7 on one problem of 11 slabs and on two of one
   1,024-lane slab (three pieces), each at its rule's geometry and
   forced ones, against its plain version;
2. map, small: `index` + `map -O0` and `-O4` of 4 planted genes through
   the CLI, once on the kernels and once with the DP forced through the
   plain versions on the card; the text must be byte-identical;
3. map, dictdisc size (plane path): a synthetic genome with the shape of
   Spaln's Dictyostelium seqdb sample (6 chromosomes, ~34 Mb, GC ~22%)
   with 200 planted genes on both strands, `index` then `map -T Dictyost
   -O0,4 --device cuda`; every bucket must run on the kernels and >= 95%
   of queries must be reported at their planted locus and strand;
4. map, tetrapod size (UDH path): 3 chromosomes (~48 Mb, GC ~41%) with
   48 planted genes of 4-10 exons and kilobase introns, `map -T Tetrapod
   -O0,4` with the size-driven choice and again with every multi-slab
   bucket forced through UDH (-A 3): the texts must be byte-identical,
   every UDH bucket must run on K4, K1 retrace and K3 strip (one strip
   launch per retrace launch) with no plain call, and >= 90% of queries
   must be at their planted locus and strand;
5. align: one 2.4 Mb genomic segment with 8 planted cDNA genes (two with
   an intron over 16,384 nt, one across the 2 Mb chunk seam), `align -T
   Tetrapod -O0,4`; all 8 must be found at their locus and strand, and
   the counters must show the chunking, the long-intron split and the UDH
   window path;
6. map -yl3 (double-affine gaps) on phase 4's genome and index: its 48
   cDNAs, a third with a 30-90 nt in-exon deletion and a third with a
   30-90 nt insertion, `map -T Tetrapod -y l3 -O0,4` with the size rule
   and with -A 3: texts byte-identical, >= 90% at the planted locus and
   strand, every bucket on the *_dagp entries with no plain call;
7. protein search at proteome size: a 20,000-entry DB (~8.5 M residues,
   background amino-acid frequencies, log-normal lengths of median 375
   aa) and 200 queries copied from random entries with 5-30%
   substitutions and 0-2 indels, `search -a db.fa --max-hits 10
   --align-top 1 -O0,1`: >= 95% of queries with their source as the top
   hit, every score pass on the score-only entry and K2e, every traced
   hit on K1 and the fused K2e + K3; then `pair` on the 200 (query,
   source) pairs;
8. protein map: a synthetic 32 Mb genome (4 chromosomes, GC ~41%) with
   100 planted protein-coding genes (proteins of median 375 aa, 3-10
   exons, introns log-uniform over 0.1-10 kb at all three codon phases,
   both strands), queries at 0-20% substitutions and 0-2 short indels:
   `index -K P`, then `map -T Tetrapod -O0,4` (Smith-Waterman local,
   3 states) and `map -y l3` (5 states); every batch on K7 and K8 with no
   plain call, >= 90% of queries at their planted locus and strand, some
   K7 launch with a problem on more than one CTA; after each map, every
   K8 launch's records (the batch's K7 run again) equal to K8's plain
   version's on the card and its tile loads to the model's; each launch of K7
   (with its k, CTAs per problem and serial steps) and K8 timed on the
   map's run beside the bound of its batch, and the sums over the
   launches;
9. the step probes (spaln_tpu_torch.probes, the H100 counterparts of
   the TPU micro-probes of scripts/): every body's kernel exactly equal
   to its plain version on the card at 256 steps, at 128 and 1024
   threads, then each probe's measure (what its main prints) at its
   script's T and 2T at 128 and 1024 threads: ns a step by
   T-differencing, and each body's bound (the integer operations its
   result needs over the card's int32 rate);
10. the step skeletons and the bench (spaln_tpu_torch.probes.mosaic_repro,
   the counterpart of scripts/mosaic_repro.py, and spaln_tpu_torch.bench,
   bench.py's): every level's kernel exactly equal to its plain version
   on the card on all four outputs, at the script's inputs (B=16; levels
   32-46 at B=8), then each level at 7 and 14 chunks (ns a step); the
   bench's workload (B=256, M=512, W=4,096): GCUPS with the spread, its
   scores equal to the plain version's, and the score launch's bound.

11. (after phase 6) K6 on phase 4's genome and index: `map -L S` (the
   size rule, then -A 3 -y l3) and `map` of its 48 cDNAs rewritten with
   junction records (;B/;b) at their planted junctions (-y l3 under the
   size rule, then -A 3): every bucket on the kernels in K6's modes
   with no plain call, >= 90% at the planted locus and strand; under -A
   3 the retrace of pairs at most once a UDH bucket (plus the plane
   budget's splits, counted) and never one slab a launch, its launches'
   pairs, CTAs an SM holds and waves logged; then
   phase 2's corpus with `-L S -A 3` and with junction records,
   byte-identical with the DP forced through the plain versions on the
   card;
12. (after phase 7) local protein search: 3 queries (two blocks of
   30-40 aa around 150 aa of background) against phase 7's 20,000-entry
   DB with copies of their blocks planted in three known entries at 15%
   substitutions (search_protein_local: K1 local with the emission a
   batch of 64): every planted island reported.
13. (last, after the K7 plain versions) the data-parallel path, the
   tools and the entry module: phase 4's queries through
   map_queries_sharded on [cuda:0, cuda:0] (every batch in two shards
   run at once), size rule and -A 3, each -O0,4 text's md5 phase 4's,
   on the kernels with no plain call; sortgrcd (-O0 and -O15) over the
   -O12 shard phase 4's default map writes beside its text; `ild fit`
   on the card of phase 4's planted intron lengths and of a seeded
   10,000-length Frechet mixture, each held against `--device cpu` (in
   a process of its own) to the fit tolerance, with both walls;
   entry()'s forward against its plain version; dryrun_multichip(1)
   over NCCL.

Phase 8's corpus and protein index are built in a process of their own
beside the kernels' builds and phase 1.  Phases 3-8 and 11 also fail if
per-query isolation skipped a query or a text's md5 differs from the
one the phase has given since it was added.  Prints
the card, per-kernel times, map throughput and stage seconds, a
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Exits
non-zero, with no result, on any failure or without a CUDA device.
Everything is made from fixed numpy seeds; scratch files go to
smoke_work/ (removed at the end), map text to smoke_out/.

    python3 chip_smoke.py --slab-timing [--package-root DIR]
    python3 chip_smoke.py --tron-timing [--package-root DIR]
    python3 chip_smoke.py --walk-timing [--package-root DIR]
    python3 chip_smoke.py --probe-timing [--package-root DIR]
    python3 chip_smoke.py --emission-timing [--package-root DIR]

run phase 1's timing buckets alone, or K7 on phase 1's tron batch and
on one problem of 11 slabs at W = 23,808 (the rule's geometry and, where
the package takes a forced one, the sweep of k and CTAs per problem) and
on each batch of phase 8's map and -y l3 map (summed), of
the package under DIR (an unpacked checkout of another commit; its
tables from $ALN_TAB), and print one JSON line: two commits timed in
turns on one card.  --walk-timing times the two traceback walks alone
(walk_timing: K3 and its strips on phase 1's buckets, K3 at tetrapod
width, K8 on phase 1's tron batch and phase 8's launches), and K2e,
the fused K2e + K3 beside K2e then K3, and the launch
floor (probe_k0) at phase 1's bucket, tetrapod width, a traced search
hit and a search score batch (ends_timing).
--probe-timing builds the probes, the skeletons,
the production slab library and its knock-out builds (-DSLAB_ABLATE
0-17, nvcc all at once), holds every probe body against its plain
version at all four thread counts, runs the probes' sweep at 128, 256,
512 and 1024 threads three times over, then spliced_slab_score in each
knock-out build on the bench batch of scripts/ablate_pallas.py (the
"none" build and each forced k = 1, 2, 4 equal to the production
kernel), each build on bisect_mosaic's batch, and each skeleton level
at 7, 14 and 28 chunks; it reports each probe instance's and each
build's score-mode instances' SASS instructions (cuobjdump) and
registers and spills (ptxas), writes the probes' SASS to smoke_out/,
and prints one JSON line.  --emission-timing builds the production
slab library and its timing build of the local emission's
store-and-scan form (-DSLAB_EMIT_ROWS=1) together, holds the two forms
equal on a batch of search_protein_local (B=64, L=64) and times K1 with
each beside K6 off on the same shape, in turns, three times over.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "smoke_work"
OUT = ROOT / "smoke_out"
SEED = 20261016

REPLACES = {
    "spliced_slab_trace": "spaln_tpu/ops/dp_spliced_pallas.py:195",
    "spliced_slab_trace_dagp": "spaln_tpu/ops/dp_spliced_pallas.py:195",
    "spliced_slab_retrace": "spaln_tpu/ops/dp_spliced_scan.py:592",
    "spliced_slab_retrace_dagp": "spaln_tpu/ops/dp_spliced_scan.py:592",
    "spliced_slab_retrace_pairs": "spaln_tpu/ops/dp_spliced_scan.py:592",
    "spliced_slab_retrace_pairs_dagp":
        "spaln_tpu/ops/dp_spliced_scan.py:592",
    "spliced_slab_links": "spaln_tpu/ops/dp_spliced_pallas.py:195",
    "spliced_slab_links_dagp": "spaln_tpu/ops/dp_spliced_scan.py:592",
    "spliced_slab_score": "spaln_tpu/ops/dp_spliced_pallas.py:195",
    "spliced_last_ends": "spaln_tpu/ops/dp_spliced_pallas.py:1122",
    "spliced_tb_walk": "spaln_tpu/ops/dp_spliced_scan.py:1127",
    "spliced_tb_strips": "spaln_tpu/ops/dp_spliced_scan.py:1235",
    "spliced_ends_tb_walk": "spaln_tpu/ops/dp_spliced_pallas.py:1075",
    "tron_forward": "spaln_tpu/ops/dp_tron_scan.py:116",
    "tron_forward_dagp": "spaln_tpu/ops/dp_tron_scan.py:116",
    "tron_walk": "spaln_tpu/ops/dp_tron_scan.py:1113",
}

# Least time the card could take: H100 SXM HBM3 at 3.35 TB/s; int32 at
# 16.7 Top/s = the H100 SXM's 67 TFLOP/s of float32 (128 lanes per SM,
# a fused multiply-add counted as 2) over 4: 64 int32 lanes per SM, one
# operation each per clock.  The DP's integer operations per band cell,
# counted from the kernels' source: the recurrence with neighbour reads
# and the masked commit, its link selects (K4), an acceptor close over 4
# candidates into 3 states, a donor push.  Double-affine gaps add per
# cell F2 (open, extend, max: 7, ring read, mask, write, commit: 4) and
# E2 (open, extend, max: 7, psp rule: 6, commit: 1), 4 link selects and
# 2 ring moves, and two more states to the acceptor close and donor push
# (per state 70/3 and 12 operations).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
OPS_CELL, OPS_LINKS, OPS_ACC, OPS_DON, OPS_WALK = 30, 15, 70, 36, 30
OPS_CELL_DAGP, OPS_LINKS_DAGP, OPS_ACC_DAGP, OPS_DON_DAGP = 55, 21, 117, 60


def log(msg: str) -> None:
    print(msg, flush=True)


def _seq(rng, n: int, gc: float) -> str:
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    return "".join(np.array(list("ACGT"))[rng.choice(4, n, p=p)])


def _intron(rng, n: int) -> str:
    return "GT" + _seq(rng, n - 4, 0.12) + "AG"


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _mutate(rng, s: str, rate: float) -> str:
    a = np.array(list(s))
    hit = np.flatnonzero(rng.random(len(a)) < rate)
    for i in hit:
        a[i] = "ACGT"[("ACGT".index(a[i]) + int(rng.integers(1, 4))) % 4]
    return "".join(a)


def _md5(path: Path) -> str:
    return hashlib.md5(path.read_bytes()).hexdigest()


# md5 (or its first 8 hex digits) of each deployment's text since its
# phase was added; the dictdisc map's equals spaln_tpu's CPU run
TEXT_MD5 = {"dictdisc map": "0ea2caf5ae1dcc3a7ddbe77efb9bf55c",
            "tetrapod map": "2ff07584", "map -yl3": "d1d7735f",
            "search": "efc6189b", "pair": "5c28654d",
            "protein map": "7e5cc997", "protein map -yl3": "80341a27",
            "map -L S": "c9a8ba0a", "map -L S -A 3 -y l3": "76dd3237",
            "map junctions -y l3": "bdf579cb",
            "map junctions -A 3": "bdf579cb"}


def _check_md5(label: str, path: Path) -> str:
    md5 = _md5(path)
    if not md5.startswith(TEXT_MD5[label]):
        raise AssertionError(f"{label}: text md5 {md5}, expected "
                             f"{TEXT_MD5[label]}")
    return md5


def _timed(fn, reps: int) -> float:
    """Milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) from the bytes and int32 operations the work
    needs on this run's inputs."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _dp_cells(bp, slabs):
    """(band cells, acceptor cells, donor cells) of the given slabs of a
    bucket, counted from this run's operands: the cells that hold a
    result (the kernels' ``active`` mask: inside the band and the matrix;
    the other lane-steps write flag 255 and are never read), and those of
    them at an acceptor or donor site, where the signal branches run."""
    B, L, T, Np = bp.B, bp.L, bp.T, bp.Nmax + 1
    dev = bp.device
    lanes = torch.arange(L, device=dev)
    tt = torch.arange(T, device=dev)[:, None, None]
    lw = bp.lws_t.long()[None, :, None]
    M = bp.Ms_t.long()[None, :, None]
    N = bp.Ns_t.long()[None, :, None]
    g = bp.gops.permute(0, 2, 1)                      # (B, Np, 6)
    bi = torch.arange(B, device=dev)[None, :, None]
    cells = acc = don = 0
    for s in slabs:
        m0 = s * L + 1
        n = (m0 + 1 + tt) + lw - lanes
        ro = tt - 2 * lanes
        act = ((ro >= 0) & (ro < bp.W) & (n >= 1) & (n <= N)
               & (m0 + lanes <= M))
        cells += int(act.sum())
        act &= n < N                       # sites are read below N only
        gi = g[bi, n.clamp(0, Np - 1)]
        acc += int((act & (gi[..., 2] != 0)).sum())
        don += int((act & (gi[..., 1] != 0)).sum())
    return cells, acc, don


def _operand_bytes(bp) -> int:
    B, A = bp.B, bp.qprof.shape[2]
    Np = bp.Nmax + 1
    return 4 * B * (bp.Mpad * A + Np * (6 + 16) + 3) + 4 * Np


@contextlib.contextmanager
def kernel_clock(K, retraces: list | None = None, each: dict | None = None,
                 pairs: list | None = None):
    """Time every C entry's launches with CUDA events while the block
    runs; yields a dict name -> device ms, filled on exit.  Appends each
    retrace launch's (problems, slabs, k, CTAs per problem) to
    ``retraces`` (a retrace of pairs: (pairs, 1, k, CTAs per pair)), each
    retrace of pairs' (entry, pairs, L, A) to ``pairs``, and fills
    ``each`` with name -> each launch's ms."""
    events = {k: [] for k in K.KERNELS}
    orig = K._launch

    def timed(name, device, *args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        orig(name, device, *args, **kw)
        e1.record()
        events[name].append((e0, e1))
        if name.startswith("spliced_slab_retrace_pairs"):
            if retraces is not None:
                retraces.append((args[9], 1, args[12], args[14]))
            if pairs is not None:
                pairs.append((name, args[9], args[10], args[11]))
        elif retraces is not None and name.startswith("spliced_slab_retrace"):
            retraces.append((args[8], args[12], args[13], args[15]))

    out: dict = {}
    K._launch = timed
    try:
        yield out
    finally:
        K._launch = orig
        torch.cuda.synchronize()
        for k, ev in events.items():
            out[k] = sum(a.elapsed_time(b) for a, b in ev)
            if each is not None:
                each[k] = [a.elapsed_time(b) for a, b in ev]


def _retrace_shapes(retraces: list) -> str:
    """'count x (problems, slabs, k, CTAs)' of a phase's retrace launches."""
    c = {}
    for r in retraces:
        c[r] = c.get(r, 0) + 1
    return ", ".join(f"{n} x {r}" for r, n in sorted(c.items()))


def _ms_launches(K, kms: dict) -> str:
    """name -> [summed device ms, launches] of the entries a phase ran
    (the counts are reset at the phase's start)."""
    return json.dumps({k: [round(v, 3), K.launches[k]] for k, v in
                       kms.items() if v or K.launches[k]})


def _reset_counts(K) -> None:
    for k in K.KERNELS:
        K.launches[k] = 0
        K.plain_calls[k] = 0


@contextlib.contextmanager
def plain_on_card(K):
    """Test hook: route the kernel calls of run_bucket (the plane path)
    and of the UDH path to the plain PyTorch versions, on the same CUDA
    tensors."""
    from spaln_tpu_torch.ops import dp_spliced_udh as U

    def spliced_slab_trace(bp, prm):
        return K.slab_trace_plain(bp, prm)

    def spliced_ends_tb_walk(bp, prm, fl, spj, row, rc, ends=None,
                             out=None, stats=None):
        se, recs = K.ends_tb_walk_plain(bp, prm, fl, spj, row, rc)
        if stats is not None:
            stats.copy_(K.walk_stats(recs, fl, bp.lws_t))
        return se, recs

    def spliced_slab_links(bp, prm):
        return K.slab_links_plain(bp, prm)

    def spliced_last_ends(bp, prm, row, rc):
        return K.last_ends_plain(bp, prm, row, rc)

    def spliced_slab_retrace(bp, prm, s0, nslab, snap, sel):
        return K.slab_retrace_plain(bp, prm, s0, nslab, snap, sel)

    def spliced_slab_retrace_pairs(bp, prm, slabs, snap, sel):
        return K.slab_retrace_pairs_plain(bp, prm, slabs, snap, sel)

    def spliced_tb_strips(fl, spj, starts, lws, s0, IT):
        return K.tb_strips_plain(fl, spj, starts, lws, s0, IT)

    hooks = [(K, spliced_slab_trace), (K, spliced_ends_tb_walk),
             (U, spliced_slab_links), (U, spliced_last_ends),
             (U, spliced_slab_retrace), (U, spliced_slab_retrace_pairs),
             (U, spliced_tb_strips)]
    saved = [(m, fn.__name__, getattr(m, fn.__name__)) for m, fn in hooks]
    for m, fn in hooks:
        setattr(m, fn.__name__, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


# --------------------------------------------------------------- phase 1
WALK_KEYS = ("steps", "ns_per_step", "tile_loads", "tile_loads_max")


def _walk_keys(stats: torch.Tensor) -> dict:
    """A walk launch's row keys from its kernel's (steps, tile loads) per
    walk: the longest walk's serial steps, the tile loads a walk (mean
    and most)."""
    stats = stats.cpu()
    return dict(steps=int(stats[:, 0].max()),
                tile_loads=float(stats[:, 1].float().mean()),
                tile_loads_max=int(stats[:, 1].max()))


def _walk_check(K, label: str, recs, stats, *model) -> dict:
    """K3's steps and tile loads (its ``stats``) equal to the model's
    (walk_stats, given ``model``, its arguments after the records) on the
    same records; returns _walk_keys."""
    want = K.walk_stats(recs, *model)
    if not torch.equal(stats.cpu(), want):
        raise AssertionError(f"{label}: steps and tile loads "
                             f"{stats.cpu().tolist()} differ from the "
                             f"model's {want.tolist()}")
    return _walk_keys(stats)


def _launch_ms(M, fn, reps: int) -> float:
    """Device ms of the C entries that fn reaches through the wrapper
    module M (one launch, or several in order), from a cold L2 (as after
    the forward's gigabytes of planes): the entries' arguments caught on
    a first call (and every tensor they point into kept), then reps
    times a 128 MB buffer zeroed (the L2 is 50 MB) and the entries
    called between CUDA events, queued while the card still zeroes, so
    that no host work lies between the events."""
    import ctypes
    seen, keep = [], []
    launch, ptr = M._launch, M._ptr

    def catch_ptr(t):
        keep.append(t)
        return ptr(t)

    def catch(name, device, *args, **kw):
        seen.append((name, args))
        return launch(name, device, *args, **kw)
    M._launch, M._ptr = catch, catch_ptr
    try:
        fn()
    finally:
        M._launch, M._ptr = launch, ptr
    calls = [(getattr(M._library(), name), args) for name, args in seen]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    events = []
    for _ in range(reps):
        flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for entry, args in calls:
            entry(*args, stream)
        t1.record()
        events.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def _timed_walk(row: dict, fn, reps: int, M) -> dict:
    """Time a walk launch into its row: ms, the kernel's device time a
    launch (_launch_ms, M its wrapper module), ns a serial step from it,
    and call_ms, CUDA events around the wrapper's call (its host work
    included, as the walks' times of earlier PRs were taken)."""
    row["ms"] = _launch_ms(M, fn, reps)
    row["call_ms"] = _timed(fn, reps)
    row["ns_per_step"] = row["ms"] * 1e6 / max(row["steps"], 1)
    return row


def _walk_log(name: str, r: dict) -> str:
    return (f"{name}: {r['ms']:.4f} ms on the card ({r['call_ms']:.4f} ms "
            f"a wrapper call), {r['steps']} serial steps = "
            f"{r['ns_per_step']:.1f} ns a step, {r['tile_loads']:.2f} tile "
            f"loads a walk (most {r['tile_loads_max']})")


def _ends_checks(K, bp, prm, k1, label: str, walk_kinds,
                 timed: bool = True) -> dict:
    """K2e on K1's (row, rc) and on every tie kind, and the fused K2e + K3
    (spliced_ends_tb_walk) on K1's rows and on the tie kinds
    ``walk_kinds``, against their plain versions, the fused one's walk
    stats against walk_stats: all exact.  With ``timed``, returns the
    fused entry's row on K1's rows: device ms a launch (_launch_ms), ms a
    wrapper call (call_ms), plain ms and the walk's keys."""
    flags, spj, row, rc = k1
    for kind in ("K1", *TIE_KINDS):
        r, c = ((row, rc) if kind == "K1"
                else tie_rows(kind, bp, row, rc, SEED))
        want = K.last_ends_plain(bp, prm, r, c)
        _equal(f"spliced_last_ends ({label}, {kind})",
               [K.spliced_last_ends(bp, prm, r, c)], [want])
        if kind != "K1" and kind not in walk_kinds:
            continue
        st = torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
        se, recs = K.spliced_ends_tb_walk(bp, prm, flags, spj, r, c,
                                          stats=st)
        _equal(f"spliced_ends_tb_walk ({label}, {kind})", [se, recs],
               [want, K.tb_walk_plain(bp, flags, spj, want)])
        keys = _walk_check(K, f"spliced_ends_tb_walk ({label}, {kind})",
                           recs, st, flags, bp.lws_t)
        if kind == "K1":
            walk_keys = keys
    log(f"{label} (B={bp.B} Nmax={bp.Nmax} Mpad={bp.Mpad}): K2e exact on "
        f"K1's rows and {len(TIE_KINDS)} tie kinds, the fused K2e + K3 on "
        f"K1's rows and {len(walk_kinds)} tie kinds (walk stats as the "
        f"model's)")
    if not timed:
        return {}
    fused = _timed_walk(dict(
        max_abs_err=0,
        plain_ms=_timed(lambda: K.ends_tb_walk_plain(bp, prm, flags, spj,
                                                     row, rc), 2),
        **walk_keys),
        lambda: K.spliced_ends_tb_walk(bp, prm, flags, spj, row, rc), 20, K)
    log(_walk_log(f"{label}: spliced_ends_tb_walk", fused))
    return {"spliced_ends_tb_walk": fused}


def _score_ends(K, dp) -> dict:
    """K2e's row at the shape that launches it on the main path: a score
    batch of phase 7's search at its largest (B=64, _protein_batch), its
    (row, rc) from K5 and on every tie kind, against the plain version;
    device ms a launch (_launch_ms), ms a wrapper call, plain ms, and
    the bound from the cells this batch's segments hold."""
    bp, prm = _protein_batch(dp)
    row, rc = K.spliced_slab_score(bp, prm)
    for kind in ("K5", *TIE_KINDS):
        r, c = ((row, rc) if kind == "K5"
                else tie_rows(kind, bp, row, rc, SEED))
        _equal(f"spliced_last_ends (score batch, {kind})",
               [K.spliced_last_ends(bp, prm, r, c)],
               [K.last_ends_plain(bp, prm, r, c)])
    fn = lambda: K.spliced_last_ends(bp, prm, row, rc)
    _launch_ms(K, fn, 20)         # a shape's first timing reads 1-3 us high
    cells = _ends_cells(bp)
    r = dict(max_abs_err=0, ms=_launch_ms(K, fn, 20), call_ms=_timed(fn, 20),
             plain_ms=_timed(lambda: K.last_ends_plain(bp, prm, row, rc), 5),
             work=(4 * cells + 24 * bp.B, 2 * cells))
    r["bound_ms"], r["bound_by"] = _bound(*r["work"])
    log(f"kernel spliced_last_ends: exact (max_abs_err 0) on a score batch "
        f"(B={bp.B} Nmax={bp.Nmax} Mpad={bp.Mpad}) and {len(TIE_KINDS)} tie "
        f"kinds; {r['ms']:.4f} ms on the card, {r['call_ms']:.4f} ms a "
        f"wrapper call, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.7f} ms by {r['bound_by']} ({r['work'][0]} bytes, "
        f"{r['work'][1]} int32 ops: {cells} cells of row and rc read)")
    return r


def _ends_cells(bp) -> int:
    """The row and rc cells K2e reads in the bucket ``bp``: each problem's
    final-row segment (under a_exgr), right-column segment (under
    b_exgr) and H(M, N)."""
    fl = bp.flags
    return sum(fl.a_exgr * max(rh - rl, 0) + fl.b_exgr * max(ch - cl, 0) + 1
               for (rl, rh), (cl, ch) in _segments(bp))


# K2e's tie-heavy inputs: each problem's final-row segment [max(M + lw,
# 0, 1), N) and right-column segment [max(N - up, 1), M) filled so that
# the first maximum, the groups' order and the empty segment decide
TIE_KINDS = ("flat", "repeat", "at_lo", "at_hi", "across_warps", "nev",
             "row_col_tie")
NEV = -939524096


def _segments(bp) -> list:
    """Per problem ((row lo, hi), (rc lo, hi)) of K2e's two segments."""
    out = []
    for M, N, lw in zip(bp.Ms, bp.Ns, bp.lws):
        up = lw + bp.W - 1
        out.append(((max(M + lw, 0, 1), N), (max(N - up, 1), M)))
    return out


def tie_rows(kind: str, bp, row: torch.Tensor, rc: torch.Tensor,
             seed: int = 0) -> tuple:
    """(row, rc) of the bucket ``bp`` with tie-heavy values, on their
    device: ``flat`` every value 5 and H(M, N) 0 (the row segment's first
    index wins, the column ties it and loses); ``repeat`` values 0-2 and
    H(M, N) -1 (the maximum repeated in every warp's share); ``at_lo``
    flat with a row maximum at the segment's first index and a greater
    column one there; ``at_hi`` both at the last index, the row's
    greater; ``across_warps`` values 0-2 with a maximum three times, 131
    cells apart, in both segments (a tie the row wins); ``nev`` NEV
    everywhere; ``row_col_tie`` values 0-100 with 200 at a random index
    of each segment."""
    rng = np.random.default_rng(seed)
    r = row.cpu().numpy().copy()
    c = rc.cpu().numpy().copy()
    if kind == "flat":
        r[:], c[:] = 5, 5
    elif kind in ("repeat", "across_warps"):
        r[:] = rng.integers(0, 3, r.shape)
        c[:] = rng.integers(0, 3, c.shape)
    elif kind in ("at_lo", "at_hi"):
        r[:], c[:] = 5, 5
    elif kind == "nev":
        r[:], c[:] = NEV, NEV
    elif kind == "row_col_tie":
        r[:] = rng.integers(0, 101, r.shape)
        c[:] = rng.integers(0, 101, c.shape)
    else:
        raise ValueError(f"tie kind {kind!r}")
    for b, ((rlo, rhi), (clo, chi)) in enumerate(_segments(bp)):
        if kind in ("flat", "repeat"):
            r[b, bp.Ns[b]] = 0 if kind == "flat" else -1
        for a, lo, hi, top in ((r, rlo, rhi, 10), (c, clo, chi, 9)):
            if hi <= lo:
                continue
            if kind == "at_lo":
                a[b, lo] = 19 - top
            elif kind == "at_hi":
                a[b, hi - 1] = top
            elif kind == "across_warps":
                a[b, lo + 7:hi:131] = 50
            elif kind == "row_col_tie":
                a[b, int(rng.integers(lo, hi))] = 200
    return (torch.from_numpy(r).to(row.device),
            torch.from_numpy(c).to(rc.device))


def _phase1_bucket(dp, ctx):
    """Phase 1's bucket: B=8 planted 2-3 exon genes (exons of 60-85 nt,
    introns of 70-300 nt) at main-path shapes, L=128, W=1,152: 2 slabs."""
    from spaln_tpu_torch.score.splice import build_splice_signals
    from spaln_tpu_torch.seq.codec import encode_dna
    rng = np.random.default_rng(SEED)
    queries, genomes, sigs, lws = [], [], [], []
    for i in range(8):
        ex = [_seq(rng, int(rng.integers(60, 86)), 0.3)
              for _ in range(2 + i % 2)]
        g = _seq(rng, 100, 0.22)
        for j, e in enumerate(ex):
            g += e
            if j < len(ex) - 1:
                g += _intron(rng, int(rng.integers(70, 300)))
        g += _seq(rng, 120, 0.22)
        q = _mutate(rng, "".join(ex), 0.01)
        gc = encode_dna(g)
        queries.append(encode_dna(q))
        genomes.append(gc)
        sigs.append(build_splice_signals(gc, ctx.cfg, ctx.tables))
        lws.append(-150 - 7 * i)
    bp = dp.prepare_spliced_batch(queries, genomes, ctx.prm, sigs=sigs,
                                  lws=lws, W=1152, L=128, device="cuda")
    if (bp.S, bp.B, bp.L) != (2, 8, 128):
        raise AssertionError(f"kernel bucket geometry {bp.S, bp.B, bp.L}")
    return bp


def check_kernels(K, dp, ctx):
    """Each kernel against its plain version at main-path shapes; the
    walks' steps and tile loads against the model's."""
    bp = _phase1_bucket(dp, ctx)
    prm = ctx.prm
    out = {}
    k1 = K.spliced_slab_trace(bp, prm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1 = K.slab_trace_plain(bp, prm)
    torch.cuda.synchronize()
    plain1 = (time.perf_counter() - t0) * 1e3
    err = max(_max_abs_err(a, b) for a, b in zip(k1, p1))
    if err:
        raise AssertionError(f"spliced_slab_trace differs from plain: {err}")
    if not (k1[1] > 0).any():
        raise AssertionError("no intron closed in the kernel bucket")
    out["spliced_slab_trace"] = dict(
        max_abs_err=err, plain_ms=plain1,
        ms=_timed(lambda: K.spliced_slab_trace(bp, prm), 5))
    flags, spj, row, rc = k1
    out.update(_ends_checks(K, bp, prm, k1, "phase 1", TIE_KINDS))
    out["spliced_last_ends"] = _score_ends(K, dp)
    e_k = K.spliced_last_ends(bp, prm, row, rc)
    st = torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
    r_k = K.spliced_tb_walk(bp, flags, spj, e_k, stats=st)
    r_p = K.tb_walk_plain(bp, flags, spj, e_k)
    err = _max_abs_err(r_k, r_p)
    if err:
        raise AssertionError(f"spliced_tb_walk differs from plain: {err}")
    ops = dp.ops_from_records(r_k.cpu().numpy(), bp.B)
    if not all(any(o[0] == "I" for o in x) for x in ops):
        raise AssertionError("a planted intron was not recovered")
    out["spliced_tb_walk"] = _timed_walk(dict(
        max_abs_err=err,
        plain_ms=_timed(lambda: K.tb_walk_plain(bp, flags, spj, e_k), 2),
        **_walk_check(K, "spliced_tb_walk", r_k, st, flags, bp.lws_t)),
        lambda: K.spliced_tb_walk(bp, flags, spj, e_k), 20,
        K)
    # ---- K4, the links forward, against its plain version
    k4 = K.spliced_slab_links(bp, prm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p4 = K.slab_links_plain(bp, prm)
    torch.cuda.synchronize()
    plain4 = (time.perf_counter() - t0) * 1e3
    err = max(_max_abs_err(a, b) for a, b in zip(k4, p4))
    if err:
        raise AssertionError(f"spliced_slab_links differs from plain: {err}")
    if _max_abs_err(k4[2], row) or _max_abs_err(k4[3], rc):
        raise AssertionError("K4's row / right column differ from K1's")
    out["spliced_slab_links"] = dict(
        max_abs_err=err, plain_ms=plain4,
        ms=_timed(lambda: K.spliced_slab_links(bp, prm), 5))
    # ---- K1 retrace of slab 1 from K4's snapshot, against K1's planes
    sel = torch.arange(bp.B, dtype=torch.int32, device="cuda")
    snap = k4[1][1].contiguous()
    r1 = K.spliced_slab_retrace(bp, prm, 1, 1, snap, sel)
    err = max(_max_abs_err(r1[0], flags[1:2]), _max_abs_err(r1[1], spj[1:2]))
    if err:
        raise AssertionError(f"retrace of slab 1 differs from K1's planes: "
                             f"{err}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1r = K.slab_retrace_plain(bp, prm, 1, 1, snap, sel)
    torch.cuda.synchronize()
    plain1r = (time.perf_counter() - t0) * 1e3
    err = max(_max_abs_err(a, b) for a, b in zip(r1, p1r))
    if err:
        raise AssertionError(f"spliced_slab_retrace differs from plain: "
                             f"{err}")
    out["spliced_slab_retrace"] = dict(
        max_abs_err=err, plain_ms=plain1r,
        ms=_timed(lambda: K.spliced_slab_retrace(bp, prm, 1, 1, snap, sel),
                  5))
    # ---- K3 strip mode: slab 1's strips from the end cells, against its
    # plain version and against the full walk's ops below the boundary
    L = bp.L
    starts = _end_strips(e_k, L)
    IT = dp.strip_walk_bound(L, bp.W)
    sst = torch.empty((starts.shape[0], 2), dtype=torch.int32,
                      device="cuda")
    rs_k = K.spliced_tb_strips(r1[0], r1[1], starts, bp.lws_t, 1, IT,
                               stats=sst)
    rs_p = K.tb_strips_plain(r1[0], r1[1], starts, bp.lws_t, 1, IT)
    err = _max_abs_err(rs_k, rs_p)
    if err:
        raise AssertionError(f"spliced_tb_strips differs from plain: {err}")
    strips = dp.ops_from_records(rs_k.cpu().numpy(), bp.B)
    if strips != [[o for o in x if o[1] > L] for x in ops]:
        raise AssertionError("strip walks differ from the full walk")
    if sum(map(len, strips)) == 0:
        raise AssertionError("no strip walked in slab 1")
    out["spliced_tb_strips"] = _timed_walk(dict(
        max_abs_err=err,
        plain_ms=_timed(lambda: K.tb_strips_plain(r1[0], r1[1], starts,
                                                  bp.lws_t, 1, IT), 2),
        **_walk_check(K, "spliced_tb_strips", rs_k, sst,
                      *_strip_model(r1[0], bp.lws_t, starts, 1))),
        lambda: K.spliced_tb_strips(r1[0], r1[1], starts, bp.lws_t, 1, IT),
        20, K)
    # ---- bounds from this run's inputs
    B, S, T, A = bp.B, bp.S, bp.T, bp.qprof.shape[2]
    Np = bp.Nmax + 1
    cells, acc, don = _dp_cells(bp, range(S))
    ops_dp = cells * OPS_CELL + acc * OPS_ACC + don * OPS_DON
    rowrc = 4 * B * (Np + bp.Mpad + 1)
    ends_cells = _ends_cells(bp)
    c1, a1, d1 = _dp_cells(bp, [1])
    steps = int((r_k[:, :, 1] != 0).sum())
    steps_s = int((rs_k[:, :, 1] != 0).sum())
    work = {
        "spliced_slab_trace": (_operand_bytes(bp) + 13 * cells + rowrc,
                               ops_dp),
        "spliced_slab_links": (_operand_bytes(bp) + rowrc
                               + 4 * S * B * (4 * T + 2 * (T + 2)),
                               ops_dp + cells * OPS_LINKS),
        "spliced_slab_retrace": (4 * B * (L * A + (T + L) * 22
                                          + 2 * (T + 2)) + 13 * c1,
                                 c1 * OPS_CELL + a1 * OPS_ACC
                                 + d1 * OPS_DON),
        "spliced_tb_walk": (25 * steps, OPS_WALK * steps),
        "spliced_ends_tb_walk": (4 * ends_cells + 24 * B + 25 * steps,
                                 2 * ends_cells + OPS_WALK * steps),
        "spliced_tb_strips": (25 * steps_s, OPS_WALK * steps_s),
    }
    for name, (nb, no) in work.items():
        out[name]["bound_ms"], out[name]["bound_by"] = _bound(nb, no)
        out[name]["work"] = (nb, no)
    for name, r in out.items():
        if name == "spliced_last_ends":
            continue                            # logged at its own shape
        log(f"kernel {name}: exact (max_abs_err {r['max_abs_err']}); "
            f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.7f} ms by {r['bound_by']} ({r['work'][0]} "
            f"bytes, {r['work'][1]} int32 ops) "
            f"(B=8 L=128 W=1152 S=2 T={T}: {cells} band cells of "
            f"{S * T * B * L} lane-steps, {acc} acceptor and {don} donor "
            f"cells; slab 1: {c1} band cells)")
    for name in ("spliced_tb_walk", "spliced_tb_strips",
                 "spliced_ends_tb_walk"):
        log(_walk_log(f"kernel {name}", out[name]))
    return out


def _end_strips(ends, L):
    """Strip starts (m, n, state, m_stop, problem) of slab 1 from each
    problem's end cell (no walk where the end lies above the slab)."""
    return torch.tensor([[int(e[1]), int(e[2]), 0, L, b] if e[1] > L
                         else [0, 0, 0, L, b]
                         for b, e in enumerate(ends.cpu().numpy())],
                        dtype=torch.int32, device="cuda")


def _indel_bucket(dp, ctx):
    """Phase 1's bucket shape (B=8, L=128, W=1152, 2 slabs) with planted
    introns, and in every gene a 30-90 nt indel inside an exon: genome
    only (a long horizontal gap) in even problems, cDNA only (a long
    vertical gap) in odd ones.  The indel is A/C only, so it holds no
    GT..AG and stays a gap."""
    from spaln_tpu_torch.score.splice import build_splice_signals
    from spaln_tpu_torch.seq.codec import encode_dna
    rng = np.random.default_rng(SEED + 5)
    queries, genomes, sigs, lws = [], [], [], []
    for i in range(8):
        ins = i % 2 == 1
        ex = [_seq(rng, int(rng.integers(60, 81)), 0.3)
              for _ in range(2 if ins else 3)]
        extra = "".join(np.array(list("AC"))[
            rng.integers(0, 2, int(rng.integers(30, 91)))])
        k = len(ex) // 2
        mid = len(ex[k]) // 2
        with_indel = ex[k][:mid] + extra + ex[k][mid:]
        g_ex, q_ex = list(ex), list(ex)
        (q_ex if ins else g_ex)[k] = with_indel
        g = _seq(rng, 100, 0.22)
        for j, e in enumerate(g_ex):
            g += e
            if j < len(g_ex) - 1:
                g += _intron(rng, int(rng.integers(70, 300)))
        g += _seq(rng, 120, 0.22)
        gc = encode_dna(g)
        queries.append(encode_dna(_mutate(rng, "".join(q_ex), 0.01)))
        genomes.append(gc)
        sigs.append(build_splice_signals(gc, ctx.cfg, ctx.tables))
        lws.append(-150 - 7 * i)
    bp = dp.prepare_spliced_batch(queries, genomes, ctx.prm, sigs=sigs,
                                  lws=lws, W=1152, L=128, device="cuda")
    if (bp.S, bp.B, bp.L) != (2, 8, 128):
        raise AssertionError(f"dagp bucket geometry {bp.S, bp.B, bp.L}")
    return bp


# residue frequencies of Robinson & Robinson (1991), the background of
# the synthetic protein DB, in the order of AMINO
AMINO = "ARNDCQEGHILKMFPSTWYV"
AA_FREQ = np.array([7.805, 5.129, 4.487, 5.364, 1.925, 4.264, 6.295, 7.377,
                    2.199, 5.142, 9.019, 5.744, 2.243, 3.856, 5.203, 7.120,
                    5.841, 1.330, 3.216, 6.441])
AA_FREQ = AA_FREQ / AA_FREQ.sum()


def _protein_lengths(rng, n: int) -> np.ndarray:
    """Entry lengths: log-normal, median 375 aa, clipped to 50-3,000."""
    x = np.exp(rng.normal(np.log(375), 0.5, n))
    return np.clip(np.round(x), 50, 3000).astype(np.int64)


def _protein(rng, n: int) -> str:
    return "".join(np.array(list(AMINO))[rng.choice(20, n, p=AA_FREQ)])


def _protein_batch(dp, traced: bool = False, local: bool = False,
                   L: int = 128):
    """A candidate batch of the search's score pass at its largest: one
    query against 64 DB entries, full band (lw = -Mmax, up = Nmax),
    L = 128, the protein matrix's alphabet and the parameters
    search_protein_db builds; with ``traced``, the traced hit: the
    query against its source alone (B = 1); with ``local`` and L = 64,
    a batch of search_protein_local (K1 in local mode, K6)."""
    from spaln_tpu_torch.config import Config, PvsP, resolve
    from spaln_tpu_torch.ops.params import DpFlags, DpParams
    from spaln_tpu_torch.score.simmtx import Simmtx
    from spaln_tpu_torch.score.tables import find_table_dir
    from spaln_tpu_torch.seq.codec import encode_protein
    rng = np.random.default_rng(SEED + 7)
    lens = _protein_lengths(rng, 64)
    db = [_protein(rng, int(n)) for n in lens]
    # the query: a copy of the entry nearest the median length
    src = int(np.argmin(abs(lens - 375)))
    query = _mutate_protein(rng, db[src], 0.2)
    prm = DpParams.build(resolve(Config(), PvsP),
                         Simmtx.protein(find_table_dir(), slot=0), PvsP)
    if traced:
        db = [db[src]]
    bp = dp.prepare_spliced_batch([encode_protein(query)] * len(db),
                                  [encode_protein(s) for s in db], prm,
                                  flags=DpFlags(local=local), L=L,
                                  device="cuda")
    return bp, prm


def _mutate_protein(rng, s: str, rate: float, n_indels: int = 0) -> str:
    """Substitutions at ``rate`` (background residues) and ``n_indels``
    insertions or deletions of 1-10 residues at random places."""
    a = np.array(list(s))
    hit = rng.random(len(a)) < rate
    a[hit] = np.array(list(AMINO))[rng.choice(20, int(hit.sum()),
                                              p=AA_FREQ)]
    out = "".join(a)
    for _ in range(n_indels):
        k = int(rng.integers(1, 11))
        p = int(rng.integers(0, len(out)))
        if rng.random() < 0.5:
            out = out[:p] + out[p + k:]
        else:
            out = out[:p] + _protein(rng, k) + out[p:]
    return out


def _plain_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def _equal(name: str, got, want) -> int:
    """max_abs_err over paired outputs; raises unless 0."""
    err = max(_max_abs_err(a, b) for a, b in zip(got, want))
    if err:
        raise AssertionError(f"{name} differs from plain: {err}")
    return err


def check_k5_kernels(K, dp, ctx3):
    """The double-affine entries (K1, K4, K1 retrace, under ctx3's -yl3
    parameters) and the 5-state K3 walk and strip on an indel bucket,
    and the score-only entry on that bucket and on a protein batch, each
    against its plain version on the card."""
    bp = _indel_bucket(dp, ctx3)
    prm = ctx3.prm
    if not prm.dagp:
        raise AssertionError("-yl3 did not select double-affine gaps")
    out, walks = {}, {}
    k1 = K.spliced_slab_trace(bp, prm)
    p1, plain1 = _plain_ms(lambda: K.slab_trace_plain(bp, prm))
    out["spliced_slab_trace_dagp"] = dict(
        max_abs_err=_equal("spliced_slab_trace_dagp", k1, p1),
        plain_ms=plain1, ms=_timed(lambda: K.spliced_slab_trace(bp, prm), 5))
    flags, spj, row, rc = k1
    if spj.shape[1] != 5:
        raise AssertionError(f"dagp planes hold {spj.shape[1]} states")
    e_k = K.spliced_last_ends(bp, prm, row, rc)
    st = torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
    r_k = K.spliced_tb_walk(bp, flags, spj, e_k, stats=st)
    walks["walk"] = _equal("spliced_tb_walk (5 states)", [r_k],
                           [K.tb_walk_plain(bp, flags, spj, e_k)])
    walk5 = _timed_walk(_walk_check(K, "spliced_tb_walk (5 states)", r_k,
                                    st, flags, bp.lws_t),
                        lambda: K.spliced_tb_walk(bp, flags, spj, e_k), 20,
                        K)
    ops = dp.ops_from_records(r_k.cpu().numpy(), bp.B)
    if not all(any(o[0] == "I" for o in x) for x in ops):
        raise AssertionError("dagp bucket: a planted intron was not "
                             "recovered")
    # the winner state of every cell the walks passed through
    rec = r_k.cpu().numpy()
    fl_h = flags.cpu().numpy()
    L = bp.L
    won = set()
    for it, b in zip(*np.nonzero((rec[:, :, 1] >= 1) & (rec[:, :, 2] >= 1))):
        m, n = int(rec[it, b, 1]), int(rec[it, b, 2])
        s, i = (m - 1) // L, (m - 1) % L
        t = (n - m) - bp.lws[b] - 1 + 2 * i
        won.add(int(fl_h[s, t, b, i]) & 7)
    if not won & {3, 4}:
        raise AssertionError(f"no path cell won by E2 or F2: {sorted(won)}")
    k4 = K.spliced_slab_links(bp, prm)
    p4, plain4 = _plain_ms(lambda: K.slab_links_plain(bp, prm))
    out["spliced_slab_links_dagp"] = dict(
        max_abs_err=_equal("spliced_slab_links_dagp", k4, p4),
        plain_ms=plain4, ms=_timed(lambda: K.spliced_slab_links(bp, prm), 5))
    if k4[0].shape[1] != 5 or k4[1].shape[1] != 3:
        raise AssertionError("dagp links: expected 5 streams, 3 rows")
    if _max_abs_err(k4[2], row) or _max_abs_err(k4[3], rc):
        raise AssertionError("K4-dagp's row / right column differ from K1's")
    sel = torch.arange(bp.B, dtype=torch.int32, device="cuda")
    snap = k4[1][1].contiguous()
    r1 = K.spliced_slab_retrace(bp, prm, 1, 1, snap, sel)
    if _max_abs_err(r1[0], flags[1:2]) or _max_abs_err(r1[1], spj[1:2]):
        raise AssertionError("dagp retrace of slab 1 differs from K1-dagp's "
                             "planes")
    p1r, plain1r = _plain_ms(
        lambda: K.slab_retrace_plain(bp, prm, 1, 1, snap, sel))
    out["spliced_slab_retrace_dagp"] = dict(
        max_abs_err=_equal("spliced_slab_retrace_dagp", r1, p1r),
        plain_ms=plain1r,
        ms=_timed(lambda: K.spliced_slab_retrace(bp, prm, 1, 1, snap, sel),
                  5))
    starts = _end_strips(e_k, L)
    IT = dp.strip_walk_bound(L, bp.W)
    sst = torch.empty((starts.shape[0], 2), dtype=torch.int32,
                      device="cuda")
    rs_k = K.spliced_tb_strips(r1[0], r1[1], starts, bp.lws_t, 1, IT,
                               stats=sst)
    walks["strip"] = _equal(
        "spliced_tb_strips (5 states)", [rs_k],
        [K.tb_strips_plain(r1[0], r1[1], starts, bp.lws_t, 1, IT)])
    strip5 = _timed_walk(
        _walk_check(K, "spliced_tb_strips (5 states)", rs_k, sst,
                    *_strip_model(r1[0], bp.lws_t, starts, 1)),
        lambda: K.spliced_tb_strips(r1[0], r1[1], starts, bp.lws_t, 1, IT),
        20, K)
    strips = dp.ops_from_records(rs_k.cpu().numpy(), bp.B)
    if strips != [[o for o in x if o[1] > L] for x in ops]:
        raise AssertionError("dagp strip walks differ from the full walk")
    # ---- score-only: both gap models on this bucket, and the protein
    # batch; the row and right column equal K1's
    prm1 = dataclasses.replace(prm, dagp=False)
    for p, want in ((prm, (row, rc)),
                    (prm1, K.spliced_slab_trace(bp, prm1)[2:])):
        got = K.spliced_slab_score(bp, p)
        _equal(f"spliced_slab_score (dagp={p.dagp})", got,
               K.slab_score_plain(bp, p))
        _equal(f"spliced_slab_score vs K1 (dagp={p.dagp})", got, want)
    dagp_score_ms = _timed(lambda: K.spliced_slab_score(bp, prm), 5)
    pbp, pprm = _protein_batch(dp)
    ks = K.spliced_slab_score(pbp, pprm)
    ps, plain_s = _plain_ms(lambda: K.slab_score_plain(pbp, pprm))
    out["spliced_slab_score"] = dict(
        max_abs_err=_equal("spliced_slab_score (protein)", ks, ps),
        plain_ms=plain_s, ms=_timed(lambda: K.spliced_slab_score(pbp, pprm),
                                    5))
    # ---- bounds from this run's inputs
    B, S, T, A = bp.B, bp.S, bp.T, bp.qprof.shape[2]
    Np = bp.Nmax + 1
    cells, acc, don = _dp_cells(bp, range(S))
    ops_dp = (cells * OPS_CELL_DAGP + acc * OPS_ACC_DAGP
              + don * OPS_DON_DAGP)
    rowrc = 4 * B * (Np + bp.Mpad + 1)
    ends_cells = _ends_cells(bp)
    c1, a1, d1 = _dp_cells(bp, [1])
    pcells, _, _ = _dp_cells(pbp, range(pbp.S))
    prowrc = 4 * pbp.B * (pbp.Nmax + 1 + pbp.Mpad + 1)
    work = {
        "spliced_slab_trace_dagp": (_operand_bytes(bp) + 21 * cells + rowrc,
                                    ops_dp),
        "spliced_slab_links_dagp": (_operand_bytes(bp) + rowrc
                                    + 4 * S * B * (5 * T + 3 * (T + 2)),
                                    ops_dp + cells * (OPS_LINKS
                                                      + OPS_LINKS_DAGP)),
        "spliced_slab_retrace_dagp": (4 * B * (L * A + (T + L) * 22
                                               + 3 * (T + 2)) + 21 * c1,
                                      c1 * OPS_CELL_DAGP + a1 * OPS_ACC_DAGP
                                      + d1 * OPS_DON_DAGP),
        "spliced_slab_score": (_operand_bytes(pbp) + prowrc,
                               pcells * OPS_CELL),
    }
    for name, (nb, no) in work.items():
        out[name]["bound_ms"], out[name]["bound_by"] = _bound(nb, no)
        out[name]["work"] = (nb, no)
    for name, r in out.items():
        if name == "spliced_last_ends":
            continue                            # logged at its own shape
        log(f"kernel {name}: exact (max_abs_err {r['max_abs_err']}); "
            f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.7f} ms by {r['bound_by']} ({r['work'][0]} "
            f"bytes, {r['work'][1]} int32 ops)")
    log(f"dagp bucket (B=8 L=128 W=1152 S=2 T={T}): {cells} band cells, "
        f"{acc} acceptor and {don} donor cells; slab 1: {c1}; 5-state walk "
        f"and strip exact; path winners {sorted(won)}; score-only exact "
        f"in both gap models ({dagp_score_ms:.3f} ms double affine)")
    log(f"protein batch (B={pbp.B} L={pbp.L} W={pbp.W} S={pbp.S} "
        f"T={pbp.T} A={pbp.qprof.shape[2]}): {pcells} band cells")
    log(_walk_log("kernel spliced_tb_walk (5 states)", walk5))
    log(_walk_log("kernel spliced_tb_strips (5 states)", strip5))
    return out


def _cpu_bucket(bp):
    """The bucket with its operands on the CPU."""
    return dataclasses.replace(
        bp, **{f.name: getattr(bp, f.name).cpu()
               for f in dataclasses.fields(bp)
               if isinstance(getattr(bp, f.name), torch.Tensor)})


def _plain_job(job):
    """One plain slab version on the CPU; a worker of check_tall_kernels.
    Returns (outputs, ms)."""
    from spaln_tpu_torch.ops import dp_spliced_cuda as K
    torch.set_num_threads(1)
    mode, bp, prm, extra = job
    t0 = time.perf_counter()
    if mode == "retrace":
        out = K.slab_retrace_plain(bp, prm, *extra)
    elif mode == "trace_local":           # K1 with K6's step emission
        out = K._slab_plain(bp, prm, emit_local=True)
    else:
        out = K._slab_plain(bp, prm, mode=mode)
    return out, (time.perf_counter() - t0) * 1e3


def _tall_bucket(dp, ctx):
    """B=4 planted one-intron genes whose cDNAs have 2,176, 1,700, 2,100
    and 1,200 nt: S=17 slabs of L=128 in a band of W=256.  K1 runs 7
    slabs in flight there (K1-dagp 5, K4 4, the score entries 8 and 4),
    so every entry wraps two rounds and ends part-full, and the shorter
    queries leave later sub-slabs past their last row."""
    from spaln_tpu_torch.score.splice import build_splice_signals
    from spaln_tpu_torch.seq.codec import encode_dna
    rng = np.random.default_rng(SEED + 10)
    queries, genomes, sigs, lws = [], [], [], []
    for i, M in enumerate((2176, 1700, 2100, 1200)):
        e1, e2 = _seq(rng, M // 2, 0.3), _seq(rng, M - M // 2, 0.3)
        g = (_seq(rng, 60 + 5 * i, 0.22) + e1 + _intron(rng, 90 + 20 * i)
             + e2 + _seq(rng, 80, 0.22))
        gc = encode_dna(g)
        queries.append(encode_dna(_mutate(rng, e1 + e2, 0.01)))
        genomes.append(gc)
        sigs.append(build_splice_signals(gc, ctx.cfg, ctx.tables))
        lws.append(-40 - 3 * i)
    bp = dp.prepare_spliced_batch(queries, genomes, ctx.prm, sigs=sigs,
                                  lws=lws, W=256, L=128, device="cuda")
    if (bp.S, bp.B, bp.L) != (17, 4, 128):
        raise AssertionError(f"tall bucket geometry {bp.S, bp.B, bp.L}")
    return bp


def check_tall_kernels(K, dp, ctx, ctx3, k6: dict):
    """Every slab entry against its plain version on a bucket of S=17
    slabs (S >= 2k+1 for every entry), single and double affine: K1, K4
    (links and snapshots at every position), the score entry and the
    retrace of slabs 2..16 (more than k) from K4's snapshot, which also
    equals K1's planes; and K6's modes at main-path shapes (``k6``, of
    k6_jobs).  The plain versions run on CPU copies of the operands, in
    parallel worker processes.  Returns (k per entry, K6's rows)."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing
    bp = _tall_bucket(dp, ctx)
    cpu = _cpu_bucket(bp)
    s0, nslab = 2, bp.S - 2
    sel = torch.tensor([3, 0, 2, 1], dtype=torch.int32, device="cuda")
    got, jobs = {}, {}
    for prm in (ctx.prm, ctx3.prm):
        d = "_dagp" if prm.dagp else ""
        got["trace" + d] = K.spliced_slab_trace(bp, prm)
        got["links" + d] = K.spliced_slab_links(bp, prm)
        got["score" + d] = K.spliced_slab_score(bp, prm)
        snap = got["links" + d][1][s0].index_select(1, sel.long())
        snap = snap.contiguous()
        got["retrace" + d] = K.spliced_slab_retrace(bp, prm, s0, nslab, snap,
                                                    sel)
        for mode in ("trace", "links", "score"):
            jobs[mode + d] = (mode, cpu, prm, ())
        jobs["retrace" + d] = ("retrace", cpu, prm,
                               (s0, nslab, snap.cpu(), sel.cpu()))
    tall = list(jobs)
    for name, job in k6.items():
        got[name] = job[3]()
        jobs[name] = job[5]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(jobs),
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as pool:
        futs = {name: pool.submit(_plain_job, job)
                for name, job in jobs.items()}
        plain = {name: f.result() for name, f in futs.items()}
    wall = time.perf_counter() - t0
    idx = sel.long()
    for name in tall:
        want, ms = plain[name]
        have = [x.cpu() for x in got[name]]
        _equal(f"tall bucket: {name}", have, want)
        if name.startswith("retrace"):
            k1 = got[name.replace("retrace", "trace")]
            _equal(f"tall bucket: {name} vs K1's planes", got[name],
                   (k1[0][s0:][:, :, idx], k1[1][s0:][:, :, :, idx]))
    for d in ("", "_dagp"):
        _equal(f"tall bucket: score{d} vs K1", got["score" + d],
               got["trace" + d][2:])
    if not (got["trace"][1] > 0).any():
        raise AssertionError("no intron closed in the tall bucket")
    udh = {("_dagp" if prm.dagp else ""): _udh_both_ways(K, dp, bp, prm)
           for prm in (ctx.prm, ctx3.prm)}
    A = bp.qprof.shape[2]
    ks = {name: K.slab_geometry(name.split("_")[0].replace("retrace",
                                                           "trace"),
                                name.endswith("dagp"), bp.L, A,
                                nslab if name.startswith("retrace")
                                else bp.S)[0] for name in tall}
    log(f"tall bucket (B={bp.B} L={bp.L} W={bp.W} S={bp.S} T={bp.T}, "
        f"queries of {bp.Ms}): every slab entry exact against its plain "
        f"version, the retrace of slabs {s0}..{bp.S - 1} equal to K1's "
        f"planes; k per entry {json.dumps(ks)}; plain versions on the "
        f"CPU in {len(jobs)} processes, {wall:.1f} s")
    for d, (n_one, n_strips) in udh.items():
        log(f"tall bucket: UDH{d or ' (single affine)'}: every path's slab "
            f"run in one retrace launch and its {n_strips} strips in one "
            f"spliced_tb_strips launch, exact against its plain version; "
            f"op streams equal to the one-slab path's ({n_one} retrace "
            f"launches of one problem-slab) and to run_bucket's")
    return ks, k6_finish(K, k6, got, plain)


def _udh_both_ways(K, dp, bp, prm):
    """The UDH path on a bucket as it runs (every path's slab run in one
    retrace launch, all strips in one strip launch) against the one-slab
    path (the retrace at a budget of one problem-slab a launch) and the
    plane path (run_bucket); the strip launch's records against its
    plain version.  Returns (launches of the one-slab path, strips)."""
    from spaln_tpu_torch.ops import dp_spliced_udh as U
    seen = []
    orig = U.spliced_tb_strips

    def capture(*args):
        seen.append((*args, orig(*args)))
        return seen[-1][-1]

    U.spliced_tb_strips = capture
    try:
        multi = U.run_spliced_batch_udh(bp, prm)
        n_multi = len(seen)
        before = K.launches[K.entry("spliced_slab_retrace", prm)]
        one = U.run_spliced_batch_udh(
            bp, prm, bp.T * bp.L * dp.plane_bytes_per_cell(prm))
        n_one = K.launches[K.entry("spliced_slab_retrace", prm)] - before
    finally:
        U.spliced_tb_strips = orig
    label = f"tall bucket UDH (dagp={prm.dagp})"
    if n_multi != 1 or n_one < bp.S:
        raise AssertionError(f"{label}: {n_multi} strip launches, {n_one} "
                             f"one-slab retrace launches")
    *args, recs = seen[0]
    _equal(f"{label}: spliced_tb_strips", [recs],
           [K.tb_strips_plain(*args)])
    planes = K.run_bucket(bp, prm)
    for name, other in (("the one-slab path", one), ("run_bucket", planes)):
        if (not np.array_equal(multi[0], other[0])
                or [tuple(e) for e in multi[1]] != [tuple(e) for e in other[1]]
                or multi[2] != other[2]):
            raise AssertionError(f"{label}: differs from {name}")
    if not all(any(o[0] == "I" for o in ops) for ops in multi[2]):
        raise AssertionError(f"{label}: a planted intron was not recovered")
    return n_one, int(args[2].shape[0])


def _pairs_work(K, bp, prm, slabs, sel) -> tuple[int, int]:
    """(bytes, int32 operations) a retrace of (problem, slab) pairs needs
    on this run's inputs: each pair's substitution rows (its slab's) and
    snapshot read once, each problem's genome operands and joint rows
    read once over the union of its pairs' bands (slab s reads the T + L
    columns from s * L on, so that neighbouring slabs share T of them),
    the pairs' band cells' planes written once, and the DP's operations
    on those cells."""
    dagp = prm.dagp
    L, T, A = bp.L, bp.T, bp.qprof.shape[2]
    nb = 3 if dagp else 2
    cells = acc = don = 0
    for s in sorted(set(slabs.tolist())):
        cols = torch.nonzero(slabs == s).flatten()
        c, a, d = _dp_cells(K._select(bp, sel[cols]), [s])
        cells, acc, don = cells + c, acc + a, don + d
    cols = 0                                # genome columns, problem by problem
    for b in sorted(set(sel.tolist())):
        end = -1
        for s in sorted(set(slabs[sel == b].tolist())):
            lo, hi = s * L, s * L + T + L
            cols += hi - max(lo, end)
            end = hi
    nbytes = (4 * int(sel.shape[0]) * (L * A + nb * (T + 2))
              + 4 * 22 * cols + (21 if dagp else 13) * cells)
    ops = (cells * (OPS_CELL_DAGP if dagp else OPS_CELL)
           + acc * (OPS_ACC_DAGP if dagp else OPS_ACC)
           + don * (OPS_DON_DAGP if dagp else OPS_DON))
    return nbytes, ops


def check_retrace_pairs(K, dp, ctx, ctx3) -> dict:
    """The UDH path of phase 1's bucket in K6's modes (local, a -yJ bonus
    on half the problems), single and double affine, as it runs: every
    (problem, slab) pair in one spliced_slab_retrace_pairs launch and
    every strip in one spliced_tb_strips launch (a slab a walk).  Each
    launch's outputs exactly equal to its plain version's on the card;
    the pairs' planes to the one-slab launches (spliced_slab_retrace of
    each slab from its own snapshot, the route it replaces); the walks' steps
    and tile loads to the model's.  The pairs launch is timed against
    those one-slab launches.  Returns the pairs entries' rows."""
    from spaln_tpu_torch.ops import dp_spliced_udh as U
    out = {}
    for c in (ctx, ctx3):
        prm = c.prm
        b6 = _k6_bucket(_phase1_bucket(dp, c))
        name = K.entry("spliced_slab_retrace_pairs", prm)
        seen = {}
        orig_r, orig_s = U.spliced_slab_retrace_pairs, U.spliced_tb_strips

        def cap_r(*a):
            seen["retrace"] = (a, orig_r(*a))
            return seen["retrace"][1]

        def cap_s(*a):
            seen["strips"] = (a, orig_s(*a))
            return seen["strips"][1]

        before = dict(K.launches)
        U.spliced_slab_retrace_pairs, U.spliced_tb_strips = cap_r, cap_s
        try:
            ops = U.run_spliced_batch_udh(b6, prm)[2]
        finally:
            U.spliced_slab_retrace_pairs, U.spliced_tb_strips = orig_r, orig_s
        n = {k: K.launches[k] - before[k] for k in K.KERNELS}
        if (n[name] != 1 or n["spliced_tb_strips"] != 1
                or n[K.entry("spliced_slab_retrace", prm)]):
            raise AssertionError(f"K6 bucket UDH: launches {n}, expected "
                                 f"one {name} and one spliced_tb_strips")
        if not all(any(o[0] == "I" for o in x) for x in ops):
            raise AssertionError(f"K6 bucket UDH ({name}): a planted intron "
                                 f"was not recovered")
        (bp, _, slabs, snap, sel), planes = seen["retrace"]
        if sorted(set(slabs.tolist())) != [0, 1]:
            raise AssertionError(f"{name}: pairs of slabs {slabs.tolist()}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = K.slab_retrace_pairs_plain(bp, prm, slabs, snap, sel)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _equal(f"{name} (K6 bucket)", planes, plain)
        one = []
        for s in (0, 1):
            cols = torch.nonzero(slabs == s).flatten()
            one.append((s, cols, snap[:, cols].contiguous(),
                        sel[cols].contiguous()))
            _equal(f"{name} slab {s} vs spliced_slab_retrace",
                   [planes[0][:, :, cols], planes[1][:, :, :, cols]],
                   K.spliced_slab_retrace(bp, prm, s, 1, one[-1][2],
                                          one[-1][3]))
        (fl, spj, starts, lws, s0, IT), recs = seen["strips"]
        if not isinstance(s0, torch.Tensor):
            raise AssertionError(f"{name}: the strips took one slab, {s0}")
        sst = torch.empty((starts.shape[0], 2), dtype=torch.int32,
                          device="cuda")
        rs = K.spliced_tb_strips(fl, spj, starts, lws, s0, IT, stats=sst)
        col = starts[:, 4].long()
        keys = _walk_check(K, f"spliced_tb_strips ({name})", rs, sst, fl,
                           lws[col], s0[col], starts[:, 2], col)
        _equal(f"spliced_tb_strips ({name}), a slab a walk", [recs, rs],
               [K.tb_strips_plain(fl, spj, starts, lws, s0, IT)] * 2)
        call = lambda: K.spliced_slab_retrace_pairs(bp, prm, slabs, snap,
                                                    sel)
        per_slab = lambda: [K.spliced_slab_retrace(bp, prm, s, 1, sn, se)
                            for s, _, sn, se in one]
        ms = [_timed(call, 5), _timed(per_slab, 5), _timed(call, 5),
              _timed(per_slab, 5)]
        occ, threads, smem = K.retrace_pairs_occupancy(
            prm.dagp, bp.L, bp.qprof.shape[2], torch.device("cuda"))
        nbytes, nops = _pairs_work(K, bp, prm, slabs, sel)
        bound_ms, bound_by = _bound(nbytes, nops)
        out[name] = dict(max_abs_err=err, plain_ms=plain_ms,
                         ms=min(ms[0], ms[2]), one_slab_ms=min(ms[1], ms[3]),
                         turns_ms=[round(x, 4) for x in ms],
                         pairs=int(sel.shape[0]), ctas_per_sm=occ,
                         bound_ms=bound_ms, bound_by=bound_by,
                         work=(nbytes, nops), strips=keys)
        log(f"K6 bucket (B={bp.B} L={bp.L} W={bp.W} S={bp.S} T={bp.T}, "
            f"local, -yJ on half): {name}: {out[name]['pairs']} pairs in one "
            f"launch, exact against its plain version on the card "
            f"({plain_ms:.0f} ms) and equal to the one-slab launches; "
            f"{out[name]['ms']:.3f} ms, the {len(one)} one-slab launches "
            f"{out[name]['one_slab_ms']:.3f} ms (turns pairs, one-slab, "
            f"pairs, one-slab: {out[name]['turns_ms']}); {threads} threads, "
            f"{smem} B of shared memory, {occ} CTAs an SM holds; bound "
            f"{bound_ms:.7f} ms by {bound_by} ({nbytes} bytes, {nops} int32 "
            f"ops); its {starts.shape[0]} strips (a slab a walk) in one "
            f"spliced_tb_strips launch exact, steps and tile loads the "
            f"model's: {json.dumps(keys)}")
    return out


# ---------------------------------------------------- phase 1, K6 modes
# int32 operations K6 adds, counted from csrc/spliced_dp.cu: per band
# cell the local mode's floor (a compare and a select; its flag bit rides
# in the flag byte's or), per acceptor cell the -yJ bonus (one add), and
# for the step emission per lane-step its share of the warp's maximum
# and the test for the best, and per slab and step the two stores of its
# (best, lane)
OPS_LOCAL_CELL, OPS_CIP_ACC, OPS_EMIT_LANE, OPS_EMIT_STEP = 2, 1, 2, 2


def _k6_bucket(bp):
    """bp in K6's modes as phase 1 holds them: local, with a -yJ bonus
    on every other problem (300-700 at the rows 3 mod 7)."""
    c = torch.zeros((bp.B, bp.Mpad + bp.L), dtype=torch.int32)
    c[::2, 2::7] = 300 + 100 * (torch.arange(c[:, 2::7].shape[1]) % 5)
    return dataclasses.replace(
        bp, flags=dataclasses.replace(bp.flags, local=True),
        cip=c.to(bp.device))


def k6_jobs(K, dp, ctx, ctx3):
    """K6's modes at main-path shapes: phase 1's bucket (B=8, L=128,
    W=1,152, 2 slabs) local with the bonus on half the problems through
    K1, K1-dagp, K4 and K4-dagp, and a batch of search_protein_local
    (B=64 entries, L=64, full band) through K1 with the emission.
    Returns name -> (entry, bucket, prm, its kernel call, the same entry
    with K6 off on the same shape, the plain job for the CPU pool)."""
    out = {}
    for c in (ctx, ctx3):
        bp = _phase1_bucket(dp, c)
        b6 = _k6_bucket(bp)
        cpu = _cpu_bucket(b6)
        d = "_dagp" if c.prm.dagp else ""
        out[f"spliced_slab_trace{d}[local,-yJ]"] = (
            "spliced_slab_trace" + d, b6, c.prm,
            functools.partial(K.spliced_slab_trace, b6, c.prm),
            functools.partial(K.spliced_slab_trace, bp, c.prm),
            ("trace", cpu, c.prm, ()))
        out[f"spliced_slab_links{d}[local,-yJ]"] = (
            "spliced_slab_links" + d, b6, c.prm,
            functools.partial(K.spliced_slab_links, b6, c.prm),
            functools.partial(K.spliced_slab_links, bp, c.prm),
            ("links", cpu, c.prm, ()))
    pb, pprm = _protein_batch(dp, local=True, L=64)
    off = dataclasses.replace(pb, flags=dataclasses.replace(pb.flags,
                                                            local=False))
    out["spliced_slab_trace[local,emission]"] = (
        "spliced_slab_trace", pb, pprm,
        functools.partial(K.spliced_slab_trace, pb, pprm, emit_local=True),
        functools.partial(K.spliced_slab_trace, off, pprm),
        ("trace_local", _cpu_bucket(pb), pprm, ()))
    return out


def k6_finish(K, jobs, got, plain) -> dict:
    """Each K6 mode's kernel outputs against its plain version's (run in
    the CPU pool), then its time beside the same entry with K6 off on
    the same shape, in turns, and its bound from this run's inputs."""
    rows = {}
    for name, (entry, bp, prm, call, off, _) in jobs.items():
        want, plain_ms = plain[name]
        err = _equal(f"K6 {name}", [x.cpu() for x in got[name]], want)
        fl = got[name][0]
        if "trace" in entry and not ((fl >= 128) & (fl != 255)).any():
            raise AssertionError(f"K6 {name}: no cell restarted at 0")
        ms = [_timed(call, 5), _timed(off, 5), _timed(call, 5),
              _timed(off, 5)]
        B, S, T, L = bp.B, bp.S, bp.T, bp.L
        cells, acc, don = _dp_cells(bp, range(S))
        dagp = prm.dagp
        ops = (cells * (OPS_CELL_DAGP if dagp else OPS_CELL)
               + acc * (OPS_ACC_DAGP if dagp else OPS_ACC)
               + don * (OPS_DON_DAGP if dagp else OPS_DON)
               + cells * OPS_LOCAL_CELL)
        nbytes = (_operand_bytes(bp) + 4 * B * (bp.Nmax + 1 + bp.Mpad + 1))
        if bp.cip is not None:
            ops += acc * OPS_CIP_ACC
            nbytes += 4 * B * (bp.Mpad + L)
        if "links" in entry:
            nb = 3 if dagp else 2
            nbytes += 4 * S * B * ((5 if dagp else 4) * T + nb * (T + 2))
            ops += cells * (OPS_LINKS + (OPS_LINKS_DAGP if dagp else 0))
        else:
            nbytes += (21 if dagp else 13) * cells
        if "emission" in name:
            nbytes += 8 * S * T * B
            ops += S * T * B * (L * OPS_EMIT_LANE + OPS_EMIT_STEP)
        bound_ms, bound_by = _bound(nbytes, ops)
        rows[name] = dict(entry=entry, max_abs_err=err, plain_ms=plain_ms,
                          ms=min(ms[0], ms[2]), off_ms=min(ms[1], ms[3]),
                          turns_ms=[round(x, 4) for x in ms],
                          bound_ms=bound_ms, bound_by=bound_by,
                          work=(nbytes, ops))
        log(f"K6 {name}: exact against its plain version (CPU pool, "
            f"{plain_ms:.0f} ms); {rows[name]['ms']:.3f} ms, K6 off on the "
            f"same shape {rows[name]['off_ms']:.3f} ms (turns on, off, on, "
            f"off: {rows[name]['turns_ms']}); bound {bound_ms:.7f} ms by "
            f"{bound_by} ({nbytes} bytes, {ops} int32 ops) (B={B} L={L} "
            f"W={bp.W} S={S} T={T}: {cells} band cells, {acc} acceptor "
            f"cells)")
    return rows


EMIT_ROWS = ("SLAB_EMIT_ROWS=1",)


@contextlib.contextmanager
def _emit_rows_build(K):
    """While the block runs, the slab entries launch from the timing
    build of the emission's store-and-scan form (-DSLAB_EMIT_ROWS=1),
    each CTA with the shared memory its rows take: STAGE_C rows of k*L |
    1 ints, or as many as fit beside the rest (at least one)."""
    lib, smem = K._library, K.slab_smem

    def rows_smem(mode, dagp, KL, A, emit=False):
        base = smem(mode, dagp, KL, A)
        rows = max(1, min(K.STAGE_C, (K.SMEM_MAX - base) // 4 // (KL | 1)))
        return base + 4 * rows * (KL | 1) if emit else base

    K._library = lambda defines=(): lib(defines or EMIT_ROWS)
    K.slab_smem = rows_smem
    try:
        yield
    finally:
        K._library, K.slab_smem = lib, smem


def emission_timing(K, dp) -> dict:
    """K1 with the local emission on a batch of search_protein_local
    (B=64, L=64, full band) in its two forms, the production build's
    reduction from registers and the timing build's store-and-scan rows
    (both built from this checkout, one nvcc each, started together),
    exactly equal on the card; each timed in turns with K6 off on the
    same shape (registers, rows, off, three times; CUDA events, 5 calls
    each)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(lambda d: K.build_library(K.SOURCE, d),
                               ((), EMIT_ROWS)))
    log(f"production and {EMIT_ROWS[0]} builds in "
        f"{time.perf_counter() - t0:.1f} s")
    for (so, secs, ptxas), tag in zip(builds, ("registers", "rows")):
        emit = {k: v for k, v in _ptxas_instances(ptxas).items()
                if re.fullmatch(r"slab_kernel<0,[01],[01],\d+,[12],2>", k)}
        log(f"  {tag}: {so.name}, nvcc {secs:.1f} s; the emission's "
            f"instances: {emit}")
    pb, pprm = _protein_batch(dp, local=True, L=64)
    off = dataclasses.replace(pb, flags=dataclasses.replace(pb.flags,
                                                            local=False))
    reg = functools.partial(K.spliced_slab_trace, pb, pprm, emit_local=True)

    def rows():
        with _emit_rows_build(K):
            return reg()

    err = _equal("the emission's two forms (rows against registers)",
                 rows(), reg())
    calls = {"registers": reg, "rows": rows,
             "k6_off": functools.partial(K.spliced_slab_trace, off, pprm)}
    turns = {k: [] for k in calls}
    for _ in range(3):
        for k, fn in calls.items():
            turns[k].append(_timed(fn, 5))
    out = dict(shape=dict(B=pb.B, L=pb.L, W=pb.W, S=pb.S, T=pb.T),
               max_abs_err=err,
               ms={k: min(v) for k, v in turns.items()},
               turns_ms={k: [round(x, 4) for x in v]
                         for k, v in turns.items()})
    log(f"K1 with the local emission (B={pb.B} L={pb.L} W={pb.W} "
        f"S={pb.S}): the two forms exactly equal; min ms {out['ms']} "
        f"(turns {out['turns_ms']})")
    return out


def _tetrapod_width_bucket(dp, ctx, B=32, W=16384, min_len=1000):
    """A bucket at tetrapod width: B genes of 8-11 exons of 60-300 nt
    (cDNAs of min_len-1,536 nt, S=12 slabs of L=128 for B=32) whose
    introns (log-uniform 0.5-5 kb) fill 50-90% of a band of W columns, in
    a genome of GC ~41% with 300 nt flanks."""
    from spaln_tpu_torch.score.splice import build_splice_signals
    from spaln_tpu_torch.seq.codec import encode_dna
    rng = np.random.default_rng(SEED + 11)
    queries, genomes, sigs, lws = [], [], [], []
    while len(queries) < B:
        n_ex = int(rng.integers(8, 12))
        lens = np.exp(rng.uniform(np.log(500), np.log(5000), n_ex - 1))
        lens = lens * rng.uniform(0.5, 0.9) * W / lens.sum()
        g, _, ex = _gene_parts(rng, n_ex, lambda j: int(lens[j]), 0.5, 0.38)
        q = "".join(ex)
        if not min_len <= len(q) <= 1536:
            continue
        flank = 300
        gc = encode_dna(_seq(rng, flank, 0.41) + g + _seq(rng, flank, 0.41))
        queries.append(encode_dna(_mutate(rng, q, 0.01)))
        genomes.append(gc)
        sigs.append(build_splice_signals(gc, ctx.cfg, ctx.tables))
        lws.append(flank - 201)
    bp = dp.prepare_spliced_batch(queries, genomes, ctx.prm, sigs=sigs,
                                  lws=lws, W=W, L=128, device="cuda")
    if (bp.S, bp.B) != (12, B):
        raise AssertionError(f"tetrapod-width bucket {bp.S, bp.B}")
    return bp


SWEEP_K = (1, 2, 3, 4, 7)


@contextlib.contextmanager
def _retrace_k(K, k):
    """Force the retrace's k (the sweep): through retrace_geometry or, in
    a checkout from before it, through slab_geometry; None leaves the
    checkout's own choice."""
    name = ("retrace_geometry" if hasattr(K, "retrace_geometry")
            else "slab_geometry")
    orig = getattr(K, name)
    if k is not None:
        setattr(K, name, (lambda dagp, L, A, nslab, nb, n_sm:
                          K.slab_geometry("trace", dagp, L, A, k))
                if name == "retrace_geometry" else
                (lambda mode, dagp, L, A, S: orig(mode, dagp, L, A,
                                                  min(S, k))))
    try:
        yield
    finally:
        setattr(K, name, orig)


def _retrace_geom(K, bp, nslab, k):
    """(k, CTAs per problem) of a retrace of all bp.B problems over
    nslab slabs, at k or at the checkout's own choice (None)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    A = bp.qprof.shape[2]
    if k is None:
        k = (K.retrace_geometry(False, bp.L, A, nslab, bp.B, n_sm)[0]
             if hasattr(K, "retrace_geometry")
             else K.slab_geometry("trace", False, bp.L, A, nslab)[0])
    return k, K.slab_ctas(k, nslab, bp.B, n_sm)


def slab_timing(K, dp, ctx):
    """Times, on the tetrapod-width bucket, K1, K4 and the retrace: as
    the UDH path launches it (the 12 slabs of every problem from K4's
    snapshot of slab 0 in one launch) at the checkout's own k and at k =
    1, 2, 3, 4, 7, beside the one-slab launch (slab 1) and slabs 1..11;
    then the retrace of a one-problem align window (B=1, W=65,536, 12
    slabs) in the same ways, and every (problem, slab) pair of each in one
    launch of the retrace of pairs (a checkout with it).  Every retrace's
    planes must equal K1's.
    Returns name -> ms per launch, k, CTAs per problem, serial steps per
    launch (the critical path, slab_serial_steps) and us per global
    step.  First K1 and K4 (single and double affine) on phase 1's
    bucket, 20 launches each, the main path's modes (K6 off)."""
    out = {}
    bp1 = _phase1_bucket(dp, ctx)
    prm3 = dataclasses.replace(ctx.prm, dagp=True, lgop=ctx.prm.gop * 2,
                               lgep=ctx.prm.gep // 2)
    for prm in (ctx.prm, prm3):
        for name in ("spliced_slab_trace", "spliced_slab_links"):
            fn = getattr(K, name)
            ms = _timed(lambda: fn(bp1, prm), 20)
            key = f"{K.entry(name, prm)} phase 1"
            out[key] = dict(ms=ms)
            log(f"phase 1's bucket (B={bp1.B} L={bp1.L} W={bp1.W} "
                f"S={bp1.S}): {key}: {ms:.4f} ms per launch")
    del bp1
    for tag, bp in (("", _tetrapod_width_bucket(dp, ctx)),
                    (" window", _tetrapod_width_bucket(
                        dp, ctx, B=1, W=65536, min_len=1409))):
        out.update(_slab_timing(K, bp, ctx.prm, tag))
        del bp
        torch.cuda.empty_cache()
    return out


def _slab_timing(K, bp, prm, tag):
    L, T, S = bp.L, bp.T, bp.S
    A = bp.qprof.shape[2]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sel = torch.arange(bp.B, dtype=torch.int32, device="cuda")
    k1 = K.spliced_slab_trace(bp, prm)
    snaps = K.spliced_slab_links(bp, prm)[1]
    runs = {}
    if not tag:
        runs["spliced_slab_trace"] = ("trace", S, None,
                                      lambda: K.spliced_slab_trace(bp, prm))
        runs["spliced_slab_links"] = ("links", S, None,
                                      lambda: K.spliced_slab_links(bp, prm))
    for s0, nslab, ks in ((1, 1, [None]), (1, S - 1, [None]),
                          (0, S, [None, *SWEEP_K])):
        snap = snaps[s0].contiguous()
        for k in ks:
            with _retrace_k(K, k):
                r = K.spliced_slab_retrace(bp, prm, s0, nslab, snap, sel)
            if not (torch.equal(r[0], k1[0][s0:s0 + nslab])
                    and torch.equal(r[1], k1[1][s0:s0 + nslab])):
                raise AssertionError(f"retrace of slabs {s0}..{s0 + nslab - 1}"
                                     f"{tag} at k={k} differs from K1's "
                                     f"planes")
            del r
            name = (f"spliced_slab_retrace{tag} x{nslab}"
                    + (f" from {s0}" if s0 == 0 else "")
                    + (f" k={k}" if k is not None else ""))
            runs[name] = ("retrace", nslab, k,
                          lambda s0=s0, nslab=nslab, snap=snap, k=k:
                          _with_k(K, k, lambda: K.spliced_slab_retrace(
                              bp, prm, s0, nslab, snap, sel)))
    if hasattr(K, "spliced_slab_retrace_pairs"):
        # every (problem, slab) pair in one launch, slab by slab: the
        # pairs of slab s are columns s*B .. s*B+B-1
        ids = torch.tensor([(b, s) for s in range(S) for b in range(bp.B)],
                           dtype=torch.int32).T.contiguous().cuda()
        psel, pslab = ids[0].contiguous(), ids[1].contiguous()
        psnap = snaps[pslab.long(), :, psel.long()].transpose(0, 1)
        psnap = psnap.contiguous()
        r = K.spliced_slab_retrace_pairs(bp, prm, pslab, psnap, psel)
        for s in range(S):
            c = slice(s * bp.B, (s + 1) * bp.B)
            if not (torch.equal(r[0][0][:, c], k1[0][s])
                    and torch.equal(r[1][0][:, :, c], k1[1][s])):
                raise AssertionError(f"retrace of pairs{tag}: slab {s} "
                                     f"differs from K1's planes")
        del r
        runs[f"spliced_slab_retrace_pairs{tag} x{S * bp.B}"] = (
            "pairs", 1, None,
            lambda: K.spliced_slab_retrace_pairs(bp, prm, pslab, psnap, psel))
    out = {} if tag else _k3_timing(K, bp, prm, k1, "tetrapod width")
    if not tag and hasattr(K, "spliced_ends_tb_walk"):
        _ends_checks(K, bp, prm, k1, "tetrapod width",
                     ("across_warps", "row_col_tie"), timed=False)
    del k1
    for name, (mode, nslab, kf, fn) in runs.items():
        extra = ""
        if mode == "retrace":
            k, ncta = _retrace_geom(K, bp, nslab, kf)
        elif mode == "pairs":                  # a CTA a pair, k = 1
            k, ncta = 1, 1
            occ = K.retrace_pairs_occupancy(prm.dagp, L, A,
                                            torch.device("cuda"))[0]
            extra = (f"; {S * bp.B} CTAs, {occ} an SM holds: "
                     f"{-(-S * bp.B // (occ * n_sm))} wave(s)")
        else:
            k = K.slab_geometry(mode, False, L, A, nslab)[0]
            ncta = K.slab_ctas(k, nslab, bp.B, n_sm)
        steps = K.slab_serial_steps(T, L, k, nslab, ncta)
        ms = _timed(fn, 3)
        out[name] = dict(ms=ms, k=k, ncta=ncta, steps=steps,
                         us_per_step=ms * 1e3 / steps)
        log(f"tetrapod-width bucket{tag} (B={bp.B} L={L} W={bp.W} S={S} "
            f"T={T}): {name}: {ms:.3f} ms per launch, k={k} on {ncta} "
            f"CTA(s) per problem, {steps} serial steps, "
            f"{ms * 1e3 / steps:.4f} us per global step{extra}")
    return out


def _with_k(K, k, fn):
    with _retrace_k(K, k):
        return fn()


def _copy_ms(t: torch.Tensor, reps: int = 5) -> float:
    """Median ms of one device-to-host copy of t into pageable memory
    (.cpu(), as run_bucket copies), host clock."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def _strip_model(flags, lws, starts, s0: int) -> tuple:
    """walk_stats' arguments after the records for a strip launch."""
    col = starts[:, 4].long()
    return flags, lws[col], s0, starts[:, 2], col


def _k3_row(K, label: str, recs, stats, *model) -> dict:
    """A K3 launch's row keys: the kernel's steps and tile loads held
    against the model's where the package has it, else the longest
    walk's steps from its records (the same count)."""
    if hasattr(K, "walk_stats"):
        return _walk_check(K, label, recs, stats, *model)
    return dict(steps=int((recs[:, :, 1] != 0).sum(0).max()))


def _k3_timing(K, bp, prm, k1, label: str, clock: bool = False) -> dict:
    """K3 (the full walk) on a bucket's K1 planes ``k1``: exact against its
    plain version, ms a launch, serial steps, ns a step and tile loads;
    and its records' copy to the host, every IT row (as run_bucket copied
    them before it read the walks' steps) against the rows the walks
    wrote."""
    flags, spj, row, rc = k1
    se = K.spliced_last_ends(bp, prm, row, rc)
    stats = torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
    fn = lambda: K.spliced_tb_walk(bp, flags, spj, se)
    recs = (K.spliced_tb_walk(bp, flags, spj, se, stats=stats)
            if hasattr(K, "walk_stats") else fn())
    _equal(f"spliced_tb_walk ({label})", [recs],
           [K.tb_walk_plain(bp, flags, spj, se)])
    r = _timed_walk(_k3_row(K, label, recs, stats, flags, bp.lws_t), fn, 5,
                    K)
    if clock:
        r.update(_clock_k3(K, bp, flags, spj, se, recs, stats))
    r.update(copy_all_ms=_copy_ms(recs), copy_rows_ms=_copy_ms(
        recs[:r["steps"]]), IT=bp.IT)
    log(f"{label} bucket (B={bp.B} L={bp.L} W={bp.W} S={bp.S} T={bp.T}): "
        f"spliced_tb_walk: {r['ms']:.4f} ms, {r['steps']} serial steps = "
        f"{r['ns_per_step']:.1f} ns a step"
        + (f", {r['tile_loads']:.2f} tile loads a walk (most "
           f"{r['tile_loads_max']})" if "tile_loads" in r else "")
        + (f"; clocked: {r['cycles_step']:.0f} cycles a step outside the "
           f"loads, {r['cycles_load']:.0f} a load, latency floor "
           f"{r['floor_ms']:.5f} ms" if clock else "")
        + f"; records to the host: all {bp.IT} rows {r['copy_all_ms']:.3f} "
        f"ms, the {r['steps']} rows written {r['copy_rows_ms']:.3f} ms")
    return {f"spliced_tb_walk {label}": r}


# ---------------------------------------------------- phase 1, tron path
# int32 operations of K7 per band cell (the recurrence with its neighbour
# reads, E and F, the commit, the ring and plane writes; double-affine
# gaps add E2 and F2), per acceptor phase at a cell (4 candidates: the
# penalty, joint and junction-codon terms, the strict-max chain into 3
# or 5 states) and per donor phase (the eligibility rules and a sorted
# insertion per state), counted from csrc/tron_dp.cu
OPS_TRON_CELL, OPS_TRON_CELL_DAGP = 70, 95
OPS_TRON_ACC, OPS_TRON_ACC_DAGP = 90, 120
OPS_TRON_DON, OPS_TRON_DON_DAGP = 75, 125


def _tron_cells(TD, bp):
    """(band cells, acceptor phase-cells, donor phase-cells) of a tron
    batch, from this run's operands: the cells inside the band and the
    matrix (K7's ``active``), and the splice phases that run their
    branches there (a phase of 2 counts twice).  Lane i of slab s
    (m = sL + 1 + i) is active at the band's W steps t = 6i..6i+W-1,
    where n = c0 + t - 3i runs over one interval: prefix sums of the
    phase weights count its sites."""
    meta = bp.meta.cpu().numpy().astype(np.int64)
    code = bp.gen[:, TD.G_CODE].cpu().numpy().astype(np.int64)
    L, W = bp.L, bp.W
    i = np.arange(L)
    cells = acc = don = 0
    for b in range(bp.B):
        M, N, lw = meta[b, :3]
        pre = []
        for shift in (TD.P3_SHIFT, TD.P5_SHIFT):
            k = ((code[b, :N] >> shift) & 7) - 2
            w = np.where(k == 2, 2, (k >= -1) & (k <= 1))
            pre.append(np.concatenate([[0], np.cumsum(w)]))
        for s in range(bp.S):
            m0 = s * L + 1
            lo = 3 * m0 + lw - 1 + 3 * i
            n_lo = np.maximum(lo, 0)
            n_hi = np.minimum(lo + W - 1, N)
            live = (m0 + i <= M) & (n_hi >= n_lo)
            cells += int(np.where(live, n_hi - n_lo + 1, 0).sum())
            s_hi = np.minimum(n_hi, N - 1)
            site = live & (m0 + i < M) & (s_hi >= n_lo)
            a = np.clip(n_lo, 0, N)
            z = np.clip(s_hi + 1, 0, N)
            acc += int(np.where(site, pre[0][z] - pre[0][a], 0).sum())
            don += int(np.where(site, pre[1][z] - pre[1][a], 0).sum())
    return cells, acc, don


def _tron_work(TD, bp, dagp: bool) -> tuple[int, int]:
    """(bytes, int32 operations) K7 needs on a batch: its operands read
    once, the planes of the band cells and the row, column and local
    end written once; the operations per band cell and splice
    phase-cell."""
    cells, acc, don = _tron_cells(TD, bp)
    nn = 5 if dagp else 3
    nbytes = (4 * (bp.gen.numel() + bp.aa.numel() + bp.tabs.numel()
                   + 2 * bp.bnd0.numel() + bp.meta.numel())
              + 6 * nn * cells + 4 * bp.B * (bp.Nmax + bp.Mpad + 7))
    nops = (cells * (OPS_TRON_CELL_DAGP if dagp else OPS_TRON_CELL)
            + acc * (OPS_TRON_ACC_DAGP if dagp else OPS_TRON_ACC)
            + don * (OPS_TRON_DON_DAGP if dagp else OPS_TRON_DON))
    return nbytes, nops


TRON_REC = 5                     # ints of a K8 record (kind, m, n, a1, a2)


def _walk_work(steps: int, B: int) -> tuple[int, int]:
    """(bytes, int32 operations) of K8's walks of ``steps`` records: a
    flag and a junction word read and a record written per step."""
    return 6 * steps + 4 * TRON_REC * steps + 4 * B * 4, OPS_WALK * steps


def _tron_jobs(pctx, seed: int, n: int, aa_len: tuple, intron_len: tuple,
               cuts: int) -> list:
    """n planted protein genes (proteins of aa_len residues, cuts or
    cuts + 1 introns, in turn, at random codon phases; GT..AG introns
    log-uniform over intron_len; 10% substitutions in the queries) and
    the jobs prepare_tron_job makes of them (the W ladder, Local bounds
    at the chain's anchors)."""
    from spaln_tpu_torch.align.protein_driver import (prepare_tron_job,
                                                      wilip_protein)
    from spaln_tpu_torch.seq.codec import encode_dna, encode_protein
    rng = np.random.default_rng(seed)
    codons = _codons()
    jobs = []
    lo, hi = np.log(intron_len[0]), np.log(intron_len[1])
    while len(jobs) < n:
        prot = "M" + _protein(rng, int(rng.integers(*aa_len)) - 1)
        cds = "".join(codons[a][int(rng.integers(len(codons[a])))]
                      for a in prot)
        cut = np.sort(rng.choice(np.arange(45, len(cds) - 45),
                                 cuts + len(jobs) % 2, replace=False))
        if np.any(np.diff(np.concatenate([[0], cut, [len(cds)]])) < 45):
            continue
        g, prev = _seq(rng, 300, 0.4), 0
        for c in list(cut) + [len(cds)]:
            g += cds[prev:c]
            if c != len(cds):
                x = int(np.exp(rng.uniform(lo, hi)))
                g += "GTAAGT" + _seq(rng, x - 12, 0.38) + "TTTCAG"
            prev = c
        g += _seq(rng, 300, 0.4)
        q = encode_protein(_mutate_protein(rng, prot, 0.1))
        gc = encode_dna(g)
        chain = wilip_protein(q, gc, pctx.pmtx, ipen=pctx.ipen)[0]
        jobs.append(prepare_tron_job(q, gc, pctx, chain))
    return jobs


def _tron_batch(TD, pctx, jobs: list, L: int, local: bool, W: int = 0):
    """The jobs as one batch of L lanes at the widest of their bands, or
    at W where that is wider (as coalesce_buckets widens a bucket)."""
    from spaln_tpu_torch.ops.params import DpFlags
    W = max(W, max(j.up - j.lw + 2 for j in jobs))
    return TD.prepare_tron_batch(
        [j.q for j in jobs], [j.gw for j in jobs], [j.sig for j in jobs],
        pctx.prm, pctx.ipen_tab, lws=[j.lw for j in jobs], W=W, L=L,
        flags=DpFlags(local=local),
        loc_bounds=[j.loc_bounds for j in jobs], device="cuda")


def _tron_bucket(TD, pctx, local: bool):
    """Phase 1's tron batch at phase 8's shapes: B=4 planted protein
    genes of 330-384 aa (3 slabs of the map's 128 lanes), 4-5 exons,
    introns of 2-6 kb, at the widest band of the four: W = 15,744, as
    one of phase 8's batches (the others 23,808-43,995)."""
    jobs = _tron_jobs(pctx, SEED + 11, 4, (330, 385), (2000, 6000), 3)
    bp = _tron_batch(TD, pctx, jobs, 128, local)
    if (bp.B, bp.S) != (4, 3) or bp.W < 15_000:
        raise AssertionError(f"tron bucket geometry {bp.B, bp.S, bp.W}")
    return bp


def _tron_long_jobs(pctx):
    """One planted gene of a 1,290-1,400 aa protein (11 slabs of 128
    lanes), 4-5 exons, introns of 100-400 nt."""
    return _tron_jobs(pctx, SEED + 12, 1, (1290, 1400), (100, 400), 3)


def _tron_wide_jobs(pctx):
    """Two planted genes of 500-700 aa proteins for one slab of 1,024
    lanes (three pieces of 342 lanes), introns of 100-400 nt."""
    return _tron_jobs(pctx, SEED + 13, 2, (500, 700), (100, 400), 2)


# the forced geometries (k slabs a CTA, CTAs a problem) of phase 1 and
# --tron-timing: k up to what the thread budget holds at L = 128
TRON_SWEEP = {dagp: [(k, c) for k in (1, 2, 3)[:2 if dagp else 3]
                     for c in (1, 2, 3)] for dagp in (False, True)}


def _tron_geom(TK, bp, prm, geom=None) -> dict:
    """K7's launch plan over bp at the rule's geometry or the forced
    one."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return TK.tron_launch_plan(bp, prm, n_sm, geom)


def _tron_sweep(TK, bp, prm, want, label: str, geoms) -> list:
    """K7 on bp at each forced geometry, held byte for byte against
    ``want``, the outputs at the rule's geometry (themselves held
    against the plain version's).  Returns the (k, CTAs) run."""
    rule = _tron_geom(TK, bp, prm)
    done = []
    for geom in geoms:
        if geom == (rule["k"], rule["ncta"]):
            continue
        planes, row, rc, loc = TK.tron_forward(bp, prm, geometry=geom)
        got = list(planes) + [row, rc, loc]
        _equal(f"{label} at k, CTAs = {geom}", got, want)
        del planes, got
        done.append(geom)
    log(f"{label}: the rule's k={rule['k']} on {rule['ncta']} CTA(s) "
        f"({rule['steps']} serial steps) and forced (k, CTAs) {done}: "
        f"byte-equal")
    return done


def _tron_plain_job(job):
    """K7's plain version on CPU copies; a worker of check_tron_kernels.
    Returns (outputs, ms)."""
    from spaln_tpu_torch.ops import dp_tron_cuda as TK
    torch.set_num_threads(1)
    bp, prm = job
    t0 = time.perf_counter()
    planes, row, rc, loc = TK.tron_forward_plain(bp, prm)
    return (list(planes) + [row, rc, loc]), (time.perf_counter() - t0) * 1e3


def _tron_walk_check(TK, label: str, bp, planes, et, recs, counts,
                     stats=None) -> tuple[dict, float]:
    """K8's records equal to its plain version's on the card, and its
    steps and tile loads (``stats``, unless None) to the model's
    (tron_walk_stats) on the same records; returns (_walk_keys or {},
    the plain version's ms)."""
    (precs, pcounts, pdone), wplain = _plain_ms(
        lambda: TK.tron_walk_plain(bp, planes, et))
    if not (torch.equal(counts, pcounts) and bool(pdone.all())):
        raise AssertionError(f"tron_walk counts differ ({label})")
    for b in range(bp.B):
        n = int(counts[b])
        _equal(f"tron_walk ({label})", [recs[b, :n]], [precs[b, :n]])
    if stats is None:
        return {}, wplain
    want = TK.tron_walk_stats(bp, planes[0], et, recs, counts)
    if not torch.equal(stats.cpu(), want):
        raise AssertionError(f"tron_walk ({label}): steps and tile loads "
                             f"{stats.cpu().tolist()} differ from the "
                             f"model's {want.tolist()}")
    return _walk_keys(stats), wplain


def _tron_ends(TD, bp, row, rc, loc) -> torch.Tensor:
    """A batch's end cells (B, 2) on the card, as run_tron_batch takes
    them."""
    ends = TD.collect_tron_ends(bp, row.cpu().numpy(), rc.cpu().numpy(),
                                loc.cpu().numpy())
    return torch.tensor([[e[1], e[2]] for e in ends], dtype=torch.int32,
                        device="cuda")


def check_tron_kernels(TK, TD, pool):
    """K7 (3 and 5 states, Local on and off) and K8 against their plain
    versions on phase 1's tron batch (B=4, L=128, 3 slabs, W = 15,744):
    every output exact, K7 at the rule's geometry and at the forced
    sweep of (k, CTAs per problem) (each held against the rule's
    outputs on the card, which are held against the plain version's);
    then K7 on one problem of 11 slabs and on a slab of 1,024 lanes (as
    pieces), Smith-Waterman local, each at its rule's geometry and
    forced ones.  K7's plain versions run on CPU copies in ``pool``'s
    processes while the later phases run; K8's on the card, here.  The
    Local variants of phase 1's batch are the map's (Smith-Waterman
    local by default): their times and bounds go into the kernel line.
    Returns a function that waits for the plain versions, compares and
    returns the kernel rows."""
    from spaln_tpu_torch.align.protein_driver import ProteinAlignerContext
    from spaln_tpu_torch.score.tables import TableDir, find_table_dir
    tables = TableDir(find_table_dir(), species="Tetrapod")
    pctx = {dagp: ProteinAlignerContext.create(
        tables, "cuda", y_args=["-yl3"] if dagp else None)
        for dagp in (False, True)}
    variants = [(dagp, local) for dagp in (False, True)
                for local in (True, False)]
    bps = {local: _tron_bucket(TD, pctx[False], local)
           for local in (True, False)}
    extra = {"long": _tron_batch(TD, pctx[False], _tron_long_jobs(
                 pctx[False]), 128, True),
             "wide": _tron_batch(TD, pctx[False], _tron_wide_jobs(
                 pctx[False]), 1024, True)}
    if extra["long"].S != 11 or extra["wide"].S != 1:
        raise AssertionError("tron long/wide batches: "
                             f"{extra['long'].S}, {extra['wide'].S} slabs")
    t_submit = time.perf_counter()
    pending, got = {}, {}
    for key, bp in extra.items():
        pending[key] = pool.apply_async(
            _tron_plain_job, ((_cpu_bucket(bp), pctx[False].prm),))
    for dagp, local in variants:
        pending[dagp, local] = pool.apply_async(
            _tron_plain_job, ((_cpu_bucket(bps[local]), pctx[dagp].prm),))
    out = {}
    for dagp, local in variants:
        name = "tron_forward_dagp" if dagp else "tron_forward"
        prm = pctx[dagp].prm
        bp = bps[local]
        planes, row, rc, loc = TK.tron_forward(bp, prm)
        mine = list(planes) + [row, rc, loc]
        _tron_sweep(TK, bp, prm, mine, f"{name} (local {local})",
                    TRON_SWEEP[dagp])
        got[dagp, local] = [x.cpu() for x in mine]
        del mine
        et = _tron_ends(TD, bp, row, rc, loc)
        st = torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
        recs, counts = TK.tron_walk(bp, planes, et, stats=st)
        wrow, wplain = _tron_walk_check(TK, f"{name}, local {local}", bp,
                                        planes, et, recs, counts, st)
        _timed_walk(wrow, lambda: TK.tron_walk(bp, planes, et), 5,
                    TK)
        introns = sum(int(((recs[b, :int(counts[b]), 0] >= 4)).sum())
                      for b in range(bp.B))
        log(f"kernel tron_walk on {name} (local {local}): exact, "
            f"{int(counts.sum())} records, {introns} introns on the paths; "
            + _walk_log("K8", wrow))
        if not introns:
            raise AssertionError("no intron on the tron paths")
        if not local:
            continue
        nbytes, nops = _tron_work(TD, bp, dagp)
        bound, by = _bound(nbytes, nops)
        ms = _timed(lambda: TK.tron_forward(bp, prm), 3)
        plan = _tron_geom(TK, bp, prm)
        out[name] = dict(ms=ms, bound_ms=bound, bound_by=by,
                         work=(nbytes, nops), plan=plan)
        cells, acc, don = _tron_cells(TD, bp)
        log(f"kernel {name}: {ms:.3f} ms = "
            f"{1e3 * ms / plan['steps']:.3f} us a step (k={plan['k']} on "
            f"{plan['ncta']} CTA(s) per problem, {plan['steps']} serial "
            f"steps), bound {bound:.7f} ms by {by} ({nbytes} bytes, {nops} "
            f"int32 ops) (B={bp.B} L={bp.L} W={bp.W} S={bp.S} T={bp.T}: "
            f"{cells} band cells of {bp.S * bp.T * bp.B * bp.L} "
            f"lane-steps, {acc} acceptor and {don} donor phase-cells)")
        if not dagp:
            steps = int(counts.sum())
            wb, wo = _walk_work(steps, bp.B)
            wbound, wby = _bound(wb, wo)
            out["tron_walk"] = dict(max_abs_err=0, plain_ms=wplain,
                                    bound_ms=wbound, bound_by=wby,
                                    work=(wb, wo), **wrow)
            log(f"kernel tron_walk: {wrow['ms']:.3f} ms vs "
                f"plain {wplain:.1f} ms (on the card), bound {wbound:.7f} "
                f"ms by {wby} ({steps} records)")
        del planes
    prm = pctx[False].prm
    for key, bp in extra.items():
        planes, row, rc, loc = TK.tron_forward(bp, prm)
        mine = list(planes) + [row, rc, loc]
        forced = [(1, 1), (1, 8), (3, 4)] if key == "long" else [(1, 1),
                                                                  (1, 2)]
        _tron_sweep(TK, bp, prm, mine, f"tron_forward ({key}: B={bp.B} "
                    f"L={bp.L} S={bp.S} W={bp.W})", forced)
        got[key] = [x.cpu() for x in mine]
        del planes, mine

    def finish():
        t0 = time.perf_counter()
        for key, job in pending.items():
            want, ms = job.get()
            if key in extra:
                _equal(f"tron_forward ({key})", got[key], want)
                log(f"kernel tron_forward ({key}): exact; plain {ms:.1f} "
                    f"ms (on a CPU copy)")
                continue
            dagp, local = key
            name = "tron_forward_dagp" if dagp else "tron_forward"
            err = _equal(f"{name} (local {local})", got[dagp, local], want)
            log(f"kernel {name} (local {local}): exact; plain {ms:.1f} ms "
                f"(on a CPU copy)")
            if local:
                out[name].update(max_abs_err=err, plain_ms=ms)
        log(f"tron batches: K7 plain versions on the CPU in {len(pending)} "
            f"processes, {time.perf_counter() - t_submit:.1f} s after "
            f"submission ({time.perf_counter() - t0:.1f} s of waiting)")
        return out
    return finish


def _phase8_batches(TK, cli) -> dict:
    """The batches K7 runs on in phase 8's protein map, default and -y
    l3: mode -> [(batch, parameters)], from one map run each (the index
    built once under smoke_work/tron_timing/ and kept there, so that the
    packages timed in one call share it)."""
    d = WORK / "tron_timing"
    if not (d / "index.done").exists():
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        make_protein_gene_corpus(d)
        cli.main(["index", str(d / "genome.fa"), "-p", str(d / "genome"),
                  "-K", "P"])
        (d / "index.done").write_text("")
    out = {}
    for mode, extra in (("default", []), ("yl3", ["-y", "l3"])):
        with _keep_tron_batches(TK) as kept:
            cli.main(["map", str(d / "prot.fa"), "-d", str(d / "genome"),
                      "-T", "Tetrapod", "-O", "0,4", "-o",
                      str(d / f"out.{mode}"), "--device", "cuda", *extra])
        out[mode] = kept["forward"]
    return out


def tron_timing(TK, TD) -> dict:
    """K7 (3 and 5 states, Smith-Waterman local) on phase 1's tron batch
    and on one problem of 11 slabs widened to W = 23,808 (as phase 8's
    one-problem batches), at the checkout's own geometry and, where the
    checkout takes a forced one, at the sweep (each held against the
    rule's outputs on the card); then on each of phase 8's batches, at
    the checkout's own geometry.  Returns name -> ms per launch, k, CTAs
    per problem, serial steps and us per serial step, and phase 8's
    summed ms per mode."""
    from spaln_tpu_torch.align.protein_driver import ProteinAlignerContext
    from spaln_tpu_torch.score.tables import TableDir, find_table_dir
    tables = TableDir(find_table_dir(), species="Tetrapod")
    pctx = {dagp: ProteinAlignerContext.create(
        tables, "cuda", y_args=["-yl3"] if dagp else None)
        for dagp in (False, True)}
    sweep = hasattr(TK, "tron_launch_plan")
    out = {}
    for tag, make in (("phase 1", lambda: _tron_bucket(TD, pctx[False],
                                                       True)),
                      ("one problem", lambda: _tron_batch(
                          TD, pctx[False], _tron_long_jobs(pctx[False]),
                          128, True, W=23_808))):
        bp = make()
        for dagp in (False, True):
            prm = pctx[dagp].prm
            name = "tron_forward_dagp" if dagp else "tron_forward"
            want, want_key = None, None
            for geom in [None] + (TRON_SWEEP[dagp] if sweep else []):
                if sweep:
                    try:
                        plan = _tron_geom(TK, bp, prm, geom)
                    except ValueError as e:       # not in this checkout
                        log(f"tron timing: {name} ({tag}) at {geom}: {e}")
                        continue
                    key = (plan["k"], plan["ncta"])
                    if geom is not None and key == want_key:
                        continue
                    fn = (lambda g=geom: TK.tron_forward(bp, prm,
                                                         geometry=g))
                else:
                    plan = dict(k=1, ncta=1, steps=bp.S * bp.T)
                    fn = (lambda: TK.tron_forward(bp, prm))
                res = fn()
                res = list(res[0]) + list(res[1:])
                if want is None:
                    want, want_key = res, (plan["k"], plan["ncta"])
                else:
                    _equal(f"{name} ({tag}) at {geom}", res, want)
                del res
                ms = _timed(fn, 3)
                label = (f"{name} {tag}"
                         + ("" if geom is None else f" k={geom[0]} "
                            f"ctas={geom[1]}"))
                out[label] = dict(ms=ms, k=plan["k"], ncta=plan["ncta"],
                                  steps=plan["steps"],
                                  us_per_step=ms * 1e3 / plan["steps"])
                log(f"tron timing (B={bp.B} L={bp.L} W={bp.W} S={bp.S} "
                    f"T={bp.T}): {label}: {ms:.3f} ms per launch, "
                    f"k={plan['k']} on {plan['ncta']} CTA(s) per problem, "
                    f"{plan['steps']} serial steps, "
                    f"{ms * 1e3 / plan['steps']:.4f} us per step")
            del want
        del bp
        torch.cuda.empty_cache()
    from spaln_tpu_torch import cli
    for mode, kept in _phase8_batches(TK, cli).items():
        each = [_timed(lambda bp=bp, prm=prm: TK.tron_forward(bp, prm), 2)
                for bp, prm in kept]
        name = "tron_forward_dagp" if mode == "yl3" else "tron_forward"
        out[f"{name} phase 8"] = dict(ms=sum(each), launches=len(each),
                                      each=each)
        log(f"tron timing: {name} on phase 8's {len(each)} batches: "
            f"{sum(each):.3f} ms in all "
            f"({', '.join(f'{x:.2f}' for x in each)})")
        del kept
        torch.cuda.empty_cache()
    return out


def ends_timing(K, dp, PC, probe, ctx, tctx) -> dict:
    """K2e alone and with K3, of the package under test, at four shapes:
    phase 1's bucket (B=8, W=1,152), the tetrapod-width bucket (B=32,
    W=16,384, S=12), a traced search hit (B=1) and a search score batch
    (B=64; K2e alone, as the score pass runs it).  Device ms (_launch_ms:
    every launch of the call between one pair of events, from a cold L2)
    and ms a wrapper call (call_ms) of K2e; of K2e then K3 (two launches) on
    the traced shapes; of the fused entry where the package has it; and
    the launch floor, probe_k0 (PC its module, probe its wrapper's).
    Every output held against its plain version."""
    fused = hasattr(K, "spliced_ends_tb_walk")
    x = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
    _equal("probe_k0", [probe.k0(x)], [probe.k0_plain(x)])
    out = {"launch floor": dict(ms=_launch_ms(PC, lambda: probe.k0(x), 50),
                                call_ms=_timed(lambda: probe.k0(x), 50))}
    log(f"launch floor (probe_k0): {out['launch floor']['ms']:.4f} ms on the "
        f"card, {out['launch floor']['call_ms']:.4f} ms a wrapper call")
    sbp, sprm = _protein_batch(dp)
    hbp, hprm = _protein_batch(dp, traced=True)
    shapes = (("phase 1", _phase1_bucket(dp, ctx), ctx.prm),
              ("tetrapod width", _tetrapod_width_bucket(dp, tctx), tctx.prm),
              ("search hit", hbp, hprm), ("score batch", sbp, sprm))
    for label, bp, prm in shapes:
        if label == "score batch":
            flags = spj = None
            row, rc = K.spliced_slab_score(bp, prm)
        else:
            flags, spj, row, rc = K.spliced_slab_trace(bp, prm)
        want = K.last_ends_plain(bp, prm, row, rc)
        _equal(f"spliced_last_ends ({label})",
               [K.spliced_last_ends(bp, prm, row, rc)], [want])
        e = lambda: K.spliced_last_ends(bp, prm, row, rc)
        _launch_ms(K, e, 20)      # a shape's first timing reads 1-3 us high
        r = dict(B=bp.B, Nmax=bp.Nmax, Mpad=bp.Mpad, ms=_launch_ms(K, e, 20),
                 call_ms=_timed(e, 20))
        out[f"spliced_last_ends {label}"] = r
        msg = (f"{label} (B={bp.B} Nmax={bp.Nmax} Mpad={bp.Mpad}): K2e "
               f"{r['ms']:.4f} ms on the card, {r['call_ms']:.4f} ms a "
               f"call")
        if flags is not None:
            recs_want = K.tb_walk_plain(bp, flags, spj, want)

            def pair():
                return K.spliced_tb_walk(bp, flags, spj,
                                         K.spliced_last_ends(bp, prm, row,
                                                             rc))
            _equal(f"K2e then K3 ({label})", [pair()], [recs_want])
            w2 = dict(ms=_launch_ms(K, pair, 20), call_ms=_timed(pair, 20))
            out[f"K2e then K3 {label}"] = w2
            msg += (f"; K2e then K3 {w2['ms']:.4f} ms on the card, "
                    f"{w2['call_ms']:.4f} ms a call")
            if fused:
                fn = lambda: K.spliced_ends_tb_walk(bp, prm, flags, spj,
                                                    row, rc)
                _equal(f"spliced_ends_tb_walk ({label})", list(fn()),
                       [want, recs_want])
                w1 = dict(ms=_launch_ms(K, fn, 20), call_ms=_timed(fn, 20))
                out[f"spliced_ends_tb_walk {label}"] = w1
                msg += (f"; fused {w1['ms']:.4f} ms on the card, "
                        f"{w1['call_ms']:.4f} ms a call")
        log(msg)
        del flags, spj, row, rc
    del shapes
    torch.cuda.empty_cache()
    return out


def walk_timing(K, dp, TK, TD) -> dict:
    """K3 and K8 alone, of the package under test: K3 on phase 1's bucket
    (3 and 5 states) and its slab-1 strips, and on the tetrapod-width
    bucket; K8 on phase 1's tron batch (3 and 5 states, Smith-Waterman
    local) and on each of phase 8's batches (default and -y l3, summed).
    Every walk but phase 8's is held against its plain version on the
    card.  Returns name -> ms a launch, serial steps, ns a step and,
    where the package has the tile model, tile loads a walk (the
    kernel's, held against the model's)."""
    from spaln_tpu_torch import cli
    from spaln_tpu_torch.align.driver import AlignerContext
    from spaln_tpu_torch.align.protein_driver import ProteinAlignerContext
    from spaln_tpu_torch.score.tables import TableDir, find_table_dir
    from spaln_tpu_torch.probes import _cuda as PC, pallas_probe
    out = {}
    clock = hasattr(K, "walk_stats")     # a package with the band kernels
    dict_tables = TableDir(find_table_dir(), species="Dictyost")
    ctx = AlignerContext.create(dict_tables, "cuda")
    ctx3 = AlignerContext.create(dict_tables, "cuda", y_args=["-yl3"])
    tctx = AlignerContext.create(TableDir(find_table_dir(),
                                          species="Tetrapod"), "cuda")
    out.update(ends_timing(K, dp, PC, pallas_probe, ctx, tctx))
    for label, c, bp in (("phase 1", ctx, _phase1_bucket(dp, ctx)),
                         ("phase 1 dagp", ctx3, _indel_bucket(dp, ctx3))):
        k1 = K.spliced_slab_trace(bp, c.prm)
        out.update(_k3_timing(K, bp, c.prm, k1, label, clock))
        se = K.spliced_last_ends(bp, c.prm, k1[2], k1[3])
        snap = K.spliced_slab_links(bp, c.prm)[1][1].contiguous()
        sel = torch.arange(bp.B, dtype=torch.int32, device="cuda")
        r1 = K.spliced_slab_retrace(bp, c.prm, 1, 1, snap, sel)
        starts = _end_strips(se, bp.L)
        IT = dp.strip_walk_bound(bp.L, bp.W)
        stats = torch.empty((starts.shape[0], 2), dtype=torch.int32,
                            device="cuda")
        fn = lambda: K.spliced_tb_strips(r1[0], r1[1], starts, bp.lws_t, 1,
                                         IT)
        rs = (K.spliced_tb_strips(r1[0], r1[1], starts, bp.lws_t, 1, IT,
                                  stats=stats)
              if hasattr(K, "walk_stats") else fn())
        _equal(f"spliced_tb_strips ({label})", [rs],
               [K.tb_strips_plain(r1[0], r1[1], starts, bp.lws_t, 1, IT)])
        r = _timed_walk(_k3_row(K, label, rs, stats,
                                *_strip_model(r1[0], bp.lws_t, starts, 1)),
                        fn, 20, K)
        out[f"spliced_tb_strips {label}"] = r
        log(f"{label}: spliced_tb_strips ({starts.shape[0]} strips): "
            f"{r['ms']:.4f} ms, {r['steps']} serial steps = "
            f"{r['ns_per_step']:.1f} ns a step")
        del k1, r1
    bp = _tetrapod_width_bucket(dp, tctx)
    out.update(_k3_timing(K, bp, tctx.prm, K.spliced_slab_trace(
        bp, tctx.prm), "tetrapod width", clock))
    del bp
    torch.cuda.empty_cache()
    tables = TableDir(find_table_dir(), species="Tetrapod")
    pctx = {dagp: ProteinAlignerContext.create(
        tables, "cuda", y_args=["-yl3"] if dagp else None)
        for dagp in (False, True)}
    bp = _tron_bucket(TD, pctx[False], True)
    for dagp in (False, True):
        planes, row, rc, loc = TK.tron_forward(bp, pctx[dagp].prm)
        et = _tron_ends(TD, bp, row, rc, loc)
        name = f"tron_walk phase 1{' dagp' if dagp else ''}"
        out[name] = r = _k8_timing(TK, bp, planes, et, name, check=True)
        if clock:
            st = torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
            recs, counts = TK.tron_walk(bp, planes, et, stats=st)
            r.update(_clock_k8(K, TD, bp, planes, et, recs, counts, st))
        log(f"{name} (B={bp.B} L={bp.L} W={bp.W} S={bp.S} T={bp.T}): "
            f"{r['ms']:.4f} ms, {r['records']} records"
            + (f", {r['steps']} serial steps = {r['ns_per_step']:.1f} ns a "
               f"step, {r['tile_loads']:.2f} tile loads a walk"
               if "steps" in r else "")
            + (f"; clocked: {r['cycles_step']:.0f} cycles a step outside "
               f"the loads, {r['cycles_load']:.0f} a load, latency floor "
               f"{r['floor_ms']:.5f} ms" if clock else ""))
        del planes
    for mode, kept in _phase8_batches(TK, cli).items():
        rows = []
        for bp, prm in kept:
            planes, row, rc, loc = TK.tron_forward(bp, prm)
            rows.append(_k8_timing(TK, bp, planes,
                                   _tron_ends(TD, bp, row, rc, loc),
                                   f"phase 8 {mode}", check=False))
            del planes
        name = f"tron_walk phase 8 {mode}"
        out[name] = dict(ms=sum(r["ms"] for r in rows), launches=len(rows),
                         each=rows)
        log(f"{name}: {out[name]['ms']:.3f} ms in {len(rows)} launches: "
            + ", ".join(f"{r['ms']:.3f} ms" + (f" ({r['steps']} steps, "
                                               f"{r['ns_per_step']:.0f} ns)"
                                               if "steps" in r else "")
                        for r in rows))
        del kept
        torch.cuda.empty_cache()
    return out


def _clocked_source(K) -> str:
    """The two walk kernels of the package's csrc/ with clock64() around
    each band's load and over the whole walk (a __device__ array of
    (cycles, load cycles) per walk), and an entry each that launches,
    synchronizes and copies the array out."""
    sp = (K.CSRC / "spliced_dp.cu").read_text()
    tr = (K.CSRC / "tron_dp.cu").read_text()
    # K3 alone: the walk body, tb_walk_kernel and its launch (without the
    # fused entry, in a checkout that has one)
    end = sp.index("// One launch of the slab kernel")
    fused = sp.find("// spliced_ends_tb_walk: K2e as the prologue")
    k3 = sp[sp.index("constexpr int TB_CELLS"):end]
    if fused >= 0:
        k3 = (sp[sp.index("constexpr int TB_CELLS"):fused]
              + sp[sp.index("int tb_walk_entry(", fused):end])
    k3_head = ("const int lane = threadIdx.x;" if fused >= 0
               else "const int w = blockIdx.x, lane = threadIdx.x;")
    k8 = tr[tr.index("constexpr int TW_CELLS"):
            tr.index("// One launch of K7")]
    a = tr.index("constexpr int DEAD = 0")
    consts = tr[a:tr.index(";", a) + 1]

    def clocked(k, w, head, tail):
        k = re.sub(r"__syncwarp\(\); +// every lane is off the old band",
                   "const long long c0 = clock64(); __syncwarp();", k, 1)
        k = k.replace("++loads;", "++loads; lc += clock64() - c0;", 1)
        k = k.replace(head, head + " long long lc = 0; const long long "
                      "t0 = clock64();", 1)
        k = k.replace(tail, f"if (lane == 0) {{ g_clk[{w} * 2] = clock64() "
                      f"- t0; g_clk[{w} * 2 + 1] = lc; }}\n" + tail, 1)
        if k.count("clock64") != 4:
            raise AssertionError("the walk kernels' source moved")
        return k
    return ("#include <cuda_runtime.h>\n#include <stdint.h>\n"
            "__device__ long long g_clk[1 << 16];\nnamespace {\n" + consts
            + "\n" + clocked(k3, "w", k3_head, "  if (stats && lane == 0) {")
            + "\n" + clocked(k8, "b", "const int b = blockIdx.x, lane = "
                             "threadIdx.x;", "  if (lane == 0) {\n"
                             "    counts[b] = cnt;")
            + "\n}\n" + """extern "C" {
int clocked_tb_walk(const unsigned char* flags, const int* spj,
                    const int* ends, const int* lws, int B, int L, int S,
                    int T, int IT, int NS, int* recs, long long* clk) {
  int e = tb_walk_entry(flags, spj, ends, nullptr, lws, B, B, L, S, T, IT,
                        NS, 0, recs, nullptr, 0);
  if (e || (e = (int)cudaDeviceSynchronize())) return e;
  return (int)cudaMemcpyFromSymbol(clk, g_clk, sizeof(long long) * 2 * B);
}
int clocked_tron_walk(const unsigned char* fl, const int* spj,
                      const signed char* php, const int* meta,
                      const int* ends, int* recs, int* counts, int* done,
                      int B, int S, int T, int L, int NN, int IT, int NM,
                      int NR, long long* clk) {
  tron_walk_kernel<<<B, 32>>>(fl, spj, php, meta, ends, recs, counts, done,
                              B, S, T, L, NN, IT, NM, NR, nullptr);
  int e = (int)cudaGetLastError();
  if (e || (e = (int)cudaDeviceSynchronize())) return e;
  return (int)cudaMemcpyFromSymbol(clk, g_clk, sizeof(long long) * 2 * B);
}
}
""")


@functools.lru_cache(maxsize=1)
def _clocked_library(K):
    """The clocked walks, built with nvcc (smoke_work/walk_clock/)."""
    import ctypes
    d = WORK / "walk_clock"
    d.mkdir(parents=True, exist_ok=True)
    src = d / "walk_clock.cu"
    src.write_text(_clocked_source(K))
    return ctypes.CDLL(str(K.build_library(src)[0]))


def _walk_cycles(clk: torch.Tensor, stats: torch.Tensor) -> dict:
    """The slowest walk's split of the clocked run: cycles a step outside
    the loads and cycles a load (SM clocks, clock64()), and the latency
    floor: the longest walk's serial steps at that step's cycles (ms at
    the card's SM clock)."""
    c = clk.view(-1, 2).tolist()
    st = stats.cpu().tolist()
    w = max(range(len(c)), key=lambda k: c[k][0])
    (tot, lc), (steps, loads) = c[w], st[w]
    step = (tot - lc) / max(steps, 1)
    khz = torch.cuda.get_device_properties(0).clock_rate
    return dict(cycles_step=step, cycles_load=lc / max(loads, 1),
                cycles_walk=tot,
                floor_ms=max(x[0] for x in st) * step / khz)


def _clock_k3(K, bp, flags, spj, se, recs, stats) -> dict:
    import ctypes
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _clocked_library(K)
    got = torch.zeros_like(recs)
    clk = torch.zeros(2 * bp.B, dtype=torch.int64)
    rc = lib.clocked_tb_walk(P(flags), P(spj), P(se), P(bp.lws_t), bp.B,
                             bp.L, bp.S, bp.T, bp.IT, spj.shape[1], P(got),
                             ctypes.c_void_p(clk.data_ptr()))
    if rc or not torch.equal(got, recs):
        raise AssertionError(f"the clocked K3 differs ({rc})")
    return _walk_cycles(clk, stats)


def _clock_k8(K, TD, bp, planes, et, recs, counts, stats) -> dict:
    import ctypes
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _clocked_library(K)
    got = torch.empty_like(recs)
    n = torch.empty_like(counts)
    done = torch.empty_like(counts)
    clk = torch.zeros(2 * bp.B, dtype=torch.int64)
    fl, spj, php = planes
    rc = lib.clocked_tron_walk(P(fl), P(spj), P(php), P(bp.meta), P(et),
                               P(got), P(n), P(done), bp.B, bp.S, bp.T,
                               bp.L, fl.shape[3], bp.IT, TD.N_META,
                               TD.N_REC, ctypes.c_void_p(clk.data_ptr()))
    if rc or not torch.equal(n, counts) or not all(
            torch.equal(got[b, :c], recs[b, :c])
            for b, c in enumerate(counts.tolist())):
        raise AssertionError(f"the clocked K8 differs ({rc})")
    return _walk_cycles(clk, stats)


def _k8_timing(TK, bp, planes, et, label: str, check: bool) -> dict:
    """K8 on a batch's planes: ms a launch (5 launches) and, where the
    package has the tile model, serial steps, ns a step and tile loads a
    walk (held against the model's); with ``check``, the records against
    its plain version on the card."""
    new = hasattr(TK, "tron_walk_stats")
    stats = (torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
             if new else None)
    recs, counts = (TK.tron_walk(bp, planes, et, stats=stats) if new
                    else TK.tron_walk(bp, planes, et))
    if check:
        r, _ = _tron_walk_check(TK, label, bp, planes, et, recs, counts,
                                stats)
    else:
        r = {}
        if new:
            want = TK.tron_walk_stats(bp, planes[0], et, recs, counts)
            if not torch.equal(stats.cpu(), want):
                raise AssertionError(f"tron_walk ({label}): steps and tile "
                                     f"loads differ from the model's")
            r = _walk_keys(stats)
    r["records"] = int(counts.sum())
    fn = lambda: TK.tron_walk(bp, planes, et)
    r["ms"] = _launch_ms(TK, fn, 5)
    r["call_ms"] = _timed(fn, 5)
    if "steps" in r:
        r["ns_per_step"] = r["ms"] * 1e6 / r["steps"]
    return r


# ----------------------------------------------------------- the probes
PROBE_T_CHECK = 256           # steps of the kernel-vs-plain check


def check_probes(PC, mods, threads, dev=torch.device("cuda")) -> dict:
    """Every step probe's kernel (csrc/probes.cu) against its plain
    version on the card, PROBE_T_CHECK steps on the script's inputs, at
    each of ``threads``: exactly equal (integer carries).  Returns
    "entry:body" -> max_abs_err, plain ms and the kernel's ms at 128
    threads, at PROBE_T_CHECK steps; raises naming every body that
    differs."""
    out, bad = {}, []
    t0 = time.perf_counter()
    for m in mods:
        for c in m.cases(dev):
            got = []
            plain_ms = PC.elapsed_ms(
                lambda: got.append(c.plain(PROBE_T_CHECK)), dev)
            err = max(_max_abs_err(c.run(PROBE_T_CHECK, th), got[0])
                      for th in threads)
            key = f"{c.entry}:{c.body}"
            if err:
                bad.append(f"{key} ({err})")
            ms = PC.elapsed_ms(lambda: c.run(PROBE_T_CHECK, 128), dev)
            out[key] = dict(max_abs_err=err, plain_ms=plain_ms, ms=ms)
    if bad:
        raise AssertionError(f"probe kernels differ from their plain "
                             f"versions: {', '.join(bad)}")
    log(f"probes: {len(out)} bodies equal to their plain versions at "
        f"T={PROBE_T_CHECK}, threads {threads} "
        f"({time.perf_counter() - t0:.1f} s)")
    return out


def probe_phase(PC, mods, checked: dict, threads, reps: int = 1,
                dev=torch.device("cuda")) -> dict:
    """The step probes' main path: each module's measure (what its main
    prints) at its script's T and 2T at ``threads``, the launch counts
    set to 0 just before and read just after; then each body's kernels
    row (ms at the script's T at 128 threads, its bound there, the
    plain version's ms at PROBE_T_CHECK steps) and the sweep."""
    PC.reset_counts()
    t0 = time.perf_counter()
    sweeps = {m.ENTRY: m.measure(m.T_DEFAULT, dev, threads, reps)
              for m in mods}
    wall = time.perf_counter() - t0
    counts = dict(PC.launches)
    rows = {}
    for m in mods:
        for c in m.cases(dev):
            key = f"{c.entry}:{c.body}"
            T = m.T_DEFAULT if c.stepped else 1
            bound, by = _bound(c.nbytes, c.ops * T)
            ms = (sweeps[m.ENTRY][c.body][128][1] if c.stepped
                  else checked[key]["ms"])
            rows[key] = dict(checked[key], ms=ms, bound_ms=bound,
                             bound_by=by, launches=counts.get(key, 0),
                             steps=T, plain_steps=PROBE_T_CHECK
                             if c.stepped else 1)
            if c.stepped:
                ns = "  ".join(f"{th // 32}w {v[0]:9.2f}" for th, v in
                               sweeps[m.ENTRY][c.body].items())
                log(f"probe {key}: T={T} ns a step: {ns}; t(T) at 4 "
                    f"warps {ms:.3f} ms, bound {bound:.5f} ms ({by}), "
                    f"launches {rows[key]['launches']}")
    log(f"probes: the sweep took {wall:.1f} s")
    return {"rows": rows, "sweeps": sweeps}


def _ptxas_summary(text: str) -> str:
    """Instances, the most registers a thread and any spill in nvcc's
    -Xptxas -v log."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = [ln.strip() for ln in text.splitlines()
              if "spill" in ln and not re.search(r"\b0 bytes spill stores, "
                                                 r"0 bytes spill loads", ln)]
    return (f"{len(regs)} instances, at most {max(regs, default=0)} "
            f"registers, {len(spills)} spilling")


def probe_timing() -> dict:
    """--probe-timing: the probe library, the skeletons' (csrc/
    mosaic_repro.cu) and the production slab library and its knock-out
    builds (ablate_pallas.BUILDS), one nvcc each, all at once, with
    each probe instance's and each build's score-mode instances' SASS
    instructions, registers and spills; every probe body against its
    plain version at all four thread counts; the full sweep (3
    repetitions); the knock-outs on the bench batch of
    scripts/ablate_pallas.py, the "none" build held equal to the
    production kernel and the production one to its plain version, and
    the batch's bound; then the builds of time_kernel_pieces and
    bisect_mosaic (SLAB_ABLATE 9-17, and k = 1, 2, 4 on the production
    build) on the same batch, each launched on bisect_mosaic's batch, and
    each mosaic_repro level's ns a step at 7, 14 and 28 chunks (a
    checkout without those modules skips them)."""
    from concurrent.futures import ThreadPoolExecutor
    from spaln_tpu_torch import probes
    from spaln_tpu_torch.probes import _cuda as PC, ablate_pallas as AB
    from spaln_tpu_torch.ops.dp_spliced_cuda import build_library
    # a checkout from before the skeletons and the variant tables
    # (--package-root) has neither
    pieces = (Path(AB.__file__).parent / "mosaic_repro.py").exists()
    if pieces:
        from spaln_tpu_torch.probes import (bisect_mosaic as BM,
                                            mosaic_repro as MR,
                                            time_kernel_pieces as TKP)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        fut = pool.submit(AB.build_all, AB.BUILDS) if pieces else \
            pool.submit(AB.build_all)
        skel = pool.submit(build_library, MR.SOURCE) if pieces else None
        so, secs, ptxas = build_library(PC.SOURCE)
        slabs = {n: v[:2] for n, v in fut.result().items()}
        if skel:
            sk_so, sk_secs, sk_ptxas = skel.result()
            log(f"skeletons: {sk_so.name} nvcc {sk_secs:.1f} s "
                f"({_ptxas_summary(sk_ptxas)}); SASS (all, the loop) "
                f"{_sass(sk_so)[0]}")
    log(f"probes + slab knock-outs built in {time.perf_counter() - t0:.1f} "
        f"s: {so.name} nvcc {secs:.1f} s ({_ptxas_summary(ptxas)}); "
        + ", ".join(f"{n} {v[1]:.1f} s" for n, v in slabs.items()))
    # what nvcc made of each probe instance and of each build's score
    # mode (slab_kernel<2,...>)
    counts, listing = _sass(so)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probes.sass").write_text(listing)
    inst = _ptxas_instances(ptxas)
    sass = {"probes": {k: dict(v, sass=counts.get(k))
                       for k, v in inst.items()}}
    for k, v in inst.items():
        if v["spill"]:
            log(f"probes: {k} spills {v['spill']} bytes ({v['regs']} "
                f"registers)")
    for n, (lib, _) in slabs.items():
        c, _ = _sass(lib)
        sass[n] = {k: v for k, v in c.items()
                   if k.startswith("slab_kernel<2,")}
        log(f"SASS of {n}'s score-mode instances: {sass[n]}")
    mods = probes.modules()
    checked = check_probes(PC, mods, PC.THREADS)
    res = probe_phase(PC, mods, checked, PC.THREADS, reps=3)
    bp, prm = AB.bench_batch(device="cuda")
    ab = AB.ablate(bp, prm, reps=3)
    AB.report(ab, bp)
    # the production step's plain version on the bench batch, and the
    # bound of the batch's score-only forward
    from spaln_tpu_torch.ops import dp_spliced_cuda as K
    want, ab["plain_ms"] = _plain_ms(lambda: K.slab_score_plain(bp, prm))
    ab["max_abs_err"] = _equal("spliced_slab_score (bench batch)",
                               K.spliced_slab_score(bp, prm), want)
    cells, acc, don = _dp_cells(bp, range(bp.S))
    ab["bound_ms"], ab["bound_by"] = _bound(
        _operand_bytes(bp) + 4 * bp.B * (bp.Nmax + 1 + bp.Mpad + 1),
        cells * OPS_CELL + acc * OPS_ACC + don * OPS_DON)
    log(f"ablate: the production step equals its plain version "
        f"({ab['plain_ms']:.1f} ms); bound {ab['bound_ms']:.4f} ms "
        f"({ab['bound_by']}: {cells} band cells, {acc} acceptor and {don} "
        f"donor cells)")
    out = {"probes": res["sweeps"], "rows": res["rows"], "ablate": ab,
           "sass": sass}
    if pieces:
        out.update(pieces_timing(AB, TKP, BM, MR, bp, prm))
    return out


def pieces_timing(AB, TKP, BM, MR, bp, prm) -> dict:
    """--probe-timing's builds of time_kernel_pieces and bisect_mosaic
    (SLAB_ABLATE 9-17) and time_kernel_pieces' forced k on the bench
    batch (each held as ablate_pallas.ablate holds them) and each build
    on bisect_mosaic's batch, and each skeleton level's ns a step at 7,
    14 and 28 chunks."""
    from spaln_tpu_torch.probes._cuda import elapsed_ms
    new = [b for b in AB.BUILDS if b not in AB.KNOCKOUTS]
    t = AB.ablate(bp, prm, new, TKP.TILINGS, reps=3)["knockouts"]
    for name, r in t.items():
        log(f"pieces: {name:16s} {r['ms']:9.3f} ms  {r['steps']} serial "
            f"steps  {r['ns_per_step']:8.1f} ns a serial step  saves "
            f"{r['saves_ns']:8.1f}")
    del bp
    torch.cuda.empty_cache()
    sb, sprm = BM.bisect_batch("cuda")
    bis = BM.bisect(sb, sprm, list(BM.VARIANTS))
    log("bisect_mosaic: " + ", ".join(f"{v} {r.split(' |')[0]}"
                                      for v, r in bis.items()))
    if any(r.startswith("FAIL") for r in bis.values()):
        raise AssertionError(f"bisect_mosaic: {bis}")
    dev = torch.device("cuda")
    steps = {}
    for lev in MR.LEVELS:
        B = MR.script_B(lev)
        ms = []
        for ch in SKELETON_CHUNKS:
            a = MR.level_inputs(lev, MR.inputs(B, ch), dev)
            MR.run(lev, a, ch)                     # loads the instance
            ms.append(elapsed_ms(lambda: MR.run(lev, a, ch), dev, 5))
        ns = [(ms[i + 1] - ms[i]) / (MR.CHUNK * (SKELETON_CHUNKS[i + 1]
                                                 - SKELETON_CHUNKS[i])) * 1e6
              for i in range(len(ms) - 1)]
        steps[lev] = dict(ms=ms, ns_per_step=ns)
        log(f"skeleton level {lev:2d} (B={B}): ms at {SKELETON_CHUNKS} "
            f"chunks {', '.join(f'{x:.4f}' for x in ms)}; ns a step "
            f"{', '.join(f'{x:.2f}' for x in ns)}")
    return {"pieces": t, "bisect": bis, "skeleton_steps": steps}


# -------------------------------------------------------------- phase 10
SKELETON_CHUNKS = (7, 14, 28)     # --probe-timing's lengths, in chunks


def check_skeletons(MR, dev=torch.device("cuda")) -> dict:
    """Phase 10, the skeletons: every mosaic_repro level's kernel against
    its plain version on the card at the script's inputs and shapes, all
    four outputs exactly equal; then, the launch counts set to 0 just
    before and read just after, each level as the module's main measures
    it (ms at 7 chunks and at 14: ns a step).  Returns level -> its
    kernels row."""
    rows, bad = {}, []
    t0 = time.perf_counter()
    for lev in MR.LEVELS:
        B = MR.script_B(lev)
        a = MR.level_inputs(lev, MR.inputs(B), dev)
        want, plain_ms = _plain_ms(lambda: MR.plain(lev, a))
        err = max(_max_abs_err(x, y) for x, y in zip(MR.run(lev, a), want))
        if err:
            bad.append(f"level {lev} ({err})")
        bound, by = _bound(*MR.bound_work(lev, a, MR.N_CHUNKS))
        rows[lev] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, B=B)
    if bad:
        raise AssertionError(f"skeleton kernels differ from their plain "
                             f"versions: {', '.join(bad)}")
    MR.reset_counts()
    for lev, r in rows.items():
        ns, r["ms"], _ = MR.step_ns(
            lev, lambda ch, lev=lev, B=r["B"]: MR.level_inputs(
                lev, MR.inputs(B, ch), dev), MR.N_CHUNKS, dev)
        r["ns_per_step"] = ns
    counts = dict(MR.launches)
    for lev, r in rows.items():
        r["launches"] = counts.get(f"level{lev}", 0)
        log(f"skeleton level {lev:2d} (B={r['B']}): equal to its plain "
            f"version ({r['plain_ms']:.1f} ms); {r['ms']:.4f} ms at "
            f"{MR.N_CHUNKS} chunks, {r['ns_per_step']:.2f} ns a step, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), launches "
            f"{r['launches']}")
    log(f"skeletons: {len(rows)} levels in {time.perf_counter() - t0:.1f} s")
    return rows


def bench_phase(K) -> dict:
    """Phase 10, the bench: spaln_tpu_torch.bench's workload (bench.py's
    batch: B=256, M=512, W=4,096, L=128), the launch counts set to 0 just
    before and read just after: GCUPS with the spread, the scores held
    against the plain version's on the card (bench.measure holds the
    score launch's (row, rc) equal to the plain version's: max_abs_err),
    and the score launch's bound."""
    from spaln_tpu_torch import bench
    t0 = time.perf_counter()
    bp, prm = bench.bench_batch(device="cuda")
    _reset_counts(K)
    res = bench.measure(bp, prm)
    launches = K.launches["spliced_slab_score"]
    cells, acc, don = _dp_cells(bp, range(bp.S))
    bound, by = _bound(
        _operand_bytes(bp) + 4 * bp.B * (bp.Nmax + 1 + bp.Mpad + 1),
        cells * OPS_CELL + acc * OPS_ACC + don * OPS_DON)
    line = {k: res[k] for k in ("metric", "value", "unit", "repeats",
                                "spread_gcups", "device")}
    log(f"bench: {json.dumps(line)}; median {res['ms']:.3f} ms a run "
        f"(launch and synchronize), (row, rc) equal to the plain "
        f"version's (max_abs_err {res['max_abs_err']}) and so its scores "
        f"({res['plain_ms']:.1f} ms), bound {bound:.4f} ms ({by}), "
        f"{launches} score launches ({time.perf_counter() - t0:.1f} s)")
    return dict(max_abs_err=res["max_abs_err"], ms=res["ms"],
                plain_ms=res["plain_ms"],
                bound_ms=bound, bound_by=by, launches=launches,
                gcups=res["value"], spread_gcups=res["spread_gcups"])


# --------------------------------------------------------------- phase 2
def small_map(K, cli):
    """4 planted genes: kernels vs plain versions, byte for byte."""
    rng = np.random.default_rng(SEED + 1)
    contig = _seq(rng, 36000, 0.3)
    recs, recs_j, pos = [], [], 3000
    for i in range(4):
        ex = [_seq(rng, int(rng.integers(90, 160)), 0.35)
              for _ in range(2 + i % 2)]
        g = ex[0]
        for e in ex[1:]:
            g += "GTAAGT" + _seq(rng, int(rng.integers(67, 387)), 0.2) \
                + "TTTCTAG" + e
        if i % 3 == 2:
            g = _revcomp(g)
        contig = contig[:pos] + g + contig[pos + len(g):]
        recs.append(f">q{i}\n{''.join(ex)}\n")
        # the same cDNA with junction records (phase 11): at its exon-exon
        # junctions, one of them off by one
        junc = np.cumsum([len(e) for e in ex[:-1]]) + (i == 1)
        recs_j.append(f">q{i}\n;B {len(junc)} {len(junc)}\n;b "
                      + " ".join(f"{p} {1 + i % 3}" for p in junc)
                      + f"\n{''.join(ex)}\n")
        pos += len(g) + 2500
    d = WORK / "small"
    d.mkdir(parents=True)
    (d / "g.fa").write_text(">c1\n" + contig + "\n")
    (d / "q.fa").write_text("".join(recs))
    (d / "q_j.fa").write_text("".join(recs_j))
    cli.main(["index", str(d / "g.fa"), "-p", str(d / "g")])
    texts = {}
    for mode in ("kernels", "plain"):
        ctxm = plain_on_card(K) if mode == "plain" else contextlib.nullcontext()
        with ctxm:
            for fmt in ("0", "4"):
                o = OUT / f"small.{mode}.O{fmt}"
                cli.main(["map", str(d / "q.fa"), "-d", str(d / "g"), "-O",
                          fmt, "-o", str(o), "--device", "cuda"])
                texts[mode, fmt] = o.read_bytes()
    for fmt in ("0", "4"):
        if texts["kernels", fmt] != texts["plain", fmt]:
            raise AssertionError(f"small map -O{fmt}: kernels and plain "
                                 f"versions differ")
    n_genes = texts["kernels", "0"].count(b"\tgene\t")
    if n_genes != 4:
        raise AssertionError(f"small map reported {n_genes} of 4 genes")
    log(f"small map: -O0 and -O4 byte-identical, kernels vs plain on the "
        f"card ({len(texts['kernels', '0'])} + "
        f"{len(texts['kernels', '4'])} bytes)")


# --------------------------------------------------------------- phase 3
CHROMS = (4.9e6, 8.5e6, 6.4e6, 5.4e6, 5.1e6, 3.6e6)


def make_corpus(d: Path):
    """Synthetic dictdisc-scale deployment: 6 chromosomes (~34 Mb, GC
    ~22%), 200 genes planted on both strands (2-5 exons of 80-600 nt,
    GT..AG introns of 70-400 nt), cDNA queries from the exons with ~1%
    substitutions.  Returns the planted truth per query."""
    rng = np.random.default_rng(SEED + 2)
    lens = [int(x) for x in CHROMS]
    chroms = [np.array(list("ACGT"), dtype="S1")[
        rng.choice(4, n, p=[0.39, 0.11, 0.11, 0.39])] for n in lens]
    truth, queries, taken = [], [], [[] for _ in lens]
    p_chrom = np.asarray(lens, float) / sum(lens)
    while len(truth) < 200:
        c = int(rng.choice(len(lens), p=p_chrom))
        ex = [_seq(rng, int(rng.integers(80, 601)), 0.3)
              for _ in range(int(rng.integers(2, 6)))]
        parts, spans, at = [], [], 0
        for j, e in enumerate(ex):
            spans.append((at, at + len(e)))
            parts.append(e)
            at += len(e)
            if j < len(ex) - 1:
                intr = _intron(rng, int(rng.integers(70, 401)))
                parts.append(intr)
                at += len(intr)
        g = "".join(parts)
        pos = int(rng.integers(5000, lens[c] - len(g) - 5000))
        if any(pos < b + 5000 and a < pos + len(g) + 5000
               for a, b in taken[c]):
            continue
        taken[c].append((pos, pos + len(g)))
        strand = "+" if len(truth) % 2 == 0 else "-"
        if strand == "-":
            g = _revcomp(g)
            spans = [(len(g) - b, len(g) - a) for a, b in spans][::-1]
        chroms[c][pos:pos + len(g)] = np.array(list(g), dtype="S1")
        qn = f"q{len(truth):03d}"
        truth.append(dict(q=qn, chrom=f"chr{c + 1}", strand=strand,
                          span=(pos, pos + len(g)),
                          exons={(pos + a + 1, pos + b) for a, b in spans}))
        queries.append(f">{qn}\n{_mutate(rng, ''.join(ex), 0.01)}\n")
    with open(d / "genome.fa", "wb") as fh:
        for c, arr in enumerate(chroms):
            fh.write(f">chr{c + 1}\n".encode())
            body = arr.tobytes()
            for k in range(0, len(body), 80):
                fh.write(body[k:k + 80] + b"\n")
    (d / "cdna.fa").write_text("".join(queries))
    return truth


def full_map(K, cli, metrics):
    d = WORK / "full"
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    truth = make_corpus(d)
    log(f"full map: corpus built in {time.perf_counter() - t0:.1f} s "
        f"({sum(CHROMS) / 1e6:.1f} Mb, {len(truth)} planted genes)")
    t0 = time.perf_counter()
    cli.main(["index", str(d / "genome.fa"), "-p", str(d / "genome")])
    log(f"full map: index built in {time.perf_counter() - t0:.1f} s")
    metrics.reset()
    _reset_counts(K)
    out = OUT / "full.O0_4"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["map", str(d / "cdna.fa"), "-d", str(d / "genome"),
              "-T", "Dictyost", "-O", "0,4", "-o", str(out),
              "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    buckets = metrics.counters.get("device_buckets", 0)
    if (buckets < 1 or any(launches[k] != buckets for k in K.PLANE_PATH)
            or launches["spliced_last_ends"] or launches["spliced_tb_walk"]):
        raise AssertionError(f"launches {launches}: expected K1 and the "
                             f"fused K2e + K3 once a bucket ({buckets})")
    log(f"full map: {buckets} plane buckets, two launches each: "
        f"{ {k: launches[k] for k in K.PLANE_PATH} }")
    if any(K.plain_calls.values()):
        raise AssertionError(f"plain versions ran: {K.plain_calls}")
    _check_no_skips(metrics, "full map")
    # first reported gene per query (GFF3 gene lines), exon table rows
    best, exons = {}, {}
    for line in out.read_text().splitlines():
        f = line.split("\t")
        if len(f) == 9 and f[2] == "gene":
            q = f[8].split("Name=")[1]
            best.setdefault(q, (f[0], f[6], int(f[3]), int(f[4])))
        elif len(f) == 14:
            exons.setdefault(f[0], set()).add((int(f[5]), int(f[6])))
    hit = tp = n_true = n_rep = 0
    for t in truth:
        b = best.get(t["q"])
        if (b and b[0] == t["chrom"] and b[1] == t["strand"]
                and b[2] <= t["span"][1] and b[3] > t["span"][0]):
            hit += 1
        rep = exons.get(t["q"], set())
        tp += len(rep & t["exons"])
        n_true += len(t["exons"])
        n_rep += len(rep)
    frac = hit / len(truth)
    secs = {k: round(v, 3) for k, v in metrics.timings.items()}
    cells = metrics.counters.get("dp_cells", 0)
    dev = metrics.timings.get("device_dp", 0.0)
    log(f"full map: {len(truth)} queries in {wall:.2f} s = "
        f"{len(truth) / wall:.2f} queries/s; {buckets} buckets; "
        f"stage seconds {json.dumps(secs, sort_keys=True)}")
    log(f"full map: dp_cells {cells} (band cells), device_dp "
        f"{dev:.3f} s -> {cells / max(dev, 1e-9) / 1e9:.3f} GCUPS")
    log(f"full map: {hit}/{len(truth)} = {100 * frac:.1f}% at the planted "
        f"locus and strand; exon recall {tp / max(n_true, 1):.4f}, "
        f"precision {tp / max(n_rep, 1):.4f}; -O0,4 text md5 "
        f"{_check_md5('dictdisc map', out)}")
    if frac < 0.95:
        raise AssertionError(f"only {100 * frac:.1f}% of queries at their "
                             f"planted locus and strand")
    return launches


# --------------------------------------------------------------- phase 4
TETRA_CHROMS = (20e6, 16e6, 12e6)


def _gene_parts(rng, n_exons, intron_len, exon_gc=0.5, intron_gc=0.38):
    """Exons of 60-300 nt joined by GT..AG introns of the given lengths;
    returns (genomic string, exon spans in it, exon strings)."""
    ex = [_seq(rng, int(rng.integers(60, 301)), exon_gc)
          for _ in range(n_exons)]
    parts, spans, at = [], [], 0
    for j, e in enumerate(ex):
        spans.append((at, at + len(e)))
        parts.append(e)
        at += len(e)
        if j < n_exons - 1:
            n = intron_len(j)
            intr = "GTAAGT" + _seq(rng, n - 12, intron_gc) + "TTTCAG"
            parts.append(intr)
            at += len(intr)
    return "".join(parts), spans, ex


def _plant(rng, chrom, pos, g, spans, strand):
    if strand == "-":
        g = _revcomp(g)
        spans = [(len(g) - b, len(g) - a) for a, b in spans][::-1]
    chrom[pos:pos + len(g)] = np.array(list(g), dtype="S1")
    return {(pos + a + 1, pos + b) for a, b in spans}


def _write_fasta(path: Path, names, arrays) -> None:
    with open(path, "wb") as fh:
        for name, arr in zip(names, arrays):
            fh.write(f">{name}\n".encode())
            body = arr.tobytes()
            for k in range(0, len(body), 80):
                fh.write(body[k:k + 80] + b"\n")


def make_tetrapod_corpus(d: Path):
    """Synthetic tetrapod-shaped deployment: 3 chromosomes (~48 Mb, GC
    ~41%), 48 genes planted on both strands with 4-10 exons of 60-300 nt
    and GT..AG introns log-uniform over 0.5-20 kb (intron GC ~38%), cDNA
    queries from the exons with 1% substitutions.  Returns the planted
    truth per query."""
    rng = np.random.default_rng(SEED + 3)
    lens = [int(x) for x in TETRA_CHROMS]
    chroms = [np.array(list("ACGT"), dtype="S1")[
        rng.choice(4, n, p=[0.295, 0.205, 0.205, 0.295])] for n in lens]
    truth, queries, taken = [], [], [[] for _ in lens]
    p_chrom = np.asarray(lens, float) / sum(lens)
    lo, hi = np.log(500), np.log(20_000)
    while len(truth) < 48:
        c = int(rng.choice(len(lens), p=p_chrom))
        g, spans, ex = _gene_parts(
            rng, int(rng.integers(4, 11)),
            lambda j: int(np.exp(rng.uniform(lo, hi))))
        pos = int(rng.integers(20_000, lens[c] - len(g) - 20_000))
        if any(pos < b + 20_000 and a < pos + len(g) + 20_000
               for a, b in taken[c]):
            continue
        taken[c].append((pos, pos + len(g)))
        strand = "+" if len(truth) % 2 == 0 else "-"
        exons = _plant(rng, chroms[c], pos, g, spans, strand)
        qn = f"t{len(truth):02d}"
        truth.append(dict(q=qn, chrom=f"chr{c + 1}", strand=strand,
                          span=(pos, pos + len(g)), exons=exons))
        queries.append(f">{qn}\n{_mutate(rng, ''.join(ex), 0.01)}\n")
    _write_fasta(d / "genome.fa", [f"chr{c + 1}" for c in range(len(lens))],
                 chroms)
    (d / "cdna.fa").write_text("".join(queries))
    return truth


def _score_text(text: str, truth: list):
    """(queries at their planted locus and strand, exon recall, exon
    precision) of -O0,4 text: the first gene line per query, exon rows."""
    best, exons = {}, {}
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) == 9 and f[2] == "gene":
            q = f[8].split("Name=")[1]
            best.setdefault(q, (f[0], f[6], int(f[3]), int(f[4])))
        elif len(f) == 14:
            exons.setdefault(f[0], set()).add((int(f[5]), int(f[6])))
    hit = tp = n_true = n_rep = 0
    missed = []
    for t in truth:
        b = best.get(t["q"])
        if (b and b[0] == t["chrom"] and b[1] == t["strand"]
                and b[2] <= t["span"][1] and b[3] > t["span"][0]):
            hit += 1
        else:
            missed.append(t["q"])
        rep = exons.get(t["q"], set())
        tp += len(rep & t["exons"])
        n_true += len(t["exons"])
        n_rep += len(rep)
    return hit, tp / max(n_true, 1), tp / max(n_rep, 1), missed


def _check_no_skips(metrics, label: str) -> None:
    """No query was skipped by per-query isolation (a skipped query has
    no result, and the run would still exit 0)."""
    n = metrics.counters.get("skipped_queries", 0)
    if n:
        raise AssertionError(f"{label}: {n} queries skipped")


def _retraces(n, dagp: bool = False) -> int:
    """Retrace launches in the launch counts n, of runs and of pairs (a
    checkout from before the pairs has none)."""
    d = "_dagp" if dagp else ""
    return (n.get("spliced_slab_retrace" + d, 0)
            + n.get("spliced_slab_retrace_pairs" + d, 0))


def _check_udh_kernels(K, metrics, label: str) -> None:
    """Every UDH bucket ran on K4, K2e, K1 retrace (of runs, or of pairs
    after a K6 links pass) and K3 strip, every plane bucket (or align
    window) on K1 and the fused K2e + K3; no plain version ran; no query
    was skipped."""
    _check_no_skips(metrics, label)
    udh = metrics.counters.get("udh_buckets", 0)
    planes = metrics.counters.get("device_buckets", 0)
    n = K.launches
    if udh and not (n["spliced_slab_links"] >= udh
                    and n["spliced_tb_strips"] == _retraces(n) >= udh):
        raise AssertionError(f"{label}: {udh} UDH buckets, launches "
                             f"{dict(n)}")
    if (n["spliced_last_ends"] != n["spliced_slab_links"]
            or not n["spliced_ends_tb_walk"] == n["spliced_slab_trace"]
            >= planes or n["spliced_tb_walk"]):
        raise AssertionError(f"{label}: {planes} plane buckets, launches "
                             f"{dict(n)}: expected K2e once a links launch "
                             f"and the fused K2e + K3 after each K1")
    if any(K.plain_calls.values()):
        raise AssertionError(f"{label}: plain versions ran: "
                             f"{K.plain_calls}")


@contextlib.contextmanager
def _walk_shapes(K):
    """Each of run_bucket's walk launches' (IT, B, stats) while the block
    runs (the fused K2e + K3)."""
    seen, orig = [], K.spliced_ends_tb_walk

    def walk(bp, *args, stats=None, **kw):
        out = orig(bp, *args, stats=stats, **kw)
        seen.append((bp.IT, bp.B, stats))
        return out
    K.spliced_ends_tb_walk = walk
    try:
        yield seen
    finally:
        K.spliced_ends_tb_walk = orig


def _copy_back_ms(seen) -> tuple[float, float, int, int]:
    """run_bucket's copies of K3's records to the host, for each walk
    launch in ``seen``, timed on buffers of their sizes: (ms of one copy
    of every IT row with the ends, as before the walks reported their
    steps; ms of the ends and stats, then of the rows the walks wrote;
    the bytes of each)."""
    old = new = old_b = new_b = 0
    for IT, B, stats in seen:
        rows = max(int(stats[:, 0].max()), 1)
        full = torch.empty(IT * B * 4 + 3 * B, dtype=torch.int32,
                           device="cuda")
        old += _copy_ms(full)
        new += _copy_ms(full[:5 * B]) + _copy_ms(full[:rows * B * 4])
        old_b += 4 * (IT * B * 4 + 3 * B)
        new_b += 4 * (5 * B + rows * B * 4)
    return old, new, old_b, new_b


def tetrapod_map(K, cli, metrics):
    """The map's UDH path at full width: default size rule, then -A 3."""
    d = WORK / "tetra"
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    truth = make_tetrapod_corpus(d)
    log(f"tetrapod map: corpus built in {time.perf_counter() - t0:.1f} s "
        f"({sum(TETRA_CHROMS) / 1e6:.1f} Mb, {len(truth)} planted genes)")
    t0 = time.perf_counter()
    cli.main(["index", str(d / "genome.fa"), "-p", str(d / "genome")])
    log(f"tetrapod map: index built in {time.perf_counter() - t0:.1f} s")
    texts, runs = {}, {}
    for mode, extra in (("default", ["-O", "0,4,12"]),
                        ("udh", ["-O", "0,4", "-A", "3"])):
        metrics.reset()
        _reset_counts(K)
        out = OUT / f"tetra.{mode}.O0_4"
        retraces = []
        with kernel_clock(K, retraces) as kms, _walk_shapes(K) as walks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the default run also writes its -O12 shard, for phase 13's
            # sortgrcd (OUT / "tetra.default.grd.npz")
            cli.main(["map", str(d / "cdna.fa"), "-d", str(d / "genome"),
                      "-T", "Tetrapod", "-o", str(out), "--device", "cuda",
                      *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if walks:
            old, new, old_b, new_b = _copy_back_ms(walks)
            log(f"tetrapod map ({mode}): K3's records to the host in "
                f"{len(walks)} buckets: every IT row {old:.3f} ms "
                f"({old_b} bytes), the rows the walks wrote {new:.3f} ms "
                f"({new_b} bytes, two copies a bucket)")
        _check_udh_kernels(K, metrics, f"tetrapod map ({mode})")
        texts[mode] = out.read_text()
        c = dict(metrics.counters)
        runs[mode] = dict(launches=dict(K.launches), counters=c, ms=kms,
                          wall=wall)
        hit, rec, prec, missed = _score_text(texts[mode], truth)
        secs = {k: round(v, 3) for k, v in metrics.timings.items()}
        busy = sum(kms.values()) / 1e3
        log(f"tetrapod map ({mode}): {len(truth)} queries in {wall:.2f} s "
            f"= {len(truth) / wall:.3f} queries/s; udh_buckets "
            f"{c.get('udh_buckets', 0)}, plane buckets "
            f"{c.get('device_buckets', 0)}; stage seconds "
            f"{json.dumps(secs, sort_keys=True)}")
        log(f"tetrapod map ({mode}): kernel ms, launches "
            f"{_ms_launches(K, kms)}; "
            f"kernels busy {busy:.3f} s = {100 * busy / wall:.2f}% of the "
            f"wall; udh_dp_cells {c.get('udh_dp_cells', 0)}, "
            f"udh_retrace_cells {c.get('udh_retrace_cells', 0)}, "
            f"dp_cells {c.get('dp_cells', 0)}; retrace launches (problems, "
            f"slabs, k, CTAs) {_retrace_shapes(retraces)}")
        log(f"tetrapod map ({mode}): {hit}/{len(truth)} = "
            f"{100 * hit / len(truth):.1f}% at the planted locus and "
            f"strand; exon recall {rec:.4f}, precision {prec:.4f}; "
            f"missed {missed}")
        if hit < 0.9 * len(truth):
            raise AssertionError(f"tetrapod map ({mode}): only {hit} of "
                                 f"{len(truth)} at their planted locus")
    if texts["default"] != texts["udh"]:
        raise AssertionError("tetrapod map: default and -A 3 texts differ")
    if runs["udh"]["counters"].get("udh_buckets", 0) < 1:
        raise AssertionError("tetrapod map: -A 3 ran no UDH bucket")
    log(f"tetrapod map: default and -A 3 -O0,4 texts byte-identical "
        f"({len(texts['udh'])} bytes, md5 "
        f"{_check_md5('tetrapod map', out)})")
    return runs, truth


# --------------------------------------------------------------- phase 5
SEGMENT_LEN = 2_400_000


def make_segment_corpus(d: Path):
    """One 2.4 Mb genomic segment (GC ~41%) with 8 planted cDNA genes of
    4-8 exons: two with an intron over 16,384 nt (the long-intron split),
    one across the 2 Mb chunk seam, the rest with 0.5-8 kb introns."""
    rng = np.random.default_rng(SEED + 4)
    seg = np.array(list("ACGT"), dtype="S1")[
        rng.choice(4, SEGMENT_LEN, p=[0.295, 0.205, 0.205, 0.295])]
    starts = [100_000, 400_000, 700_000, 1_000_000, 1_300_000, 1_600_000,
              1_994_000, 2_200_000]
    truth, queries = [], []
    for k, pos in enumerate(starts):
        big = {0: 18_000, 3: 25_000}.get(k)
        n_ex = int(rng.integers(4, 9))
        g, spans, ex = _gene_parts(
            rng, n_ex,
            lambda j: big if big and j == 1 else int(rng.integers(500,
                                                                  8_000)))
        strand = "+" if k % 2 == 0 else "-"
        exons = _plant(rng, seg, pos, g, spans, strand)
        qn = f"s{k}"
        truth.append(dict(q=qn, chrom="seg", strand=strand,
                          span=(pos, pos + len(g)), exons=exons))
        queries.append(f">{qn}\n{_mutate(rng, ''.join(ex), 0.01)}\n")
    seam = truth[6]["span"]
    if not seam[0] < 2_000_000 < seam[1]:
        raise AssertionError(f"seam gene at {seam} misses the chunk seam")
    _write_fasta(d / "segment.fa", ["seg"], [seg])
    (d / "cdna.fa").write_text("".join(queries))
    return truth


def segment_align(K, cli, metrics):
    d = WORK / "segment"
    d.mkdir(parents=True)
    truth = make_segment_corpus(d)
    metrics.reset()
    _reset_counts(K)
    out = OUT / "segment.O0_4"
    retraces = []
    with kernel_clock(K, retraces) as kms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["align", str(d / "segment.fa"), str(d / "cdna.fa"), "-T",
                  "Tetrapod", "-O", "0,4", "-o", str(out), "--device",
                  "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _check_udh_kernels(K, metrics, "segment align")
    c = dict(metrics.counters)
    hit, rec, prec, missed = _score_text(out.read_text(), truth)
    busy = sum(kms.values()) / 1e3
    log(f"segment align: {len(truth)} queries x {SEGMENT_LEN} nt in "
        f"{wall:.2f} s; counters {json.dumps(c, sort_keys=True)}")
    log(f"segment align: kernel ms, launches {_ms_launches(K, kms)}; kernels "
        f"busy {busy:.3f} s = {100 * busy / wall:.2f}% of the wall; retrace "
        f"launches (problems, slabs, k, CTAs) {_retrace_shapes(retraces)}")
    log(f"segment align: {hit}/{len(truth)} at the planted locus and "
        f"strand; exon recall {rec:.4f}, precision {prec:.4f}; missed "
        f"{missed}")
    if hit < len(truth):
        raise AssertionError(f"segment align: {missed} not at their locus")
    if (c.get("segment_chunks", 0) < 2 or c.get("align_long", 0) < 2
            or c.get("udh_windows", 0) < 1):
        raise AssertionError(f"segment align: a path was not taken: {c}")
    return dict(launches=dict(K.launches), ms=kms)


# --------------------------------------------------------------- phase 6
def _read_fasta(path: Path) -> list[tuple[str, str]]:
    recs = []
    for block in path.read_text().split(">")[1:]:
        name, *body = block.splitlines()
        recs.append((name.split()[0], "".join(body)))
    return recs


def make_indel_queries(d: Path, truth: list) -> dict:
    """Phase 4's cDNAs with long indels: query k % 3 == 1 loses 30-90 nt
    inside its longest exon (a long horizontal gap), k % 3 == 2 gains
    30-90 nt there (a long vertical gap), the rest stay as they were.
    Writes d/cdna_yl3.fa; returns the indel length per query."""
    rng = np.random.default_rng(SEED + 6)
    by_name = {t["q"]: t for t in truth}
    recs, indel = [], {}
    for k, (name, q) in enumerate(_read_fasta(d / "cdna.fa")):
        t = by_name[name]
        lens = [b - a + 1 for a, b in sorted(t["exons"])]
        if t["strand"] == "-":
            lens = lens[::-1]              # cDNA order
        j = int(np.argmax(lens))
        at = sum(lens[:j])
        n = int(rng.integers(30, min(90, lens[j] - 30) + 1))
        if k % 3 == 1:
            p = at + (lens[j] - n) // 2
            q = q[:p] + q[p + n:]
            indel[name] = -n
        elif k % 3 == 2:
            p = at + lens[j] // 2
            q = q[:p] + _seq(rng, n, 0.5) + q[p:]
            indel[name] = n
        recs.append(f">{name}\n{q}\n")
    (d / "cdna_yl3.fa").write_text("".join(recs))
    return indel


def _check_dagp_kernels(K, metrics, label: str) -> None:
    """Every bucket ran on the double-affine entries (K1-dagp and the
    fused K2e + K3 on planes, K4-dagp, K2e, its retrace and K3 strip on
    UDH), none on a single-affine
    slab entry; no plain version ran; no query was skipped."""
    _check_no_skips(metrics, label)
    c, n = metrics.counters, K.launches
    udh, planes = c.get("udh_buckets", 0), c.get("device_buckets", 0)
    if n["spliced_slab_trace_dagp"] != planes or (udh and not (
            n["spliced_slab_links_dagp"] >= udh
            and n["spliced_tb_strips"] == _retraces(n, True)
            >= udh)) or n["spliced_ends_tb_walk"] != planes or (
            n["spliced_last_ends"] != n["spliced_slab_links_dagp"]
            or n["spliced_tb_walk"]):
        raise AssertionError(f"{label}: {planes} plane and {udh} UDH "
                             f"buckets, launches {dict(n)}")
    single = [k for k in ("spliced_slab_trace", "spliced_slab_links",
                          "spliced_slab_retrace",
                          "spliced_slab_retrace_pairs") if n.get(k)]
    if single:
        raise AssertionError(f"{label}: single-affine entries ran: {single}")
    if any(K.plain_calls.values()):
        raise AssertionError(f"{label}: plain versions ran: "
                             f"{K.plain_calls}")


def _long_gap_rows(text: str) -> int:
    """Exon-table rows (-O4) whose query and genome spans differ by 29 or
    more: the exon holds a long gap."""
    n = 0
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) == 14:
            n += abs((int(f[4]) - int(f[3])) - (int(f[6]) - int(f[5]))) >= 29
    return n


def tetrapod_yl3_map(K, cli, metrics, truth):
    """map -yl3 on phase 4's genome and index: size rule, then -A 3."""
    d = WORK / "tetra"
    indel = make_indel_queries(d, truth)
    texts, runs = {}, {}
    for mode, extra in (("default", []), ("udh", ["-A", "3"])):
        metrics.reset()
        _reset_counts(K)
        out = OUT / f"tetra_yl3.{mode}.O0_4"
        retraces = []
        with kernel_clock(K, retraces) as kms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(["map", str(d / "cdna_yl3.fa"), "-d", str(d / "genome"),
                      "-T", "Tetrapod", "-y", "l3", "-O", "0,4", "-o",
                      str(out), "--device", "cuda", *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _check_dagp_kernels(K, metrics, f"map -yl3 ({mode})")
        texts[mode] = out.read_text()
        c = dict(metrics.counters)
        runs[mode] = dict(launches=dict(K.launches), counters=c, ms=kms,
                          wall=wall)
        hit, rec, prec, missed = _score_text(texts[mode], truth)
        secs = {k: round(v, 3) for k, v in metrics.timings.items()}
        busy = sum(kms.values()) / 1e3
        n_del = sum(v < 0 for v in indel.values())
        n_ins = sum(v > 0 for v in indel.values())
        log(f"map -yl3 ({mode}): {len(truth)} queries ({n_del} deletions, "
            f"{n_ins} insertions of 30-90 nt) in {wall:.2f} s = "
            f"{len(truth) / wall:.3f} queries/s; udh_buckets "
            f"{c.get('udh_buckets', 0)}, plane buckets "
            f"{c.get('device_buckets', 0)}; stage seconds "
            f"{json.dumps(secs, sort_keys=True)}")
        log(f"map -yl3 ({mode}): kernel ms, launches "
            f"{_ms_launches(K, kms)}; "
            f"kernels busy {busy:.3f} s = {100 * busy / wall:.2f}% of the "
            f"wall; udh_dp_cells {c.get('udh_dp_cells', 0)}, dp_cells "
            f"{c.get('dp_cells', 0)}; retrace launches (problems, slabs, k, "
            f"CTAs) {_retrace_shapes(retraces)}")
        log(f"map -yl3 ({mode}): {hit}/{len(truth)} = "
            f"{100 * hit / len(truth):.1f}% at the planted locus and "
            f"strand; exon recall {rec:.4f}, precision {prec:.4f}; "
            f"exon rows with a gap of 29+ nt {_long_gap_rows(texts[mode])}; "
            f"missed {missed}")
        if hit < 0.9 * len(truth):
            raise AssertionError(f"map -yl3 ({mode}): only {hit} of "
                                 f"{len(truth)} at their planted locus")
    if texts["default"] != texts["udh"]:
        raise AssertionError("map -yl3: default and -A 3 texts differ")
    if runs["udh"]["counters"].get("udh_buckets", 0) < 1:
        raise AssertionError("map -yl3: -A 3 ran no UDH bucket")
    if _long_gap_rows(texts["udh"]) < 1:
        raise AssertionError("map -yl3: no exon holds a long gap")
    log(f"map -yl3: default and -A 3 -O0,4 texts byte-identical "
        f"({len(texts['udh'])} bytes, md5 {_check_md5('map -yl3', out)})")
    return runs


# -------------------------------------------------------------- phase 11
@contextlib.contextmanager
def k6_modes(K):
    """Count the K1 and K4 calls of the block by (entry, K6 mode): the
    local mode, the -yJ bonus, the emission (the map's plane path calls
    K1 through dp_spliced_cuda, its UDH links pass K4 through
    dp_spliced_udh, the local search K1 through protein_search)."""
    from spaln_tpu_torch.align import protein_search as PS
    from spaln_tpu_torch.ops import dp_spliced_udh as U
    seen: dict = {}

    def wrap(fn):
        def spy(bp, prm, *a, **kw):
            name = K.entry(fn.__name__, prm)
            key = (name, bool(bp.flags.local), bp.cip is not None,
                   bool(kw.get("emit_local")))
            seen[key] = seen.get(key, 0) + 1
            return fn(bp, prm, *a, **kw)
        return spy

    saved = [(m, n, getattr(m, n)) for m, n in (
        (K, "spliced_slab_trace"), (U, "spliced_slab_links"),
        (PS, "spliced_slab_trace"))]
    for m, n, fn in saved:
        setattr(m, n, wrap(fn))
    try:
        yield seen
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def write_junction_queries(src: Path, dst: Path, truth: list) -> int:
    """The cDNAs of ``src`` with junction records (";B n n" and ";b pos
    num ...") at their planted exon-exon junctions, num 1-3 in turn.
    Returns the junctions written."""
    by_name = {t["q"]: t for t in truth}
    recs, n = [], 0
    for name, q in _read_fasta(src):
        t = by_name[name]
        lens = [b - a + 1 for a, b in sorted(t["exons"])]
        if t["strand"] == "-":
            lens = lens[::-1]              # cDNA order
        junc = np.cumsum(lens[:-1]).tolist()
        n += len(junc)
        recs.append(f">{name}\n;B {len(junc)} {len(junc)}\n;b "
                    + " ".join(f"{p} {1 + k % 3}" for k, p in
                               enumerate(junc)) + f"\n{q}\n")
    dst.write_text("".join(recs))
    return n


# the K6 runs of phase 11: (label, queries, extra arguments)
K6_RUNS = (("map -L S", "cdna.fa", ["-L", "S"]),
           ("map -L S -A 3 -y l3", "cdna.fa", ["-L", "S", "-A", "3", "-y",
                                               "l3"]),
           ("map junctions -y l3", "cdna_j.fa", ["-y", "l3"]),
           ("map junctions -A 3", "cdna_j.fa", ["-A", "3"]))


def _k6_small(K, cli) -> None:
    """Phase 2's corpus, `map -L S -A 3` and `map` on its cDNAs with
    junction records: the kernels' -O0,4 text byte-identical with the DP
    forced through the plain versions on the card."""
    d = WORK / "small"
    for label, q, extra in (("-L S -A 3", "q.fa", ["-L", "S", "-A", "3"]),
                            ("junctions", "q_j.fa", [])):
        texts = {}
        for mode in ("kernels", "plain"):
            ctxm = (plain_on_card(K) if mode == "plain"
                    else contextlib.nullcontext())
            with ctxm, k6_modes(K) as seen:
                o = OUT / f"small_k6.{label.split()[0]}.{mode}.O0_4"
                cli.main(["map", str(d / q), "-d", str(d / "g"), "-O",
                          "0,4", "-o", str(o), "--device", "cuda", *extra])
            texts[mode] = o.read_bytes()
            if not seen or not all(k[1] or k[2] for k in seen):
                raise AssertionError(f"small map {label} ({mode}): K6 off "
                                     f"in {seen}")
        if texts["kernels"] != texts["plain"]:
            raise AssertionError(f"small map {label}: kernels and plain "
                                 f"versions differ")
        if texts["kernels"].count(b"\tgene\t") != 4:
            raise AssertionError(f"small map {label}: not 4 genes")
        log(f"small map {label}: -O0,4 byte-identical, kernels vs plain "
            f"on the card ({len(texts['kernels'])} bytes)")


def _check_pair_launches(K, label: str, counters: dict, dagp: bool,
                         retraces: list, pairs: list) -> dict:
    """A K6 map under -A 3: the retrace ran as the retrace of pairs, at
    most once a UDH bucket past the plane budget's splits (the counter
    udh_retrace_splits), never one slab a launch (no launch of the
    retrace of runs), one strip launch each.  Logs the launches' pairs,
    the CTAs an SM holds and the waves; returns them."""
    d = "_dagp" if dagp else ""
    n = K.launches
    name = "spliced_slab_retrace_pairs" + d
    udh = counters.get("udh_buckets", 0)
    splits = counters.get("udh_retrace_splits", 0)
    if (n["spliced_slab_retrace" + d] or not 1 <= n[name] <= udh + splits
            or n["spliced_tb_strips"] != n[name]):
        raise AssertionError(f"{label}: {udh} UDH buckets and {splits} "
                             f"plane-budget splits, launches {dict(n)}: "
                             f"expected {name} at most once a bucket past "
                             f"the splits and no one-slab retrace")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    waves, occ = [], {}
    for _, nb, L, A in pairs:
        if (L, A) not in occ:
            occ[L, A] = K.retrace_pairs_occupancy(dagp, L, A,
                                                  torch.device("cuda"))[0]
        waves.append(-(-nb // (occ[L, A] * n_sm)))
    out = dict(launches=n[name], buckets=udh, splits=splits,
               pairs=[p[1] for p in pairs], ctas_per_sm=sorted(set(
                   occ.values())), waves=max(waves))
    log(f"{label}: retrace {n[name]} {name} launch(es) for {udh} UDH "
        f"buckets ({splits} plane-budget splits), 0 one-slab launches, "
        f"{n['spliced_tb_strips']} strip launch(es); pairs a launch "
        f"{out['pairs']}; (pairs, 1, k, CTAs a pair) "
        f"{_retrace_shapes(retraces)}; {out['ctas_per_sm']} CTAs an SM "
        f"holds ({n_sm} SMs), at most {out['waves']} wave(s) a launch")
    return out


def tetrapod_k6_map(K, cli, metrics, truth) -> dict:
    """K6 on phase 4's genome and index: map -L S (the size rule, then
    -A 3 -y l3) and map of the cDNAs with junction records at their
    planted junctions (-y l3 under the size rule, then -A 3); every
    bucket on the kernels in K6's modes with no plain call, >= 90% of
    queries at their planted locus and strand; then phase 2's corpus
    against the plain versions on the card (_k6_small).  Under -A 3 the
    UDH retrace runs every (problem, slab) pair of a bucket in one
    launch of the retrace of pairs (_check_pair_launches)."""
    d = WORK / "tetra"
    nj = write_junction_queries(d / "cdna.fa", d / "cdna_j.fa", truth)
    runs = {}
    for label, q, extra in K6_RUNS:
        metrics.reset()
        _reset_counts(K)
        out = OUT / f"tetra_k6.{'_'.join(label.split()[1:])}.O0_4"
        retraces, pairs = [], []
        with kernel_clock(K, retraces, pairs=pairs) as kms, \
                k6_modes(K) as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(["map", str(d / q), "-d", str(d / "genome"), "-T",
                      "Tetrapod", "-O", "0,4", "-o", str(out), "--device",
                      "cuda", *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if "l3" in extra:
            _check_dagp_kernels(K, metrics, label)
        else:
            _check_udh_kernels(K, metrics, label)
        local, cip = "-L" in extra, q == "cdna_j.fa"
        if not seen or any(k[1:3] != (local, cip) for k in seen):
            raise AssertionError(f"{label}: K1/K4 calls by mode {seen}")
        c = dict(metrics.counters)
        udh = "-A" in extra
        if bool(c.get("udh_buckets")) != udh or (
                not udh and not c.get("device_buckets")):
            raise AssertionError(f"{label}: buckets {c}")
        text = out.read_text()
        hit, rec, prec, missed = _score_text(text, truth)
        secs = {k: round(v, 3) for k, v in metrics.timings.items()}
        busy = sum(kms.values()) / 1e3
        runs[label] = dict(launches=dict(K.launches), counters=c, ms=kms,
                           wall=wall, modes={"|".join(map(str, k)): v
                                             for k, v in seen.items()})
        if udh:
            runs[label]["retrace"] = _check_pair_launches(
                K, label, c, "l3" in extra, retraces, pairs)
        log(f"{label}: {len(truth)} queries in {wall:.2f} s = "
            f"{len(truth) / wall:.3f} queries/s; udh_buckets "
            f"{c.get('udh_buckets', 0)}, plane buckets "
            f"{c.get('device_buckets', 0)}; K6 calls {runs[label]['modes']}"
            f"; stage seconds {json.dumps(secs, sort_keys=True)}")
        log(f"{label}: kernel ms, launches {_ms_launches(K, kms)}; kernels "
            f"busy {busy:.3f} s = {100 * busy / wall:.2f}% of the wall; "
            f"{hit}/{len(truth)} = {100 * hit / len(truth):.1f}% at the "
            f"planted locus and strand; exon recall {rec:.4f}, precision "
            f"{prec:.4f}; missed {missed}; text md5 "
            f"{_check_md5(label, out)}")
        if hit < 0.9 * len(truth):
            raise AssertionError(f"{label}: only {hit} of {len(truth)} at "
                                 f"their planted locus")
    log(f"phase 11: {nj} junction records at the planted junctions")
    t0 = time.perf_counter()
    _k6_small(K, cli)
    log(f"phase 11: small maps took {time.perf_counter() - t0:.1f} s")
    return runs


# -------------------------------------------------------------- phase 12
N_LOCAL_QUERIES = 3


def local_protein_search(K, metrics) -> dict:
    """search_protein_local against phase 7's 20,000-entry DB: each of
    N_LOCAL_QUERIES queries is two blocks of 30-40 aa joined by 150 aa of
    background, and copies of its blocks (15% substitutions) are planted
    in three known entries (both blocks in one, one block each in two
    others).  Every planted island must be reported, on the DB entry and
    the span where it was planted; every batch runs K1 in local mode
    with the emission, with no plain call."""
    from spaln_tpu_torch.align.protein_search import search_protein_local
    from spaln_tpu_torch.score.tables import find_table_dir
    from spaln_tpu_torch.seq.codec import encode_protein
    rng = np.random.default_rng(SEED + 12)
    db = [(n, s) for n, s in _read_fasta(WORK / "protein" / "db.fa")]
    runs, found, n_isl = [], 0, 0
    for j in range(N_LOCAL_QUERIES):
        blk = [_protein(rng, int(rng.integers(30, 41))) for _ in range(2)]
        query = blk[0] + _protein(rng, 150) + blk[1]
        entries = rng.choice(len(db), 3, replace=False)
        local_db, planted = list(db), []
        for e, which in zip(entries, ((0, 1), (0,), (1,))):
            name, s = local_db[e]
            at = int(rng.integers(0, max(len(s) // 3, 1)))
            for w in which:
                isl = _mutate_protein(rng, blk[w], 0.15)
                s = s[:at] + isl + s[at + len(isl):]
                planted.append((name, at, at + len(isl)))
                at += len(isl) + int(rng.integers(40, 120))
            local_db[e] = (name, s)
        enc = [(n, encode_protein(s)) for n, s in local_db]
        metrics.reset()
        _reset_counts(K)
        with kernel_clock(K) as kms, k6_modes(K) as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hits = search_protein_local(encode_protein(query), enc,
                                        table_dir=find_table_dir(),
                                        device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if any(K.plain_calls.values()):
            raise AssertionError(f"local search: plain versions ran: "
                                 f"{K.plain_calls}")
        batches = metrics.counters.get("local_search_batches", 0)
        key = ("spliced_slab_trace", True, False, True)
        if seen != {key: batches} or K.launches["spliced_slab_trace"] != \
                batches or batches < -(-len(db) // 64):
            raise AssertionError(f"local search: {batches} batches, calls "
                                 f"{seen}, launches {dict(K.launches)}")
        ok = [any(h.name == n and h.s_span[0] < b and h.s_span[1] > a
                  for h in hits) for n, a, b in planted]
        found += sum(ok)
        n_isl += len(planted)
        secs = {k: round(v, 3) for k, v in metrics.timings.items()}
        busy = sum(kms.values()) / 1e3
        runs.append(dict(wall=wall, batches=batches, hits=len(hits),
                         launches=batches, ms=kms))
        log(f"local search {j}: {len(db)} entries in {wall:.2f} s, "
            f"{batches} batches (K1 local with the emission), {len(hits)} "
            f"hits; planted islands reported {sum(ok)}/{len(planted)} "
            f"{planted}; kernels busy {busy:.3f} s = "
            f"{100 * busy / wall:.2f}% of the wall; stage seconds "
            f"{json.dumps(secs, sort_keys=True)}")
    if found != n_isl:
        raise AssertionError(f"local search: {found} of {n_isl} planted "
                             f"islands reported")
    return dict(runs=runs, launches=sum(r["launches"] for r in runs))


# -------------------------------------------------------------- phase 13
ILD_MIXTURE = dict(weights=[0.7, 0.3], mus=[30., 30.], thetas=[60., 600.],
                   kappas=[1.2, 1.8])


def _planted_intron_lengths(truth: list) -> list:
    """Phase 4's planted intron lengths: the gaps between consecutive
    exons (1-based, inclusive spans) of every gene."""
    out = []
    for t in truth:
        ex = sorted(t["exons"])
        out += [b[0] - a[1] - 1 for a, b in zip(ex, ex[1:])]
    return out


def _cpu_fits(paths: list) -> list:
    """`ild fit --device cpu` of each length list, in a process of its
    own beside the card's work, on one intra-op thread (faster than
    many at these sizes, and it leaves the main process its cores):
    (its output, wall s) a list."""
    from spaln_tpu_torch import cli
    torch.set_num_threads(1)
    out = []
    for p in paths:
        t0 = time.perf_counter()
        cli.main(["ild", "fit", p, "--device", "cpu", "-o", p + ".cpu"])
        out.append((Path(p + ".cpu").read_text(), time.perf_counter() - t0))
    return out


def _fit_misses(got: dict, want: dict) -> list:
    """Where a fit leaves the tolerance of tests/test_torch_ild.py: NLL
    relative 1e-5, weights absolute 0.005, theta and kappa relative 1%,
    mu within 1% of its component's theta."""
    bad = []
    if abs(got["nll"] - want["nll"]) > 1e-5 * abs(want["nll"]):
        bad.append(("nll", got["nll"], want["nll"]))
    for g, w in zip(got["weights"], want["weights"]):
        if abs(g - w) > 0.005:
            bad.append(("weights", g, w))
    for key in ("thetas", "kappas"):
        for g, w in zip(got[key], want[key]):
            if abs(g - w) > 0.01 * abs(w):
                bad.append((key, g, w))
    for g, w, th in zip(got["mus"], want["mus"], want["thetas"]):
        if abs(g - w) > 0.01 * th:
            bad.append(("mus", g, w))
    return bad


def sharded_phase(K, cli, metrics, truth) -> dict:
    """Phase 13, the modules of the last slice on the card: phase 4's
    48 queries through map_queries_sharded on [cuda:0, cuda:0] (every
    batch in two shards, at once), size rule and -A 3, each text's md5
    phase 4's; sortgrcd over phase 4's -O12 shard; `ild fit` on the card
    (its default) of phase 4's planted intron lengths and of a seeded
    10,000-length Frechet mixture, first, each held against `--device
    cpu` (run in a process of its own meanwhile) to the fit tolerance;
    entry()'s
    forward against its plain version; dryrun_multichip(1) over NCCL."""
    from spaln_tpu_torch.align.driver import AlignerContext
    from spaln_tpu_torch.align.mapper import GenomeMapper
    from spaln_tpu_torch.entry import dryrun_multichip, entry
    from spaln_tpu_torch.parallel import map_queries_sharded
    from spaln_tpu_torch.score.tables import TableDir, find_table_dir
    from spaln_tpu_torch.seed.blockindex import BlockIndex
    from spaln_tpu_torch.seq.fasta import iter_seqfile
    from spaln_tpu_torch.seq.genome import GenomeStore
    from spaln_tpu_torch.tools.fitild import sample_frechet_mixture
    import multiprocessing
    t13 = time.perf_counter()
    d = WORK / "tetra"
    out: dict = {}
    lens = {"tetrapod introns": _planted_intron_lengths(truth),
            "mixture 10k": sample_frechet_mixture(
                np.random.default_rng(SEED + 13), 10_000, **ILD_MIXTURE)}
    paths = []
    for i, x in enumerate(lens.values()):
        paths.append(str(WORK / f"ild{i}.txt"))
        Path(paths[-1]).write_text("\n".join(map(str, x)) + "\n")
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu = pool.apply_async(_cpu_fits, (paths,))
        fits = {}
        for label, p in zip(lens, paths):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(["ild", "fit", p, "-o", p + ".cuda"])
            torch.cuda.synchronize()
            fits[label] = (Path(p + ".cuda").read_text(),
                           time.perf_counter() - t0)
        store = GenomeStore.load(str(d / "genome"))
        index = BlockIndex.load(str(d / "genome"))
        tables = TableDir(find_table_dir(), species="Tetrapod")
        recs = list(iter_seqfile(str(d / "cdna.fa")))
        devices = [torch.device("cuda", 0)] * 2
        for mode, udh in (("default", False), ("udh", True)):
            mapper = GenomeMapper(store, index, AlignerContext.create(
                tables, "cuda", force_udh=udh))
            metrics.reset()
            _reset_counts(K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = map_queries_sharded(mapper, [r.codes for r in recs],
                                      q_names=[r.name for r in recs],
                                      devices=devices)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            path = OUT / f"tetra.sharded.{mode}.O0_4"
            with open(path, "w") as fh:
                sink = cli.OutputSink([0, 4], fh)
                for rec, gs in zip(recs, res):
                    sink.emit(gs, len(rec.codes))
                sink.close()
            label = f"sharded map ({mode})"
            _check_udh_kernels(K, metrics, label)
            c = dict(metrics.counters)
            if not c.get("sharded_batches"):
                raise AssertionError(f"{label}: no batch was sharded: {c}")
            md5 = _check_md5("tetrapod map", path)
            launches = {k: n for k, n in K.launches.items() if n}
            secs = {k: round(v, 3) for k, v in metrics.timings.items()}
            log(f"{label}: {len(recs)} queries on 2 shards of cuda:0 in "
                f"{wall:.2f} s; {c.get('sharded_batches')} sharded batches "
                f"({c.get('udh_buckets', 0)} UDH, "
                f"{c.get('device_buckets', 0)} plane), launches "
                f"{json.dumps(launches)}; stage seconds "
                f"{json.dumps(secs, sort_keys=True)}; -O0,4 md5 {md5} "
                f"(phase 4's)")
            out[label] = dict(wall=wall, launches=launches, md5=md5)
        grd = OUT / "tetra.default.grd.npz"
        for fmt in ("0", "15"):
            path = OUT / f"tetra.sortgrcd.O{fmt}"
            cli.main(["sortgrcd", str(grd), "-O", fmt, "-o", str(path)])
            text = path.read_text()
            n = (text.count("!\t") if fmt == "0"
                 else len(text.splitlines()))
            want = (0.9 * len(truth) if fmt == "0"
                    else 0.8 * len(lens["tetrapod introns"]))
            log(f"sortgrcd -O{fmt} over phase 4's -O12 shard: {n} "
                f"{'loci' if fmt == '0' else 'unique introns'}, md5 "
                f"{_md5(path)}")
            if n < want:
                raise AssertionError(f"sortgrcd -O{fmt}: {n} rows")
        for (label, (text, wall)), (ctext, cwall) in zip(
                fits.items(), cpu.get(timeout=900)):
            got = json.loads(text.splitlines()[0])
            want = json.loads(ctext.splitlines()[0])
            bad = _fit_misses(got, want)
            log(f"ild fit ({label}, n={got['n']}): cuda {wall:.2f} s, "
                f"cpu {cwall:.2f} s; {text.splitlines()[1]} against "
                f"{ctext.splitlines()[1]}; nll {got['nll']} against "
                f"{want['nll']}")
            if bad:
                raise AssertionError(f"ild fit ({label}): cuda against cpu "
                                     f"out of tolerance: {bad}")
            out[f"ild fit ({label})"] = dict(wall=wall, cpu_wall=cwall)
    fn, args = entry()
    row = fn(*args)
    fn_c, args_c = entry("cpu")
    err = _max_abs_err(row.cpu(), fn_c(*args_c))
    if err:
        raise AssertionError(f"entry(): max_abs_err {err} against the "
                             f"plain version")
    t0 = time.perf_counter()
    dryrun_multichip(1)
    out["dryrun_multichip(1)"] = dict(wall=time.perf_counter() - t0)
    log(f"entry() row equal to its plain version; dryrun_multichip(1) over "
        f"NCCL in {out['dryrun_multichip(1)']['wall']:.2f} s")
    log(f"phase 13 took {time.perf_counter() - t13:.1f} s on {_card()}")
    return out


# --------------------------------------------------------------- phase 7
N_DB, N_PROT_QUERIES = 20_000, 200


def make_protein_corpus(d: Path) -> dict:
    """A proteome-size DB (N_DB entries of background residues, lengths
    log-normal with median 375 aa, clipped to 50-3,000) and
    N_PROT_QUERIES queries, each a copy of a random entry with 5-30%
    substitutions and 0-2 indels of 1-10 aa.  Writes db.fa, q.fa and
    pairs.fa (query, source alternating); returns query -> source."""
    rng = np.random.default_rng(SEED + 8)
    lens = _protein_lengths(rng, N_DB)
    letters = np.array(list(AMINO))[rng.choice(20, int(lens.sum()),
                                               p=AA_FREQ)]
    body = letters.astype("S1").tobytes().decode()
    offs = np.concatenate([[0], np.cumsum(lens)])
    seqs = [body[offs[i]:offs[i + 1]] for i in range(N_DB)]
    with open(d / "db.fa", "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">db{i:05d}\n")
            for k in range(0, len(s), 60):
                fh.write(s[k:k + 60] + "\n")
    src = rng.choice(N_DB, N_PROT_QUERIES, replace=False)
    truth, qrecs, pairs = {}, [], []
    for j, i in enumerate(src):
        q = _mutate_protein(rng, seqs[i], float(rng.uniform(0.05, 0.30)),
                            int(rng.integers(0, 3)))
        name = f"pq{j:03d}"
        truth[name] = f"db{i:05d}"
        qrecs.append(f">{name}\n{q}\n")
        pairs.append(f">{name}\n{q}\n>db{i:05d}\n{seqs[i]}\n")
    (d / "q.fa").write_text("".join(qrecs))
    (d / "pairs.fa").write_text("".join(pairs))
    return truth


def _hit_lines(text: str, truth: dict) -> dict:
    """query -> subjects of its -O0 statistics lines, best first."""
    hits: dict = {}
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) == 8 and f[0] in truth:
            hits.setdefault(f[0], []).append(f[1])
    return hits


def protein_search(K, cli, metrics):
    """search -a at proteome size, then pair on the (query, source)
    pairs."""
    d = WORK / "protein"
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    truth = make_protein_corpus(d)
    log(f"protein search: corpus built in {time.perf_counter() - t0:.1f} s "
        f"({N_DB} entries, {(d / 'db.fa').stat().st_size / 1e6:.1f} MB of "
        f"fasta, {len(truth)} queries)")
    runs = {}
    for cmd in ("search", "pair"):
        metrics.reset()
        _reset_counts(K)
        out = OUT / f"protein.{cmd}"
        argv = (["search", str(d / "q.fa"), "-a", str(d / "db.fa"),
                 "--max-hits", "10", "--align-top", "1", "-O", "0,1"]
                if cmd == "search" else ["pair", str(d / "pairs.fa"), "-O",
                                         "0"])
        with kernel_clock(K) as kms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main([*argv, "-o", str(out), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _check_no_skips(metrics, cmd)
        if any(K.plain_calls.values()):
            raise AssertionError(f"{cmd}: plain versions ran: "
                                 f"{K.plain_calls}")
        c, n = dict(metrics.counters), dict(K.launches)
        batches = c.get("search_score_batches", 0)
        traced = c.get("search_traced_hits", 0)
        # a score batch: K5 score-only and K2e; a traced hit: K1 and the
        # fused K2e + K3 (run_bucket)
        if (batches < len(truth) or n["spliced_slab_score"] != batches
                or traced != len(truth)
                or any(n[k] != traced for k in K.PLANE_PATH)
                or n["spliced_last_ends"] != batches
                or n["spliced_tb_walk"]):
            raise AssertionError(f"{cmd}: {batches} score batches, {traced} "
                                 f"traced hits, launches {n}")
        hits = _hit_lines(out.read_text(), truth)
        top = sum(hits.get(q, [None])[0] == s for q, s in truth.items())
        busy = sum(kms.values()) / 1e3
        secs = {k: round(v, 3) for k, v in metrics.timings.items()}
        log(f"{cmd}: {len(truth)} queries in {wall:.2f} s = "
            f"{len(truth) / wall:.3f} queries/s; {batches} score batches, "
            f"{traced} traced hits; stage seconds "
            f"{json.dumps(secs, sort_keys=True)}")
        log(f"{cmd}: kernel ms, launches {_ms_launches(K, kms)}; "
            f"kernels busy {busy:.3f} s = {100 * busy / wall:.2f}% of the "
            f"wall; source as the top hit for {top}/{len(truth)}; text md5 "
            f"{_check_md5(cmd, out)}")
        if top < 0.95 * len(truth):
            raise AssertionError(f"{cmd}: source the top hit of only {top} "
                                 f"of {len(truth)} queries")
        runs[cmd] = dict(launches=n, ms=kms, wall=wall)
    return runs


# --------------------------------------------------------------- phase 8
PROT_CHROMS = (9.5e6, 8.5e6, 7.5e6, 6.5e6)
N_PROT_GENES = 100


def _codons() -> dict:
    """aa letter -> its sense codons (the standard code)."""
    from spaln_tpu_torch import constants as C
    from spaln_tpu_torch.seq.codec import decode_protein
    out: dict = {}
    for c in range(64):
        aa = decode_protein(np.asarray([C.GENCODE[c]], np.int8))
        if aa in AMINO:
            out.setdefault(aa, []).append("ACGT"[(c >> 4) & 3]
                                          + "ACGT"[(c >> 2) & 3]
                                          + "ACGT"[c & 3])
    return out


def make_protein_gene_corpus(d: Path) -> list:
    """Synthetic protein-to-genome deployment: 4 chromosomes (~32 Mb, GC
    ~41%) with N_PROT_GENES protein-coding genes planted on both strands
    (proteins of phase 7's log-normal lengths, median 375 aa, clipped to
    80-1,500; back-translated with random synonymous codons and a stop;
    3-10 exons cut at random codon phases; GT..AG introns log-uniform
    over 0.1-10 kb), and queries: each source protein with 0-20%
    substitutions and 0-2 indels of 1-10 aa.  Writes genome.fa and
    prot.fa; returns the planted truth per query (coding exons without
    the stop codon)."""
    rng = np.random.default_rng(SEED + 9)
    codons = _codons()
    lens = [int(x) for x in PROT_CHROMS]
    chroms = [np.array(list("ACGT"), dtype="S1")[
        rng.choice(4, n, p=[0.295, 0.205, 0.205, 0.295])] for n in lens]
    truth, queries, taken = [], [], [[] for _ in lens]
    p_chrom = np.asarray(lens, float) / sum(lens)
    lo, hi = np.log(100), np.log(10_000)
    while len(truth) < N_PROT_GENES:
        n_aa = int(np.clip(np.round(np.exp(rng.normal(np.log(375), 0.5))),
                           80, 1500))
        prot = "M" + _protein(rng, n_aa - 1)
        cds = "".join(codons[a][int(rng.integers(len(codons[a])))]
                      for a in prot) + "TAA"
        n_ex = int(rng.integers(3, 11))
        cuts = np.sort(rng.choice(np.arange(30, len(cds) - 33),
                                  n_ex - 1, replace=False))
        if np.any(np.diff(np.concatenate([[0], cuts, [len(cds)]])) < 12):
            continue
        parts, spans, at, prev = [], [], 0, 0
        for c in list(cuts) + [len(cds)]:
            e = cds[prev:c]
            spans.append((at, at + len(e) - (3 if c == len(cds) else 0)))
            parts.append(e)
            at += len(e)
            prev = c
            if c != len(cds):
                n = int(np.exp(rng.uniform(lo, hi)))
                intr = "GTAAGT" + _seq(rng, n - 12, 0.38) + "TTTCAG"
                parts.append(intr)
                at += len(intr)
        g = "".join(parts)
        c = int(rng.choice(len(lens), p=p_chrom))
        pos = int(rng.integers(20_000, lens[c] - len(g) - 20_000))
        if any(pos < b + 20_000 and a < pos + len(g) + 20_000
               for a, b in taken[c]):
            continue
        taken[c].append((pos, pos + len(g)))
        strand = "+" if len(truth) % 2 == 0 else "-"
        exons = _plant(rng, chroms[c], pos, g, spans, strand)
        qn = f"pg{len(truth):03d}"
        truth.append(dict(q=qn, chrom=f"chr{c + 1}", strand=strand,
                          span=(pos, pos + len(g)), exons=exons))
        queries.append(f">{qn}\n" + _mutate_protein(
            rng, prot, float(rng.uniform(0.0, 0.2)),
            int(rng.integers(0, 3))) + "\n")
    _write_fasta(d / "genome.fa", [f"chr{c + 1}" for c in range(len(lens))],
                 chroms)
    (d / "prot.fa").write_text("".join(queries))
    return truth


@contextlib.contextmanager
def _keep_tron_batches(TK):
    """Keep every batch K7 is called on (its operands stay on the card)
    and the records each K8 walk wrote, in launch order."""
    kept = {"forward": [], "walk": []}
    fwd, walk = TK.tron_forward, TK.tron_walk

    def forward(bp, prm):
        kept["forward"].append((bp, prm))
        return fwd(bp, prm)

    def walk_(bp, planes, ends):
        recs, counts = walk(bp, planes, ends)
        kept["walk"].append(dict(B=bp.B, records=int(counts.sum()),
                                 recs=recs, counts=counts))
        return recs, counts
    TK.tron_forward, TK.tron_walk = forward, walk_
    try:
        yield kept
    finally:
        TK.tron_forward, TK.tron_walk = fwd, walk


def _tron_launches(TK, TD, kept: dict, each: dict, fwd: str) -> dict:
    """K7 and K8 on phase 8's own batches: each launch's geometry (k
    slabs a CTA, CTAs per problem, serial steps) and time (CUDA events
    on the map's run) beside the bound of its work; the sums of ms,
    bound and ms - bound over the launches, and the most CTAs a problem
    had."""
    rows = {fwd: [], "tron_walk": []}
    ctas = 0
    for (bp, prm), ms in zip(kept["forward"], each[fwd]):
        bound, by = _bound(*_tron_work(TD, bp, prm.dagp))
        plan = _tron_geom(TK, bp, prm)
        ctas = max(ctas, plan["ncta"])
        rows[fwd].append(ms - bound)
        log(f"  {fwd}: B={bp.B} S={bp.S} W={bp.W} T={bp.T} k={plan['k']} "
            f"CTAs={plan['ncta']} steps={plan['steps']}: {ms:.3f} ms = "
            f"{1e3 * ms / plan['steps']:.3f} us a step, bound "
            f"{bound:.5f} ms by {by}")
    for w, ms in zip(kept["walk"], each["tron_walk"]):
        bound, by = _bound(*_walk_work(w["records"], w["B"]))
        rows["tron_walk"].append(ms - bound)
        log(f"  tron_walk: B={w['B']}, {w['records']} records, "
            f"{w['steps']} serial steps: {ms:.3f} ms = "
            f"{ms * 1e6 / w['steps']:.1f} ns a step, "
            f"{w['tile_loads']:.2f} tile loads a walk (most "
            f"{w['tile_loads_max']}), bound {bound:.7f} ms by {by}")
    out = {}
    for k, ex in rows.items():
        out[k] = dict(launches=len(ex), ms=sum(each[k]),
                      ms_minus_bound=sum(ex))
    out[fwd]["max_ctas"] = ctas
    return out


def _recheck_tron_walks(TK, TD, kept: dict, label: str) -> float:
    """Each K8 launch of a map, after it: the batch's K7 run again, the
    map's records held against K8's plain version and against K8 run
    again with its stats, whose steps and tile loads must equal the
    model's; each walk entry of ``kept`` gains their _walk_keys.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    for j, ((bp, prm), w) in enumerate(zip(kept["forward"], kept["walk"])):
        planes, row, rc, loc = TK.tron_forward(bp, prm)
        et = _tron_ends(TD, bp, row, rc, loc)
        st = torch.empty((bp.B, 2), dtype=torch.int32, device="cuda")
        recs, counts = TK.tron_walk(bp, planes, et, stats=st)
        if not torch.equal(counts, w["counts"]) or not all(
                torch.equal(recs[b, :n], w["recs"][b, :n])
                for b, n in enumerate(counts.tolist())):
            raise AssertionError(f"{label}: batch {j}'s walk differs on a "
                                 f"second run")
        keys, _ = _tron_walk_check(TK, f"{label}, batch {j}", bp, planes,
                                   et, w.pop("recs"), w.pop("counts"), st)
        w.update(keys)
        del planes, recs
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _protmap_prep(d: str) -> tuple:
    """Phase 8's corpus and `index -K P`, in a worker process: (truth,
    seconds of the corpus, seconds of the index)."""
    from spaln_tpu_torch import cli
    d = Path(d)
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    truth = make_protein_gene_corpus(d)
    t1 = time.perf_counter()
    cli.main(["index", str(d / "genome.fa"), "-p", str(d / "genome"),
              "-K", "P"])
    return truth, t1 - t0, time.perf_counter() - t1


def protein_map(TK, TD, cli, metrics, prep):
    """index -K P (``prep``, the pending result of _protmap_prep, started
    with the script), then map of the protein queries: the default (SW local,
    3 states) and -y l3 (5 states) on K7 and K8; each launch of K7 and
    K8 timed beside its bound."""
    d = WORK / "protmap"
    t0 = time.perf_counter()
    truth, t_corpus, t_index = prep.get()
    log(f"protein map: corpus built in {t_corpus:.1f} s "
        f"({sum(PROT_CHROMS) / 1e6:.1f} Mb, {len(truth)} planted genes) "
        f"and index -K P built in {t_index:.1f} s in a process of their "
        f"own beside the builds and phase 1 "
        f"({time.perf_counter() - t0:.1f} s of waiting)")
    runs = {}
    for mode, extra in (("default", []), ("yl3", ["-y", "l3"])):
        metrics.reset()
        _reset_counts(TK)
        out = OUT / f"protmap.{mode}.O0_4"
        each = {}
        with kernel_clock(TK, each=each) as kms, \
                _keep_tron_batches(TK) as kept:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(["map", str(d / "prot.fa"), "-d", str(d / "genome"),
                      "-T", "Tetrapod", "-O", "0,4", "-o", str(out),
                      "--device", "cuda", *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _check_no_skips(metrics, f"protein map ({mode})")
        if any(TK.plain_calls.values()):
            raise AssertionError(f"protein map ({mode}): plain versions "
                                 f"ran: {TK.plain_calls}")
        c, n = dict(metrics.counters), dict(TK.launches)
        fwd = "tron_forward_dagp" if mode == "yl3" else "tron_forward"
        label = "protein map -yl3" if mode == "yl3" else "protein map"
        nb = c.get("tron_buckets", 0)
        if not nb or n[fwd] != nb or n["tron_walk"] != nb:
            raise AssertionError(f"protein map ({mode}): {nb} batches, "
                                 f"launches {n}")
        hit, rec, prec, missed = _score_text(out.read_text(), truth)
        secs = {k: round(v, 3) for k, v in metrics.timings.items()}
        busy = sum(kms.values()) / 1e3
        log(f"protein map ({mode}): {len(truth)} queries in {wall:.2f} s = "
            f"{len(truth) / wall:.3f} queries/s; {nb} tron batches, "
            f"{c.get('tron_jobs', 0)} jobs, tron_dp_cells "
            f"{c.get('tron_dp_cells', 0)}; stage seconds "
            f"{json.dumps(secs, sort_keys=True)}")
        log(f"protein map ({mode}): kernel ms, launches "
            f"{_ms_launches(TK, kms)}; kernels busy {busy:.3f} s = "
            f"{100 * busy / wall:.2f}% of the wall")
        log(f"protein map ({mode}): {hit}/{len(truth)} = "
            f"{100 * hit / len(truth):.1f}% at the planted locus and "
            f"strand; exon recall {rec:.4f}, precision {prec:.4f}; missed "
            f"{missed}; text md5 {_check_md5(label, out)}")
        if hit < 0.9 * len(truth):
            raise AssertionError(f"protein map ({mode}): only {hit} of "
                                 f"{len(truth)} at their planted locus")
        secs = _recheck_tron_walks(TK, TD, kept, f"protein map ({mode})")
        log(f"protein map ({mode}): every K8 launch exact against its "
            f"plain version, its steps and tile loads equal to the model's "
            f"({secs:.1f} s after the map)")
        log(f"protein map ({mode}): each launch of K7 and K8")
        per = _tron_launches(TK, TD, kept, each, fwd)
        geoms = {k: v for k, v in c.items() if k.startswith("tron_k7")}
        log(f"protein map ({mode}): over the launches "
            f"{json.dumps(per, sort_keys=True)}; K7 launches by geometry "
            f"(metrics) {json.dumps(geoms, sort_keys=True)}")
        if per[fwd]["max_ctas"] < 2:
            raise AssertionError(f"protein map ({mode}): no K7 launch ran "
                                 f"a problem on more than one CTA")
        runs[mode] = dict(launches=n, ms=kms, wall=wall, per_launch=per)
    return runs


_MANGLED = re.compile(r"(\w*?_kernel)((?:I(?:L\w+?-?\d+E)+E)?)")


def _kernel_name(mangled: str) -> str:
    """A kernel instance's name with its template arguments
    (kernel<1,0>), from its mangled name."""
    m = _MANGLED.search(mangled)
    # the mangled name ends in <length><name>
    pre = m.group(1)
    name = next(pre[-k:] for k in range(1, len(pre))
                if pre[:-k].endswith(str(k)))
    args = re.findall(r"L[a-z]+(-?\d+)E", m.group(2))
    return f"{name}<{','.join(args)}>" if args else name


def _ptxas_report(text: str) -> list:
    """nvcc -Xptxas -v's lines for each kernel instance: its name with
    the template arguments (kernel<1,0>), its spills and its registers
    and barriers."""
    out = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and _MANGLED.search(m.group(1)):
            out.append(_kernel_name(m.group(1)))
        elif "registers" in line or "spill" in line:
            out.append("  " + line.replace("ptxas info    :", "").strip())
    return out


def _ptxas_instances(text: str) -> dict:
    """Each kernel instance's registers and spill stores (bytes) in
    nvcc's -Xptxas -v log: name -> {"regs", "spill"}."""
    out, name = {}, None
    for line in _ptxas_report(text):
        if not line.startswith(" "):
            name = line
            out[name] = {"regs": 0, "spill": 0}
        elif m := re.search(r"(\d+) bytes spill stores", line):
            out[name]["spill"] = int(m.group(1))
        elif m := re.search(r"Used (\d+) registers", line):
            out[name]["regs"] = int(m.group(1))
    return out


def _sass(so: Path) -> tuple[dict, str]:
    """(kernel instance -> [its SASS instructions but NOPs, those of its
    largest loop (a backward branch's span)], the listing) of a library,
    from cuobjdump -sass."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, name, addrs = {}, None, []
    for line in text.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            name = (_kernel_name(m.group(1))
                    if _MANGLED.search(m.group(1)) else m.group(1))
            counts[name], addrs = [0, 0], []
        elif name and (m := re.match(
                r"\s*/\*([0-9a-f]{4,})\*/\s+(?!NOP\b)(\S.*)", line)):
            at = int(m.group(1), 16)
            addrs.append(at)
            counts[name][0] += 1
            if (b := re.search(r"\bBRA 0x([0-9a-f]+)", m.group(2))) \
                    and int(b.group(1), 16) < at:
                span = sum(int(b.group(1), 16) <= a for a in addrs)
                counts[name][1] = max(counts[name][1], span)
    return counts, text


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def timing_main(what: str, argv: list) -> int:
    """--slab-timing, --tron-timing, --probe-timing, --walk-timing or
    --emission-timing [--package-root DIR]: phase 1's tetrapod-width
    timing (slab_timing), the tron timing (tron_timing), the step probes
    and knock-outs (probe_timing), the walks (walk_timing) or the two
    forms of K6's local emission (emission_timing) alone, of the package
    under DIR (default: this checkout), so that two commits are timed on
    one card; prints one JSON line."""
    if argv[:1] == ["--package-root"]:
        sys.path.insert(0, str(Path(argv[1]).resolve()))
    log(_card())
    if what == "--emission-timing":
        from spaln_tpu_torch.ops import dp_spliced as dp
        from spaln_tpu_torch.ops import dp_spliced_cuda as K
        print(json.dumps({"emission_timing": emission_timing(K, dp),
                          "package": K.__file__}))
        return 0
    if what == "--walk-timing":
        from concurrent.futures import ThreadPoolExecutor
        from spaln_tpu_torch.ops import dp_spliced as dp
        from spaln_tpu_torch.ops import dp_spliced_cuda as K
        from spaln_tpu_torch.ops import dp_tron as TD
        from spaln_tpu_torch.ops import dp_tron_cuda as TK
        from spaln_tpu_torch.probes import _cuda as PC
        with ThreadPoolExecutor(3) as pool:
            builds = list(pool.map(K.build_library, (K.SOURCE, TK.SOURCE,
                                                     PC.SOURCE)))
        for so, secs, ptxas in builds:
            log(f"  {so.name}: nvcc {secs:.1f} s")
            if so.name.startswith("libprobes"):
                continue
            for line in _ptxas_report(ptxas):
                log("  ptxas: " + line)
        print(json.dumps({"walk_timing": walk_timing(K, dp, TK, TD),
                          "package": K.__file__}))
        return 0
    if what == "--probe-timing":
        print(json.dumps({"probe_timing": probe_timing()}))
        return 0
    if what == "--tron-timing":
        from spaln_tpu_torch.ops import dp_tron as TD
        from spaln_tpu_torch.ops import dp_tron_cuda as TK
        so, secs, _ = TK.build_library(TK.SOURCE)
        log(f"kernels of {TK.__file__} built in {secs:.1f} s")
        print(json.dumps({"tron_timing": tron_timing(TK, TD),
                          "package": TK.__file__}))
        return 0
    from spaln_tpu_torch.align.driver import AlignerContext
    from spaln_tpu_torch.ops import dp_spliced as dp
    from spaln_tpu_torch.ops import dp_spliced_cuda as K
    from spaln_tpu_torch.score.tables import TableDir, find_table_dir
    so, secs, _ = K.build_library()
    log(f"kernels of {K.__file__} built in {secs:.1f} s")
    ctx = AlignerContext.create(
        TableDir(find_table_dir(), species="Tetrapod"), "cuda")
    print(json.dumps({"slab_timing": slab_timing(K, dp, ctx),
                      "package": K.__file__}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] in (["--slab-timing"], ["--tron-timing"],
                         ["--probe-timing"], ["--walk-timing"],
                         ["--emission-timing"]):
        return timing_main(sys.argv[1], sys.argv[2:])
    from spaln_tpu_torch import cli
    from spaln_tpu_torch.align.driver import AlignerContext
    from spaln_tpu_torch.ops import dp_spliced as dp
    from spaln_tpu_torch.ops import dp_spliced_cuda as K
    from spaln_tpu_torch.ops import dp_tron as TD
    from spaln_tpu_torch.ops import dp_tron_cuda as TK
    from spaln_tpu_torch.score.tables import TableDir, find_table_dir
    from spaln_tpu_torch.utils.metrics import metrics
    from spaln_tpu_torch import probes
    from spaln_tpu_torch.probes import _cuda as PC, mosaic_repro as MR
    from concurrent.futures import ThreadPoolExecutor
    import multiprocessing

    log(_card())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    OUT.mkdir(parents=True, exist_ok=True)
    stack = contextlib.ExitStack()
    try:
        # phase 8's corpus and protein index, built in a process of their
        # own beside the builds and phase 1 (before the K7 plain versions
        # take six cores)
        protmap_prep = stack.enter_context(
            multiprocessing.get_context("spawn").Pool(1)).apply_async(
                _protmap_prep, (str(WORK / "protmap"),))
        # one nvcc per source, started together
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            builds = list(pool.map(K.build_library,
                                   (K.SOURCE, TK.SOURCE, PC.SOURCE,
                                    MR.SOURCE)))
        log(f"kernels built in {time.perf_counter() - t0:.1f} s")
        for so, secs, ptxas in builds:
            log(f"  {so.relative_to(ROOT)}: nvcc {secs:.1f} s")
            if so.name.startswith(("libprobes", "libmosaic_repro")):
                log(f"  ptxas: {_ptxas_summary(ptxas)}")
                continue
            for line in _ptxas_report(ptxas):
                log("  ptxas: " + line)
        ctx = AlignerContext.create(
            TableDir(find_table_dir(), species="Dictyost"), "cuda")
        results = check_kernels(K, dp, ctx)
        ctx3 = AlignerContext.create(
            TableDir(find_table_dir(), species="Dictyost"), "cuda",
            y_args=["-yl3"])
        results.update(check_k5_kernels(K, dp, ctx3))
        _, k6_rows = check_tall_kernels(K, dp, ctx, ctx3,
                                        k6_jobs(K, dp, ctx, ctx3))
        results.update(check_retrace_pairs(K, dp, ctx, ctx3))
        # K7's plain versions step on CPU copies in 6 processes while
        # phases 2-8 run (the pool's workers end with the block)
        tron_pool = stack.enter_context(
            multiprocessing.get_context("spawn").Pool(6))
        tron_finish = check_tron_kernels(TK, TD, tron_pool)
        slab_timing(K, dp, AlignerContext.create(
            TableDir(find_table_dir(), species="Tetrapod"), "cuda"))
        small_map(K, cli)
        plane_launches = full_map(K, cli, metrics)
        tetra, truth = tetrapod_map(K, cli, metrics)
        segment_align(K, cli, metrics)
        yl3 = tetrapod_yl3_map(K, cli, metrics, truth)
        k6map = tetrapod_k6_map(K, cli, metrics, truth)
        prot = protein_search(K, cli, metrics)
        lsearch = local_protein_search(K, metrics)
        pmap = protein_map(TK, TD, cli, metrics, protmap_prep)
        # the step probes, while K7's plain versions finish
        mods = probes.modules()
        probe_res = probe_phase(PC, mods, check_probes(PC, mods, (128, 1024)),
                                (128, 1024))
        # phase 10: the skeletons and the bench, while they finish
        t10 = time.perf_counter()
        skeletons = check_skeletons(MR)
        bench_row = bench_phase(K)
        log(f"phase 10 took {time.perf_counter() - t10:.1f} s")
        tron = tron_finish()
        # phase 13, on phase 4's genome and index, with the cores free
        sharded_phase(K, cli, metrics, truth)
    finally:
        stack.close()
        shutil.rmtree(WORK, ignore_errors=True)
    src = str((ROOT / "spaln_tpu_torch/csrc/spliced_dp.cu")
              .relative_to(ROOT))
    # launches: the plane-path entries from phase 3's map, the UDH ones
    # from phase 4's forced-UDH map, the double-affine ones from phase 6
    # (K1-dagp from the size rule's run, the UDH entries from -A 3's) and
    # the score-only entry from phase 7's search
    launches = dict(plane_launches)
    for k in ("spliced_slab_links", "spliced_slab_retrace",
              "spliced_tb_strips"):
        launches[k] = tetra["udh"]["launches"][k]
    launches["spliced_slab_trace_dagp"] = \
        yl3["default"]["launches"]["spliced_slab_trace_dagp"]
    for k in ("spliced_slab_links_dagp", "spliced_slab_retrace_dagp"):
        launches[k] = yl3["udh"]["launches"][k]
    launches["spliced_slab_score"] = \
        prot["search"]["launches"]["spliced_slab_score"]
    # the retrace of pairs from phase 11's K6 maps under -A 3: the
    # junction-record map (single affine) and -L S -y l3 (double)
    launches["spliced_slab_retrace_pairs"] = k6map["map junctions -A 3"][
        "launches"]["spliced_slab_retrace_pairs"]
    launches["spliced_slab_retrace_pairs_dagp"] = k6map[
        "map -L S -A 3 -y l3"]["launches"]["spliced_slab_retrace_pairs_dagp"]
    # K2e from phase 7's score pass, one a score batch (the plane path
    # runs it inside the fused entry; spliced_tb_walk, K3 alone, is on no
    # path: its walk runs in the fused entry, its kernel in the strips')
    launches["spliced_last_ends"] = \
        prot["search"]["launches"]["spliced_last_ends"]
    # the tron entries from phase 8's maps: K7 and K8 from the default
    # run, K7's double-affine mode from -y l3's
    launches["tron_forward"] = pmap["default"]["launches"]["tron_forward"]
    launches["tron_walk"] = pmap["default"]["launches"]["tron_walk"]
    launches["tron_forward_dagp"] = \
        pmap["yl3"]["launches"]["tron_forward_dagp"]
    results.update(tron)
    # K6's modes: K1 and K4 in the local and -yJ modes from phase 11's
    # maps, K1 with the emission from phase 12's local search
    k6_launches = {name: 0 for name in k6_rows}
    for run in k6map.values():
        for key, n in run["modes"].items():
            entry, local, cip, emit = key.split("|")
            mode = "[local,emission]" if emit == "True" else "[local,-yJ]"
            if local == "True" or cip == "True":
                k6_launches[entry + mode] += n
    k6_launches["spliced_slab_trace[local,emission]"] = lsearch["launches"]
    if not all(k6_launches.values()):
        raise AssertionError(f"a K6 mode never ran: {k6_launches}")
    sources = {k: src for k in K.KERNELS}
    sources.update({k: str(TK.SOURCE.relative_to(ROOT)) for k in TK.KERNELS})
    names = K.KERNELS + TK.KERNELS
    path = set(K.PLANE_PATH + K.PLANE_PATH_DAGP + K.UDH_PATH
               + K.UDH_PATH_DAGP + K.UDH_PATH_K6 + K.UDH_PATH_K6_DAGP
               + K.SCORE_PATH + TK.KERNELS)
    if not all(launches[k] > 0 for k in path) or launches["spliced_tb_walk"]:
        raise AssertionError(f"a kernel of the path never ran, or K3 ran "
                             f"alone: {launches}")
    rows = probe_res["rows"]
    idle = [k for k, r in rows.items() if r["launches"] == 0]
    if idle:
        raise AssertionError(f"a probe kernel never ran: {idle}")
    idle = [lev for lev, r in skeletons.items() if r["launches"] == 0]
    if idle or not bench_row["launches"]:
        raise AssertionError(f"a skeleton level never ran: {idle}, or the "
                             f"bench's score kernel: {bench_row}")
    probe_src = str(PC.SOURCE.relative_to(ROOT))
    skel_src = str(MR.SOURCE.relative_to(ROOT))
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=sources[k], replaces=REPLACES[k],
             launches=launches[k], max_abs_err=results[k]["max_abs_err"],
             ms=results[k]["ms"], plain_ms=results[k]["plain_ms"],
             bound_ms=results[k]["bound_ms"],
             bound_by=results[k]["bound_by"], library_ms=None,
             **{x: results[k][x] for x in (*WALK_KEYS, "call_ms",
                                           "one_slab_ms", "pairs",
                                           "ctas_per_sm")
                if x in results[k]},
             **({} if k in path else {"main_path": "none: its walk runs "
                                      "in spliced_ends_tb_walk"}))
        for k in names] + [
        dict(name=k, route="cuda", source=src,
             replaces="spaln_tpu/ops/dp_spliced_scan.py:223",
             launches=k6_launches[k], max_abs_err=r["max_abs_err"],
             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=None, off_ms=r["off_ms"])
        for k, r in k6_rows.items()] + [
        dict(name=k, route="cuda", source=probe_src,
             replaces=probes.REPLACES[k.split(":")[0]],
             launches=r["launches"], max_abs_err=r["max_abs_err"],
             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=None, steps=r["steps"],
             plain_steps=r["plain_steps"])
        for k, r in rows.items()] + [
        dict(name=f"skeleton_kernel<{lev}>", route="cuda", source=skel_src,
             replaces=MR.REPLACES[MR.kernel_of(lev)], launches=r["launches"],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=None, B=r["B"],
             ns_per_step=r["ns_per_step"])
        for lev, r in skeletons.items()] + [
        dict(name="spliced_slab_score (bench)", route="cuda", source=src,
             replaces="bench.py:92", launches=bench_row["launches"],
             max_abs_err=bench_row["max_abs_err"], ms=bench_row["ms"],
             plain_ms=bench_row["plain_ms"], bound_ms=bench_row["bound_ms"],
             bound_by=bench_row["bound_by"], library_ms=None,
             gcups=bench_row["gcups"],
             spread_gcups=bench_row["spread_gcups"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
