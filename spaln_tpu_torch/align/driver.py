"""Seeded alignment driver for genome mapping: query x genomic window
jobs -> gene structures, batched by geometry onto the device DP.

The counterpart of spaln_tpu/align/driver.py for the map path: host-side
geometry (window restriction, band placement, geometry buckets) and
gene-structure extraction stay on the host; the banded spliced DP of
each bucket runs on ``AlignerContext.device`` through run_bucket (three
CUDA kernels on a CUDA device, their plain versions on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config, resolve, CvsG, apply_y_args
from ..ops.params import DpParams, DpFlags
from ..ops.dp_spliced import prepare_spliced_batch
from ..ops.dp_spliced_cuda import run_bucket
from ..score.intron import IntronPenalty
from ..score.simmtx import Simmtx
from ..score.splice import build_splice_signals
from ..score.tables import TableDir
from ..seed.wilip import Chain
from .gene import GeneStructure, build_gene_structure

# device-memory budget for one launch's traceback planes (13 B per cell:
# a flag byte and three int32 junction planes): 16 GiB of the H100's
# 80 GB, leaving room for operands, the walk records and the caching
# allocator.  A bucket over it runs as several smaller batches with the
# same results.
PLANE_BYTES_BUDGET = 16 << 30
PLANE_BYTES_PER_CELL = 13


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class AlignerContext:
    """Per-run immutable context (tables + resolved params + device)."""
    cfg: Config
    tables: TableDir
    prm: DpParams
    ipen: IntronPenalty
    flags: DpFlags
    device: torch.device

    @classmethod
    def create(cls, tables: TableDir, device: torch.device | str,
               cfg: Config | None = None, dvsp: int = CvsG,
               y_args: list | None = None) -> "AlignerContext":
        cfg = cfg or Config()
        # species AlnParam file re-fed as -y args (readargs role)
        cfg = apply_y_args(cfg, tables.alnparam_args())
        if y_args:
            cfg = apply_y_args(cfg, y_args)
        cfg = resolve(cfg, dvsp)
        ipen = IntronPenalty(cfg, dvsp)
        sm = Simmtx.dna(match=cfg.aln.smn_match,
                        mismatch=cfg.aln.smn_mismatch)
        prm = DpParams.build(cfg, sm, dvsp, ipen=ipen)
        if prm.dagp:
            raise NotImplementedError(
                "double-affine gaps (-yl3) are not ported yet: ROADMAP.md "
                "Queue 2, K5 (dagp mode of the slab kernel)")
        return cls(cfg=cfg, tables=tables, prm=prm, ipen=ipen,
                   flags=DpFlags(), device=torch.device(device))


@dataclass
class AlignJob:
    """One query x genomic-window DP problem, band resolved, ready for
    the batched engine."""
    q: np.ndarray
    gw: np.ndarray
    sig: object
    lw: int
    up: int
    strand: str
    lo: int                      # gw offset within the caller's window
    g_total: int = 0             # caller-window length (minus-view flip)
    q_name: str = ""
    g_name: str = ""


def prepare_job(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                chain: Chain | None, sh: int = 100, margin: int = 2000,
                q_name: str = "", g_name: str = "",
                strand: str = "+") -> AlignJob | None:
    """Window restriction + band geometry for one problem (stripe role,
    aln2.cc:156-199)."""
    M = len(q)
    if chain is not None:
        g0, g1 = chain.g_span
        q0, q1 = chain.q_span
        # uncovered query ends may be short first/last exons across an
        # unseen intron: keep enough upstream/downstream genome in the
        # window for the end-refinement scan (first_exon/last_exon,
        # fwd2s1.cc:2274-2404)
        end_margin = 20_000
        lo = max(0, g0 - q0 - (margin if q0 <= 8 else end_margin))
        hi = min(len(g), g1 + (M - q1)
                 + (margin if M - q1 <= 8 else end_margin))
    else:
        lo, hi = 0, len(g)
    gw = np.asarray(g[lo:hi])
    N = len(gw)
    if N == 0 or M == 0:
        return None
    sig = build_splice_signals(gw, ctx.cfg, ctx.tables)
    if chain is not None:
        diags = [h.diag - lo for h in chain.hsps]
        lw = max(min(diags) - sh, -M)
        up = min(max(diags) + sh, N)
        # query ends not covered by the chain may sit across an unseen
        # intron; widen the band there
        q0, q1 = chain.q_span
        if q0 > 15:
            lw = max(lw - q0 - margin, -M)
        if M - q1 > 15:
            up = min(up + (M - q1) + margin, N)
    else:
        lw, up = -M, N
    # band widths on a 1.5x ladder from 512: few distinct bucket widths
    # for at most 50% masked cells (the placement is part of the result,
    # so it stays the reference's)
    W = up - lw + 1
    Wb = 512
    while Wb < W:
        Wb = _round_up(Wb * 3 // 2, 256)
    extra = Wb - W
    lw = max(lw - extra // 2, -M)
    up = min(lw + Wb - 1, N)
    lw = max(up - Wb + 1, -M)
    return AlignJob(q=q, gw=gw, sig=sig, lw=lw, up=up, strand=strand,
                    lo=lo, g_total=len(g), q_name=q_name, g_name=g_name)


def _to_minus_view(gs: GeneStructure, M: int, N: int) -> GeneStructure:
    """Re-express a minus-strand result computed in transcript
    orientation (original query x length-N reverse-complemented window)
    in the output convention: rc-query coordinates with ascending
    forward-genome coordinates (the reference's SiteNo conversion,
    sqpr.cc)."""
    for e in gs.exons:
        e.q_start, e.q_end = M - e.q_end, M - e.q_start
        e.g_start, e.g_end = N - e.g_end, N - e.g_start
    gs.exons.reverse()
    for i in gs.introns:
        i.g_start, i.g_end = N - i.g_end, N - i.g_start
        i.q_pos = M - i.q_pos
    gs.introns.reverse()
    return gs


def _finish_job(job: AlignJob, score: int, ops: list,
                prm=None) -> GeneStructure | None:
    gs = build_gene_structure(ops, job.q, job.gw, score, sig=job.sig,
                              q_name=job.q_name, g_name=job.g_name,
                              strand=job.strand, prm=prm)
    if gs is None:
        return None
    if prm is not None and job.sig is not None:
        # first/last-exon end refinement (fwd2s1.cc:2274-2404) in
        # window/transcript coordinates, before offset + strand flips
        from .refine import refine_ends
        refine_ends(gs, job.q, job.gw, job.sig, prm)
    for e in gs.exons:
        e.g_start += job.lo
        e.g_end += job.lo
    for i in gs.introns:
        i.g_start += job.lo
        i.g_end += job.lo
    if job.strand == "-":
        _to_minus_view(gs, len(job.q), job.g_total)
    return gs


def coalesce_buckets(buckets: dict, jobs: list, max_batch: int) -> dict:
    """Bucket coalescing: within each Mpad, promote the under-filled
    width classes (fewer than ``max_batch`` jobs) into the widest W of
    the group, widening each promoted job's band (``up``) to it.  The
    band is a search-space restriction, so widening only adds freedom,
    but it can change a result: the reference does it on every backend,
    and so does the port.  ``buckets`` maps (W, Mpad) to indices into
    ``jobs``; returns the merged map."""
    by_m: dict[int, list[tuple]] = {}
    for (W, Mpad), idxs in buckets.items():
        by_m.setdefault(Mpad, []).append((W, idxs))
    merged: dict[tuple, list[int]] = {}
    for Mpad, entries in by_m.items():
        entries.sort()                      # ascending W
        Wmax = entries[-1][0]
        small, kept = [], []
        for W, idxs in entries:
            if W < Wmax and len(idxs) < max_batch:
                small.extend(idxs)
            else:
                kept.append((W, idxs))
        if small:
            if kept and kept[-1][0] == Wmax:
                kept[-1] = (Wmax, kept[-1][1] + small)
            else:
                kept.append((Wmax, small))
            for i in small:
                jobs[i].up = jobs[i].lw + Wmax - 1
        for W, idxs in kept:
            merged[(W, Mpad)] = idxs
    return merged


def execute_jobs(jobs: list[AlignJob], ctx: AlignerContext,
                 lanes: int = 128, max_batch: int = 32
                 ) -> list[GeneStructure | None | BaseException]:
    """Run many jobs through the device DP, bucketed by geometry (W,
    Mpad): one run_bucket (three kernel launches, one copy back) per
    batch of a bucket."""
    from ..utils.metrics import metrics, stage
    results: list = [None] * len(jobs)
    buckets: dict[tuple, list[int]] = {}
    for i, job in enumerate(jobs):
        if job is None:
            continue
        W = job.up - job.lw + 1
        Mpad = _round_up(len(job.q), lanes)
        buckets.setdefault((W, Mpad), []).append(i)

    buckets = coalesce_buckets(buckets, jobs, max_batch)
    for (W, Mpad), idxs in buckets.items():
        T = W + 2 * lanes - 2
        n_slabs = max(Mpad // lanes, 1)
        per = T * lanes * PLANE_BYTES_PER_CELL * n_slabs
        mb = min(max_batch, max(1, PLANE_BYTES_BUDGET // per))
        for c0 in range(0, len(idxs), mb):
            part = idxs[c0:c0 + mb]
            js = [jobs[i] for i in part]
            with stage("prep"):
                bp = prepare_spliced_batch(
                    [j.q for j in js], [j.gw for j in js], ctx.prm,
                    sigs=[j.sig for j in js], lws=[j.lw for j in js],
                    W=W, L=lanes, flags=ctx.flags, device=ctx.device)
            with stage("device_dp"):
                scores, ends, ops_all = run_bucket(bp, ctx.prm)
            metrics.bump("device_buckets")
            metrics.bump("dp_cells", bp.B * bp.S * bp.L * bp.W)
            with stage("traceback"):
                for bi, ji in enumerate(part):
                    # per-job isolation: a gene-structure failure
                    # surfaces as an exception result, not an abort
                    try:
                        results[ji] = _finish_job(jobs[ji], int(scores[bi]),
                                                  ops_all[bi], prm=ctx.prm)
                    except Exception as exc:
                        results[ji] = exc
            metrics.bump("jobs", len(part))
    return results
