"""Seeded alignment driver: query x genomic window jobs -> gene
structures, batched by geometry onto the device DP.

The counterpart of spaln_tpu/align/driver.py for cDNA queries: host-side
seeding and geometry (chains -> strand -> window -> band, geometry
buckets, the long-intron split and its closed-form junction joins) and
gene-structure extraction stay on the host; the banded spliced DP runs
on ``AlignerContext.device``, through the plane path (run_bucket) or the
linear-space UDH path (run_spliced_batch_udh), CUDA kernels on a CUDA
device and their plain versions on the CPU.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config, resolve, CvsG, apply_y_args
from ..ops.params import DpParams, DpFlags
from ..ops.dp_spliced import (PLANE_BYTES_BUDGET, plane_bytes_per_cell,
                              prepare_spliced_batch)
from ..ops.dp_spliced_cuda import run_bucket
from ..ops.dp_spliced_udh import run_spliced_batch_udh
from ..score.intron import IntronPenalty
from ..score.simmtx import Simmtx
from ..score.splice import build_splice_signals
from ..score.tables import TableDir
from ..seed.wilip import Chain, wilip
from ..seq.codec import comrev
from ..utils.errors import DeviceDPError
from ..utils.metrics import carry_stages, metrics, stage
from .gene import GeneStructure, build_gene_structure

# A bucket whose planes at the full batch would pass ``plane_budget``
# (default PLANE_BYTES_BUDGET, 16 GiB) runs through the linear-space UDH
# path instead of shrinking the batch (the reference's size rule,
# spaln_tpu/align/driver.py:554-565, MaxVmfSpace role, vmf.h:26-28).
# Planes cost plane_bytes_per_cell(prm) bytes per cell: 13, or 21 with
# double-affine gaps, where the reference counts 13 always; UDH and
# planes give the same results, so this moves memory, never output.
# One align window takes the UDH path when its planes would pass 96 MB
# (spaln_tpu/align/driver.py:764).
WINDOW_PLANE_BYTES = 96 << 20


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
    plane_budget: int = PLANE_BYTES_BUDGET   # bytes of planes per launch
    force_udh: bool = False                  # every multi-slab DP on UDH

    @classmethod
    def create(cls, tables: TableDir, device: torch.device | str,
               cfg: Config | None = None, dvsp: int = CvsG,
               y_args: list | None = None,
               plane_budget: int = PLANE_BYTES_BUDGET,
               force_udh: bool = False,
               local: bool = False) -> "AlignerContext":
        """``local`` (-L S) makes the map path's DP Smith-Waterman local
        (K6); the align windows stay semi-global, as in the reference
        (forward_spliced)."""
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
        return cls(cfg=cfg, tables=tables, prm=prm, ipen=ipen,
                   flags=DpFlags(local=local), device=torch.device(device),
                   plane_budget=plane_budget, force_udh=force_udh)

    def use_udh(self, n_slabs: int, planes_too_big: bool) -> bool:
        """The size-driven choice of the linear-space path, or every
        multi-slab problem under force_udh; a one-slab problem has no
        boundary to cross and always takes the planes."""
        return n_slabs > 1 and (self.force_udh or planes_too_big)


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
    cip: dict | None = None      # -yJ query junction bonus {m: value}


@stage("prep")
def prepare_job(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                chain: Chain | None, sh: int = 100, margin: int = 2000,
                q_name: str = "", g_name: str = "",
                strand: str = "+", cip: dict | None = None
                ) -> AlignJob | None:
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
                    lo=lo, g_total=len(g), q_name=q_name, g_name=g_name,
                    cip=cip)


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


@stage("traceback")
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


def coalesce_buckets(buckets: dict, jobs: list, max_batch: int,
                     band_extra: int = 1) -> dict:
    """Bucket coalescing: within each Mpad, promote the under-filled
    width classes (fewer than ``max_batch`` jobs) into the widest W of
    the group, widening each promoted job's band (``up``) to it.  The
    band is a search-space restriction, so widening only adds freedom,
    but it can change a result: the reference does it on every backend,
    and so does the port.  ``buckets`` maps (W, Mpad) to indices into
    ``jobs``, W = up - lw + ``band_extra`` (1 for cDNA jobs, 2 for
    protein ones); returns the merged map."""
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
                jobs[i].up = jobs[i].lw + Wmax - band_extra
        for W, idxs in kept:
            merged[(W, Mpad)] = idxs
    return merged


def _shards(part: list[int], devices: list) -> list[tuple[list, object]]:
    """Contiguous shards of a batch, one per listed device (sizes within
    one of each other; a device gets none when the batch is shorter than
    the list)."""
    n = len(devices)
    cut = [len(part) * i // n for i in range(n + 1)]
    return [(part[a:b], dev) for a, b, dev in zip(cut, cut[1:], devices)
            if b > a]


def execute_jobs(jobs: list[AlignJob], ctx: AlignerContext,
                 lanes: int = 128, max_batch: int = 32,
                 devices: list | None = None
                 ) -> list[GeneStructure | None | BaseException]:
    """Run many jobs through the device DP, bucketed by geometry (W,
    Mpad).  A bucket whose planes fit ``ctx.plane_budget`` runs as
    batches of one run_bucket each (two kernel launches, one copy
    back); a bucket that would have to shrink its batch for them runs
    whole through the UDH path (links pass, backwalk, retrace).

    With ``devices`` (the jax mesh's counterpart,
    spaln_tpu/align/driver.py:576-595), each batch, its route and size
    chosen whole as without, runs as contiguous shards, one per listed
    device, each prepared on its device; on CUDA devices the shards run
    at once (a thread a shard), CPU shards (the plain versions, whose
    own threads share the cores) in turn.  The results come back in job
    order.  A problem's result does not depend on its batch, so they
    equal the unsharded run's.  No padding: the reference pads to a
    device multiple only to reuse XLA compilations."""
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
        per = T * lanes * plane_bytes_per_cell(ctx.prm) * n_slabs
        mb_full = max(1, ctx.plane_budget // per)
        udh = ctx.use_udh(n_slabs, mb_full < min(max_batch, len(idxs)))
        mb = min(max_batch, len(idxs) if udh else mb_full)
        for c0 in range(0, len(idxs), mb):
            part = idxs[c0:c0 + mb]
            shards = (_shards(part, devices) if devices
                      else [(part, ctx.device)])
            with stage("prep"):
                bps = [_prepare_part([jobs[i] for i in sh], ctx, W, lanes,
                                     dev) for sh, dev in shards]

            def run(bp):
                if udh:
                    return run_spliced_batch_udh(bp, ctx.prm,
                                                 ctx.plane_budget)
                return run_bucket(bp, ctx.prm)
            with stage("device_dp"):
                if len(bps) > 1 and all(bp.device.type == "cuda"
                                        for bp in bps):
                    with ThreadPoolExecutor(len(bps)) as pool:
                        outs = list(pool.map(carry_stages(run), bps))
                else:
                    outs = [run(bp) for bp in bps]
            cells = sum(bp.B * bp.S * bp.L * bp.W for bp in bps)
            if udh:
                metrics.bump("udh_buckets")
                metrics.bump("udh_dp_cells", cells)
            else:
                metrics.bump("device_buckets")
                metrics.bump("dp_cells", cells)
            if devices:
                metrics.bump("sharded_batches")
            with stage("traceback"):
                for (sh, _), (scores, ends, ops_all) in zip(shards, outs):
                    for bi, ji in enumerate(sh):
                        # per-job isolation: a gene-structure failure
                        # surfaces as an exception result, not an abort
                        try:
                            results[ji] = _finish_job(
                                jobs[ji], int(scores[bi]), ops_all[bi],
                                prm=ctx.prm)
                        except Exception as exc:
                            results[ji] = exc
            metrics.bump("jobs", len(part))
    return results


def _prepare_part(js: list[AlignJob], ctx: AlignerContext, W: int,
                  lanes: int, device):
    """One batch of jobs at band width W, prepared on ``device``; the
    -yJ bonuses travel with their jobs."""
    cips = [j.cip for j in js] if any(j.cip for j in js) else None
    return prepare_spliced_batch(
        [j.q for j in js], [j.gw for j in js], ctx.prm,
        sigs=[j.sig for j in js], lws=[j.lw for j in js], W=W, L=lanes,
        flags=ctx.flags, cips=cips, device=device)


def forward_spliced(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                    sig=None, lw: int | None = None, up: int | None = None,
                    L: int = 128, udh: bool = False):
    """One problem (B = 1) on ``ctx.device`` through the plane path
    (run_bucket), or with ``udh`` the linear-space path: (score, end_m,
    end_n, ops), the counterpart of spaln_tpu's forward_spliced_scan +
    traceback_spliced_scan and forward_spliced_udh.  Any failure of the
    DP is raised as DeviceDPError, which per-query isolation passes on.
    The DP is semi-global with no -yJ bonus whatever ``ctx`` says: the
    reference's align windows call its DP without flags or cips
    (spaln_tpu/align/driver.py:326-328, 766-775), so `align -L S` and
    `align -y J...` print plain align's text there (ROADMAP.md Queue
    3)."""
    M, N = len(q), len(g)
    if lw is None:
        lw, up = -M, N
    try:
        bp = prepare_spliced_batch(
            [np.asarray(q)], [np.asarray(g)], ctx.prm,
            sigs=[sig] if sig is not None else None, lws=[lw],
            W=up - lw + 1, L=L, flags=DpFlags(), device=ctx.device)
        if udh:
            scores, ends, ops_all = run_spliced_batch_udh(
                bp, ctx.prm, ctx.plane_budget)
        else:
            scores, ends, ops_all = run_bucket(bp, ctx.prm)
    except Exception as exc:
        raise DeviceDPError(
            f"{'UDH' if udh else 'plane'} DP of a {M} x {N} problem on "
            f"{ctx.device}: {type(exc).__name__}: {exc}") from exc
    return int(scores[0]), int(ends[0][0]), int(ends[0][1]), ops_all[0]


def _align_window(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                  chain: Chain | None, sh: int, margin: int, lanes: int,
                  q_name: str, g_name: str, g_off: int,
                  strand: str) -> GeneStructure | None:
    job = prepare_job(q, g, ctx, chain, sh=sh, margin=margin,
                      q_name=q_name, g_name=g_name, strand=strand)
    if job is None:
        return None
    W = job.up - job.lw + 1
    T = W + 2 * lanes - 2
    n_slabs = -(-len(job.q) // lanes)
    big = (T * lanes * plane_bytes_per_cell(ctx.prm) * n_slabs
           > WINDOW_PLANE_BYTES)
    # full planes over WINDOW_PLANE_BYTES: the linear-space path
    udh = ctx.use_udh(n_slabs, big)
    score, em, en, ops = forward_spliced(job.q, job.gw, ctx, sig=job.sig,
                                         lw=job.lw, up=job.up, L=lanes,
                                         udh=udh)
    metrics.bump("udh_windows" if udh else "plane_windows")
    return _finish_job(job, score, ops, prm=ctx.prm)


def align_cdna(query: np.ndarray, genome: np.ndarray, ctx: AlignerContext,
               strand: str = "auto", level: int = 1, sh: int = 100,
               margin: int = 2000, lanes: int = 128, q_name: str = "",
               g_name: str = "", g_off: int = 0) -> list[GeneStructure]:
    """Map and align one cDNA query onto one genomic window.

    Returns gene structures (usually one), genome coordinates relative to
    the given window plus ``g_off``.  ``strand='auto'`` tries both
    orientations and keeps the better chain (geneorient, wln.cc:1024).
    """
    results: list[GeneStructure] = []
    # minus-strand genes are aligned in TRANSCRIPT orientation: the
    # original query against the reverse-complemented genomic window, so
    # the splice-signal model (GT..AG donors/acceptors, PSSMs) applies
    # exactly as on the plus strand (the reference evaluates reverse
    # genes the same way and converts coordinates at output, sqpr
    # SiteNo); results are re-expressed in forward-genome coordinates by
    # _to_minus_view.
    cands: list[tuple[int, str, np.ndarray, Chain | None]] = []
    rc_g = None
    with stage("seed"):
        fwd_chains = wilip(query, genome, level=level, ipen=ctx.ipen,
                           prm=ctx.prm, spaced=ctx.cfg.alg.crs > 0)
        if strand in ("auto", "+") and fwd_chains:
            cands.append((fwd_chains[0].score, "+", genome, fwd_chains[0]))
        if strand in ("auto", "-"):
            rc_g = comrev(genome)
            rev_chains = wilip(query, rc_g, level=level, ipen=ctx.ipen,
                               prm=ctx.prm, spaced=ctx.cfg.alg.crs > 0)
            if rev_chains:
                cands.append((rev_chains[0].score, "-", rc_g,
                              rev_chains[0]))
    if not cands and strand in ("auto", "+"):
        cands.append((0, "+", genome, None))
    if not cands:
        if strand != "-":
            return []
        cands.append((0, "-", rc_g if rc_g is not None
                      else comrev(genome), None))
    cands.sort(key=lambda c: -c[0])
    score0, st, g_use, chain = cands[0]
    if chain is None:
        # no chain on either strand: the DP spans the whole window
        metrics.bump("unchained_windows")
    gs = None
    if chain is not None and _max_gap(chain) > BIG_GAP:
        gs = _align_long(query, g_use, ctx, chain, sh=sh, margin=margin,
                         lanes=lanes, q_name=q_name, g_name=g_name,
                         strand=st)
    if gs is None:
        gs = _align_window(query, g_use, ctx, chain, sh=sh, margin=margin,
                           lanes=lanes, q_name=q_name, g_name=g_name,
                           g_off=g_off, strand=st)
    if gs is not None:
        results.append(gs)
    return results


# genomic diagonal jump above which the DP splits around the intron and
# the junction is resolved in closed form instead of inside the band
# (the role of interpolateS choosing indelfreespjS for large gaps,
# fwd2s1.cc:2003-2162, and of the cutrng shortcut fwd2s1.cc:423-430)
BIG_GAP = 16384


def _max_gap(chain: Chain) -> int:
    return max((b.diag - a.diag for a, b in zip(chain.hsps,
                                                chain.hsps[1:])),
               default=0)


def _split_chain(chain: Chain) -> list[Chain]:
    groups: list[list] = [[chain.hsps[0]]]
    for a, b in zip(chain.hsps, chain.hsps[1:]):
        if b.diag - a.diag > BIG_GAP:
            groups.append([b])
        else:
            groups[-1].append(b)
    return [Chain(hsps=g, score=0) for g in groups]


@stage("prep")
@stage("long_join")
def _splice_join(q, g, sig, prm, d1: int, d2: int, m_lo: int, m_hi: int):
    """Best splice junction connecting two fixed diagonals: maximize
    prefix(m) + spj(m + d1, m + d2) + suffix(m) over junction query
    position m in [m_lo, m_hi] (indelfreespjS, fwd2s1.cc:2003-2093).

    Returns (m, gain, n5, n3) or None when no eligible site exists.
    1-based m: exon left ends after query residue m; donor boundary
    n5 = m + d1, acceptor boundary n3 = m + d2 (0-based positions)."""
    ms = np.arange(m_lo, m_hi + 1)
    n5 = ms + d1
    n3 = ms + d2
    N = len(g)
    ok = (n5 >= 0) & (n3 + 1 <= N) & (n5 <= n3)
    ok &= sig.is_donor[np.clip(n5, 0, N - 1)] != 0
    ok &= sig.is_accpt[np.clip(n3, 0, N - 1)] != 0
    if not ok.any():
        return None
    # per-m diagonal substitution scores, cumulative: residue m (1-based)
    # pairs with g[m-1+d] on diagonal d
    qi = np.asarray(q, dtype=np.int64)[ms - 1]
    sub1 = prm.qprof_mtx[qi, np.asarray(
        g, dtype=np.int64)[np.clip(ms - 1 + d1, 0, N - 1)]]
    sub2 = prm.qprof_mtx[qi, np.asarray(
        g, dtype=np.int64)[np.clip(ms - 1 + d2, 0, N - 1)]]
    # prefix: residues m_lo+1..m on d1 (residue m_lo itself belongs to
    # the left anchor); suffix: residues m+1..m_hi on d2
    pre = np.concatenate([[0], np.cumsum(sub1[1:])])
    suf = np.concatenate([np.cumsum(sub2[1:][::-1])[::-1], [0]])
    ilen = d2 - d1
    ipen = int(prm.intron_table(ilen + 2)[ilen])
    accb = sig.sig3.astype(np.int64) - sig.tabs.tab3[sig.dinc3]
    joint = sig.acc_joint[np.clip(n3, 0, N - 1),
                          np.clip(sig.dinc5[np.clip(n5, 0, N - 1)], 0, 15)]
    spj = (sig.sig5[np.clip(n5, 0, N - 1)].astype(np.int64)
           + accb[np.clip(n3, 0, N - 1)] + joint + ipen)
    tot = np.where(ok, pre + spj + suf, np.int64(-2**62))
    k = int(np.argmax(tot))
    if tot[k] <= -2**61:
        return None
    m = int(ms[k])
    return m, int(tot[k]), int(n5[k]), int(n3[k])


@stage("prep")
@stage("long_join")
def _micro_exon_join(q, g, sig, prm, d1: int, d2: int,
                     m_lo: int, m_hi: int):
    """Join via a micro exon: snap to the nearest eligible donor after
    the left anchor and acceptor before the right anchor (nearest5ss/
    3ss, fwd2s1.cc:2094-2162), then place the interior query piece with
    micro_exon_scan.  Returns (ma, mb, l, r, p, total) where total is
    score-comparable with _splice_join's gain over [m_lo, m_hi]."""
    from .refine import micro_exon_scan
    N = len(g)
    don = np.nonzero(sig.is_donor[
        np.clip(m_lo + d1, 0, N):np.clip(m_hi + d1 + 1, 0, N)])[0]
    acc = np.nonzero(sig.is_accpt[
        np.clip(m_lo + d2, 0, N):np.clip(m_hi + d2 + 1, 0, N)])[0]
    if not len(don) or not len(acc):
        return None
    qi = np.asarray(q, dtype=np.int64)
    gi = np.asarray(g, dtype=np.int64)
    best = None
    # a chance GT/AG near the anchors can shadow the true sites, so
    # every eligible site pair in the (short) anchor windows is scored
    for dof in don:
        for aof in acc:
            l = int(dof) + max(m_lo + d1, 0)
            r = int(aof) + max(m_lo + d2, 0)
            ma, mb = l - d1, r - d2
            if not (m_lo <= ma <= m_hi and m_lo <= mb <= m_hi) \
                    or ma > mb:
                continue
            res = micro_exon_scan(q, g, sig, prm, ma, mb, l, r, w=1.0)
            if res is None:
                continue
            pre = int(prm.qprof_mtx[
                qi[m_lo:ma],
                gi[np.clip(np.arange(m_lo, ma) + d1, 0, N - 1)]].sum())
            suf = int(prm.qprof_mtx[
                qi[mb:m_hi],
                gi[np.clip(np.arange(mb, m_hi) + d2, 0, N - 1)]].sum())
            tot = pre + res[0] + suf
            if best is None or tot > best[5]:
                best = (ma, mb, l, r, res[1], tot)
    return best


def _align_long(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                chain: Chain, sh: int, margin: int, lanes: int,
                q_name: str, g_name: str,
                strand: str) -> GeneStructure | None:
    """Long-intron path: per-segment banded DP + closed-form junction
    joins, so band width (and traceback memory) stays bounded by exon
    cluster geometry, not intron length."""
    metrics.bump("align_long")
    segs = _split_chain(chain)
    JN = 24
    M = len(q)
    with stage("prep"):
        sig_full = build_splice_signals(np.asarray(g), ctx.cfg,
                                        ctx.tables)
    all_ops: list = []
    prev = None                    # (d_right, q_end) of previous segment
    for si, seg in enumerate(segs):
        qa = 0 if si == 0 else min(seg.hsps[0].jx + JN, M - 1)
        if si == len(segs) - 1:
            qb = M
        else:
            qb = min(segs[si + 1].hsps[0].jx, seg.hsps[-1].rx)
        qb = max(qb, qa + 1)
        if si > 0:
            # join previous segment to this one across the big gap.
            # The left anchor may have crept a few chance-matching
            # bases past the true junction; give the join creepback
            # slack and strip those trailing ops (creepback,
            # fwd2s1.cc:1960-2001)
            d1, _ = prev
            d2 = seg.hsps[0].diag
            CB = 12
            m_lo = max(min(prev[1], seg.hsps[0].jx + JN) - CB, 1)
            while (all_ops and all_ops[-1][0] != 'I'
                   and all_ops[-1][1] > m_lo):
                all_ops.pop()
            m_hi = min(seg.hsps[0].jx + JN, M - 1)
            jn = _splice_join(q, g, sig_full, ctx.prm, d1, d2,
                              m_lo, m_hi)
            # micro-exon alternative between the nearest eligible sites
            # (micro_exon, fwd2s1.cc:2163-2234); interpolateS picks the
            # better-scoring option
            me = _micro_exon_join(q, g, sig_full, ctx.prm, d1, d2,
                                  m_lo, m_hi)
            if me is not None and me[4] >= 0 and (
                    jn is None or me[5] > jn[1]):
                metrics.bump("long_join_micro_exon")
                ma, mb, l, r, p, _tot = me
                for m in range(m_lo + 1, ma + 1):
                    all_ops.append(('D', m, m + d1))
                all_ops.append(('I', ma, l, p))
                for i2, m in enumerate(range(ma + 1, mb + 1)):
                    all_ops.append(('D', m, p + i2 + 1))
                all_ops.append(('I', mb, p + (mb - ma), r))
                for m in range(mb + 1, qa + 1):
                    all_ops.append(('D', m, m + d2))
            elif jn is not None:
                metrics.bump("long_join_splice")
                mb, _, n5, n3 = jn
                for m in range(m_lo + 1, mb + 1):
                    all_ops.append(('D', m, m + d1))
                all_ops.append(('I', mb, n5, n3))
                for m in range(mb + 1, qa + 1):
                    all_ops.append(('D', m, m + d2))
            elif me is not None and me[4] < 0:
                # skipped-exon single junction; any interior query
                # residues (ma < mb) stay unpaired
                metrics.bump("long_join_skip")
                ma, mb, l, r, p, _tot = me
                for m in range(m_lo + 1, ma + 1):
                    all_ops.append(('D', m, m + d1))
                all_ops.append(('I', ma, l, r))
                for m in range(ma + 1, mb + 1):
                    all_ops.append(('F', m, r))
                for m in range(mb + 1, qa + 1):
                    all_ops.append(('D', m, m + d2))
            else:
                return None        # caller may fall back to wide band
        # banded DP over this segment's query slice
        q_sub = np.asarray(q[qa:qb])
        lo = max(0, seg.hsps[0].jy - (seg.hsps[0].jx - qa) - margin)
        hi = min(len(g), seg.hsps[-1].ry + (qb - seg.hsps[-1].rx)
                 + margin)
        gw = np.asarray(g[lo:hi])
        with stage("prep"):
            sig = build_splice_signals(gw, ctx.cfg, ctx.tables)
        # full coords: n = m + d; sub coords m' = m - qa, n' = n - lo
        # => d' = d - lo + qa
        diags = [h.diag - lo + qa for h in seg.hsps]
        Ms = len(q_sub)
        lw = max(min(diags) - sh, -Ms)
        up = min(max(diags) + sh, len(gw))
        if si == 0 and qa == 0 and seg.hsps[0].jx > 15:
            lw = max(lw - seg.hsps[0].jx - margin, -Ms)
        if si == len(segs) - 1 and qb == M and M - seg.hsps[-1].rx > 15:
            up = min(up + (M - seg.hsps[-1].rx) + margin, len(gw))
        W = up - lw + 1
        Wb = _round_up(W, 256)
        lw = max(lw - (Wb - W) // 2, -Ms)
        up = min(lw + Wb - 1, len(gw))
        lw = max(up - Wb + 1, -Ms)
        score, em, en, ops = forward_spliced(q_sub, gw, ctx, sig=sig,
                                             lw=lw, up=up, L=lanes)
        # shift sub-problem coords into full coords
        for op in ops:
            if op[0] == 'I':
                all_ops.append(('I', op[1] + qa, op[2] + lo, op[3] + lo))
            else:
                all_ops.append((op[0], op[1] + qa, op[2] + lo))
        prev = (seg.hsps[-1].diag, min(qb, em + qa))
    with stage("traceback"):
        total = 0                       # rescore from the op stream
        gs = build_gene_structure(all_ops, q, np.asarray(g), total,
                                  sig=sig_full, q_name=q_name, g_name=g_name,
                                  strand=strand, prm=ctx.prm)
        if gs is None:
            return None
        gs.score = _score_ops(all_ops, q, g, sig_full, ctx.prm)
        from .refine import refine_ends
        refine_ends(gs, q, g, sig_full, ctx.prm)
        if strand == "-":
            _to_minus_view(gs, len(q), len(g))
    return gs


def _score_ops(ops: list, q, g, sig, prm) -> int:
    """Score an op stream under the engine's model (for joined paths)."""
    tot = 0
    ipen_cache: dict[int, int] = {}
    accb = None
    state = None
    for op in ops:
        if op[0] == 'D':
            _, m, n = op
            tot += int(prm.qprof_mtx[q[m - 1], g[n - 1]])
            state = None
        elif op[0] in ('E', 'F'):
            tot += prm.gep + (prm.gop if state != op[0] else 0)
            state = op[0]
        elif op[0] == 'I':
            _, m, n5, n3 = op
            ilen = n3 - n5
            if ilen not in ipen_cache:
                ipen_cache[ilen] = int(prm.intron_table(ilen + 2)[ilen])
            if accb is None:
                accb = sig.sig3.astype(np.int64) - sig.tabs.tab3[sig.dinc3]
            joint = sig.acc_joint[n3, np.clip(sig.dinc5[n5], 0, 15)]
            tot += (int(sig.sig5[n5]) + int(accb[n3]) + int(joint)
                    + ipen_cache[ilen])
            state = None
    return int(tot)
