"""Protein -> genome seeded spliced-alignment driver.

The counterpart of spaln_tpu/align/protein_driver.py (the role of
Aln2h1's driver hierarchy, globalH_ng/seededH_ng, fwd2h1.cc:2400-3316):
host-side 3-frame translated seeding (the Wilber-Lipman tron search
dmsnno31, wln.cc:554-678), band geometry in r = n - 3m coordinates, the
tron DP on ``ProteinAlignerContext.device`` (ops/dp_tron: K7 and K8 on a
CUDA device, their plain versions on the CPU) and codon-aware
gene-structure extraction on the host (skl_rngH_ng role,
fwd2h1.cc:619-900).  A failure of the DP raises DeviceDPError: nothing
falls back to a host walk.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as K
from ..config import Config, resolve, PvsG
from ..ops.params import DpFlags, NEVSEL
from ..ops.dp_spliced import PLANE_BYTES_BUDGET
from ..ops.dp_tron import (forward_tron, prepare_tron_batch, run_tron_batch,
                           tron_plane_bytes_per_cell)
from ..ops.tron_params import TronDpParams
from ..score.codepot import build_tron_signals, TronSignals
from ..score.intron import IntronPenalty
from ..score.simmtx import Simmtx
from ..score.tables import TableDir
from ..seed.wilip import Hsp, Chain, chain_hsps
from ..seq.codec import comrev, translate
from ..utils.errors import DeviceDPError
from ..utils.metrics import metrics, stage
from .driver import coalesce_buckets
from .gene import Exon, Intron, GeneStructure


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class ProteinAlignerContext:
    """Per-run immutable context for the protein path."""
    cfg: Config
    tables: TableDir
    prm: TronDpParams
    ipen: IntronPenalty
    ipen_tab: np.ndarray
    pmtx: np.ndarray              # protein (aa x aa) matrix for seeding
    # protein gene mapping runs Smith-Waterman local by default (the
    # reference recipe maps with -LS, seqdb/Makefile:69-75)
    flags: DpFlags
    device: torch.device
    plane_budget: int = PLANE_BYTES_BUDGET   # bytes of planes per launch

    @classmethod
    def create(cls, tables: TableDir, device: torch.device | str,
               cfg: Config | None = None, max_intron: int = 200_000,
               local: bool = True, y_args: list | None = None,
               plane_budget: int = PLANE_BYTES_BUDGET
               ) -> "ProteinAlignerContext":
        from ..config import apply_y_args
        cfg = cfg or Config()
        cfg = apply_y_args(cfg, tables.alnparam_args())
        if y_args:
            cfg = apply_y_args(cfg, y_args)
        cfg = resolve(cfg, PvsG)
        sm = Simmtx.protein(tables.root, pam=cfg.aln.pam1, slot=0)
        prm = TronDpParams.build(cfg, sm.tron().mtx)
        ipen = IntronPenalty(cfg, PvsG)
        tab = ipen.penalty(np.arange(max_intron)).astype(np.int32)
        # pad the seeding matrix to the full tron alphabet: 6-frame
        # genome translations contain stop codons (TRM=25) and real
        # queries may carry SEC/TRM2 — score them at the matrix minimum
        # (a stop never extends an HSP; Simmtx covers 25 letters only)
        from ..constants import TSIMD
        pmtx = sm.mtx
        if pmtx.shape[0] < TSIMD:
            full = np.full((TSIMD, TSIMD), int(pmtx.min()),
                           dtype=pmtx.dtype)
            full[:pmtx.shape[0], :pmtx.shape[1]] = pmtx
            pmtx = full
        return cls(cfg=cfg, tables=tables, prm=prm, ipen=ipen,
                   ipen_tab=tab, pmtx=pmtx, flags=DpFlags(local=local),
                   device=torch.device(device), plane_budget=plane_budget)


# per-level protein seed parameters (wlprm tron rows, wln.cc:100-116)
AA_LEVELS = ({"k": 5, "thr": 500}, {"k": 4, "thr": 400},
             {"k": 3, "thr": 300})


def _aa_kmer_words(red: np.ndarray, k: int, nalpha: int = 20):
    L = len(red)
    if L < k:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    valid = red < nalpha
    w = np.zeros(L - k + 1, dtype=np.int64)
    ok = np.ones(L - k + 1, dtype=bool)
    for i in range(k):
        w = w * nalpha + np.clip(red[i:L - k + 1 + i], 0, nalpha - 1)
        ok &= valid[i:L - k + 1 + i]
    return w, ok


def find_hsps_protein(qaa: np.ndarray, g: np.ndarray, pmtx: np.ndarray,
                      level: int = 0) -> list[Hsp]:
    """3-frame translated k-mer seeding (dmsnno31 role, wln.cc:554-678).

    Returns HSPs in *scaled* coordinates: jx in nt-equivalents (3 x aa),
    jy in nt — so diag = jy - jx is the tron band offset r = n - 3m and
    the generic chainer applies unchanged.
    """
    prm = AA_LEVELS[min(level, len(AA_LEVELS) - 1)]
    k = prm["k"]
    red_q = K.AA_REDUCE20[np.asarray(qaa, dtype=np.int64)]
    qw, qok = _aa_kmer_words(red_q, k)
    if not len(qw):
        return []
    qpos = np.nonzero(qok)[0]
    qv = qw[qpos]
    order = np.argsort(qv, kind="stable")
    qv_s, qp_s = qv[order], qpos[order]
    hsps: list[Hsp] = []
    qa = np.asarray(qaa, dtype=np.int64)
    for frame in range(3):
        faa = translate(g, frame)
        red_g = K.AA_REDUCE20[faa.astype(np.int64)]
        gw, gok = _aa_kmer_words(red_g, k)
        if not len(gw):
            continue
        gpos = np.nonzero(gok)[0]
        gv = gw[gpos]
        lo = np.searchsorted(qv_s, gv, side="left")
        hi = np.searchsorted(qv_s, gv, side="right")
        cnt = hi - lo
        has = cnt > 0
        if not has.any():
            continue
        g_rep = np.repeat(gpos[has], cnt[has])
        idx = np.concatenate([np.arange(l, h) for l, h in
                              zip(lo[has], hi[has])])
        q_rep = qp_s[idx]
        diag = g_rep.astype(np.int64) - q_rep
        order2 = np.lexsort((g_rep, diag))
        dd, gg, qq = diag[order2], g_rep[order2], q_rep[order2]
        brk = np.nonzero((np.diff(dd) != 0) | (np.diff(gg) > 3 * k))[0] + 1
        starts = np.concatenate([[0], brk])
        ends = np.concatenate([brk, [len(dd)]])
        ga = faa.astype(np.int64)
        for s, e in zip(starts, ends):
            jx, jy = int(qq[s]), int(gg[s])
            alen = int(gg[e - 1]) + k - jy
            alen = min(alen, len(qa) - jx, len(ga) - jy)
            if alen < k:
                continue
            qs, gs = qa[jx:jx + alen], ga[jy:jy + alen]
            nid = int(((qs == gs) & (qs >= 3) & (qs < 23)).sum())
            scr = int(pmtx[qs, gs].sum())
            if scr >= prm["thr"]:
                hsps.append(Hsp(jx=3 * jx, jy=3 * jy + frame,
                                jlen=3 * alen, nid=nid, jscr=scr))
    return hsps


def wilip_protein(qaa: np.ndarray, g: np.ndarray, pmtx: np.ndarray,
                  ipen=None, level: int = 0, **kw) -> list[Chain]:
    """Protein HSP search + intron-aware chaining, coarser on retry."""
    for lv in range(level, len(AA_LEVELS)):
        hsps = find_hsps_protein(qaa, g, pmtx, lv)
        chains = chain_hsps(hsps, ipen=ipen, vthr=kw.pop("vthr", 600), **kw)
        if chains:
            return chains
    return []


def align_protein(query: np.ndarray, genome: np.ndarray,
                  ctx: ProteinAlignerContext, strand: str = "auto",
                  sh: int = 150, margin: int = 2000, lanes: int = 64,
                  q_name: str = "", g_name: str = "",
                  g_off: int = 0) -> list[GeneStructure]:
    """Map and align one protein query onto one genomic window.

    strand='auto' seeds both genome orientations and aligns the better
    one; '-' results carry window-forward coordinates of the reverse
    strand alignment (flipped by the caller for reporting).
    """
    cands = []
    with stage("seed"):
        if strand in ("auto", "+"):
            ch = wilip_protein(query, genome, ctx.pmtx, ipen=ctx.ipen)
            if ch:
                cands.append((ch[0].score, "+", genome, ch[0]))
        if strand in ("auto", "-"):
            rc = comrev(genome)
            ch = wilip_protein(query, rc, ctx.pmtx, ipen=ctx.ipen)
            if ch:
                cands.append((ch[0].score, "-", rc, ch[0]))
    if not cands and strand in ("auto", "+"):
        cands.append((0, "+", genome, None))
    if not cands:
        return []
    cands.sort(key=lambda c: -c[0])
    _, st, g_use, chain = cands[0]
    gs = _align_window_tron(query, g_use, ctx, chain, sh=sh, margin=margin,
                            lanes=lanes, q_name=q_name, g_name=g_name,
                            strand=st)
    if gs is None:
        return []
    if st == "-":
        _flip_coords(gs, len(genome))
    return [gs]


def _flip_coords(gs: GeneStructure, N: int) -> None:
    """Map reverse-strand window coords back to forward-strand coords."""
    for e in gs.exons:
        e.g_start, e.g_end = N - e.g_end, N - e.g_start
    for i in gs.introns:
        i.g_start, i.g_end = N - i.g_end, N - i.g_start
    gs.exons.reverse()
    gs.introns.reverse()


@dataclass
class TronJob:
    """One protein x genomic-window DP problem, window/band already
    restricted (the aa analog of driver.AlignJob)."""
    q: np.ndarray
    gw: np.ndarray
    sig: object
    lw: int
    up: int
    strand: str
    lo: int                    # window offset inside the genome segment
    g_total: int
    q_name: str = ""
    g_name: str = ""
    loc_bounds: tuple = (1 << 30, -(1 << 30))  # Local outside anchors
    k5: int = 0                # unanchored aa at the 5' query end
    k3: int = 0                # unanchored aa at the 3' query end


SPLICE_MASK_EDGE = 9          # nt kept splice-eligible at anchor edges
END_NOREC_NT = 45             # no_rec end-gap bound (interpolateH wlmt*3)


def _mask_splice_sites(sig: TronSignals, chain: Chain, lo: int, N: int,
                       minl: int, q_nt: int) -> TronSignals:
    """Chain-derived splice eligibility (the seededH_ng/interpolateH
    decision tree, fwd2h1.cc:3022-3135, applied as a signal mask):

    - anchor (HSP) interiors take the diagonal verbatim — no junctions
      (seededH_ng consumes wjxt runs without DP, fwd2h1.cc:3220-3243);
    - between adjacent anchors with dgap < IntronPrm.minl the reference
      runs ordinary un-spliced alignment (fwd2h1.cc:3083-3091) — the
      whole inter-anchor stretch is masked;
    - small end gaps (<= wlmt*3) extend diagonally via cds5end/cds3end
      (no new junctions); larger end gaps keep splice freedom (the
      recursive-seeding / lspH fallbacks can splice).
    """
    import dataclasses
    phs5 = sig.phs5.copy()
    phs3 = sig.phs3.copy()
    allow = np.ones(N, dtype=bool)
    hs = chain.hsps
    E = SPLICE_MASK_EDGE
    for h in hs:
        a0, a1 = h.jy - lo + E, h.jy - lo + h.jlen - E
        if a1 > a0:
            allow[max(a0, 0):max(a1, 0)] = False
    for h1, h2 in zip(hs, hs[1:]):
        dgap = (h2.jy - h1.ry) - (h2.jx - h1.rx)
        if dgap < minl:
            a0, a1 = h1.ry - lo - E, h2.jy - lo + E
            if a1 > a0:
                allow[max(a0, 0):max(a1, 0)] = False
    # end regions: diagonal-only when the uncovered query end is small
    if hs[0].jx <= END_NOREC_NT:
        allow[:max(hs[0].jy - lo - E, 0)] = False
    if q_nt - hs[-1].rx <= END_NOREC_NT:
        allow[max(hs[-1].ry - lo + E, 0):] = False
    phs5[~allow] = -2
    phs3[~allow] = -2
    return dataclasses.replace(sig, phs5=phs5, phs3=phs3)


@stage("prep")
def prepare_tron_job(q: np.ndarray, g: np.ndarray,
                     ctx: ProteinAlignerContext, chain: Chain | None,
                     sh: int = 150, margin: int = 2000,
                     q_name: str = "", g_name: str = "",
                     strand: str = "+") -> TronJob | None:
    """Window restriction + band geometry for one protein problem
    (stripe31 role, aln2.cc:178-199)."""
    M = len(q)
    if chain is not None:
        g0, g1 = chain.g_span
        q0, q1 = chain.q_span          # scaled (nt-equivalent) coords
        lo = max(0, g0 - q0 - margin)
        hi = min(len(g), g1 + (3 * M - q1) + margin)
        lo -= lo % 3                   # keep frame alignment of diags
    else:
        lo, hi = 0, len(g)
    gw = np.asarray(g[lo:hi])
    N = len(gw)
    if N < 3 or M == 0:
        return None
    sig = build_tron_signals(gw, ctx.cfg, ctx.tables)
    loc_bounds = (1 << 30, -(1 << 30))
    if chain is not None and chain.hsps:
        sig = _mask_splice_sites(sig, chain, lo, N,
                                 ctx.prm.intron_minl, 3 * M)
        # Local (SW) behavior applies only outside the anchored span
        # (interior segments are anchored, fwd2h1.cc:3218-3241)
        loc_bounds = (chain.hsps[0].jy - lo, chain.hsps[-1].ry - lo)
    if chain is not None:
        diags = [h.diag - lo for h in chain.hsps]
        lw = max(min(diags) - 3 * sh, -3 * M)
        up = min(max(diags) + 3 * sh, N)
        # widen over query ends the chain does not cover (the reference
        # runs cds5end/first-exon heuristics there, fwd2h1.cc:2331-2396)
        q0, q1 = chain.q_span
        if q0 > 45:
            lw = max(lw - q0 - margin, -3 * M)
        if 3 * M - q1 > 45:
            up = min(up + (3 * M - q1) + margin, N)
    else:
        lw, up = -3 * M, N
    # geometric W ladder: every distinct W is a fresh compile (see
    # driver.prepare_job)
    W = up - lw + 2
    Wb = 384
    while Wb < W:
        Wb = _round_up(Wb * 3 // 2, 384)
    extra = Wb - W
    lw = max(lw - extra // 2, -3 * M)
    up = min(lw + Wb - 2, N)
    lw = max(up - Wb + 2, -3 * M)
    k5 = k3 = 0
    if chain is not None and chain.hsps:
        k5 = chain.hsps[0].jx // 3
        k3 = M - chain.hsps[-1].rx // 3
    return TronJob(q=q, gw=gw, sig=sig, lw=lw, up=up, strand=strand,
                   lo=lo, g_total=len(g), q_name=q_name, g_name=g_name,
                   loc_bounds=loc_bounds, k5=k5, k3=k3)


@stage("traceback")
def _finish_tron_job(job: TronJob, score: int, ops: list,
                     ctx: "ProteinAlignerContext") -> GeneStructure | None:
    gs = build_gene_structure_tron(ops, job.q, job.gw, score,
                                   sig=job.sig, q_name=job.q_name,
                                   g_name=job.g_name, strand=job.strand,
                                   prm=ctx.prm, ipen_tab=ctx.ipen_tab,
                                   k5=job.k5, k3=job.k3,
                                   wmm_w=ctx.cfg.aln2.w,
                                   intron_maxl=int(ctx.ipen.maxl))
    if gs is None:
        return None
    for e in gs.exons:
        e.g_start += job.lo
        e.g_end += job.lo
    for i in gs.introns:
        i.g_start += job.lo
        i.g_end += job.lo
    return gs


def tron_launch_key(bp, prm: TronDpParams) -> str:
    """The metrics counter of a K7 launch on the card: its batch (B, S)
    and geometry (k slabs a CTA, CTAs a problem, serial steps)."""
    from ..ops.dp_tron_cuda import tron_launch_plan
    n_sm = torch.cuda.get_device_properties(
        bp.device).multi_processor_count
    plan = tron_launch_plan(bp, prm, n_sm)
    return (f"tron_k7 B={bp.B} S={bp.S} k={plan['k']} "
            f"ctas={plan['ncta']} steps={plan['steps']}")


def execute_tron_jobs(jobs: list, ctx: ProteinAlignerContext,
                      lanes: int = 64, max_batch: int = 32
                      ) -> list[GeneStructure | None | BaseException]:
    """Run many protein jobs through the tron DP on ``ctx.device``,
    bucketed by geometry (W, Mpad) (execute_tron_jobs,
    spaln_tpu/align/protein_driver.py:365 — the reference's MasterWorker
    treats aa queries as cDNA ones, spaln.cc:1220-1468).  Under-filled
    band widths of an Mpad are promoted to its widest (coalesce_buckets:
    this widens their bands, as the reference does); a bucket runs as
    batches of up to ``max_batch`` problems whose planes fit
    ``ctx.plane_budget``, each one run_tron_batch (K7, the ends, K8),
    counted per K7 geometry under tron_launch_key's name.  A
    failure of the DP raises DeviceDPError; a gene-structure failure is
    that job's result."""
    results: list = [None] * len(jobs)
    buckets: dict[tuple, list[int]] = {}
    for i, job in enumerate(jobs):
        if job is None:
            continue
        W = job.up - job.lw + 2
        Mpad = _round_up(len(job.q), lanes)
        buckets.setdefault((W, Mpad), []).append(i)
    buckets = coalesce_buckets(buckets, jobs, max_batch, band_extra=2)
    for (W, Mpad), idxs in buckets.items():
        T = W + 6 * (lanes - 1)
        n_slabs = max(Mpad // lanes, 1)
        per = T * lanes * tron_plane_bytes_per_cell(ctx.prm) * n_slabs
        mb = max(1, min(max_batch, ctx.plane_budget // per))
        for c0 in range(0, len(idxs), mb):
            part = idxs[c0:c0 + mb]
            js = [jobs[i] for i in part]
            try:
                with stage("prep"):
                    bp = prepare_tron_batch(
                        [j.q for j in js], [j.gw for j in js],
                        [j.sig for j in js], ctx.prm, ctx.ipen_tab,
                        lws=[j.lw for j in js], W=W, L=lanes,
                        flags=ctx.flags,
                        loc_bounds=[j.loc_bounds for j in js],
                        device=ctx.device)
                with stage("device_dp"):
                    res = run_tron_batch(bp, ctx.prm)
            except Exception as exc:
                raise DeviceDPError(
                    f"tron DP of a batch of {len(part)} (W {W}, Mpad "
                    f"{Mpad}) on {ctx.device}: {type(exc).__name__}: "
                    f"{exc}") from exc
            metrics.bump("tron_buckets")
            metrics.bump("tron_dp_cells", bp.B * bp.Mpad * bp.W)
            if bp.device.type == "cuda":    # K7's launch: its geometry
                metrics.bump(tron_launch_key(bp, ctx.prm))
            with stage("traceback"):
                for bi, ji in enumerate(part):
                    score, _, _, ops = res[bi]
                    try:
                        results[ji] = _finish_tron_job(jobs[ji], score, ops,
                                                       ctx)
                    except Exception as exc:
                        results[ji] = exc
            metrics.bump("tron_jobs", len(part))
    return results


def _align_window_tron(q: np.ndarray, g: np.ndarray,
                       ctx: ProteinAlignerContext, chain: Chain | None,
                       sh: int, margin: int, lanes: int, q_name: str,
                       g_name: str, strand: str) -> GeneStructure | None:
    job = prepare_tron_job(q, g, ctx, chain, sh=sh, margin=margin,
                           q_name=q_name, g_name=g_name, strand=strand)
    if job is None:
        return None
    try:
        score, _, _, ops = forward_tron(job.q, job.gw, job.sig, ctx.prm,
                                        ctx.ipen_tab, lw=job.lw, up=job.up,
                                        L=lanes, flags=ctx.flags,
                                        loc_bounds=job.loc_bounds,
                                        device=ctx.device)
    except Exception as exc:
        raise DeviceDPError(
            f"tron DP of a {len(job.q)} x {len(job.gw)} problem on "
            f"{ctx.device}: {type(exc).__name__}: {exc}") from exc
    return _finish_tron_job(job, score, ops, ctx)


def reclassify_introns_tron(ops: list, sig: TronSignals,
                            prm: TronDpParams,
                            ipen_tab: np.ndarray) -> list:
    """Intron-vs-gap re-decision at reporting (skl_rngH_ng,
    fwd2h1.cc:699-735): each horizontal run that the DP spliced is
    re-judged as  iscr + GapPenalty3(insert - intlen)  vs
    GapPenalty3(insert); when the ordinary-gap path wins, the intron is
    demoted to a genome insertion so the flanking exons merge.

    iscr = sig5 + spjscr = sig5[n5] + IntronPenalty(len) + sig53(n5,n3)
    (codepot.cc:74-77).  Only phase-0 junctions are re-judged: the
    +-1 ops carry a junction-codon rescoring baked into the DP score
    that a post-hoc gap conversion cannot unwind exactly.
    """
    n_ops = len(ops)
    out = list(ops)
    i = 0
    while i < n_ops:
        if out[i][0] not in ('E', 'I'):
            i += 1
            continue
        j = i
        insert = 0
        intr = []                       # positions of 'I' ops in the run
        while j < n_ops and out[j][0] in ('E', 'I'):
            if out[j][0] == 'E':
                insert += out[j][3]
            else:
                intr.append(j)
                insert += out[j][3] - out[j][2]
            j += 1
        # interior runs only: a terminal run has no bracketing match
        interior = (i > 0 and j < n_ops)
        if interior and len(intr) == 1 and out[intr[0]][4] == 0:
            _, m, n5, n3, _phs = out[intr[0]]
            intlen = n3 - n5
            iscr = (int(sig.sig5[n5]) + int(ipen_tab[intlen])
                    + int(sig.sig53_ie53(n5, n3)))
            x = prm.gap_penalty3(insert)
            xi = iscr + prm.gap_penalty3(insert - intlen)
            if xi < x:
                out[intr[0]] = ('E', m, n3, intlen)
        i = j
    return out


def _isCanon(sig: TronSignals, nd: int, na: int) -> bool:
    """Canonical donor/acceptor PAIR (Exinon::isCanon,
    codepot.h:108-113): classes must pair — GT/GC (3) with AG (3),
    AT (2) with AC (2); class-1 sites pair with anything.  Accepting
    the sides independently admits GT..AC / AT..AG junctions the
    reference rejects (measured: spurious first-exon relocations)."""
    N = len(sig.dinc5)
    if not (0 <= nd < N and 0 <= na < N):
        return False
    c5 = int(sig.cano5[nd])
    c3 = int(sig.cano3[na])
    return bool((c5 == 3 and c3 == 3) or (c5 == 2 and c3 == 2)
                or (c5 == 1 and c3 > 0) or (c5 > 0 and c3 == 1))


def refine_terminal_exons(exons: list, introns: list, a: np.ndarray,
                          sig: TronSignals, prm: TronDpParams,
                          ipen_tab: np.ndarray,
                          k5: int, k3: int, w: float = 9.0,
                          scan_cap: int = 2000) -> None:
    """first_exon / last_exon placement of unanchored query ends
    (fwd2h1.cc:2753-2980), in place.

    The reference never hands terminal query residues to the banded DP:
    the prefix before the first seed anchor is re-placed as a candidate
    first exon at the best upstream site scoring
        w * diagonal-match + sigS(start) + sig5(donor) + spjscr,
    and symmetrically the suffix as a last exon ending just before a
    positive TransTerm signal.  The junction then faces the standard
    intron-vs-gap re-decision: losing junctions merge into one long
    terminal exon with an unpaired run (the reference's trailing '-'
    stretches to the start/stop codon).

    k5/k3: unanchored aa counts at the 5'/3' ends (from the seed chain).
    """
    N = len(sig.sigS)
    mtx = prm.qprof_mtx
    bt = sig.btron

    def diag_mch(q0: int, q1: int, g0: int) -> int:
        tot = 0
        for i in range(q0, q1):
            p = g0 + 3 * (i - q0)
            if p + 1 >= N:
                return NEVSEL
            tot += int(mtx[a[i], bt[p + 1]])
        return tot

    def judge(nd: int, na: int, e_new: Exon, e_old: Exon,
              side5: bool) -> None:
        """Attach e_new via intron (nd, na) or merge as a gap run."""
        intlen = na - nd
        iscr = (int(sig.sig5[nd]) + int(ipen_at(intlen))
                + int(sig.sig53_ie53(nd, na)))
        if iscr + prm.gap_penalty3(0) >= prm.gap_penalty3(intlen):
            intr = Intron(g_start=nd, g_end=na,
                          q_pos=e_new.q_end if side5 else e_old.q_end,
                          sig5=int(sig.sig5[nd]),
                          sig3=int(sig.sig3[na]) if na < N else 0,
                          canonical=True)
            if side5:
                exons.insert(0, e_new)
                introns.insert(0, intr)
            else:
                exons.append(e_new)
                introns.append(intr)
        else:                                   # merged unpaired run
            if side5:
                e_old.q_start = e_new.q_start
                e_old.g_start = e_new.g_start
            else:
                e_old.q_end = e_new.q_end
                e_old.g_end = e_new.g_end
            e_old.mch += e_new.mch
            e_old.mmc += e_new.mmc
            e_old.unp += intlen
            e_old.gap += 1

    def ipen_at(ln: int):
        return 0 if ln <= 0 else int(ipen_tab[min(ln,
                                                  len(ipen_tab) - 1)])

    def nid(q0: int, q1: int, g0: int) -> int:
        return sum(1 for i in range(q0, q1)
                   if 0 <= g0 + 3 * (i - q0) + 1 < N
                   and int(a[i]) == int(bt[g0 + 3 * (i - q0) + 1]))

    MAX_DIST2SS = 5                            # fwd2h1.cc:46
    # ---------------------------------------------------------- 5' side
    e0 = exons[0]
    # skip when the current start already sits on a translation-init
    # signal (the reference relocates only segments its driver left
    # unanchored; an ATG-anchored start is the anchored outcome)
    cur_sS = (int(sig.sigS[e0.g_start + 1])
              if e0.g_start + 1 < N else 0)
    # candidate peel sizes: the unanchored prefix, and nearest3ss-style
    # boundary shifts of up to max_dist2ss aa (the reference re-opens
    # the boundary to nearby acceptors even when the seed covered it)
    peels = set(range(e0.q_start, max(1, e0.q_start) + MAX_DIST2SS))
    if k5 >= 1:
        peels.add(k5)
    best = None
    if cur_sS <= 0:
        for k in sorted(peels):
            if not (e0.q_start <= k < e0.q_end):
                continue
            # acceptor boundary: the nominal codon-aligned peel point,
            # or a nearby 3'ss (nearest3ss scans +-max_dist2ss aa for
            # sig3-positive sites, fwd2h1.cc:2666-2707)
            na_nom = e0.g_start + 3 * (k - e0.q_start)
            na_cands = [na_nom] + [
                p for p in range(max(0, na_nom - 15),
                                 min(N, na_nom + 16))
                if p != na_nom and sig.cano3[p] > 0]
            pmch = sum(int(mtx[a[i], a[i]]) for i in range(0, k))
            for na in na_cands:
                n_hi = na - 3 * k - prm.intron_minl
                n_lo = max(0, na - 3 * k - scan_cap)
                for n in range(n_hi, n_lo - 1, -1):
                    nd = n + 3 * k             # donor boundary
                    if not _isCanon(sig, nd, na):
                        continue
                    sS = int(sig.sigS[n + 1]) if 0 <= n + 1 < N else 0
                    if sS <= 0:
                        continue               # must land on an ATG
                    mch = diag_mch(0, k, n)
                    if k >= 2 and mch != pmch:  # BoyerMoore: exact
                        continue
                    scr = (w * mch + sS + int(sig.sig5[nd])
                           + int(ipen_at(na - nd))
                           + int(sig.sig53_ie53(nd, na)))
                    if best is None or scr > best[0]:
                        best = (scr, n, nd, na, k, mch)
    if best is not None:
        scr, n, nd, na, k, mch = best
        if k > e0.q_start:
            e_new = Exon(q_start=0, q_end=k, g_start=n, g_end=nd,
                         mch=nid(0, k, n))
            e_new.mmc = k - e_new.mch
            e0.q_start, e0.g_start = k, na
            judge(nd, na, e_new, e0, side5=True)
        else:                                  # pure unpaired extension
            e0.g_start = n
            e0.unp += na - n
            e0.gap += 1
    # ---------------------------------------------------------- 3' side
    el = exons[-1]
    M = len(a)
    cur_sT = (int(sig.sigT[el.g_end + 1])
              if el.g_end + 1 < N else 0)
    peels = set(range(M - el.q_end,
                      max(1, M - el.q_end) + MAX_DIST2SS))
    if k3 >= 1:
        peels.add(k3)
    best = None
    if cur_sT <= 0:
        for k in sorted(peels):
            q0 = M - k                         # first suffix aa index
            if not (el.q_start < q0 <= el.q_end):
                continue
            ld = el.g_end - 3 * (el.q_end - q0)    # donor boundary
            if ld <= el.g_start:
                continue
            pmch = sum(int(mtx[a[i], a[i]]) for i in range(q0, M))
            n_lo = ld + prm.intron_minl
            n_hi = min(N - 3 * k - 4, ld + scan_cap)
            for n in range(n_lo, n_hi + 1):
                if not _isCanon(sig, ld, n):
                    continue
                stop_at = n + 3 * k + 1        # TransTerm after suffix
                sT = int(sig.sigT[stop_at]) if stop_at < N else 0
                if sT <= 0:
                    continue
                mch = diag_mch(q0, M, n)
                if k >= 2 and mch != pmch:
                    continue
                scr = (w * mch + sT + int(sig.sig5[ld])
                       + int(ipen_at(n - ld))
                       + int(sig.sig53_ie53(ld, n)))
                if best is None or scr > best[0]:
                    best = (scr, n, ld, k, mch)
    if best is not None:
        scr, n, ld, k, mch = best
        q0 = M - k
        if q0 < el.q_end:
            e_new = Exon(q_start=q0, q_end=M, g_start=n,
                         g_end=n + 3 * k, mch=nid(q0, M, n))
            e_new.mmc = k - e_new.mch
            el.q_end, el.g_end = q0, ld
            judge(ld, n, e_new, el, side5=False)


def first_exon_zero5(exons: list, introns: list, a: np.ndarray,
                     bn: np.ndarray, sig: TronSignals,
                     prm: TronDpParams, ipen_tab: np.ndarray,
                     w: float = 1.0, scan_cap: int = 2000,
                     intron_maxl: int = 600) -> None:
    """first_exon for a fully-anchored 5' end (fwd2h1.cc:3040-3055).

    Even with zero unanchored query residues the reference re-opens the
    5' boundary: nearest3ss finds acceptor sites within max_dist2ss aa
    of the current start; an acceptor d3 codons DOWNSTREAM pulls
    ar = -d3 leading residues into a candidate first exon placed at the
    best sigS-positive (TransInit) site >= intron-minl upstream, scored
    w*mch + sigS + sig5 + spjscr (first_exon_wmm).  The junction then
    faces the intron-vs-gap re-decision; a losing junction merges into
    one exon with an unpaired run to the start codon — the reference's
    'T-' stretches (cds5end finding nothing positive is the gate; the
    interpolateH cmode=1 flow keeps first_exon only in that case)."""
    N = len(sig.sigS)
    mtx = prm.qprof_mtx
    bt = sig.btron
    e0 = exons[0]
    if e0.q_start != 0 or e0.q_end - e0.q_start <= 6:
        return
    g0 = e0.g_start

    def spl_aa(nd: int, na: int, phs: int) -> int:
        """Tron symbol of the junction codon (spjseq role)."""
        from ..seq.codec import _tron_of
        if phs == 1:
            c = (bn[nd - 2], bn[nd - 1], bn[na])
        else:
            c = (bn[nd - 1], bn[na], bn[na + 1])
        return int(_tron_of(np.array([c[0]]), np.array([c[1]]),
                            np.array([c[2]]), tron=True)[0])

    # nearest3ss: sig3-positive acceptors within +-max_dist2ss aa of the
    # current start, nearest-two kept (fwd2h1.cc:2573-2619); only
    # downstream sites pull residues into the new first exon (upstream
    # ones give a->right <= 0 and fall back to cds5end)
    cands = [p for p in range(g0 + 1, min(N - 2, g0 + 16))
             if sig.sig3[p] > 0]
    if not cands:
        cands = [p for p in range(g0 + 1, min(N - 2, g0 + 16))
                 if sig.cano3[p] > 0]
    cands.sort(key=lambda p: p - g0)
    if len(cands) > 2:
        cands = cands[:2]
    if len(cands) == 2 and sig.sig3[cands[0]] > sig.sig3[cands[1]]:
        cands = cands[:1]
    best = None
    for r in cands:
        d3 = g0 - r
        d3 = (d3 + 1) // 3 if d3 >= 0 else -((-d3 + 1) // 3)
        ar = -d3                            # aa pulled into the exon
        if ar < 1 or ar >= e0.q_end:
            continue
        br = g0 + 3 * ar                    # adjusted boundary
        d3p = br - r                        # junction phase (-1, 0, 1)
        n_hi = br - 3 * ar - prm.intron_minl
        n_lo = max(0, n_hi - scan_cap)
        for n in range(n_hi, n_lo - 1, -1):
            nd = n + 3 * ar - d3p           # donor boundary
            # chunked scan (first_exon_wmm, fwd2h1.cc:2747): stop at
            # IntronPrm.maxl-length boundaries once any candidate
            # exists — near sites win by early termination, not score
            if best is not None and (r - nd) % intron_maxl == 0:
                break
            sS = int(sig.sigS[n + 1]) if 0 <= n + 1 < N else 0
            if sS <= 0:
                continue
            if not _isCanon(sig, nd, r):
                continue
            mch = 0
            # straight codons; the phase-split junction codon scores
            # through spjseq (first_exon_wmm, fwd2h1.cc:2728-2736)
            top = ar - 1 if d3p == 1 else ar
            for i in range(top):
                p = n + 3 * i + 1
                if p >= N:
                    mch = NEVSEL
                    break
                mch += int(mtx[a[i], bt[p]])
            if d3p == 1:
                mch += int(mtx[a[ar - 1], spl_aa(nd, r, 1)])
            elif d3p == -1 and ar < len(a):
                mch += int(mtx[a[ar], spl_aa(nd, r, -1)])
            intlen = r - nd
            scr = (w * mch + sS + int(sig.sig5[nd])
                   + int(ipen_tab[min(max(intlen, 0),
                                      len(ipen_tab) - 1)])
                   + int(sig.sig53_ie53(nd, r)))
            if best is None or scr > best[0]:
                best = (scr, n, nd, r, ar, d3p, mch)
    if best is None or best[0] <= 0:
        return
    scr, n, nd, na, k, d3p, mch = best
    nid = sum(1 for i in range(k)
              if n + 3 * i + 1 < N and int(a[i]) == int(bt[n + 3 * i + 1]))
    e_new = Exon(q_start=0, q_end=k, g_start=n, g_end=nd, mch=nid)
    e_new.mmc = k - nid
    e0.q_start, e0.g_start = k, na + (1 if d3p == 1 else 0)
    intlen = na - nd
    iscr = (int(sig.sig5[nd])
            + int(ipen_tab[min(max(intlen, 0), len(ipen_tab) - 1)])
            + int(sig.sig53_ie53(nd, na)))
    # skl_rngH re-detects the junction from phase markers at the
    # codon-rounded skl bounds; a phased (+-1) junction written by
    # first_exon only reconstitutes for strong-canonical donors, so in
    # practice it lands as an unpaired run (the reference's 'T-'
    # output).  Keep the intron only for phase-0 junctions that win
    # the intron-vs-gap re-decision
    if d3p == 0 and iscr + prm.gap_penalty3(0) >= \
            prm.gap_penalty3(intlen):
        exons.insert(0, e_new)
        introns.insert(0, Intron(g_start=nd, g_end=na, q_pos=k,
                                 sig5=int(sig.sig5[nd]),
                                 sig3=int(sig.sig3[na]) if na < N else 0,
                                 canonical=True))
    else:                                     # merged unpaired run
        unp = e0.g_start - nd
        e0.q_start, e0.g_start = e_new.q_start, e_new.g_start
        e0.mch += e_new.mch
        e0.mmc += e_new.mmc
        e0.unp += unp
        e0.gap += 1


def last_exon_zero3(exons: list, introns: list, a: np.ndarray,
                    sig: TronSignals, prm: TronDpParams,
                    ipen_tab: np.ndarray, w: float = 1.0,
                    scan_cap: int = 2000,
                    intron_maxl: int = 600) -> None:
    """last_exon for a fully-anchored 3' end (fwd2h1.cc:3056-3071),
    symmetric to first_exon_zero5: nearest5ss donors just upstream of
    the current end pull trailing residues into a candidate last exon
    at the best sigT-positive (TransTerm) site downstream."""
    N = len(sig.sigS)
    mtx = prm.qprof_mtx
    bt = sig.btron
    el = exons[-1]
    M = len(a)
    if el.q_end != M or el.q_end - el.q_start <= 6:
        return
    ge = el.g_end
    cands = [p for p in range(max(0, ge - 15), ge)
             if sig.sig5[p] > 0]
    if not cands:
        cands = [p for p in range(max(0, ge - 15), ge)
                 if sig.cano5[p] > 0]
    best = None
    for ld in cands:
        d5 = ge - ld
        k = (d5 + 1) // 3                    # residues pulled out
        if k < 1 or k >= el.q_end - el.q_start:
            continue
        q0 = M - k
        n_lo = ld + prm.intron_minl
        n_hi = min(N - 3 * k - 4, n_lo + scan_cap)
        for n in range(n_lo, n_hi + 1):
            # chunked scan (last_exon_wmm, fwd2h1.cc:2899)
            if best is not None and (n - ld) % intron_maxl == 0:
                break
            if not _isCanon(sig, ld, n):
                continue
            stop_at = n + 3 * k + 1
            sT = int(sig.sigT[stop_at]) if stop_at < N else 0
            if sT <= 0:
                continue
            mch = 0
            for i in range(k):
                p = n + 3 * i + 1
                if p >= N:
                    mch = NEVSEL
                    break
                mch += int(mtx[a[q0 + i], bt[p]])
            intlen = n - ld
            scr = (w * mch + sT + int(sig.sig5[ld])
                   + int(ipen_tab[min(max(intlen, 0),
                                      len(ipen_tab) - 1)])
                   + int(sig.sig53_ie53(ld, n)))
            if best is None or scr > best[0]:
                best = (scr, n, ld, k, mch)
    if best is None or best[0] <= 0:
        return
    scr, n, ld, k, mch = best
    q0 = M - k
    nid = sum(1 for i in range(k)
              if n + 3 * i + 1 < N
              and int(a[q0 + i]) == int(bt[n + 3 * i + 1]))
    e_new = Exon(q_start=q0, q_end=M, g_start=n, g_end=n + 3 * k,
                 mch=nid)
    e_new.mmc = k - nid
    el.q_end, el.g_end = q0, ld
    intlen = n - ld
    d5p = 3 * k - (ge - ld)                  # junction phase
    iscr = (int(sig.sig5[ld])
            + int(ipen_tab[min(max(intlen, 0), len(ipen_tab) - 1)])
            + int(sig.sig53_ie53(ld, n)))
    if d5p == 0 and iscr + prm.gap_penalty3(0) >= \
            prm.gap_penalty3(intlen):
        exons.append(e_new)
        introns.append(Intron(g_start=ld, g_end=n, q_pos=q0,
                              sig5=int(sig.sig5[ld]),
                              sig3=int(sig.sig3[n]) if n < N else 0,
                              canonical=True))
    else:
        el.q_end, el.g_end = e_new.q_end, e_new.g_end
        el.mch += e_new.mch
        el.mmc += e_new.mmc
        el.unp += intlen
        el.gap += 1


def snap_cds_ends(exons: list, a: np.ndarray, bn: np.ndarray,
                  sig: TronSignals, prm: TronDpParams) -> tuple:
    """Anchor the CDS ends at start/stop codons (cds5end/cds3end,
    fwd2h1.cc:2331-2396), in place.

    5': walk codon steps upstream of the first exon, accumulating
    sigE + aa-match (or BasicGEP once the query is exhausted); take the
    best boundary that lands on a positive TransInit signal within the
    Vthr score-drop budget.  3': symmetric walk downstream to a positive
    TransTerm signal, placing the boundary past the stop codon."""
    N = len(bn)
    tr_a = None

    def tr(m):
        return prm.qprof_mtx[int(a[m])]

    # ------------------------------------------------------ 5' (cds5end)
    e0 = exons[0]
    x, y = e0.q_start, e0.g_start
    scr = maxscr = 0
    best = None
    while y - 3 >= 0:
        sS = int(sig.sigS[y + 1]) if y + 1 < N else 0
        if sS > 0:
            scr += sS
        if scr > maxscr:
            maxscr = scr
            best = (x, y)
        if sS > 0 or scr + prm.vthr < 0:
            break
        p = y - 3                        # candidate upstream codon
        scr += int(sig.sigE[p + 1]) if p + 1 < N else 0
        if x > 0:
            x -= 1
            scr += int(tr(x)[int(sig.btron[p + 1])])
        else:
            scr += prm.gep
        y -= 3
    max5 = maxscr
    if maxscr > 0 and best is not None and best != (e0.q_start,
                                                   e0.g_start):
        e0.q_start, e0.g_start = best
    # ------------------------------------------------------ 3' (cds3end)
    el = exons[-1]
    x, y = el.q_end, el.g_end
    scr = maxscr = 0
    best = None
    M = len(a)
    while y + 3 <= N:
        sT = int(sig.sigT[y + 1]) if y + 1 < N else 0
        if sT > 0:
            scr += sT
        else:
            scr += (int(sig.sigE[y + 1]) if y + 1 < N else 0) + prm.gep
        if scr > maxscr:
            maxscr = scr
            best = (x, y + 3)
        if sT > 0 or scr + prm.vthr < 0:
            break
        if x < M:
            scr += int(tr(x)[int(sig.btron[y + 1])])
            x += 1
        y += 3
    if maxscr > 0 and best is not None:
        el.q_end, el.g_end = best
    return max5, maxscr


def build_gene_structure_tron(ops: list, a: np.ndarray, bn: np.ndarray,
                              score: int, sig: TronSignals | None = None,
                              q_name: str = "", g_name: str = "",
                              strand: str = "+",
                              prm: TronDpParams | None = None,
                              ipen_tab: np.ndarray | None = None,
                              k5: int = 0, k3: int = 0,
                              wmm_w: float = 9.0,
                              intron_maxl: int = 600
                              ) -> GeneStructure | None:
    """Traceback op stream from the tron engine -> exon/intron records
    (skl_rngH_ng role, fwd2h1.cc:619-900).

    Tron ops: ('D', m, n) codon match of aa m vs genome [n-3, n);
    ('E', m, n, w) w-nt insertion; ('F', m, n, s) aa deletion with s extra
    nt; ('I', m, n5, n3, phs) intron n5..n3 at splice phase phs.
    q coords in aa, g coords in nt.
    """
    if not ops:
        return None
    if sig is not None and prm is not None and ipen_tab is not None:
        ops = reclassify_introns_tron(ops, sig, prm, ipen_tab)
    btron = sig.btron if sig is not None else None

    def tr_same(m: int, aa_g: int) -> bool:
        tr_a = int(a[m - 1])
        return (aa_g == tr_a
                or (tr_a == K.SER and aa_g == K.SER2)
                or (tr_a == K.SER2 and aa_g == K.SER))

    def spliced_aa(n5: int, n3: int, phs: int) -> int:
        """Translate the phase +-1 split codon across the junction
        (spjseq/spj_tron_tab role, codepot.h:130-186).  0-based nt:
        phs=+1 -> (n5-2, n5-1 | n3); phs=-1 -> (n5-1 | n3, n3+1)."""
        from ..seq.codec import _tron_of
        if phs == 1:
            c = (bn[n5 - 2], bn[n5 - 1], bn[n3])
        else:
            c = (bn[n5 - 1], bn[n3], bn[n3 + 1])
        return int(_tron_of(np.array([c[0]]), np.array([c[1]]),
                            np.array([c[2]]), tron=True)[0])

    exons: list[Exon] = []
    introns: list[Intron] = []
    cur: Exon | None = None
    last_gap = None
    pending: Intron | None = None       # intron awaiting its first exon op
    pend_phs = 0
    last_d = None                       # (m, n) of the newest codon match
    pend_gap = pend_unp = 0             # gap ops awaiting a bracketing match
    for op in ops:
        kind = op[0]
        if kind == 'D':
            _, m, n = op
            last_d = (m, n)
            if cur is None:
                gs0 = pending.g_end if pending is not None else n - 3
                cur = Exon(q_start=m - 1, q_end=m, g_start=gs0, g_end=n)
            else:
                cur.q_end, cur.g_end = m, n
            if pending is not None and pend_phs == -1:
                # first codon is split across the junction
                aa_g = spliced_aa(introns[-1].g_start, introns[-1].g_end,
                                  -1)
            else:
                aa_g = int(btron[n - 2]) if (btron is not None and
                                             0 <= n - 2 < len(btron)) else -1
            if tr_same(m, aa_g):
                cur.mch += 1
            else:
                cur.mmc += 1
            cur.gap += pend_gap
            cur.unp += pend_unp
            pend_gap = pend_unp = 0
            pending, pend_phs, last_gap = None, 0, None
        elif kind == 'E':
            _, m, n, w = op
            if cur is not None:
                cur.g_end = n
                pend_unp += w
                if last_gap != 'E':
                    pend_gap += 1
                last_gap = 'E'
            pending, pend_phs = None, 0
        elif kind == 'F':
            _, m, n, s = op
            if cur is None:
                gs0 = pending.g_end if pending is not None else max(n - s, 0)
                cur = Exon(q_start=m - 1, q_end=m, g_start=gs0, g_end=n)
            else:
                cur.q_end = m
                cur.g_end = max(cur.g_end, n)
            pend_unp += 1
            if last_gap != 'F':
                pend_gap += 1
            last_gap = 'F'
            pending, pend_phs = None, 0
        elif kind == 'I':
            _, m, n5, n3, phs = op
            pend_gap = pend_unp = 0
            if cur is not None:
                if phs == 1:
                    # the preceding D was the split codon: re-judge it
                    # against the spliced translation
                    old = int(btron[cur.g_end - 2]) if (
                        btron is not None
                        and 0 <= cur.g_end - 2 < len(btron)) else -1
                    new = spliced_aa(n5, n3, 1)
                    if tr_same(m, old) and not tr_same(m, new):
                        cur.mch -= 1
                        cur.mmc += 1
                    elif not tr_same(m, old) and tr_same(m, new):
                        cur.mmc -= 1
                        cur.mch += 1
                s5 = int(sig.sig5[n5]) if sig is not None else 0
                s3 = int(sig.sig3[n3]) if (sig is not None
                                           and n3 < len(sig.sig3)) else 0
                cur.sig5 = s5
                cur.g_end = n5              # exon ends at the donor site
                exons.append(cur)
                d5 = int(sig.dinc5[n5]) if sig is not None else 11
                d3 = int(sig.dinc3[n3]) if sig is not None else 2
                pending = Intron(g_start=n5, g_end=n3, q_pos=m,
                                 sig5=s5, sig3=s3,
                                 canonical=(d5 == 11 and d3 == 2))
                pend_phs = phs
                introns.append(pending)
                cur = None
                last_gap = None
    if cur is not None:
        # crop a trailing free-end gap run (not part of the exon)
        if last_d is not None and last_d[0] >= cur.q_start + 1:
            cur.q_end = min(cur.q_end, last_d[0])
            cur.g_end = min(cur.g_end, last_d[1])
            exons.append(cur)
    if not exons:
        return None
    from .gene import AlnView, trim_terminal_microexons
    trim_terminal_microexons(exons, introns, min_q=4, max_loose=7)
    if sig is not None and prm is not None:
        if ipen_tab is not None and (k5 or k3):
            # unanchored query ends re-placed as first/last exons at
            # start/stop-codon-anchored sites (fwd2h1.cc:2753-2980).
            # Fires only when the seed chain left the end unanchored —
            # the reference's terminal machinery runs on its (coarser)
            # chain's end segments; re-deciding anchored ends regresses
            # correct starts (round-5 triage).
            try:
                refine_terminal_exons(exons, introns, a, sig, prm,
                                      ipen_tab, k5, k3, w=wmm_w)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException:
                pass
        # CDS start/stop-codon anchoring (cds5end/cds3end).  Exon stats
        # keep the DP-path counts; the snapped boundary codons are
        # signal-driven extensions (the reference writes bare SKL
        # records for them too, fwd2h1.cc:2352-2357).
        m5, m3 = snap_cds_ends(exons, a, bn, sig, prm)
        if ipen_tab is not None:
            # interpolateH cmode=1/2 fallback: when the cds5end/cds3end
            # walk finds nothing positive, the reference re-opens even a
            # fully-anchored end through first_exon/last_exon
            # (fwd2h1.cc:3040-3071)
            if not k5 and m5 <= 0:
                try:
                    first_exon_zero5(exons, introns, a, bn, sig, prm,
                                     ipen_tab, w=wmm_w,
                                     intron_maxl=intron_maxl)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException:
                    pass
            if not k3 and m3 <= 0:
                try:
                    last_exon_zero3(exons, introns, a, sig, prm,
                                    ipen_tab, w=wmm_w,
                                    intron_maxl=intron_maxl)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException:
                    pass
    for i, intr in enumerate(introns):
        if i + 1 < len(exons):
            exons[i + 1].sig3 = intr.sig3
    view = AlnView(q=np.asarray(a), g=np.asarray(bn),
                   exons=[(e.q_start, e.q_end, e.g_start, e.g_end)
                          for e in exons],
                   introns=[(i.g_start, i.g_end) for i in introns],
                   q_is_aa=True, ops=ops)
    return GeneStructure(score=score, exons=exons, introns=introns,
                         q_name=q_name, g_name=g_name, strand=strand,
                         view=view)
