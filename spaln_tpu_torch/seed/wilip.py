"""Wilber-Lipman HSP search and chaining (vectorized host stage).

The role of Wlp/Wilip (wln.cc:253-996): locate high-scoring seed pairs
between a query and a genomic window, merge them into diagonal runs (HSPs),
chain HSPs with intron-aware gap costs, and hand the DP driver per-chain
genomic bounds + band geometry.

The reference's streaming per-diagonal scanner (scan_b/dmsnno) is re-cast
as whole-array numpy: k-mer match pairs via sorted-word join, run merging
via diagonal grouping, chaining via the same O(h^2) DP with LinkHspScr =
min(intron PenaltyPlus, ordinary GapPenalty) and the <=50% overlap rule
(SURVEY.md A.12).  This stage is tiny compared to the DP and stays on host
(it is also jittable later if profiling says otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import NT_REDUCE4

# per-level seed parameters (wln.cc:100-104 ncprm: tuple len, merge gain,
# score threshold x scale)
NT_LEVELS = ({"k": 8, "thr": 50}, {"k": 6, "thr": 40}, {"k": 4, "thr": 30})

# spaced-seed patterns by weight (WlnDefBitPat, wln.cc:40-42; applied in
# cross-species mode, setwlprm wln.cc:55-62).  '1' = sampled position.
WLN_DEF_BITPAT = ("", "1", "101", "1101", "11011", "1101101", "110011011",
                  "1101101011", "110010110111", "11101100101011",
                  "110110010110111", "1111011001011011")


@dataclass
class Hsp:
    jx: int        # query start (0-based)
    jy: int        # genome start
    jlen: int      # length
    nid: int       # identities
    jscr: int      # matrix score (x10)

    @property
    def rx(self) -> int:
        return self.jx + self.jlen

    @property
    def ry(self) -> int:
        return self.jy + self.jlen

    @property
    def diag(self) -> int:
        return self.jy - self.jx


@dataclass
class Chain:
    hsps: list[Hsp]
    score: int
    llmt: int = 0      # genomic lower search bound
    ulmt: int = 0      # genomic upper bound

    @property
    def q_span(self) -> tuple[int, int]:
        return self.hsps[0].jx, self.hsps[-1].rx

    @property
    def g_span(self) -> tuple[int, int]:
        return self.hsps[0].jy, self.hsps[-1].ry

    def band(self, M: int, N: int, sh: int = 100) -> tuple[int, int]:
        """DP band from chain geometry (stripe-from-jxt semantics,
        aln2.cc:156-199): diagonals covered by the chain widened by sh.
        The band deliberately does NOT reach the matrix corners — with
        free end gaps the path starts/ends on the band's init row/last
        row, and query ends uncovered by the chain get extra widening
        from the caller (the reference runs dedicated end heuristics
        instead of widening, fwd2s1.cc:2274-2404)."""
        diags = [h.diag for h in self.hsps]
        lw = max(min(diags) - sh - 1, -M)
        up = min(max(diags) + sh + 1, N)
        return lw, up


def _kmer_words(red: np.ndarray, k: int,
                pattern: str | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Packed k-mer codes and validity mask (positions with no ambiguity).

    With a spaced-seed pattern (Bitpat, bitpat.h:69-106), only the '1'
    offsets of the width-len(pattern) window are sampled; the word still
    packs `weight` bases, so the lookup tables keep their size while the
    seed tolerates mismatches at the '0' positions."""
    L = len(red)
    offs = (range(k) if pattern is None else
            [i for i, c in enumerate(pattern) if c == '1'])
    width = k if pattern is None else len(pattern)
    if L < width:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    valid = red < 4
    nw = L - width + 1
    w = np.zeros(nw, dtype=np.int64)
    ok = np.ones(nw, dtype=bool)
    for i in offs:
        w = w * 4 + red[i:nw + i]
        ok &= valid[i:nw + i]
    return w, ok


def _ragged_arange(lo: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """concatenate([arange(l, l+c) for l, c in zip(lo, cnt)]) without a
    Python loop (cnt entries must be > 0)."""
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(cnt)
    delta = np.ones(total, dtype=np.int64)
    delta[ends[:-1]] = lo[1:] - (lo[:-1] + cnt[:-1]) + 1
    delta[0] = lo[0]
    return np.cumsum(delta)


# per-word occurrence cap in the seed join (the WordTab `toomany`
# abundance cap, bitpat.h:117-178): a word hitting more window positions
# than this is low-information repeat content (poly-A/AT runs in AT-rich
# genomes) whose quadratic pair blow-up buys no sensitivity
TOOMANY_PER_WORD = 64
# HSP count handed to the O(h^2) chain DP (the reference bounds work per
# level via thresholds + poslmt; we keep the best by matrix score)
MAX_HSPS = 1024


class WindowTable:
    """Per-window word tables, built once and probed by query words
    (the role of Wlp's per-target lookup kept for the whole query,
    wln.cc:253-350).  Reused across strands (the query flips instead of
    the window), across ExtBlock widen rounds that land on the same
    range, and across queries voting into the same locus."""

    def __init__(self, g: np.ndarray):
        self.g = np.asarray(g)
        self.rg = NT_REDUCE4[self.g.astype(np.int64)]
        self._levels: dict[tuple, tuple] = {}

    def level(self, level: int, spaced: bool):
        """(gv_sorted, gpos_sorted) for the level's seed geometry."""
        ent = self._levels.get((level, spaced))
        if ent is None:
            prm = NT_LEVELS[min(level, 2)]
            k = prm["k"]
            pattern = (WLN_DEF_BITPAT[k]
                       if spaced and k < len(WLN_DEF_BITPAT)
                       else None)
            gw, gok = _kmer_words(self.rg, k, pattern)
            gpos = np.nonzero(gok)[0]
            gv = gw[gpos]
            order = np.argsort(gv, kind="stable")
            ent = (gv[order], gpos[order])
            self._levels[(level, spaced)] = ent
        return ent


def find_hsps(q: np.ndarray, g: np.ndarray | None = None, level: int = 1,
              match: int = 20, mismatch: int = -60,
              max_gap_in_run: int | None = None,
              min_score: int | None = None,
              mtx: np.ndarray | None = None,
              spaced: bool = False,
              wtab: WindowTable | None = None) -> list[Hsp]:
    """K-mer seed pairs -> diagonal runs -> scored HSPs (vectorized).

    mtx: substitution matrix for run evaluation (Wlp::eval, wln.cc:358);
    falls back to flat match/mismatch when absent.  spaced: use the
    level's WlnDefBitPat spaced seed (cross-species sensitivity).
    wtab: prebuilt window word table (probed with the query words —
    the same pair set as the direct formulation, at Q log G probes)."""
    prm = NT_LEVELS[min(level, 2)]
    k = prm["k"]
    pattern = WLN_DEF_BITPAT[k] if spaced and k < len(WLN_DEF_BITPAT) \
        else None
    thr = (min_score if min_score is not None else prm["thr"] * 10)
    merge_gap = max_gap_in_run if max_gap_in_run is not None else 3 * k
    rq = NT_REDUCE4[np.asarray(q, dtype=np.int64)]
    if wtab is None:
        wtab = WindowTable(g)
    g = wtab.g
    rg = wtab.rg
    qw, qok = _kmer_words(rq, k, pattern)
    if not len(qw):
        return []
    gv_sorted, gpos_sorted = wtab.level(level, pattern is not None)
    if not len(gv_sorted):
        return []
    qpos = np.nonzero(qok)[0]
    qv = qw[qpos]
    lo = np.searchsorted(gv_sorted, qv, side="left")
    hi = np.searchsorted(gv_sorted, qv, side="right")
    cnt = hi - lo                          # per-query-position cg
    # abundance caps: a word occurring cq times in the query and cg
    # times in the window generates cq*cg seed pairs; low-complexity
    # words (poly-A/AT runs) explode quadratically with no sensitivity
    # gain.  Same pair set as the historical window-probes-query
    # formulation: keep iff cq <= CAP and cq*cg <= CAP^2.
    has = cnt > 0
    if has.any():
        _, inv, cq = np.unique(qv, return_inverse=True,
                               return_counts=True)
        cq_pos = cq[inv]
        has &= ((cq_pos <= TOOMANY_PER_WORD)
                & (cnt * cq_pos <= TOOMANY_PER_WORD * TOOMANY_PER_WORD))
    if not has.any():
        return []
    q_rep = np.repeat(qpos[has], cnt[has])
    idx = _ragged_arange(lo[has].astype(np.int64),
                         cnt[has].astype(np.int64))
    g_rep = gpos_sorted[idx]
    diag = g_rep.astype(np.int64) - q_rep
    order = np.lexsort((g_rep, diag))
    dd, gg, qq = diag[order], g_rep[order], q_rep[order]
    # split into runs: same diagonal, genome-gap <= merge_gap
    brk = np.nonzero((np.diff(dd) != 0)
                     | (np.diff(gg) > merge_gap))[0] + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(dd)]])
    span = k if pattern is None else len(pattern)
    jx = qq[starts]
    jy = gg[starts]
    jlen = gg[ends - 1] + span - jy
    L = np.minimum(np.minimum(jlen, len(rq) - jx), len(rg) - jy)
    keep = L >= k
    jx, jy, L = jx[keep], jy[keep], L[keep]
    if not len(jx):
        return []
    # vectorized run evaluation (Wlp::eval): flat gather + reduceat
    qixs = _ragged_arange(jx, L)
    gixs = _ragged_arange(jy, L)
    offs = np.concatenate([[0], np.cumsum(L)[:-1]])
    eq_flat = (rq[qixs] == rg[gixs]) & (rq[qixs] < 4)
    nid = np.add.reduceat(eq_flat.astype(np.int64), offs)
    if mtx is not None:
        q_arr = np.asarray(q, dtype=np.int64)
        g_arr = np.asarray(g, dtype=np.int64)
        scr = np.add.reduceat(mtx[q_arr[qixs], g_arr[gixs]], offs)
    else:
        scr = nid * match + (L - nid) * mismatch
    good = np.nonzero(scr >= thr)[0]
    if len(good) > MAX_HSPS:
        good = good[np.argsort(scr[good])[::-1][:MAX_HSPS]]
        good.sort()
    return [Hsp(jx=int(jx[i]), jy=int(jy[i]), jlen=int(L[i]),
                nid=int(nid[i]), jscr=int(scr[i])) for i in good]


def chain_hsps(hsps: list[Hsp], ipen=None, gop: int = -80, gep: int = -30,
               min_intron: int = 20, vthr: int = 350,
               max_out: int = 4) -> list[Chain]:
    """O(h^2) chain DP (Wlp::jxtcore, wln.cc:777-926).

    Link cost between chained HSPs = min(intron PenaltyPlus(dr), ordinary
    GapPenalty) with overlap correction; <=50% overlap rejection rule."""
    if not hsps:
        return []
    hs = sorted(hsps, key=lambda h: (h.ry, h.rx))
    n = len(hs)
    a_jx = np.array([h.jx for h in hs], dtype=np.int64)
    a_jy = np.array([h.jy for h in hs], dtype=np.int64)
    a_rx = np.array([h.rx for h in hs], dtype=np.int64)
    a_ry = np.array([h.ry for h in hs], dtype=np.int64)
    a_scr = np.array([h.jscr for h in hs], dtype=np.int64)
    best = a_scr.copy()
    prev = np.full(n, -1, dtype=np.int64)
    NEG = np.int64(-2**62)
    for i in range(1, n):
        # vectorized inner loop over all predecessors j < i
        ok = (a_rx[:i] < a_rx[i]) & (a_ry[:i] < a_ry[i])
        ovl_x = a_rx[:i] - a_jx[i]
        ok &= 2 * ovl_x <= a_rx[i] - a_jx[:i]         # <=50% overlap
        if not ok.any():
            continue
        dr = (a_jy[i] - a_ry[:i]) - (a_jx[i] - a_rx[:i])
        ovl = np.maximum(np.maximum(ovl_x, a_ry[:i] - a_jy[i]), 0)
        link = np.where(dr != 0, gop + gep * np.abs(dr), 0)
        if ipen is not None:
            intr = dr >= min_intron
            if intr.any():
                pen = ipen.penalty_plus(dr[intr])
                link[intr] = np.maximum(pen, gop + gep * dr[intr])
        cand = np.where(ok, best[:i] + a_scr[i] + link - ovl * 20, NEG)
        j = int(np.argmax(cand))
        if cand[j] > best[i]:
            best[i] = cand[j]
            prev[i] = j
    # extract non-overlapping chains best-first
    order = np.argsort(best)[::-1]
    used = [False] * n
    chains: list[Chain] = []
    for i in order:
        if used[i] or best[i] < vthr:
            continue
        members = []
        j = int(i)
        clash = False
        while j >= 0:
            if used[j]:
                clash = True
                break
            members.append(j)
            j = prev[j]
        if clash or not members:
            continue
        for j in members:
            used[j] = True
        members.reverse()
        chains.append(Chain(hsps=[hs[j] for j in members],
                            score=int(best[i])))
        if len(chains) >= max_out:
            break
    # negotiate genomic bounds with neighbors (wln.cc:865-924 simplified:
    # butt at each other's spans)
    chains_sorted = sorted(chains, key=lambda c: c.g_span[0])
    for a, b in zip(chains_sorted, chains_sorted[1:]):
        mid = (a.g_span[1] + b.g_span[0]) // 2
        a.ulmt = max(a.g_span[1], mid)
        b.llmt = min(b.g_span[0], mid)
    if chains_sorted:
        chains_sorted[0].llmt = 0
        chains_sorted[-1].ulmt = 1 << 62
    return chains


def mirror_hsps(hsps: list[Hsp], M: int, N: int) -> list[Hsp]:
    """Map HSPs of (revcomp(q) x window) into (q x revcomp(window))
    coordinates: an exact match is strand-symmetric, so the minus-strand
    seed pass flips the short query instead of the long window and
    mirrors the results (jx' = M - rx, jy' = N - ry)."""
    return [Hsp(jx=M - h.rx, jy=N - h.ry, jlen=h.jlen, nid=h.nid,
                jscr=h.jscr) for h in hsps]


def wilip(q: np.ndarray, g: np.ndarray | None = None, level: int = 1,
          ipen=None, prm=None, spaced: bool = False,
          wtab: WindowTable | None = None,
          mirror: bool = False, max_level: int | None = None,
          **kw) -> list[Chain]:
    """HSP search + chaining at one level; retries coarser levels if the
    finer one finds nothing (the -Q level recursion entry).

    prm: DpParams — supplies the substitution matrix for HSP evaluation
    and the gap costs for chain links (replacing the flat defaults).
    spaced: spaced seeds at every level, falling back to the contiguous
    seed at the coarsest level (cross-species mode).
    wtab: prebuilt window table; mirror: q is the revcomp query probed
    against the forward window — chains come out in (q x rc-window)
    coordinates (see mirror_hsps)."""
    if prm is not None:
        kw.setdefault("gop", prm.gop)
        kw.setdefault("gep", prm.gep)
    mtx = prm.qprof_mtx if prm is not None else None
    N = len(wtab.g if wtab is not None else g)

    def _find(lv, sp):
        hsps = find_hsps(q, g, lv, mtx=mtx, spaced=sp, wtab=wtab)
        if mirror:
            hsps = mirror_hsps(hsps, len(q), N)
        return hsps

    hi = 3 if max_level is None else min(max_level + 1, 3)
    for lv in range(level, hi):
        chains = chain_hsps(_find(lv, spaced), ipen=ipen, **kw)
        if chains:
            return chains
    if spaced:
        chains = chain_hsps(_find(2, False), ipen=ipen, **kw)
        if chains:
            return chains
    return []
