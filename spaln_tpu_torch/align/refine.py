"""Boundary-refinement heuristics (fwd2s1.cc:2094-2404).

The reference's interpolateS decision tree runs dedicated searches for
the hard junction cases the banded DP cannot see: a micro exon inside a
long intron (micro_exon, fwd2s1.cc:2163-2234), and short first/last
exons far up/downstream of the aligned span (first_exon/last_exon,
2274-2404).  Here they are host-side numpy scans over the splice-signal
arrays, applied as post-passes by the driver:

* `micro_exon_scan` — exact placement of a fixed query piece between
  two anchored junctions, scored w*match + sig53 + two intron
  penalties, with the exon-skip (single junction) alternative.
* `refine_first_exon` / `refine_last_exon` — extend a gene whose query
  head/tail is uncovered by planting a short end exon at the best
  donor/acceptor-consistent genomic position within MaxGene.

All scores are in the engine's x10 fixed-point scale; `w` is the
match factor for very short alignments (alprm2.w = 9, seq.h:30,
simmtx.cc:50).
"""
from __future__ import annotations

import numpy as np

from .gene import Exon, GeneStructure, Intron


def _sig53_pair(sig, n5: int, n3: int) -> int:
    """sig5[n5] + joint acceptor term at n3 (the IE5P3/IE53 composite the
    closed-form join uses; see driver._splice_join)."""
    N = len(sig.sig5)
    if not (0 <= n5 < N and 0 <= n3 < N):
        return -(1 << 30)
    accb = int(sig.sig3[n3]) - int(sig.tabs.tab3[sig.dinc3[n3]])
    joint = int(sig.acc_joint[n3, int(sig.dinc5[n5]) & 15])
    return int(sig.sig5[n5]) + accb + joint


def micro_exon_scan(q, g, sig, prm, ma: int, mb: int, l: int, r: int,
                    w: float = 9.0):
    """Place query piece q[ma:mb] (0-based, may be empty) between donor
    site l and acceptor site r (micro_exon, fwd2s1.cc:2163-2234).

    Returns (score, p) where p is the exon genomic start, p < 0 for the
    skipped-exon single junction, or None if nothing is eligible."""
    alen = mb - ma
    minl = prm.intron_llmt
    if r - l < 2 * minl + max(alen, 0):
        return None
    ipen_tab = prm.intron_table(r - l + 2)
    if alen <= 0:
        if sig.is_donor[l] and sig.is_accpt[r]:
            return (int(ipen_tab[r - l]) + _sig53_pair(sig, l, r), -1)
        return None
    piece = np.asarray(q[ma:mb], dtype=np.int64)
    ps = np.arange(l + minl, r - alen - minl)
    if not len(ps):
        return None
    ok = (sig.is_accpt[ps] != 0) & (sig.is_donor[ps + alen] != 0)
    if not ok.any():
        return None
    ps = ps[ok]
    garr = np.asarray(g, dtype=np.int64)
    win = ps[:, None] + np.arange(alen)[None, :]
    mch = prm.qprof_mtx[piece[None, :], garr[win]].sum(axis=1)
    accb = sig.sig3.astype(np.int64) - sig.tabs.tab3[sig.dinc3]
    j_in = (sig.acc_joint[ps, np.asarray(sig.dinc5[l], np.int64) & 15]
            + accb[ps] + int(sig.sig5[l]))
    d16 = sig.dinc5[ps + alen].astype(np.int64) & 15
    j_out = (sig.acc_joint[r, d16] + int(accb[r])
             + sig.sig5[ps + alen].astype(np.int64))
    tot = (w * mch + j_in + j_out
           + ipen_tab[ps - l] + ipen_tab[r - ps - alen])
    k = int(np.argmax(tot))
    base = micro_exon_scan(q, g, sig, prm, ma, ma, l, r, w)
    if base is not None:
        # skipping a non-empty piece leaves it unpaired: ordinary gap
        base = (base[0] + prm.gop + prm.gep * alen, base[1])
    best = (int(tot[k]), int(ps[k]))
    if base is not None and base[0] >= best[0]:
        return base
    return best


def _end_scan(piece, g, sig, prm, lo, hi, donor_at_end: bool,
              w: float = 9.0):
    """Best placement of `piece` in g[lo:hi] with an eligible donor
    right after it (first-exon case) or acceptor right before it
    (last-exon case); returns (score_without_intron_terms, p)."""
    u = len(piece)
    ps = np.arange(max(lo, 0), hi - u)
    if not len(ps):
        return None
    # donor site = first intron base after the exon; acceptor site = the
    # exon-start boundary itself (Intron g_end convention)
    site = ps + u if donor_at_end else ps
    elig = (sig.is_donor[np.clip(site, 0, len(g) - 1)] != 0
            if donor_at_end else
            sig.is_accpt[np.clip(site, 0, len(g) - 1)] != 0)
    elig &= (site >= 0) & (site < len(g))
    if not elig.any():
        return None
    ps = ps[elig]
    garr = np.asarray(g, dtype=np.int64)
    win = ps[:, None] + np.arange(u)[None, :]
    mch = prm.qprof_mtx[np.asarray(piece, np.int64)[None, :],
                        garr[win]].sum(axis=1)
    return w * mch, ps


def _creepback_head(gs: GeneStructure, q, g, prm, max_head: int):
    """Longest sloppy prefix of the first exon: walk the op stream
    while the cumulative matrix score stays <= 0 (creepback,
    fwd2s1.cc:1960-2001).  Returns (q_cut, g_cut, cum, mch, mmc, ng)
    of the best strip point, or None."""
    if gs.view is None or not gs.view.ops:
        return None
    e0 = gs.exons[0]
    qi = np.asarray(q, dtype=np.int64)
    gi = np.asarray(g, dtype=np.int64)
    cum = 0
    mch = mmc = ng = 0
    best = None                        # strip at the cumulative MINIMUM
    best_cum = 0
    n_cur = e0.g_start
    for op in gs.view.ops:
        if op[0] == 'I':
            break
        m = op[1]
        if m > min(e0.q_end, e0.q_start + max_head):
            break
        if op[0] == 'D':
            n_cur = op[2]
            cum += int(prm.qprof_mtx[qi[m - 1], gi[n_cur - 1]])
            if qi[m - 1] == gi[n_cur - 1]:
                mch += 1
            else:
                mmc += 1
        else:
            if op[0] == 'E':
                n_cur = op[2]
            cum += prm.gep
            ng += 1
        if cum < best_cum:
            best_cum = cum
            best = (m, n_cur, cum, mch, mmc, ng)
    return best


def refine_first_exon(gs: GeneStructure, q, g, sig, prm,
                      maxgene: int = 100_000, max_head: int = 120,
                      w: float = 9.0) -> bool:
    """Plant a short first exon for an uncovered query head
    (first_exon, fwd2s1.cc:2274-2360).  A sloppy aligned head (score
    <= 0 prefix) is stripped first (creepback, fwd2s1.cc:1960-2001).
    Mutates gs; True if extended."""
    e0 = gs.exons[0]
    strip = None
    if e0.q_start < 2:
        cb = _creepback_head(gs, q, g, prm, max_head)
        if cb is not None and cb[0] - e0.q_start >= 4:
            # tentative strip; the acceptor may sit a few nt away on
            # the same diagonal (nearest3ss, fwd2s1.cc:2128-2162)
            mq, mg, cum, smch, smmc, sng = cb
            d0 = mg - mq
            for off in [0] + [s * d for d in range(1, 11)
                              for s in (1, -1)]:
                gcut = mg + off
                qcut = gcut - d0
                if not (0 <= gcut < len(g) and 2 <= qcut
                        <= e0.q_end - 2):
                    continue
                if sig.is_accpt[gcut]:
                    strip = (qcut, gcut, cum, smch, smmc)
                    break
        if strip is None:
            return False
        qh, g0 = strip[0], strip[1]
    else:
        qh, g0 = e0.q_start, e0.g_start
    if qh < 2 or qh > max_head:
        return False
    if g0 < prm.intron_llmt + qh or not sig.is_accpt[g0]:
        return False
    res = _end_scan(q[:qh], g, sig, prm, g0 - maxgene,
                    g0 - prm.intron_llmt, donor_at_end=True, w=w)
    if res is None:
        return False
    mscr, ps = res
    ipen_tab = prm.intron_table(int(g0 - ps.min()) + 2)
    tot = mscr + ipen_tab[g0 - (ps + qh)] + np.array(
        [_sig53_pair(sig, int(p + qh), g0) for p in ps])
    k = int(np.argmax(tot))
    # the planted exon must beat keeping the (non-positive-scoring)
    # stripped prefix in place
    floor = strip[2] if strip is not None else 0
    if tot[k] <= floor:
        return False
    p = int(ps[k])
    if strip is not None:
        # shrink exon 0 to the strip point before planting
        e0.q_start, e0.g_start = qh, g0
        e0.mch = max(e0.mch - strip[3], 0)
        e0.mmc = max(e0.mmc - strip[4], 0)
        e0.sig3 = int(sig.sig3[g0])
        gs.score -= strip[2]
    piece = np.asarray(q[:qh], np.int64)
    garr = np.asarray(g, np.int64)[p:p + qh]
    nid = int((piece == garr).sum())
    gs.exons.insert(0, Exon(q_start=0, q_end=qh, g_start=p,
                            g_end=p + qh, mch=nid, mmc=qh - nid,
                            sig5=int(sig.sig5[p + qh])))
    gs.introns.insert(0, Intron(
        g_start=p + qh, g_end=g0, q_pos=qh,
        sig5=int(sig.sig5[p + qh]), sig3=int(sig.sig3[g0]),
        canonical=(int(sig.dinc5[p + qh]) == 11
                   and int(sig.dinc3[g0]) == 2)))
    gs.score += int(tot[k])
    return True


def refine_last_exon(gs: GeneStructure, q, g, sig, prm,
                     maxgene: int = 100_000, max_tail: int = 120,
                     w: float = 9.0) -> bool:
    """Plant a short last exon for an uncovered query tail
    (last_exon, fwd2s1.cc:2362-2404).  Mutates gs; True if extended."""
    el = gs.exons[-1]
    M = len(q)
    qt = M - el.q_end
    if qt < 2 or qt > max_tail:
        return False
    g1 = el.g_end                      # donor boundary candidate
    N = len(g)
    if g1 + prm.intron_llmt + qt > N or not sig.is_donor[g1]:
        return False
    res = _end_scan(q[el.q_end:], g, sig, prm, g1 + prm.intron_llmt,
                    min(N, g1 + maxgene), donor_at_end=False, w=w)
    if res is None:
        return False
    mscr, ps = res
    ipen_tab = prm.intron_table(int(ps.max() - g1) + 2)
    tot = mscr + ipen_tab[ps - g1] + np.array(
        [_sig53_pair(sig, g1, int(p)) for p in ps])
    k = int(np.argmax(tot))
    if tot[k] <= 0:
        return False
    p = int(ps[k])
    piece = np.asarray(q[el.q_end:], np.int64)
    garr = np.asarray(g, np.int64)[p:p + qt]
    nid = int((piece == garr).sum())
    gs.introns.append(Intron(
        g_start=g1, g_end=p, q_pos=el.q_end,
        sig5=int(sig.sig5[g1]), sig3=int(sig.sig3[p]),
        canonical=(int(sig.dinc5[g1]) == 11
                   and int(sig.dinc3[p]) == 2)))
    gs.exons.append(Exon(q_start=el.q_end, q_end=M, g_start=p,
                         g_end=p + qt, mch=nid, mmc=qt - nid,
                         sig3=int(sig.sig3[p])))
    gs.score += int(tot[k])
    return True


def refine_ends(gs: GeneStructure, q, g, sig, prm,
                maxgene: int = 100_000) -> GeneStructure:
    """Apply first/last-exon refinement in place and return gs."""
    try:
        refine_first_exon(gs, q, g, sig, prm, maxgene=maxgene)
        refine_last_exon(gs, q, g, sig, prm, maxgene=maxgene)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        pass                           # refinement is best-effort
    return gs
