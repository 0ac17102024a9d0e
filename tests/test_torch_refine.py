"""The port's first-exon refinement (``align/refine.py``
``refine_first_exon``) on a seeded first exon whose DP path aligned the
query's head against the intron's tail: the sloppy head is stripped at
the acceptor and the head planted upstream as its own exon.  Where the
acceptor sits ``off`` columns from the creepback point along the
diagonal, the exon left behind keeps the matches and mismatches of the
columns it spans, and the score loses the head's matrix score to the
moved cut; at ``off`` = 0 the head taken off is the creepback point's
own."""
import dataclasses

import numpy as np
import pytest

from spaln_tpu_torch.align.driver import AlignerContext
from spaln_tpu_torch.align.gene import build_gene_structure
from spaln_tpu_torch.align.refine import (_creepback_head, _head_to,
                                          _sig53_pair, refine_first_exon)
from spaln_tpu_torch.score.splice import build_splice_signals
from spaln_tpu_torch.score.tables import TableDir, find_table_dir
from spaln_tpu_torch.seq.codec import encode_dna

HEAD, BODY, P = 20, 150, 50          # the true first exon at g[P:P+HEAD]
OTHER = {"A": "C", "C": "G", "G": "T", "T": "A"}


@pytest.fixture(scope="module")
def ctx():
    return AlignerContext.create(TableDir(find_table_dir()), "cpu")


def _mk(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _case(ctx, off: int, seed: int):
    """(gs, q, g, sig, d0): a query head + body whose path runs on one
    diagonal from the query's start, the head against the intron's last
    HEAD bases.  The head mismatches the intron there, so the creepback
    point is the acceptor b0; ``off`` = +1 makes the head's last column a
    match (the point one column short of b0), ``off`` = -1 makes the
    body's first column a mismatch (one column past it).  The acceptor is
    b0 alone."""
    rng = np.random.default_rng(seed)
    tail = _mk(rng, HEAD - 6) + "TTACAG"
    head = "".join(OTHER[c] for c in tail)
    if off == 1:
        head = head[:-1] + tail[-1]
    body = _mk(rng, BODY)
    g = (_mk(rng, P) + head + "GTAAGT" + _mk(rng, 400) + tail + body
         + _mk(rng, 40))
    b0 = g.index(tail + body) + HEAD
    qb = body if off != -1 else OTHER[body[0]] + body[1:]
    q, gc = encode_dna(head + qb), encode_dna(g)
    d0 = b0 - HEAD
    ops = [("D", m, m + d0) for m in range(1, HEAD + BODY + 1)]
    sig = build_splice_signals(gc, ctx.cfg, ctx.tables)
    cano3 = np.zeros_like(sig.cano3)
    cano3[b0] = 1
    sig = dataclasses.replace(sig, cano3=cano3)
    score = int(sum(ctx.prm.qprof_mtx[q[m - 1], gc[n - 1]]
                    for _, m, n in ops))
    gs = build_gene_structure(ops, q, gc, score, q_name="q", g_name="g")
    return gs, q, gc, sig, d0


def _recount(q, g, e):
    assert e.q_end - e.q_start == e.g_end - e.g_start
    mch = int((q[e.q_start:e.q_end] == g[e.g_start:e.g_end]).sum())
    return mch, e.q_end - e.q_start - mch


def _planted_score(ctx, q, g, sig, e, g0, w=9.0):
    """The planted exon's total as the refinement scores it: w times its
    matrix score, the intron's penalty and the junction's signals."""
    prm, qh = ctx.prm, e.q_end
    ilen = g0 - e.g_end
    return (w * int(prm.qprof_mtx[q[:qh], g[e.g_start:e.g_end]].sum())
            + int(prm.intron_table(ilen + 2)[ilen])
            + _sig53_pair(sig, e.g_end, g0))


@pytest.mark.parametrize("off,seed", [(1, 2001), (-1, 2002), (0, 2003)])
def test_strip_keeps_counts_and_score_in_step(ctx, off, seed):
    gs, q, g, sig, d0 = _case(ctx, off, seed)
    cb = _creepback_head(gs, q, g, ctx.prm, 120)
    assert cb[0] == HEAD - off and cb[1] == cb[0] + d0
    before = dataclasses.replace(gs.exons[0])
    score0 = gs.score
    head_mtx = int(sum(ctx.prm.qprof_mtx[q[i], g[i + d0]]
                       for i in range(HEAD)))
    assert refine_first_exon(gs, q, g, sig, ctx.prm)
    planted, kept = gs.exons[0], gs.exons[1]
    b0 = HEAD + d0
    assert (kept.q_start, kept.g_start) == (HEAD, b0)
    assert (planted.q_start, planted.q_end) == (0, HEAD)
    assert (planted.g_start, planted.g_end) == (P, P + HEAD)
    assert gs.introns[0].g_start == P + HEAD and gs.introns[0].g_end == b0
    assert _recount(q, g, kept) == (kept.mch, kept.mmc)
    assert _recount(q, g, planted) == (planted.mch, planted.mmc)
    assert gs.score == pytest.approx(
        score0 - head_mtx + _planted_score(ctx, q, g, sig, planted, b0))
    if off == 0:
        # the creepback point's own head, as before the cut could move
        assert (kept.mch, kept.mmc) == (before.mch - cb[3],
                                        before.mmc - cb[4])
        assert head_mtx == cb[2]
    else:
        assert head_mtx != cb[2]


@pytest.mark.parametrize("off,seed", [(1, 2001), (-1, 2002), (0, 2003)])
def test_head_to_the_creepback_point_is_its_own(ctx, off, seed):
    gs, q, g, _, _ = _case(ctx, off, seed)
    cb = _creepback_head(gs, q, g, ctx.prm, 120)
    assert _head_to(gs, q, g, ctx.prm, cb[0], cb[1]) == cb[2:5]
