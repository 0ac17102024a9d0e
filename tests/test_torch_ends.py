"""K2e, the end extraction, and its fusion with K3 on the plane path
(spliced_ends_tb_walk), on the CPU: how the kernel splits a segment
into a scalar head, whole int4 and a scalar tail (ends_partition), the
plain version against spaln_tpu's collect_batch_results on tie-heavy
rows, and the fused entry's plain version against
collect_batch_results + traceback_device_batch on tests/test_torch_dp.py's
batches.  All integer: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from spaln_tpu.config import Config, resolve, CvsG
from spaln_tpu.ops.dp_spliced_scan import (_pads, _rc_pos, _row_pos,
                                           collect_batch_results,
                                           prepare_spliced_batch,
                                           run_spliced_batch,
                                           traceback_device_batch)
from spaln_tpu.ops.params import DpFlags, DpParams
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch.ops import dp_spliced as port_dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops.convert import (batch_from_reference,
                                         params_from_reference)
from spaln_tpu_torch.ops.params import DpFlags as PortFlags
from test_torch_dp import CASES, _batches

LENGTHS = [0, 1, 3, 4, 5, 31, 32, 33, 127, 128, 129]


@pytest.mark.parametrize("base", range(4))
@pytest.mark.parametrize("n", LENGTHS)
def test_ends_partition_reads_each_index_once(base, n):
    """Every index of [lo, lo + n) is read exactly once, whatever the
    array's offset ``base`` from a 16-byte boundary and the segment's
    start: an index inside a whole aligned int4 of the segment by that
    int4's thread (int4 c from the first one by thread c mod
    ENDS_THREADS), any other one (at most 3 at each end) on its own."""
    P = K.ENDS_THREADS
    for lo in (0, 1, 2, 3, 6, 257):
        hi = lo + n
        reads = K.ends_partition(base, lo, hi)
        assert len(reads) == P
        got = sorted(k for r in reads for k in r)
        assert got == list(range(lo, hi)), lo
        owner = {k: j for j, r in enumerate(reads) for k in r}
        first = lo + (-(base + lo)) % 4           # the first aligned index
        for k in range(lo, hi):
            q = k - (base + k) % 4                 # k's aligned int4
            if q >= lo and q + 4 <= hi:
                assert owner[k] == ((q - first) // 4) % P, (lo, k)
            else:
                assert k - lo < 3 or hi - k <= 3, (lo, k)


def test_ends_partition_of_an_empty_or_reversed_segment():
    assert not any(K.ends_partition(1, 9, 9))
    assert not any(K.ends_partition(2, 9, 4))


def test_ends_partition_wraps_past_the_cta():
    """A segment of more than ENDS_THREADS int4: thread j reads int4 j,
    j + ENDS_THREADS, ... of the body, in order."""
    P = K.ENDS_THREADS
    reads = K.ends_partition(0, 0, 4 * (2 * P + 3))
    assert reads[0] == [*range(0, 4), *range(4 * P, 4 * P + 4),
                        *range(8 * P, 8 * P + 4)]
    assert reads[3] == [*range(12, 16), *range(4 * P + 12, 4 * P + 16)]


# ------------------------------------------------ ties against spaln_tpu
@pytest.fixture(scope="module")
def ties(table_dir):
    """A reference batch of 6 problems with long rows (M 150-400, N
    600-1,400, L = 32, its own band per problem, both segments of every
    problem non-empty) and the port's view of it."""
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    rng = np.random.default_rng(17)
    bases = np.array(list("ACGT"))
    qs, gs, ss = [], [], []
    for M, N in ((150, 600), (260, 900), (400, 1400), (333, 777),
                 (201, 1023), (390, 1300)):
        qs.append(encode_dna("".join(rng.choice(bases, M))))
        gc = encode_dna("".join(rng.choice(bases, N)))
        gs.append(gc)
        ss.append(build_splice_signals(gc, cfg, table_dir))
    bp = prepare_spliced_batch(qs, gs, prm, sigs=ss, L=32,
                               lws=[-150, -200, -330, -250, -100, -300],
                               W=1500)
    return bp, prm, batch_from_reference(bp), params_from_reference(prm)


def _with(bp, tb, flags=None, lws=None):
    """The reference and port batches with other end flags or bands."""
    if flags is not None:
        bp = dataclasses.replace(bp, flags=DpFlags(**flags))
        tb = dataclasses.replace(tb, flags=PortFlags(**flags))
    if lws is not None:
        bp = dataclasses.replace(bp, lws=list(lws))
        tb = dataclasses.replace(tb, lws=list(lws),
                                 lws_t=torch.tensor(lws, dtype=torch.int32))
    return bp, tb


def _reference_ends(bp, prm, row, rc):
    """collect_batch_results on the port's (row, rc) placed where the
    reference's storage conventions (_pads) put them, other cells
    garbage."""
    PB, TOTn, PBm, TOTm = _pads(bp.L, bp.T, bp.Nmax, bp.Mpad)
    row_h = np.full((bp.B, TOTn), 12345, np.int32)
    rc_h = np.full((bp.B, TOTm), 12345, np.int32)
    for i in range(bp.B):
        M, N, d = bp.Ms[i], bp.Ns[i], bp.deltas[i]
        ro = _row_pos(PB, bp.L, 0, d, (M - 1) % bp.L)
        co = _rc_pos(PBm, bp.Nmax, 0, d, N)
        row_h[i, ro:ro + bp.Nmax + 1] = row[i]
        rc_h[i, co:co + bp.Mpad + 1] = rc[i]
    scores, ends, _ = collect_batch_results(bp, row_h, rc_h, None, True,
                                            prm=prm)
    return np.concatenate([scores[:, None], ends], axis=1)


FLAGS = {"all free": {},
         "row only": dict(b_exgr=False),
         "column only": dict(a_exgr=False),
         "anchored": dict(a_exgl=False, b_exgl=False),
         "none": dict(a_exgr=False, b_exgr=False)}


@pytest.mark.parametrize("kind", chip_smoke.TIE_KINDS)
@pytest.mark.parametrize("flags", list(FLAGS))
def test_last_ends_plain_equals_reference_on_ties(ties, kind, flags):
    bp, prm, tb, pprm = ties
    bp, tb = _with(bp, tb, flags=dict(FLAGS[flags]))
    row = torch.zeros((tb.B, tb.Nmax + 1), dtype=torch.int32)
    rc = torch.zeros((tb.B, tb.Mpad + 1), dtype=torch.int32)
    row, rc = chip_smoke.tie_rows(kind, tb, row, rc, seed=3)
    got = K.last_ends_plain(tb, pprm, row, rc).numpy()
    np.testing.assert_array_equal(
        got, _reference_ends(bp, prm, row.numpy(), rc.numpy()))


def test_tie_kinds_decide_as_described(ties):
    """The tie rows exercise what they claim: the row's first index wins
    a flat segment, the column its first index where it is greater, the
    row a tie with the column, the first of repeated maxima."""
    bp, prm, tb, pprm = ties
    segs = chip_smoke._segments(tb)
    z = (torch.zeros((tb.B, tb.Nmax + 1), dtype=torch.int32),
         torch.zeros((tb.B, tb.Mpad + 1), dtype=torch.int32))
    ends = {k: K.last_ends_plain(tb, pprm, *chip_smoke.tie_rows(k, tb, *z))
            for k in chip_smoke.TIE_KINDS}
    for b, ((rlo, _), (clo, _)) in enumerate(segs):
        assert ends["flat"][b].tolist() == [5, tb.Ms[b], rlo]
        assert ends["at_lo"][b].tolist() == [10, clo, tb.Ns[b]]
        assert ends["across_warps"][b].tolist() == [50, tb.Ms[b], rlo + 7]
        assert ends["row_col_tie"][b, 0] == 200
        assert ends["row_col_tie"][b, 1] == tb.Ms[b]


@pytest.mark.parametrize("which", ["row", "column"])
def test_last_ends_plain_equals_reference_on_empty_segments(ties, which):
    """Bands that leave the final-row segment (lw >= N - M) or the
    right-column one (lw + W - 1 <= N - M) empty: the empty segment never
    wins, even against NEV."""
    bp, prm, tb, pprm = ties
    d = [N - M for M, N in zip(tb.Ms, tb.Ns)]
    lws = ([x + 3 for x in d] if which == "row"
           else [x - tb.W + 1 - 2 for x in d])
    bp, tb = _with(bp, tb, lws=lws)
    segs = chip_smoke._segments(tb)
    k = 0 if which == "row" else 1
    assert all(s[k][1] <= s[k][0] for s in segs)
    for kind in ("nev", "repeat", "flat"):
        row = torch.zeros((tb.B, tb.Nmax + 1), dtype=torch.int32)
        rc = torch.zeros((tb.B, tb.Mpad + 1), dtype=torch.int32)
        row, rc = chip_smoke.tie_rows(kind, tb, row, rc, seed=5)
        got = K.last_ends_plain(tb, pprm, row, rc).numpy()
        np.testing.assert_array_equal(
            got, _reference_ends(bp, prm, row.numpy(), rc.numpy()))


# ------------------------------------------- the fused entry's plain path
@pytest.fixture(scope="module")
def fused_runs(table_dir):
    """spaln_tpu's scores, ends and op streams per fixture of
    tests/test_torch_dp.py, and the port's K1 planes of the same
    batch."""
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    pprm = params_from_reference(prm)
    out = {}
    for name, q, g, s, band, L in _batches(cfg, table_dir):
        bp = prepare_spliced_batch(q, g, prm, sigs=s, L=L, **band)
        row, rc, traces = run_spliced_batch(bp, prm, score_only=False)
        scores, ends, _ = collect_batch_results(bp, row, rc, None, True,
                                                prm=prm)
        tb = batch_from_reference(bp)
        out[name] = dict(scores=scores, ends=ends, tb=tb, pprm=pprm,
                         ops=traceback_device_batch(bp, traces, ends),
                         planes=K.spliced_slab_trace(tb, pprm))
    return out


@pytest.mark.parametrize("case", CASES)
def test_ends_tb_walk_plain_equals_reference(fused_runs, case):
    """spliced_ends_tb_walk on CPU tensors (its plain version, K2e's then
    K3's) gives collect_batch_results + traceback_device_batch's scores,
    ends and op streams, and the model's walk stats."""
    r = fused_runs[case]
    tb, pprm = r["tb"], r["pprm"]
    flags, spj, row, rc = r["planes"]
    before = dict(K.plain_calls)
    st = torch.zeros((tb.B, 2), dtype=torch.int32)
    se, recs = K.spliced_ends_tb_walk(tb, pprm, flags, spj, row, rc,
                                      stats=st)
    assert K.plain_calls["spliced_ends_tb_walk"] == \
        before["spliced_ends_tb_walk"] + 1
    se = se.numpy()
    np.testing.assert_array_equal(se[:, 0], r["scores"])
    np.testing.assert_array_equal(se[:, 1:], r["ends"])
    assert port_dp.ops_from_records(recs.numpy(), tb.B) == r["ops"]
    assert torch.equal(st, K.walk_stats(recs, flags, tb.lws_t))
    assert torch.equal(recs, K.tb_walk_plain(
        tb, flags, spj, K.last_ends_plain(tb, pprm, row, rc)))
