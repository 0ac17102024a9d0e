"""The port's double-affine (-yl3) and score-only modes of the slab kernel
(K5), as the wrappers run their plain PyTorch versions on the CPU,
against spaln_tpu's lax.scan engine on the CPU.  All integer, so the
tolerance is 0: planes (five junction planes, flag bits 5-6), scores,
ends, op streams, UDH crossings and the score-only final row and right
column are equal.

Two double-affine parameter sets: tests/test_dp_pallas.py:121's
(lgop = gop // 2, lgep = gep // 3) and the one `-y l3` gives (Spaln's
long-gap costs, ls = 3).  Fixtures: tests/test_dp_pallas.py's planted
introns, and planted genes with a 20-60 nt deletion or insertion inside
an exon, so the long-gap states E2 and F2 carry paths (and, on the UDH
path, cross slab boundaries).
"""
import dataclasses

import numpy as np
import pytest
import torch

from spaln_tpu.config import Config, resolve, CvsG
from spaln_tpu.ops import dp_spliced_udh as ref_udh
from spaln_tpu.ops.dp_spliced_scan import (collect_batch_results,
                                           prepare_spliced_batch,
                                           run_spliced_batch,
                                           traceback_device_batch,
                                           _pads, _rc_pos, _row_pos)
from spaln_tpu.ops.params import DpParams
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch.ops import dp_spliced as port_dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops import dp_spliced_udh as port_udh
from spaln_tpu_torch.ops.convert import (batch_from_reference,
                                         params_from_reference)
from test_torch_udh import BUDGETS, retrace_at_budget

BASES = np.array(list("ACGT"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of steps of tiny tensor ops,
    where intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ctx(table_dir):
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    cfg3 = dataclasses.replace(cfg, aln=dataclasses.replace(cfg.aln, ls=3))
    prms = {"single": prm,
            "half": dataclasses.replace(prm, dagp=True, lgop=prm.gop // 2,
                                        lgep=prm.gep // 3),
            "yl3": DpParams.build(cfg3, Simmtx.dna(), CvsG,
                                  ipen=IntronPenalty(cfg3, CvsG))}
    assert prms["yl3"].dagp and prms["yl3"].lgop != prms["half"].lgop
    return cfg, prms, table_dir


def _mk(rng, n):
    return "".join(rng.choice(BASES, n))


def _spliced(cfg, tables, B, M, ilen, seed):
    """tests/test_dp_pallas.py:32-45: one planted intron per problem."""
    rng = np.random.default_rng(seed)
    qs, gs = [], []
    for i in range(B):
        e1, e2 = _mk(rng, M // 2), _mk(rng, M - M // 2)
        gi = "GTAAGT" + _mk(rng, ilen - 13) + "TTTCTAG"
        qs.append(e1 + e2)
        gs.append(e1 + gi + e2 + _mk(rng, 7 + (i % 5)))
    return qs, gs


def _indels(B, seed, lo=20, hi=60):
    """Two-exon genes, each with a deletion mid-exon (genome-only bases:
    a long horizontal gap, E2) or, every other problem, an insertion
    (query-only bases: a long vertical gap, F2) of lo-hi nt, with 35 nt
    of exon on either side (shorter flanks are cheaper to leave
    unaligned at the free query ends than to gap)."""
    rng = np.random.default_rng(seed)
    qs, gs = [], []
    for i in range(B):
        e1, e2 = _mk(rng, 70), _mk(rng, 70)
        d = _mk(rng, int(rng.integers(lo, hi + 1)))
        intron = "GTAAGT" + _mk(rng, 80) + "TTTCTAG"
        if i % 2 == 0:
            q, g = e1 + e2, e1 + intron + e2[:35] + d + e2[35:]
        else:
            q, g = e1[:35] + d + e1[35:] + e2, e1 + intron + e2
        qs.append(q)
        gs.append(_mk(rng, 10) + g + _mk(rng, 9))
    return qs, gs


def _encode(cfg, tables, qs, gs):
    qc = [encode_dna(q) for q in qs]
    gc = [encode_dna(g) for g in gs]
    return qc, gc, [build_splice_signals(g, cfg, tables) for g in gc]


# (problems, band, lanes, parameter set)
CASES = {
    "pallas_half": (("spliced", 4, 40, 60, 3), dict(lw=-96, up=95), 16,
                    "half"),
    "indel_half": (("indels", 4, 5), {}, 16, "half"),
    "indel_yl3": (("indels", 4, 6), {}, 16, "yl3"),
    "lws_yl3": (("indels", 3, 7), dict(lws=[-40, -30, -60], W=256), 32,
                "yl3"),
}


def _case(ctx, name):
    cfg, prms, tables = ctx
    (kind, *args), band, L, pset = CASES[name]
    qs, gs = (_spliced(cfg, tables, *args) if kind == "spliced"
              else _indels(*args))
    return _encode(cfg, tables, qs, gs), band, L, prms[pset]


@pytest.fixture(scope="module")
def runs(ctx):
    """Reference (scan engine) and port (plain K1-dagp, K2e, K3) results
    per case, computed once."""
    out = {}
    for name in CASES:
        (q, g, s), band, L, prm = _case(ctx, name)
        bp = prepare_spliced_batch(q, g, prm, sigs=s, L=L, **band)
        row, rc, traces = run_spliced_batch(bp, prm, score_only=False)
        scores, ends, _ = collect_batch_results(bp, row, rc, None, True,
                                                prm=prm)
        pprm = params_from_reference(prm)
        tb = batch_from_reference(bp)
        planes = K.spliced_slab_trace(tb, pprm)
        se = K.spliced_last_ends(tb, pprm, planes[2], planes[3])
        recs = K.spliced_tb_walk(tb, planes[0], planes[1], se)
        out[name] = dict(
            traces=[(np.asarray(f), np.asarray(p)) for f, p in traces],
            scores=scores, ends=ends,
            ops=traceback_device_batch(bp, traces, ends), planes=planes,
            se=se, recs=recs, tb=tb, pprm=pprm, inputs=(q, g, s, band, L))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_dagp_planes_equal_scan(runs, case):
    r = runs[case]
    flags, spj = r["planes"][0].numpy(), r["planes"][1].numpy()
    assert spj.shape[1] == 5
    assert len(r["traces"]) == flags.shape[0]
    for s, (fl_ref, spj_ref) in enumerate(r["traces"]):
        np.testing.assert_array_equal(flags[s], fl_ref)
        np.testing.assert_array_equal(np.moveaxis(spj[s], 0, -1), spj_ref)
    live = flags[flags != 255]
    assert ((live & 7) >= 3).any()           # E2 or F2 won a cell
    assert (live & 0x60).any()               # and opened somewhere


@pytest.mark.parametrize("case", list(CASES))
def test_dagp_ends_and_walk_equal_reference(runs, case):
    """K2e + the 5-state K3 give collect_batch_results +
    traceback_device_batch's scores, ends and op streams; so does the
    host walk over the port's SliceTraces."""
    r = runs[case]
    se = r["se"].numpy()
    np.testing.assert_array_equal(se[:, 0], r["scores"])
    np.testing.assert_array_equal(se[:, 1:], r["ends"])
    ops = port_dp.ops_from_records(r["recs"].numpy(), r["tb"].B)
    assert ops == r["ops"]
    tb, planes = r["tb"], r["planes"]
    sc, en, btr = port_dp.collect_batch_results(tb, r["pprm"], planes[2],
                                                planes[3], planes[:2])
    np.testing.assert_array_equal(sc, r["scores"])
    for b in range(tb.B):
        assert port_dp.traceback_spliced_scan(
            btr[b], int(en[b][0]), int(en[b][1])) == r["ops"][b]


@pytest.mark.parametrize("case", ["indel_half", "indel_yl3", "lws_yl3"])
def test_dagp_long_gaps_on_the_path(runs, case):
    """The planted indels are long gaps on the paths: runs of 20 or more
    E (genome-only) and F (query-only) moves, not split into short ones.
    (A deletion whose bases happen to hold a GT..AG may be taken as an
    intron instead.)"""
    longest = {"E": 0, "F": 0}
    for ops in runs[case]["ops"]:
        run = 0
        for prev, o in zip([None] + ops, ops):
            run = run + 1 if prev is not None and prev[0] == o[0] else 1
            if o[0] in longest:
                longest[o[0]] = max(longest[o[0]], run)
    assert min(longest.values()) >= 20, longest


@pytest.mark.parametrize("case", list(CASES))
def test_dagp_port_prep_and_run_bucket(runs, case):
    """The port's own operand prep through run_bucket (K1-dagp -> K2e ->
    K3) gives the reference's scores, ends and op streams."""
    r = runs[case]
    q, g, s, band, L = r["inputs"]
    bp = port_dp.prepare_spliced_batch(q, g, r["pprm"], sigs=s, L=L, **band)
    before = dict(K.plain_calls)
    scores, ends, ops = K.run_bucket(bp, r["pprm"])
    np.testing.assert_array_equal(scores, r["scores"])
    assert [list(e) for e in ends] == [list(e) for e in r["ends"]]
    assert ops == r["ops"]
    for k in K.PLANE_PATH_DAGP:
        assert K.plain_calls[k] == before[k] + 1
    assert K.plain_calls["spliced_slab_trace"] == before["spliced_slab_trace"]


def _ref_row_rc(bp, row_h, rc_h):
    """spaln_tpu's final row / right column in the port's layout: (B,
    Nmax+1) by column n, (B, Mpad+1) by row m (the _pads storage
    conventions that collect_batch_results reads)."""
    PB, _, PBm, _ = _pads(bp.L, bp.T, bp.Nmax, bp.Mpad)
    row_full, rc_full = np.asarray(row_h), np.asarray(rc_h)
    row = np.empty((bp.B, bp.Nmax + 1), np.int32)
    rc = np.empty((bp.B, bp.Mpad + 1), np.int32)
    for i in range(bp.B):
        M, N, d = bp.Ms[i], bp.Ns[i], bp.deltas[i]
        ro = _row_pos(PB, bp.L, 0, d, (M - 1) % bp.L)
        co = _rc_pos(PBm, bp.Nmax, 0, d, N)
        row[i] = row_full[i, ro:ro + bp.Nmax + 1]
        rc[i] = rc_full[i, co:co + bp.Mpad + 1]
    return row, rc


@pytest.mark.parametrize("case,pset", [("indel_half", "single"),
                                       ("indel_half", "half"),
                                       ("lws_yl3", "yl3")])
def test_score_only_equals_scan(ctx, runs, case, pset):
    """K5's score-only mode, single and double affine: the final row and
    right column equal run_spliced_batch(score_only=True)'s (and, for the
    case's own parameters, K1's)."""
    cfg, prms, tables = ctx
    (q, g, s), band, L, prm_case = _case(ctx, case)
    prm = prms[pset]
    bp = prepare_spliced_batch(q, g, prm, sigs=s, L=L, **band)
    row_h, rc_h, traces = run_spliced_batch(bp, prm, score_only=True)
    assert traces == []
    ref_row, ref_rc = _ref_row_rc(bp, row_h, rc_h)
    before = dict(K.plain_calls)
    row, rc = K.spliced_slab_score(batch_from_reference(bp),
                                   params_from_reference(prm))
    assert K.plain_calls["spliced_slab_score"] == \
        before["spliced_slab_score"] + 1
    np.testing.assert_array_equal(row.numpy(), ref_row)
    np.testing.assert_array_equal(rc.numpy(), ref_rc)
    if prm is prm_case:
        planes = runs[case]["planes"]
        assert torch.equal(planes[2], row) and torch.equal(planes[3], rc)


# ------------------------------------------------------------------ UDH
def _udh_problems(ctx, name):
    """"test_udh": tests/test_udh.py:124's problem (a 40 nt deletion in
    the query mid-exon, one problem, L = 32); "batch": three three-exon
    genes with a 24-36 nt deletion or insertion (an F2 crossing)."""
    cfg, prms, tables = ctx
    if name == "test_udh":
        rng = np.random.default_rng(11)
        ex = [_mk(rng, 70), _mk(rng, 90)]
        g = (_mk(rng, 20) + ex[0] + "GTAAGT" + _mk(rng, 140 - 13)
             + "TTTTTAG" + ex[1] + _mk(rng, 20))
        q = "".join(ex)
        return _encode(cfg, tables, [q[:30] + q[70:]], [g])
    rng = np.random.default_rng(1001)
    qs, gs = [], []
    for k in range(3):
        ex = [_mk(rng, n) for n in (40, 50, 45)]
        g = (_mk(rng, 20) + ex[0] + "GTAAGT" + _mk(rng, 77) + "TTTTTAG"
             + ex[1] + "GTAAGT" + _mk(rng, 107) + "TTTTTAG" + ex[2]
             + _mk(rng, 20))
        q = "".join(ex)
        d = _mk(rng, 24 + 6 * k)
        if k == 1:
            q = q[:60] + d + q[60:]
        else:
            g = g.replace(ex[1], ex[1][:20] + d + ex[1][20:])
        qs.append(q)
        gs.append(g)
    return _encode(cfg, tables, qs, gs)


def _capture(monkeypatch, module, name):
    fn = getattr(module, name)
    seen = []

    def wrapped(*args, **kw):
        seen.append(fn(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.fixture(scope="module")
def udh_runs(ctx):
    cfg, prms, tables = ctx
    prm = prms["yl3"]
    pprm = params_from_reference(prm)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        ref_cr = _capture(mp, ref_udh, "_backwalk")
        passes = _capture(mp, port_udh, "links_pass")
        for name in ("test_udh", "batch"):
            q, g, s = _udh_problems(ctx, name)
            bp = prepare_spliced_batch(q, g, prm, sigs=s, L=32)
            ref = ref_udh.run_spliced_batch_udh(bp, prm, engine="scan")
            pbp = port_dp.prepare_spliced_batch(q, g, pprm, sigs=s, L=32)
            port = port_udh.run_spliced_batch_udh(pbp, pprm)
            links, snaps, se, cr = passes[-1]
            out[name] = dict(ref=ref, ref_cr=ref_cr[-1], port=port,
                             pbp=pbp, pprm=pprm, links=links, snaps=snaps,
                             se=se, cr=cr)
    return out


@pytest.mark.parametrize("name,budget", [
    *(pytest.param(n, None, id=n) for n in ("test_udh", "batch")),
    *(pytest.param(n, b, id=f"{n}-{b}") for n in ("test_udh", "batch")
      for b in BUDGETS)])
def test_udh_dagp_equals_reference(udh_runs, monkeypatch, name, budget):
    """The port's UDH path with double-affine gaps (K4-dagp with its F2
    link stream, the backwalk, K1-dagp retrace, 5-state strips) against
    spaln_tpu's UDH on its scan engine: scores, ends, op streams and the
    backwalk's crossings; and against the port's plane path.  The
    retrace also at plane budgets of one slab, two slabs and one run a
    launch."""
    r = udh_runs[name]
    s_ref, e_ref, ops_ref = r["ref"]
    s, e, ops = r["port"]
    if budget is not None:
        ops = retrace_at_budget(monkeypatch, r, r["pprm"],
                                BUDGETS[budget])[0]
    np.testing.assert_array_equal(s, np.asarray(s_ref))
    assert [tuple(x) for x in e] == [tuple(int(v) for v in x)
                                     for x in e_ref]
    assert ops == ops_ref
    cr = r["cr"]
    got = []
    for i in range(cr.shape[0]):
        sf = (int(r["se"][i, 1]) - 1) // 32
        got.append({k: (int(cr[i, k, 0]), int(cr[i, k, 1]))
                    for k in range(sf, 0, -1)} if cr[i, 0, 0] else None)
    assert got == r["ref_cr"]
    assert tuple(r["links"].shape[:2]) == (r["pbp"].S, 5)
    assert r["snaps"].shape[1] == 3
    if name == "batch":                   # an F2 crossing is followed
        assert any(st == 4 for c in got for _, st in c.values())
    planes = K.run_bucket(r["pbp"], r["pprm"])
    assert planes[2] == ops


def test_dagp_retrace_from_snapshot_equals_full_planes(udh_runs):
    """K1-dagp's retrace of every slab, from K4-dagp's three-row
    snapshot, and of the whole run from slab 0 in one launch, gives
    exactly the full K1-dagp run's planes; the 5-state strip walks from
    each crossing (states 0, 2 and 4), all in one launch, stitch to the
    full walk's op streams."""
    r = udh_runs["batch"]
    pbp, pprm, snaps, cr, se = (r["pbp"], r["pprm"], r["snaps"], r["cr"],
                                r["se"])
    L = pbp.L
    flags, spj, _, _ = K.spliced_slab_trace(pbp, pprm)
    sel = torch.tensor([2, 0, 1], dtype=torch.int32)
    idx = sel.long()
    for s in range(pbp.S):
        snap = snaps[s].index_select(1, idx).contiguous()
        fl, sp = K.spliced_slab_retrace(pbp, pprm, s, 1, snap, sel)
        np.testing.assert_array_equal(fl[0].numpy(),
                                      flags[s][:, idx].numpy())
        np.testing.assert_array_equal(sp[0].numpy(),
                                      spj[s][:, :, idx].numpy())
    fl, sp = K.spliced_slab_retrace(pbp, pprm, 0, pbp.S,
                                    snaps[0].index_select(1, idx)
                                    .contiguous(), sel)
    np.testing.assert_array_equal(fl.numpy(), flags[:, :, idx].numpy())
    np.testing.assert_array_equal(sp.numpy(), spj[:, :, :, idx].numpy())
    starts, keys = [], []
    for j, b in enumerate(sel.tolist()):
        sf = (int(se[b, 1]) - 1) // L
        for s in range(sf + 1):
            starts.append([int(se[b, 1]), int(se[b, 2]), 0, s * L, j]
                          if s == sf else
                          [(s + 1) * L, int(cr[b, s + 1, 0]),
                           int(cr[b, s + 1, 1]), s * L, j])
            keys.append((b, s))
    recs = K.spliced_tb_strips(fl, sp, torch.tensor(starts, dtype=torch.int32),
                               pbp.lws_t.index_select(0, idx), 0,
                               port_dp.strip_walk_bound(L, pbp.W))
    strips = {b: {} for b in range(pbp.B)}
    for (b, s), ops in zip(keys, port_dp.ops_from_records(recs.numpy(),
                                                          len(keys))):
        strips[b][s] = ops
    assert [[o for s in sorted(strips[b]) for o in strips[b][s]]
            for b in range(pbp.B)] == r["port"][2]
