"""The port's linear-space UDH path (plain PyTorch versions of K4, K1's
retrace mode and K3's strip mode, as the wrappers run them on the CPU)
against spaln_tpu's UDH path on its lax.scan engine.  All integer, so
the tolerance is 0: scores, ends, op streams and the backwalk's
crossings are equal.

Problems are those of tests/test_udh.py: CASES (multi-slab at L = 32),
the mixed-geometry batch and the right-column end.  The retrace runs at
the default plane budget (every path's slab run in one launch) and at
budgets of one slab, two slabs (runs split mid-way) and one whole run a
launch.
"""
import numpy as np
import pytest
import torch

from spaln_tpu.config import Config, resolve, CvsG
from spaln_tpu.ops import dp_spliced_udh as ref_udh
from spaln_tpu.ops.dp_spliced_scan import (SliceTrace,
                                           prepare_spliced_batch,
                                           traceback_spliced_strip)
from spaln_tpu.ops.params import DpParams
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch.ops import dp_spliced as port_dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops import dp_spliced_udh as port_udh
from spaln_tpu_torch.ops.convert import params_from_reference

L = 32


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
    return cfg, prm, params_from_reference(prm), table_dir


def _mutate(rng, seq, sub=0.03, indel=0.01):
    out = []
    for c in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(rng.choice(list("ACGT")))
        if rng.random() < sub:
            c = rng.choice(list("ACGT"))
        out.append(c)
    return "".join(out)


def _gene(rng, exon_lens, intron_lens, mut=0.0):
    """tests/test_udh.py _gene: 20 nt flanks, GTAAGT..TTTTTAG introns."""
    bases = np.array(list("ACGT"))
    exons = ["".join(rng.choice(bases, n)) for n in exon_lens]
    introns = ["GTAAGT" + "".join(rng.choice(bases, n - 13)) + "TTTTTAG"
               for n in intron_lens]
    g = "".join(rng.choice(bases, 20))
    for i, e in enumerate(exons):
        g += e
        if i < len(introns):
            g += introns[i]
    g += "".join(rng.choice(bases, 20))
    q = "".join(exons)
    if mut:
        q = _mutate(rng, q, sub=mut, indel=mut / 3)
    return q, g


# tests/test_udh.py CASES: queries of 100-200 nt span 4-7 slabs at L=32
CASES = [((60, 80), (150,), 0.0), ((40, 50, 45), (90, 120), 0.0),
         ((60, 80), (200,), 0.06), ((30, 120, 50), (80, 300), 0.04)]


def _problems(ctx, name):
    """(queries, genomes, sigs, band kwargs) of one fixture."""
    cfg, prm, pprm, tables = ctx
    if name.startswith("case"):
        k = int(name[4:])
        q, g = _gene(np.random.default_rng(1000 + k), *CASES[k][:2],
                     mut=CASES[k][2])
        qs, gs = [q], [g]
        band = {}
    elif name == "mixed":
        rng = np.random.default_rng(77)
        qs, gs = [], []
        for exons, introns in [((60, 80), (150,)), ((40, 90, 40), (100, 90)),
                               ((120, 50), (250,))]:
            q, g = _gene(rng, exons, introns, mut=0.03)
            qs.append(q)
            gs.append(g)
        band = dict(lws=[-8, -16, -4], W=512)
    else:                                       # right-column end
        rng = np.random.default_rng(5)
        bases = np.array(list("ACGT"))
        core = "".join(rng.choice(bases, 100))
        qs, gs = [core + "".join(rng.choice(bases, 60))], [core]
        band = {}
    qc = [encode_dna(q) for q in qs]
    gc = [encode_dna(g) for g in gs]
    sigs = [build_splice_signals(g, cfg, tables) for g in gc]
    return qc, gc, sigs, band


FIXTURES = ["case0", "case1", "case2", "case3", "mixed", "rightcol"]


def _crossings_dicts(cr, ends):
    """The port's crossings (B, S, 2) as spaln_tpu's _backwalk returns
    them: per problem {slab s: (col, state)} for 1 <= s <= its end slab,
    or None for a no-op end."""
    out = []
    for i in range(cr.shape[0]):
        if not cr[i, 0, 0]:
            out.append(None)
            continue
        sf = (int(ends[i][1]) - 1) // L
        out.append({s: (int(cr[i, s, 0]), int(cr[i, s, 1]))
                    for s in range(sf, 0, -1)})
    return out


def _capture(monkeypatch, module, name):
    """Record what module.name returns while the pipeline calls it."""
    fn = getattr(module, name)
    seen = []

    def wrapped(*args, **kw):
        seen.append(fn(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.fixture(scope="module")
def runs(ctx):
    """Reference and port UDH results per fixture, computed once; the
    crossings and link streams are captured on the way."""
    cfg, prm, pprm, tables = ctx
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        ref_cr = _capture(mp, ref_udh, "_backwalk")
        passes = _capture(mp, port_udh, "links_pass")
        for name in FIXTURES:
            qc, gc, sigs, band = _problems(ctx, name)
            bp = prepare_spliced_batch(qc, gc, prm, sigs=sigs, L=L, **band)
            ref = ref_udh.run_spliced_batch_udh(bp, prm, engine="scan")
            pbp = port_dp.prepare_spliced_batch(qc, gc, pprm, sigs=sigs,
                                                L=L, **band)
            port = port_udh.run_spliced_batch_udh(pbp, pprm)
            plinks, snaps, se, cr = passes[-1]
            out[name] = dict(ref=ref, ref_cr=ref_cr[-1], port=port,
                             pbp=pbp, links=plinks, snaps=snaps, se=se,
                             cr=cr)
    return out


# plane budgets of the retrace, in problem-slabs a launch (None: the
# longest run's slabs)
BUDGETS = {"one_slab": 1, "two_slabs": 2, "run": None}


def retrace_at_budget(monkeypatch, r, pprm, budget):
    """_retrace over a fixture's links pass at ``budget`` (BUDGETS), the
    retrace launches recorded: [(s0, nslab, problems)]; each launch's
    planes must fit the budget."""
    pbp, cr, se = r["pbp"], r["cr"], r["se"]
    per = pbp.T * pbp.L * port_dp.plane_bytes_per_cell(pprm)
    if budget is None:
        budget = max((int(se[i, 1]) - 1) // pbp.L + 1 for i in range(pbp.B))
    calls = []
    retrace = port_udh.spliced_slab_retrace

    def recorded(bp, prm, s0, nslab, snap, sel):
        calls.append((s0, nslab, sel.tolist()))
        assert len(calls[-1][2]) * nslab * per <= budget * per
        return retrace(bp, prm, s0, nslab, snap, sel)

    monkeypatch.setattr(port_udh, "spliced_slab_retrace", recorded)
    before = K.plain_calls["spliced_tb_strips"]
    ops = port_udh._retrace(pbp, pprm, r["snaps"], cr, se, budget * per)
    assert K.plain_calls["spliced_tb_strips"] - before == len(calls)
    return ops, calls


@pytest.mark.parametrize("name,budget", [
    *(pytest.param(n, None, id=n) for n in FIXTURES),
    *(pytest.param(n, b, id=f"{n}-{b}") for n in FIXTURES
      for b in BUDGETS)])
def test_udh_equals_reference(ctx, runs, monkeypatch, name, budget):
    r = runs[name]
    s_ref, e_ref, ops_ref = r["ref"]
    s, e, ops = r["port"]
    if budget is not None:
        ops, calls = retrace_at_budget(monkeypatch, r, ctx[2],
                                       BUDGETS[budget])
        if budget == "one_slab":
            assert all(n == 1 and len(m) == 1 for _, n, m in calls)
        elif budget == "two_slabs":      # a run split mid-way
            assert any(n == 2 for _, n, _ in calls)
            assert any(s0 > 0 for s0, _, _ in calls)
    np.testing.assert_array_equal(s, np.asarray(s_ref))
    assert [tuple(x) for x in e] == [tuple(int(v) for v in x)
                                     for x in e_ref]
    assert ops == ops_ref
    assert _crossings_dicts(r["cr"], r["se"]) == r["ref_cr"]
    assert all(len(c) >= 3 for c in r["ref_cr"])     # multi-slab paths
    if name == "rightcol":
        assert int(e[0][1]) == r["pbp"].Ns[0]        # ends on column N
    else:
        assert all(any(o[0] == "I" for o in x) for x in ops)


@pytest.mark.parametrize("name", ["case0", "rightcol"])
def test_udh_equals_plane_path(ctx, runs, name):
    """The port's two paths agree: run_bucket's full-plane walk gives the
    same scores, ends and op streams."""
    cfg, prm, pprm, tables = ctx
    r = runs[name]
    scores, ends, ops = K.run_bucket(r["pbp"], pprm)
    np.testing.assert_array_equal(scores, r["port"][0])
    assert [tuple(x) for x in ends] == [tuple(x) for x in r["port"][1]]
    assert ops == r["port"][2]


def test_retrace_from_snapshot_equals_full_planes(ctx, runs):
    """K1's retrace of every slab, from K4's snapshot, gives exactly the
    full K1 run's planes of that slab (the stale band-edge columns of
    the entry boundary included), and so does the retrace of the whole
    run from slab 0 in one launch; K3's strip mode walks every strip of
    that launch in one launch, strip for strip as spaln_tpu's
    traceback_spliced_strip over the full planes."""
    cfg, prm, pprm, tables = ctx
    r = runs["mixed"]
    pbp, snaps = r["pbp"], r["snaps"]
    flags, spj, _, _ = K.spliced_slab_trace(pbp, pprm)
    sel = torch.tensor([2, 0, 1], dtype=torch.int32)
    idx = sel.long()
    traces = [SliceTrace(flags=[f for f in flags[:, :, b].numpy()],
                         spj=[np.moveaxis(x, 0, -1)
                              for x in spj[:, :, :, b].numpy()],
                         L=L, lw=pbp.lws[b], W=pbp.W)
              for b in range(pbp.B)]
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
    # every strip of every problem, from its crossing above
    starts, expect = [], []
    for j, b in enumerate(sel.tolist()):
        sf = (int(r["se"][b, 1]) - 1) // L
        for s in range(sf + 1):
            if s == sf:
                m, n, st = int(r["se"][b, 1]), int(r["se"][b, 2]), 0
            else:
                m, (n, st) = (s + 1) * L, r["cr"][b, s + 1]
            starts.append([m, int(n), int(st), s * L, j])
            expect.append(traceback_spliced_strip(
                traces[b], m, int(n), int(st), m_stop=s * L)[0])
    before = K.plain_calls["spliced_tb_strips"]
    recs = K.spliced_tb_strips(fl, sp, torch.tensor(starts, dtype=torch.int32),
                               pbp.lws_t.index_select(0, idx), 0,
                               port_dp.strip_walk_bound(L, pbp.W))
    assert K.plain_calls["spliced_tb_strips"] == before + 1
    assert port_dp.ops_from_records(recs.numpy(), len(starts)) == expect
    assert len(starts) >= pbp.S and sum(map(len, expect)) > 0


def test_links_pass_holds_no_planes(ctx, runs):
    """The links pass keeps O(S * T) int32 per problem: four link
    streams and a (T + 2)-wide entry snapshot of two boundary rows per
    slab (single affine), and runs no trace-mode slab."""
    cfg, prm, pprm, tables = ctx
    r = runs["rightcol"]
    pbp = r["pbp"]
    S, B, T = pbp.S, pbp.B, pbp.T
    assert tuple(r["links"].shape) == (S, port_dp.n_links(pprm), B, T)
    assert port_dp.n_links(pprm) == 4
    assert tuple(r["snaps"].shape) == (S, 2, B, T + 2)
    before = dict(K.plain_calls)
    port_udh.links_pass(pbp, pprm)
    assert K.plain_calls["spliced_slab_links"] == \
        before["spliced_slab_links"] + 1
    assert K.plain_calls["spliced_slab_trace"] == \
        before["spliced_slab_trace"]
    per_problem = (r["links"].numel() + r["snaps"].numel()) * 4 // B
    planes = S * T * L * port_dp.plane_bytes_per_cell(pprm)
    assert per_problem * 3 < planes


def test_execute_jobs_udh_equals_planes_and_reference(table_dir):
    """With the plane budget at 1 byte every multi-slab bucket takes the
    UDH path, in one batch: the gene structures equal the plane path's
    and spaln_tpu's execute_jobs'."""
    from spaln_tpu.align.driver import (AlignerContext as RefContext,
                                        execute_jobs as ref_execute,
                                        prepare_job as ref_prepare)
    from spaln_tpu_torch.align.driver import (AlignerContext,
                                              execute_jobs, prepare_job)
    from spaln_tpu_torch.score.tables import TableDir as PTableDir
    from spaln_tpu_torch.utils.metrics import metrics
    rctx = RefContext.create(table_dir)
    rng = np.random.default_rng(21)
    genes = [_gene(rng, (60, 80), (150,), mut=0.02) for _ in range(3)]
    ref = ref_execute([ref_prepare(encode_dna(q), encode_dna(g), rctx,
                                   None) for q, g in genes], rctx, lanes=32)

    def port_run(**kw):
        pctx = AlignerContext.create(PTableDir(table_dir.root), "cpu", **kw)
        jobs = [prepare_job(encode_dna(q), encode_dna(g), pctx, None)
                for q, g in genes]
        metrics.reset()
        res = execute_jobs(jobs, pctx, lanes=32)
        return res, dict(metrics.counters)

    planes, c_planes = port_run()
    udh, c_udh = port_run(plane_budget=1)
    assert c_planes.get("device_buckets") and not c_planes.get("udh_buckets")
    assert c_udh.get("udh_buckets") == 1 and not c_udh.get("device_buckets")
    for a, b, c in zip(ref, planes, udh):
        for gs in (a, b, c):
            assert gs is not None and not isinstance(gs, BaseException)
        for gs in (b, c):
            assert gs.score == a.score
            assert [(e.g_start, e.g_end, e.q_start, e.q_end)
                    for e in gs.exons] == \
                [(e.g_start, e.g_end, e.q_start, e.q_end) for e in a.exons]


@pytest.mark.parametrize("kw,n_slabs,big,want", [
    ({}, 1, True, False), ({}, 4, False, False), ({}, 4, True, True),
    (dict(force_udh=True), 4, False, True),
    (dict(force_udh=True), 1, True, False)])
def test_udh_choice_and_overrides(table_dir, kw, n_slabs, big, want):
    """The reference's size rule (spaln_tpu/align/driver.py:554-565), and
    force_udh in place of SPALN_UDH=1: a one-slab problem always takes
    the planes."""
    from spaln_tpu_torch.align.driver import AlignerContext
    from spaln_tpu_torch.score.tables import TableDir as PTableDir
    pctx = AlignerContext.create(PTableDir(table_dir.root), "cpu", **kw)
    assert pctx.use_udh(n_slabs, big) is want
