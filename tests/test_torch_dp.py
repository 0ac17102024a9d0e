"""The port's device DP (plain PyTorch versions of K1, K2e and K3, as the
wrappers run them on the CPU) against spaln_tpu's CPU path: the lax.scan
engine, collect_batch_results and traceback_device_batch.  All integer,
so the tolerance is 0: planes, scores, ends and op streams are equal.

Fixtures are those of tests/test_dp_scan.py (planted genes, mutated
queries) and tests/test_dp_pallas.py:32-45 (batches of planted introns,
shared and per-problem bands).
"""
import numpy as np
import pytest
import torch

from spaln_tpu.config import Config, resolve, CvsG
from spaln_tpu.ops.dp_spliced_scan import (prepare_spliced_batch,
                                           run_spliced_batch,
                                           collect_batch_results,
                                           traceback_device_batch)
from spaln_tpu.ops.params import DpParams
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch.ops import dp_spliced as port_dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops.convert import (batch_from_reference,
                                         params_from_reference)
from spaln_tpu_torch.ops.dp_spliced_ref import (forward_spliced_ref,
                                                traceback_spliced_ref)
from spaln_tpu_torch.score.splice import \
    build_splice_signals as port_signals
from spaln_tpu_torch.score.tables import TableDir as PortTableDir


@pytest.fixture(scope="module")
def ctx(table_dir):
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    return cfg, prm, table_dir


def _spliced_problems(cfg, tables, B, M, ilen, seed=0):
    """tests/test_dp_pallas.py:32-45."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    queries, genomes, sigs = [], [], []
    for i in range(B):
        e1 = "".join(rng.choice(bases, M // 2))
        e2 = "".join(rng.choice(bases, M - M // 2))
        gi = "GTAAGT" + "".join(rng.choice(bases, ilen - 13)) + "TTTCTAG"
        g = e1 + gi + e2 + "".join(rng.choice(bases, 7 + (i % 5)))
        queries.append(encode_dna(e1 + e2))
        gc = encode_dna(g)
        genomes.append(gc)
        sigs.append(build_splice_signals(gc, cfg, tables))
    return queries, genomes, sigs


def _mutate(rng, seq, sub, indel):
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


def _gene(rng, exon_lens, intron_lens, mut):
    """tests/test_dp_scan.py _gene: 20 nt flanks, GTAAGT..TTTTTAG."""
    bases = np.array(list("ACGT"))
    exons = ["".join(rng.choice(bases, n)) for n in exon_lens]
    g = "".join(rng.choice(bases, 20))
    for i, e in enumerate(exons):
        g += e
        if i < len(intron_lens):
            g += ("GTAAGT" + "".join(rng.choice(bases, intron_lens[i] - 13))
                  + "TTTTTAG")
    g += "".join(rng.choice(bases, 20))
    q = "".join(exons)
    if mut:
        q = _mutate(rng, q, mut, mut / 3)
    return q, g


GENES = [((60, 80), (150,), 0.0), ((40, 50, 45), (90, 120), 0.0),
         ((60, 80), (200,), 0.05), ((30, 120, 50), (80, 300), 0.03)]


def _batches(cfg, tables):
    """(name, queries, genomes, sigs, band kwargs, L) for every fixture."""
    out = []
    for B, M, ilen, W in ((8, 40, 60, 192), (3, 40, 60, 192)):
        q, g, s = _spliced_problems(cfg, tables, B, M, ilen)
        lw = -(W // 2)
        out.append((f"pallas_B{B}", q, g, s, dict(lw=lw, up=lw + W - 1), 16))
    q, g, s = _spliced_problems(cfg, tables, 4, 32, 48, seed=3)
    out.append(("pallas_lws", q, g, s,
                dict(lws=[-20, -36, -28, -44], W=128), 16))
    for k, (ex, intr, mut) in enumerate(GENES):
        rng = np.random.default_rng(100 + k)
        qs, gs_ = _gene(rng, ex, intr, mut)
        qc, gc = encode_dna(qs), encode_dna(gs_)
        out.append((f"scan_gene{k}", [qc], [gc],
                    [build_splice_signals(gc, cfg, tables)], {}, 32))
    return out


CASES = ["pallas_B8", "pallas_B3", "pallas_lws", "scan_gene0",
         "scan_gene1", "scan_gene2", "scan_gene3"]


@pytest.fixture(scope="module")
def runs(ctx):
    """Reference and port results per fixture, computed once."""
    cfg, prm, tables = ctx
    pprm = params_from_reference(prm)
    out = {}
    for name, q, g, s, band, L in _batches(cfg, tables):
        bp = prepare_spliced_batch(q, g, prm, sigs=s, L=L, **band)
        row, rc, traces = run_spliced_batch(bp, prm, score_only=False)
        scores, ends, _ = collect_batch_results(bp, row, rc, None, True,
                                                prm=prm)
        ref_ops = traceback_device_batch(bp, traces, ends)
        tb = batch_from_reference(bp)
        planes = K.spliced_slab_trace(tb, pprm)
        se = K.spliced_last_ends(tb, pprm, planes[2], planes[3])
        recs = K.spliced_tb_walk(tb, planes[0], planes[1], se)
        out[name] = dict(
            traces=[(np.asarray(f), np.asarray(p)) for f, p in traces],
            scores=scores, ends=ends, ops=ref_ops, planes=planes, se=se,
            recs=recs, tb=tb, bp=bp, inputs=(q, g, s, band, L))
    return out


@pytest.mark.parametrize("case", CASES)
def test_slab_trace_planes_equal_scan(runs, case):
    r = runs[case]
    flags, spj = r["planes"][0].numpy(), r["planes"][1].numpy()
    assert len(r["traces"]) == flags.shape[0]
    for s, (fl_ref, spj_ref) in enumerate(r["traces"]):
        np.testing.assert_array_equal(flags[s], fl_ref)
        np.testing.assert_array_equal(np.moveaxis(spj[s], 0, -1), spj_ref)
    assert (spj > 0).any()                  # introns were closed


@pytest.mark.parametrize("case", CASES)
def test_ends_and_walk_equal_reference(ctx, runs, case):
    """K2e + K3 give collect_batch_results + traceback_device_batch's
    scores, ends and op streams; so does the host walk over the port's
    SliceTraces."""
    cfg, prm, tables = ctx
    r = runs[case]
    se = r["se"].numpy()
    np.testing.assert_array_equal(se[:, 0], r["scores"])
    np.testing.assert_array_equal(se[:, 1:], r["ends"])
    ops = port_dp.ops_from_records(r["recs"].numpy(), r["tb"].B)
    assert ops == r["ops"]
    assert all(any(o[0] == 'I' for o in x) for x in ops)
    tb, planes = r["tb"], r["planes"]
    sc, en, btr = port_dp.collect_batch_results(
        tb, params_from_reference(prm), planes[2], planes[3], planes[:2])
    np.testing.assert_array_equal(sc, r["scores"])
    for b in range(tb.B):
        assert port_dp.traceback_spliced_scan(
            btr[b], int(en[b][0]), int(en[b][1])) == r["ops"][b]


@pytest.mark.parametrize("case", CASES)
def test_port_prep_and_run_bucket(ctx, runs, case):
    """The port's own operand prep (prepare_spliced_batch, unbucketed
    geometry) through run_bucket gives the reference's scores, ends and
    op streams."""
    cfg, prm, tables = ctx
    r = runs[case]
    q, g, s, band, L = r["inputs"]
    pprm = params_from_reference(prm)
    bp = port_dp.prepare_spliced_batch(q, g, pprm, sigs=s, L=L, **band)
    scores, ends, ops = K.run_bucket(bp, pprm)
    np.testing.assert_array_equal(scores, r["scores"])
    assert [list(e) for e in ends] == [list(e) for e in r["ends"]]
    assert ops == r["ops"]


@pytest.mark.parametrize("k", range(len(GENES)))
def test_port_matches_scalar_oracle(ctx, k):
    """The port's plain path end to end, on its own signals and params,
    against its carried-over scalar oracle (the numpy spec)."""
    cfg, prm, tables = ctx
    pprm = params_from_reference(prm)
    ptab = PortTableDir(tables.root)
    rng = np.random.default_rng(100 + k)
    qs, gs_ = _gene(rng, *GENES[k])
    qc, gc = encode_dna(qs), encode_dna(gs_)
    sig = port_signals(gc, cfg, ptab)
    s_ref, em, en, tb = forward_spliced_ref(qc, gc, pprm, sig=sig)
    bp = port_dp.prepare_spliced_batch([qc], [gc], pprm, sigs=[sig], L=32)
    scores, ends, ops = K.run_bucket(bp, pprm)
    assert int(scores[0]) == s_ref
    assert ends[0] == (em, en)
    assert ops[0] == traceback_spliced_ref(tb, em, en)


def test_records_zero_after_walk_ends(runs):
    """Walk records past each problem's last step are all zero (the
    contract the CUDA walker shares with its plain version)."""
    recs = runs["pallas_B8"]["recs"].numpy()
    for b in range(recs.shape[1]):
        live = np.flatnonzero(recs[:, b].any(axis=1))
        assert len(live) and (recs[live[-1] + 1:, b] == 0).all()


def test_wrappers_count_plain_calls_and_no_launch_on_cpu(ctx, runs):
    cfg, prm, tables = ctx
    tb = runs["pallas_B3"]["tb"]
    pprm = params_from_reference(prm)
    before = dict(K.plain_calls)
    launched = dict(K.launches)
    K.run_bucket(tb, pprm)
    for k in K.KERNELS:
        assert K.plain_calls[k] == before[k] + 1
    assert K.launches == launched


def test_kernel_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        K._launch("spliced_tb_walk", torch.device("cpu"))


def test_prepare_rejects_codes_the_kernels_cannot_index(ctx):
    """Residue codes index the substitution rows and donor dinucleotide
    codes the joint table inside the kernels: out-of-range values are
    refused on the host."""
    cfg, prm, tables = ctx
    pprm = params_from_reference(prm)
    q = encode_dna("ACGTACGTAC")
    g = encode_dna("ACGTACGTACGTAC").copy()
    g[3] = pprm.qprof_mtx.shape[1]
    with pytest.raises(ValueError, match="residue codes"):
        port_dp.prepare_spliced_batch([q], [g], pprm)
