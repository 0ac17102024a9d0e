"""K6's -yJ mode of the slab kernel (the conserved intron-position
bonus, added to every acceptor close of a query row that carries one),
and what runs on it, against spaln_tpu on the CPU: the plain versions of
K1 and K4 with the bonus, single and double affine and with the local
mode, against the scan engine (_make_step(cip=True)); the batch layer's
bonus operand; `map` on queries with junction records (;B/;b), which
get the bonus at spb = 20 without -yJ, and with -y J30; `align -y J30`,
which the reference runs without it; and the UDH path, whose retrace
the reference runs without the bonus.  All integer, so the tolerance
is 0.

Tables come from find_table_dir() (the vendored data_tables/).
"""
import dataclasses

import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu.ops import dp_spliced_scan as ref_scan
from spaln_tpu.ops.params import DpFlags
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.ops import dp_spliced as port_dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops.convert import (batch_from_reference,
                                         params_from_reference)

from test_torch_local import (_align, _paths, assert_udh_pin,  # noqa: F401
                              corpus, map_both, one_thread, prms)
from test_torch_udh import _gene

# the Queue 3 case's bonuses: rows near the two junctions of exons (60,
# 80, 50), off by a few rows
BONUS = {55: 600, 57: 600, 138: 600, 143: 600}


def _problems(cfg, tables, name):
    """(queries, genomes, sigs, band kwargs, L, cips) of a slab fixture."""
    if name == "multi":                   # multi-slab at L = 32
        qs, gs = [], []
        for s in (0, 1):
            q, g = _gene(np.random.default_rng(s), (60, 80, 50), (150, 120),
                         mut=0.08)
            qs.append(q)
            gs.append(g)
        band, L, cips = {}, 32, [BONUS, {61: 300, 140: 900}]
    else:                                 # per-problem bands, L = 16
        rng = np.random.default_rng(31)
        qs, gs = [], []
        for k in range(3):
            q, g = _gene(rng, (30 + 10 * k, 40), (70,), mut=0.06)
            qs.append(q)
            gs.append(g)
        band, L = dict(lws=[-24, -30, -20], W=160), 16
        cips = [{28: 700, 31: 400}, None, {49: 500, 52: 800, 90: 300}]
    qc = [encode_dna(q) for q in qs]
    gc = [encode_dna(g) for g in gs]
    return qc, gc, [build_splice_signals(g, cfg, tables) for g in gc], \
        band, L, cips


# (fixture, double affine, local): multi-slab at L = 32 single affine,
# at L = 16 (6 slabs) both gap models, and the bonus with the local mode
MODES = [("multi", False, False), ("lws", False, False), ("lws", True, False),
         ("multi", False, True)]


@pytest.fixture(scope="module")
def slab_runs(prms, table_dir):
    """Per (fixture, dagp, local) of MODES: the reference's trace and links
    runs with the bonus, and the port's K1 and K4 plain versions on the
    same batch."""
    cfg, p = prms
    out = {}
    for name, dagp, local in MODES:
        qc, gc, sigs, band, L, cips = _problems(cfg, table_dir, name)
        prm = p[dagp]
        bp = ref_scan.prepare_spliced_batch(
            qc, gc, prm, sigs=sigs, L=L, flags=DpFlags(local=local),
            cips=cips, **band)
        row, rc, traces = ref_scan.run_spliced_batch(bp, prm,
                                                     score_only=False)
        _, _, ltr = ref_scan.run_spliced_batch(bp, prm, score_only=True,
                                               emit_links=True)
        tb = batch_from_reference(bp)
        pprm = params_from_reference(prm)
        out[name, dagp, local] = dict(
            bp=bp, tb=tb, pprm=pprm, row=row, rc=rc, prm=prm,
            traces=[tuple(np.asarray(y) for y in ys) for ys in traces],
            links=[[np.asarray(y) for y in ys] for ys, _ in ltr],
            k1=K.spliced_slab_trace(tb, pprm, emit_local=local),
            k4=K.spliced_slab_links(tb, pprm),
            inputs=(qc, gc, sigs, band, L, cips))
    return out


IDS = [f"{n}-{'dagp' if d else 'single'}{'-local' if lo else ''}"
       for n, d, lo in MODES]


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_cip_trace_equals_reference(slab_runs, mode):
    """K1's plain version with the bonus: every flag and junction plane
    (and in local mode the emission) equals the scan engine's, and so do
    the ends K2e takes from its rows."""
    r = slab_runs[mode]
    k1 = r["k1"]
    for s, ys in enumerate(r["traces"]):
        np.testing.assert_array_equal(k1[0][s].numpy(), ys[0])
        np.testing.assert_array_equal(np.moveaxis(k1[1][s].numpy(), 0, -1),
                                      ys[1])
        if mode[2]:
            np.testing.assert_array_equal(k1[4][s].numpy(), ys[2])
            np.testing.assert_array_equal(k1[5][s].numpy(), ys[3])
    scores, ends, _ = ref_scan.collect_batch_results(
        r["bp"], r["row"], r["rc"], None, True, prm=r["prm"])
    se = K.spliced_last_ends(r["tb"], r["pprm"], k1[2], k1[3]).numpy()
    np.testing.assert_array_equal(se[:, 0], scores)
    np.testing.assert_array_equal(se[:, 1:], ends)


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_cip_links_equal_reference(slab_runs, mode):
    """K4's plain version with the bonus: every link stream of every slab
    equals the scan engine's links mode, and its rows equal K1's."""
    r = slab_runs[mode]
    links, _, row, rc = r["k4"]
    for s, ys in enumerate(r["links"]):
        for k in range(links.shape[1]):
            np.testing.assert_array_equal(links[s, k].numpy(), ys[k])
    assert torch.equal(row, r["k1"][2]) and torch.equal(rc, r["k1"][3])


@pytest.mark.parametrize("name", ["multi", "lws"])
def test_bonus_changes_the_dp(slab_runs, name):
    """The bonus reaches the DP: without it the same batch gives other
    junction planes and other final rows."""
    r = slab_runs[name, False, False]
    plain = K.spliced_slab_trace(
        dataclasses.replace(r["tb"], cip=None), r["pprm"])
    assert not torch.equal(plain[1], r["k1"][1])
    assert not torch.equal(plain[2], r["k1"][2])


def test_cip_operand_as_reference(slab_runs):
    """prepare_spliced_batch's bonus operand is the reference's: (B, Mpad
    + L) int32, bonus of 1-based row m at m - 1, rows past Mpad dropped,
    None when no query carries one."""
    cfg_in = slab_runs["lws", False, False]["inputs"]
    qc, gc, sigs, band, L, cips = cfg_in
    pprm = slab_runs["lws", False, False]["pprm"]
    cips = [dict(c or {}) for c in cips]
    cips[1] = {1: 11, len(qc[1]): 22, 10_000: 33}
    bp = port_dp.prepare_spliced_batch(qc, gc, pprm, sigs=sigs, L=L,
                                       cips=cips, **band)
    want = np.zeros((3, bp.Mpad + L), np.int32)
    for i, c in enumerate(cips):
        for m, v in c.items():
            if 1 <= m <= bp.Mpad:
                want[i, m - 1] = v
    np.testing.assert_array_equal(bp.cip.numpy(), want)
    assert port_dp.prepare_spliced_batch(qc, gc, pprm, sigs=sigs, L=L,
                                         cips=[None, {}, None],
                                         **band).cip is None


def test_cip_refused_where_no_path_runs_it(slab_runs):
    """The score-only entry and the retrace refuse the bonus with a
    ValueError naming why."""
    r = slab_runs["lws", False, False]
    tb, pprm = r["tb"], r["pprm"]
    with pytest.raises(ValueError, match="score-only"):
        K.spliced_slab_score(tb, pprm)
    sel = torch.arange(tb.B, dtype=torch.int32)
    with pytest.raises(ValueError, match="retrace"):
        K.spliced_slab_retrace(tb, pprm, 0, 1, r["k4"][1][0], sel)


# ------------------------------------------- map on junction records
@pytest.mark.parametrize("extra", [[], ["-A", "3", "-y", "l3"],
                                   ["-y", "J30"]],
                         ids=["size_rule", "udh_yl3", "yJ30"])
def test_map_junction_records_text_identical(corpus, monkeypatch, extra):
    """`map` of cDNAs with junction records -O0,4: byte-identical to
    spaln_tpu's on planes (the size rule), on the UDH path with
    double-affine gaps (-A 3 -y l3) and with -y J30 (a larger bonus);
    every K1 or K4 call of the port carries the bonus."""
    tag = "J" + "".join(extra)
    ref, port, seen = map_both(corpus, monkeypatch, "cdna_j.fa", extra, tag)
    assert port == ref
    assert ref.count(b"\tgene\t") == 3
    assert seen and all(cip and not local for local, cip in seen)


def test_align_yj_is_plain_align(corpus):
    """`align -y J30` on cDNAs with junction records: spaln_tpu's align
    builds no bonuses (ROADMAP.md Queue 3), nor does the port's: its
    text equals the reference's and plain align's."""
    d = corpus
    ref = _align(ref_cli.main, d, "ref_alignJ.txt", ["-y", "J30"],
                 queries="cdna_j.fa")
    port = _align(port_cli.main, d, "port_alignJ.txt",
                  ["-y", "J30", "--device", "cpu"], queries="cdna_j.fa")
    plain = _align(port_cli.main, d, "port_align_plain.txt",
                   ["--device", "cpu"])
    assert port == ref == plain
    assert ref.count(b"\tgene\t") == 3


# ------------------------------------ ROADMAP.md Queue 3: UDH drops cip
def test_udh_retrace_drops_cip_as_the_reference(prms, table_dir):
    """ROADMAP.md Queue 3: the reference's UDH retrace re-runs its slabs
    without the bonus (spaln_tpu/ops/dp_spliced_udh.py:159-163), so its
    UDH walk can take another path than its plane walk.  The port
    reproduces it."""
    cfg, p = prms
    q, g = _gene(np.random.default_rng(0), (60, 80, 50), (150, 120),
                 mut=0.08)
    sigs = [build_splice_signals(encode_dna(g), cfg, table_dir)]
    assert_udh_pin(*_paths(p[False], params_from_reference(p[False]), q, g,
                           sigs, DpFlags(), cips=[BONUS]))
