"""K6's local (Smith-Waterman-Gotoh) mode of the slab kernel, and what
runs on it, against spaln_tpu on the CPU: the plain versions of K1
(with the step emission) and K4 in local mode, single and double
affine, against the scan engine (_make_step(local=True)); the host
colony functions; the local protein-DB search; the `map -L S` text;
`align -L S`, which the reference runs semi-global; and the UDH path,
whose retrace the reference runs without the local mode.  All integer,
so the tolerance is 0.

Tables come from find_table_dir() (the vendored data_tables/).
"""
import dataclasses

import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu.align.protein_search import \
    search_protein_local as ref_local_search
from spaln_tpu.config import Config, resolve, CvsG, PvsP
from spaln_tpu.ops import dp_spliced_scan as ref_scan
from spaln_tpu.ops import dp_spliced_udh as ref_udh
from spaln_tpu.ops.params import DpParams, DpFlags
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna, encode_protein
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.align import protein_search as port_ps
from spaln_tpu_torch.ops import dp_spliced as port_dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops import dp_spliced_udh as port_udh
from spaln_tpu_torch.ops.convert import (batch_from_reference,
                                         params_from_reference)
from spaln_tpu_torch.utils.metrics import metrics

from test_torch_udh import _gene

AAS = list("ARNDCQEGHILKMFPSTWYV")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of steps of tiny tensor ops,
    where intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prms():
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    cfg3 = dataclasses.replace(cfg, aln=dataclasses.replace(cfg.aln, ls=3))
    prm3 = DpParams.build(cfg3, Simmtx.dna(), CvsG,
                          ipen=IntronPenalty(cfg3, CvsG))    # -y l3
    assert prm3.dagp
    return cfg, {False: prm, True: prm3}


def junk_gene(seed: int, mut: float = 0.05):
    """The case of the UDH inconsistency (ROADMAP.md Queue 3): exons (60,
    80, 50), introns (150, 120), the query mutated and flanked by 50
    random nt on both ends, which the local restart cuts off."""
    rng = np.random.default_rng(seed)
    q, g = _gene(rng, (60, 80, 50), (150, 120), mut=mut)
    bases = np.array(list("ACGT"))
    q = ("".join(rng.choice(bases, 50)) + q
         + "".join(rng.choice(bases, 50)))
    return q, g


def _problems(cfg, tables, name):
    """(queries, genomes, sigs, band kwargs, L) of a slab fixture."""
    if name == "junk":                    # multi-slab at L = 32
        qs, gs = zip(*(junk_gene(s) for s in (0, 1)))
        band, L = {}, 32
    else:                                 # per-problem bands, L = 16
        rng = np.random.default_rng(21)
        qs, gs = [], []
        for k in range(3):
            q, g = _gene(rng, (30 + 10 * k, 40), (70,), mut=0.04)
            qs.append("".join(rng.choice(list("ACGT"), 12)) + q)
            gs.append(g)
        band, L = dict(lws=[-24, -30, -20], W=160), 16
    qc = [encode_dna(q) for q in qs]
    gc = [encode_dna(g) for g in gs]
    return qc, gc, [build_splice_signals(g, cfg, tables) for g in gc], \
        band, L


@pytest.fixture(scope="module")
def slab_runs(prms, table_dir):
    """Reference trace and links runs in local mode per (fixture, dagp),
    and the port's K1 (with the emission) and K4 plain versions on the
    same batch."""
    cfg, p = prms
    out = {}
    for name in ("junk", "lws"):
        qc, gc, sigs, band, L = _problems(cfg, table_dir, name)
        for dagp in (False, True):
            prm = p[dagp]
            bp = ref_scan.prepare_spliced_batch(
                qc, gc, prm, sigs=sigs, L=L, flags=DpFlags(local=True),
                **band)
            row, rc, traces = ref_scan.run_spliced_batch(bp, prm,
                                                         score_only=False)
            _, _, ltr = ref_scan.run_spliced_batch(bp, prm, score_only=True,
                                                   emit_links=True)
            tb = batch_from_reference(bp)
            pprm = params_from_reference(prm)
            out[name, dagp] = dict(
                bp=bp, tb=tb, pprm=pprm, row=row, rc=rc,
                traces=[tuple(np.asarray(y) for y in ys) for ys in traces],
                links=[([np.asarray(y) for y in ys], snap)
                       for ys, snap in ltr],
                k1=K.spliced_slab_trace(tb, pprm, emit_local=True),
                k4=K.spliced_slab_links(tb, pprm))
    return out


SLAB_CASES = [pytest.param(n, d, id=f"{n}-{'dagp' if d else 'single'}")
              for n in ("junk", "lws") for d in (False, True)]


@pytest.mark.parametrize("name,dagp", SLAB_CASES)
def test_local_trace_equals_reference(prms, slab_runs, name, dagp):
    """K1's plain version in local mode: every flag plane (bit 7 where an
    active cell restarted at the zero floor), every junction plane and
    the step emission (best H over the lanes, first lane on ties) equal
    the scan engine's, and so do the ends K2e takes from its rows."""
    r = slab_runs[name, dagp]
    fl, spj, row, rc, lv, li = r["k1"]
    for s, (f_ref, sp_ref, v_ref, i_ref) in enumerate(r["traces"]):
        np.testing.assert_array_equal(fl[s].numpy(), f_ref)
        np.testing.assert_array_equal(np.moveaxis(spj[s].numpy(), 0, -1),
                                      sp_ref)
        np.testing.assert_array_equal(lv[s].numpy(), v_ref)
        np.testing.assert_array_equal(li[s].numpy(), i_ref)
    f = fl.numpy()
    assert ((f != 255) & (f >= 128)).any()          # restarts happened
    assert (li.numpy() > 0).any()                   # not lane 0 only
    scores, ends, _ = ref_scan.collect_batch_results(
        r["bp"], r["row"], r["rc"], None, True, prm=prms[1][dagp])
    se = K.spliced_last_ends(r["tb"], r["pprm"], row, rc).numpy()
    np.testing.assert_array_equal(se[:, 0], scores)
    np.testing.assert_array_equal(se[:, 1:], ends)


@pytest.mark.parametrize("name,dagp", SLAB_CASES)
def test_local_links_equal_reference(slab_runs, name, dagp):
    """K4's plain version in local mode: every link stream of every slab
    equals the scan engine's links mode, and its rows equal K1's."""
    r = slab_runs[name, dagp]
    links, snaps, row, rc = r["k4"]
    nlk = links.shape[1]
    for s, (ys, _) in enumerate(r["links"]):
        for k in range(nlk):
            np.testing.assert_array_equal(links[s, k].numpy(), ys[k])
    assert torch.equal(row, r["k1"][2]) and torch.equal(rc, r["k1"][3])


def test_local_modes_refused_where_no_path_runs_them(slab_runs):
    """The score-only entry and the retrace refuse the local mode with a
    ValueError naming why (no path of the reference runs them so), and
    the emission is the local mode's only."""
    r = slab_runs["lws", False]
    tb, pprm = r["tb"], r["pprm"]
    with pytest.raises(ValueError, match="score-only"):
        K.spliced_slab_score(tb, pprm)
    sel = torch.arange(tb.B, dtype=torch.int32)
    snap = r["k4"][1][0]
    with pytest.raises(ValueError, match="retrace"):
        K.spliced_slab_retrace(tb, pprm, 0, 1, snap, sel)
    plain = dataclasses.replace(tb, flags=DpFlags())
    with pytest.raises(ValueError, match="emit_local"):
        K.spliced_slab_trace(plain, pprm, emit_local=True)


@pytest.mark.parametrize("vthr", [0, 150, 400])
def test_collect_local_ends_and_pick_colonies(slab_runs, vthr):
    """collect_local_ends and pick_colonies give the reference's lists:
    the same ends in the same order (ties in slab and step order), and
    the same colonies from the same walks."""
    r = slab_runs["junk", False]
    bp, tb = r["bp"], r["tb"]
    lv, li = r["k1"][4].numpy(), r["k1"][5].numpy()
    ref = ref_scan.collect_local_ends(bp, r["traces"], vthr)
    port = port_dp.collect_local_ends(tb, list(zip(lv, li)), vthr)
    assert port == ref
    assert sum(map(len, ref)) > (50 if vthr < 400 else 0)
    for i, cands in enumerate(ref):
        tr_ref = ref_scan.SliceTrace(
            flags=[t[0][:, i] for t in r["traces"]],
            spj=[t[1][:, i] for t in r["traces"]], L=bp.L,
            lw=bp.lws[i], W=bp.W)
        fl, spj = r["k1"][0].numpy(), r["k1"][1].numpy()
        tr_port = port_dp.SliceTrace(
            flags=list(fl[:, :, i]),
            spj=[np.moveaxis(x, 0, -1) for x in spj[:, :, :, i]],
            L=tb.L, lw=tb.lws[i], W=tb.W)

        def fn(walk, tr):
            def trace(m, n):
                ops = walk(tr, m, n)
                return (ops[0][1], ops[0][2], ops) if ops else None
            return trace

        want = ref_scan.pick_colonies(
            cands, fn(ref_scan.traceback_spliced_scan, tr_ref), max_out=5)
        got = port_dp.pick_colonies(
            cands, fn(port_dp.traceback_spliced_scan, tr_port), max_out=5)
        assert got == want


# ------------------------------------------------ local protein search
def _two_islands():
    """tests/test_local.py::test_local_two_islands's case."""
    rng = np.random.default_rng(7)
    blk1 = "".join(rng.choice(AAS, 20))
    blk2 = "".join(rng.choice(AAS, 18))
    query = blk1 + "".join(rng.choice(AAS, 120)) + blk2
    subject = ("".join(rng.choice(AAS, 30)) + blk1
               + "".join(rng.choice(AAS, 200)) + blk2
               + "".join(rng.choice(AAS, 20)))
    return encode_protein(query), [("s", encode_protein(subject))], 4, 32


def _one_island():
    """tests/test_local.py::test_local_score_matches_swg_oracle's case."""
    rng = np.random.default_rng(8)
    q = "".join(rng.choice(AAS, 30))
    s = ("".join(rng.choice(AAS, 15)) + q[5:25]
         + "".join(rng.choice(AAS, 15)))
    return encode_protein(q), [("s", encode_protein(s))], 1, 16


def _many():
    """Both islands' query against a 70-entry DB (two batches of 64):
    decoys, the two-island subject and copies of its islands at other
    offsets, so hits of equal score come from several entries."""
    q, db, _, _ = _two_islands()
    rng = np.random.default_rng(11)
    subj = db[0][1]
    out = [(f"d{i}", encode_protein("".join(rng.choice(AAS, int(
        rng.integers(40, 260)))))) for i in range(70)]
    for k in (5, 40, 66):
        out[k] = (f"isl{k}", subj)
    out[20] = ("blk1", np.concatenate([out[20][1], subj[30:50]]))
    out[21] = ("blk1b", np.concatenate([subj[30:50], out[21][1]]))
    return q, out, 4, 32


def _hkey(hits):
    return [(h.name, h.score, tuple(h.q_span), tuple(h.s_span), h.identity,
             [e.__dict__ for e in h.structure.exons]) for h in hits]


@pytest.mark.parametrize("case", ["two_islands", "one_island", "many"])
def test_search_protein_local_equals_reference(table_dir, case):
    q, db, max_out, lanes = {"two_islands": _two_islands,
                             "one_island": _one_island,
                             "many": _many}[case]()
    ref = ref_local_search(q, db, table_dir=table_dir.root, max_out=max_out,
                           lanes=lanes)
    before = dict(K.plain_calls)
    port = port_ps.search_protein_local(q, db, table_dir=table_dir.root,
                                        max_out=max_out, lanes=lanes,
                                        device="cpu")
    assert _hkey(port) == _hkey(ref)
    assert (K.plain_calls["spliced_slab_trace"]
            - before["spliced_slab_trace"]) == -(-len(db) // 64)
    if case == "two_islands":      # tests/test_local.py's own checks
        spans = sorted(h.s_span for h in port[:2])
        assert abs(spans[0][0] - 30) <= 2 and abs(spans[0][1] - 50) <= 2
        assert abs(spans[1][0] - 250) <= 2 and abs(spans[1][1] - 268) <= 2
        assert all(h.identity > 0.95 for h in port[:2])
    elif case == "one_island":     # against a numpy Smith-Waterman-Gotoh
        assert port[0].score == _swg(q, db[0][1], table_dir)
    else:
        assert len({h.name for h in port}) >= 4


def _swg(qc, sc, table_dir) -> int:
    cfg = resolve(Config(), PvsP)
    sm = Simmtx.protein(table_dir.root, slot=0)
    prm = DpParams.build(cfg, sm, PvsP)
    gop, gep = prm.gop, prm.gep
    M, N = len(qc), len(sc)
    H = np.zeros((M + 1, N + 1), np.int64)
    E = np.full((M + 1, N + 1), -10**9, np.int64)
    F = np.full((M + 1, N + 1), -10**9, np.int64)
    for m in range(1, M + 1):
        for n in range(1, N + 1):
            E[m][n] = max(E[m][n - 1], H[m][n - 1] + gop) + gep
            F[m][n] = max(F[m - 1][n], H[m - 1][n] + gop) + gep
            d = H[m - 1][n - 1] + int(sm.mtx[qc[m - 1], sc[n - 1]])
            H[m][n] = max(0, d, E[m][n], F[m][n])
    return int(H.max())


def test_search_protein_local_split_by_plane_budget(table_dir):
    """A batch whose planes pass the budget runs as several launches, cut
    by problems in DB order; the hits do not change (a problem's band
    covers its whole matrix in any batch)."""
    q, db, max_out, lanes = _many()
    whole = port_ps.search_protein_local(q, db, table_dir=table_dir.root,
                                         max_out=max_out, lanes=lanes,
                                         device="cpu")
    before = K.plain_calls["spliced_slab_trace"]
    per = (-(-len(q) // lanes)) * (len(q) + 300 + 2 * lanes) * lanes * 13
    cut = port_ps.search_protein_local(q, db, table_dir=table_dir.root,
                                       max_out=max_out, lanes=lanes,
                                       device="cpu", plane_budget=9 * per)
    assert K.plain_calls["spliced_slab_trace"] - before >= 8
    assert _hkey(cut) == _hkey(whole)


# ------------------------------------------------------------ map -L S
def _seq(rng, n, gc=0.41):
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    return "".join(np.array(list("ACGT"))[rng.choice(4, n, p=p)])


# (exon lengths, intron lengths) of the corpus' genes: queries of 300-330
# nt span 3 slabs of 128 lanes, bands of about a thousand columns
GENES = [((100, 120, 90), (300, 420)), ((110, 100, 120), (380, 260)),
         ((90, 130, 100), (350, 330))]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 12 kb contig with three planted genes (the second on the minus
    strand), its cDNAs (3% substitutions, the third with a 40 nt stretch
    at 40% inside its middle exon, where the local mode may restart) as
    cdna.fa, and the same cDNAs with junction records (";B" and ";b
    pos num" at the planted exon-exon junctions and one off by two) as
    cdna_j.fa; both packages' indexes."""
    from spaln_tpu.seq.codec import comrev, decode_dna
    rng = np.random.default_rng(2027)
    d = tmp_path_factory.mktemp("local_corpus")
    contig = _seq(rng, 12000)
    recs, recs_j, pos = [], [], 1500
    for k, (exons, introns) in enumerate(GENES):
        ex = [_seq(rng, n, 0.5) for n in exons]
        g = ex[0] + "".join("GTAAGT" + _seq(rng, n - 12, 0.38) + "TTTCAG" + e
                            for n, e in zip(introns, ex[1:]))
        if k == 1:
            g = decode_dna(comrev(encode_dna(g)))
        contig = contig[:pos] + g + contig[pos + len(g):]
        q = np.array(list("".join(ex)))
        rate = np.full(len(q), 0.03)
        if k == 2:
            a = exons[0] + 40
            rate[a:a + 40] = 0.4
        hit = np.flatnonzero(rng.random(len(q)) < rate)
        q[hit] = [("ACGT".replace(c, ""))[rng.integers(3)] for c in q[hit]]
        q = "".join(q)
        recs.append(f">t{k}\n{q}\n")
        junc = np.cumsum(exons[:-1]).tolist()
        if k == 0:
            junc[0] += 2                       # one record off the site
        recs_j.append(f">t{k}\n;B {len(junc)} {len(junc)}\n;b "
                      + " ".join(f"{p} {1 + (p % 3)}" for p in junc)
                      + f"\n{q}\n")
        pos += len(g) + 1800
    (d / "genome.fa").write_text(">chr1\n" + contig + "\n")
    (d / "cdna.fa").write_text("".join(recs))
    (d / "cdna_j.fa").write_text("".join(recs_j))
    for main, db in ((ref_cli.main, "ref"), (port_cli.main, "port")):
        assert main(["index", str(d / "genome.fa"), "-p", str(d / db)]) == 0
    return d


def spy_modes(monkeypatch) -> list:
    """Record (local, has cip) of every K1 and K4 call the port's map
    makes (plane path and UDH links pass)."""
    seen = []

    def wrap(fn):
        def spy(bp, prm, *a, **kw):
            seen.append((bool(bp.flags.local), bp.cip is not None))
            return fn(bp, prm, *a, **kw)
        return spy

    monkeypatch.setattr(K, "spliced_slab_trace", wrap(K.spliced_slab_trace))
    monkeypatch.setattr(port_udh, "spliced_slab_links",
                        wrap(port_udh.spliced_slab_links))
    return seen


def map_both(corpus, monkeypatch, queries, args, tag):
    """`map` of ``queries`` -O0,4 with ``args`` by both CLIs: (reference
    text, port text, the port's metrics, its K1/K4 modes).  SPALN_UDH=0
    pins the reference's size rule to planes, as the port's takes them
    at this size; -A 3 sends both to UDH."""
    monkeypatch.setenv("SPALN_UDH", "0")
    d = corpus
    argv = ["map", str(d / queries), "-T", "Tetrapod", "-O", "0,4", *args]
    assert ref_cli.main([*argv, "-d", str(d / "ref"), "-o",
                         str(d / f"ref{tag}.txt")]) == 0
    metrics.reset()
    seen = spy_modes(monkeypatch)
    assert port_cli.main([*argv, "-d", str(d / "port"), "-o",
                          str(d / f"port{tag}.txt"), "--device",
                          "cpu"]) == 0
    c = dict(metrics.counters)
    assert not c.get("skipped_queries")
    if "-A" in args:
        assert c.get("udh_buckets") and not c.get("device_buckets")
    else:
        assert c.get("device_buckets") and not c.get("udh_buckets")
    return ((d / f"ref{tag}.txt").read_bytes(),
            (d / f"port{tag}.txt").read_bytes(), seen)


@pytest.mark.parametrize("extra", [[], ["-A", "3", "-y", "l3"]],
                         ids=["size_rule", "udh_yl3"])
def test_map_local_text_identical(corpus, monkeypatch, extra):
    """`map -L S` -O0,4: byte-identical to spaln_tpu's, on planes (the
    size rule) and on the UDH path with double-affine gaps (-A 3 -y l3),
    every K1 or K4 call of the port in local mode."""
    ref, port, seen = map_both(corpus, monkeypatch, "cdna.fa",
                               ["-L", "S", *extra], "L" + "".join(extra))
    assert port == ref
    assert ref.count(b"\tgene\t") == 3
    assert seen and all(local and not cip for local, cip in seen)


def _align(main, d, out, extra=(), queries="cdna.fa"):
    assert main(["align", str(d / "genome.fa"), str(d / queries), "-T",
                 "Tetrapod", "-O", "0,4", "-o", str(d / out), *extra]) == 0
    return (d / out).read_bytes()


def test_align_local_is_plain_align(corpus):
    """`align -L S` on cDNA: spaln_tpu's align windows run semi-global
    whatever -L says (ROADMAP.md Queue 3), and so do the port's: its
    text equals the reference's and plain align's."""
    d = corpus
    ref = _align(ref_cli.main, d, "ref_alignL.txt", ["-L", "S"])
    port = _align(port_cli.main, d, "port_alignL.txt",
                  ["-L", "S", "--device", "cpu"])
    plain = _align(port_cli.main, d, "port_align.txt", ["--device", "cpu"])
    assert port == ref == plain
    assert ref.count(b"\tgene\t") == 3


# ----------------------------------- ROADMAP.md Queue 3: UDH drops local
def _paths(prm, pprm, q, g, sigs, flags, cips=None):
    """(plane path, UDH path) of one problem in both packages at L = 32:
    each (scores, ends, ops)."""
    qc, gc = [encode_dna(q)], [encode_dna(g)]
    bp = ref_scan.prepare_spliced_batch(qc, gc, prm, sigs=sigs, L=32,
                                        flags=flags, cips=cips)
    row, rc, traces = ref_scan.run_spliced_batch(bp, prm, score_only=False)
    scores, ends, _ = ref_scan.collect_batch_results(bp, row, rc, None,
                                                     True, prm=prm)
    ref_plane = (scores, ends, ref_scan.traceback_device_batch(bp, traces,
                                                               ends))
    ref_u = ref_udh.run_spliced_batch_udh(bp, prm, engine="scan")
    pbp = port_dp.prepare_spliced_batch(qc, gc, pprm, sigs=sigs, L=32,
                                        flags=flags, cips=cips)
    return ref_plane, ref_u, K.run_bucket(pbp, pprm), \
        port_udh.run_spliced_batch_udh(pbp, pprm)


def assert_udh_pin(ref_plane, ref_u, port_plane, port_u):
    """Both packages' UDH op streams differ from their plane op streams;
    the port's plane path equals the reference's, and its UDH path the
    reference's UDH path; the scores and ends agree across all four."""
    def same(a, b):
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert ([tuple(int(v) for v in x) for x in a[1]]
                == [tuple(int(v) for v in x) for x in b[1]])
        assert a[2] == b[2]
    same(port_plane, ref_plane)
    same(port_u, ref_u)
    np.testing.assert_array_equal(np.asarray(ref_u[0]),
                                  np.asarray(ref_plane[0]))
    assert ref_u[2] != ref_plane[2] and port_u[2] != port_plane[2]


def test_udh_retrace_drops_local_as_the_reference(prms, table_dir):
    """ROADMAP.md Queue 3: the reference's UDH retrace re-runs its slabs
    without the local mode (spaln_tpu/ops/dp_spliced_udh.py:159-163), so
    its UDH walk runs through the junk the local restart cut off on the
    plane path.  The port reproduces it."""
    cfg, p = prms
    q, g = junk_gene(0)
    sigs = [build_splice_signals(encode_dna(g), cfg, table_dir)]
    got = _paths(p[False], params_from_reference(p[False]), q, g, sigs,
                 DpFlags(local=True))
    assert_udh_pin(*got)
    assert got[0][2][0][0][:2] != got[1][2][0][0][:2]   # where they start
