"""The port's data parallelism against spaln_tpu on the CPU: parallel/
sharding.py's helpers, the genome-sharded equivalence of
tests/test_sharded_index.py, map_queries split over devices (three CPU
shards, plane and UDH buckets) against the unsharded port and spaln_tpu's
unsharded map, entry()'s forward against spaln_tpu's score-only run of
the same problem, and dryrun_multichip over gloo."""
import numpy as np
import pytest
import torch

from spaln_tpu.align.driver import AlignerContext as RCtx
from spaln_tpu.align.mapper import GenomeMapper as RMapper
from spaln_tpu.constants import DNA
from spaln_tpu.out.formats import gff3_lines as ref_gff3
from spaln_tpu.parallel import sharding as RS
from spaln_tpu.seed.blockindex import BlockIndex as RIndex
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu.seq.fasta import SeqRecord
from spaln_tpu.seq.genome import GenomeStore as RStore
from spaln_tpu_torch.align.driver import AlignerContext
from spaln_tpu_torch.align.mapper import GenomeMapper
from spaln_tpu_torch.out.formats import gff3_lines
from spaln_tpu_torch.parallel import (local_devices, map_queries_sharded,
                                      merge_shards, sharding as PS)
from spaln_tpu_torch.score.tables import TableDir, find_table_dir
from spaln_tpu_torch.seed.blockindex import BlockIndex
from spaln_tpu_torch.seq.genome import GenomeStore
from spaln_tpu_torch.utils.metrics import metrics

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is small tensors a step: one intra-op
    thread runs it faster than many, and keeps the file's time under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LANES, MAX_BATCH = 128, 8


def _mk(rng, n):
    return "".join(rng.choice(np.array(list("ACGT")), n))


def _gene(rng):
    e1, e2 = _mk(rng, 120), _mk(rng, 130)
    ilen = int(rng.integers(100, 300))
    intron = "GTAAGT" + _mk(rng, ilen - 13) + "TTTCTAG"
    return e1 + e2, e1 + intron + e2


@pytest.fixture(scope="module")
def corpus():
    """tests/test_sharded_index.py's corpus: 4 contigs of 2 planted
    two-exon genes each (numpy seed 42), the 8 cDNAs; the port's and
    spaln_tpu's stores, indexes and contexts (DP on the CPU), and both
    packages' unsharded maps."""
    rng = np.random.default_rng(42)
    contigs, queries = [], []
    for ci in range(4):
        parts = [_mk(rng, 2000)]
        for _ in range(2):
            q, g = _gene(rng)
            queries.append(encode_dna(q))
            parts.append(g)
            parts.append(_mk(rng, 1500))
        contigs.append(SeqRecord(name=f"c{ci}", molc=DNA,
                                 codes=encode_dna("".join(parts))))
    store = GenomeStore.from_records(contigs)
    rstore = RStore.from_records(contigs)
    ctx = AlignerContext.create(TableDir(find_table_dir()), "cpu")
    mapper = GenomeMapper(store, BlockIndex.build(store), ctx)
    rmapper = RMapper(rstore, RIndex.build(rstore),
                      RCtx.create(TableDir(find_table_dir())))
    names = [f"q{i}" for i in range(len(queries))]
    full = mapper.map_queries(queries, q_names=names, lanes=LANES,
                              max_batch=MAX_BATCH)
    ref = rmapper.map_queries(queries, q_names=names, lanes=LANES,
                              max_batch=MAX_BATCH)
    return dict(store=store, ctx=ctx, mapper=mapper, queries=queries,
                names=names, full=full, ref=ref)


def _struct(res):
    return [[(g.q_name, g.g_name, g.strand, g.score,
              [(e.q_start, e.q_end, e.g_start, e.g_end) for e in g.exons],
              [(i.g_start, i.g_end, i.q_pos) for i in g.introns])
             for g in per_q] for per_q in res]


def _text(res, queries, fmt):
    out, gid = [], 1
    for per_q, q in zip(res, queries):
        for g in per_q:
            out += fmt(g, q_len=len(q), gene_id=gid)
            gid += 1
    return "\n".join(out)


def test_full_map_equals_reference(corpus):
    full, ref = corpus["full"], corpus["ref"]
    assert sum(bool(r) for r in full) == len(full) == 8
    assert _struct(full) == _struct(ref)
    assert _text(full, corpus["queries"], gff3_lines) == \
        _text(ref, corpus["queries"], ref_gff3)


@pytest.mark.parametrize("udh", [False, True])
def test_map_over_three_devices_equals_unsharded(corpus, udh):
    """devices=["cpu"] * 3: every batch in three contiguous shards (in
    turn on the CPU, at once on cards); plane buckets (the size rule) and UDH ones (-A 3) give the
    unsharded port's gene structures and text, hence spaln_tpu's."""
    mapper = corpus["mapper"]
    if udh:
        mapper = GenomeMapper(corpus["store"], mapper.index,
                              AlignerContext.create(
                                  TableDir(find_table_dir()), "cpu",
                                  force_udh=True))
    metrics.reset()
    got = mapper.map_queries(corpus["queries"], q_names=corpus["names"],
                             lanes=LANES, max_batch=MAX_BATCH,
                             devices=["cpu"] * 3)
    c = dict(metrics.counters)
    assert c.get("sharded_batches", 0) >= 1
    assert c.get("udh_buckets" if udh else "device_buckets", 0) >= 1
    assert not c.get("device_buckets" if udh else "udh_buckets", 0)
    assert _struct(got) == _struct(corpus["full"]) == _struct(corpus["ref"])
    assert _text(got, corpus["queries"], gff3_lines) == \
        _text(corpus["ref"], corpus["queries"], ref_gff3)


def test_shards_split_contiguously():
    from spaln_tpu_torch.align.driver import _shards
    part = list(range(10, 17))
    got = _shards(part, ["a", "b", "c"])
    assert [s for s, _ in got] == [[10, 11], [12, 13], [14, 15, 16]]
    assert [d for _, d in got] == ["a", "b", "c"]
    assert _shards([5], ["a", "b"]) == [([5], "b")]


def test_sharding_helpers_equal(corpus):
    store = corpus["store"]
    for n in (1, 2, 3):
        for h in range(n):
            ids = PS.contig_shard(store, n, h)
            assert ids == RS.contig_shard(store, n, h)
            assert PS.split_queries(11, n, h) == RS.split_queries(11, n, h)
            sh = PS.build_shard(store, ids)
            assert sh.names == [store.names[i] for i in ids]
            np.testing.assert_array_equal(
                sh.codes, RS.build_shard(store, ids).codes)
    per_host = [corpus["full"], corpus["ref"]]
    got = PS.merge_query_results(per_host, max_out=2)
    assert _struct(got) == _struct(RS.merge_query_results(per_host, 2))
    loci = merge_shards([corpus["full"], corpus["full"]])
    assert len(loci) == 8
    assert all(len(lo.members) == 2 for lo in loci)


def test_genome_sharded_equivalence(corpus):
    """tests/test_sharded_index.py on the port: per-host contig-slice
    indexes + merge_query_results reproduce the single-index map."""
    store, ctx, full = corpus["store"], corpus["ctx"], corpus["full"]
    per_host = []
    for h in range(2):
        st = PS.build_shard(store, PS.contig_shard(store, 2, h))
        per_host.append(GenomeMapper(st, BlockIndex.build(st), ctx)
                        .map_queries(corpus["queries"],
                                     q_names=corpus["names"], lanes=LANES,
                                     max_batch=MAX_BATCH))
    merged = PS.merge_query_results(per_host, max_out=1)
    assert _struct(merged) == _struct(full)


def test_no_gpu_is_an_error(corpus, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        map_queries_sharded(corpus["mapper"], corpus["queries"][:1])
    from spaln_tpu_torch import entry as E
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
    with pytest.raises(RuntimeError, match="a card a rank"):
        E.dryrun_multichip(2)


def test_entry_rows_equal_reference():
    """entry()'s K5 forward (the plain version on the CPU) on
    __graft_entry__._tiny_problem's batch: each problem's best final-row
    score and its K2e ends equal spaln_tpu's score-only run of the same
    batch (run_spliced_batch, collect_batch_results).
    __graft_entry__.entry()'s fwd runs the first slab alone, so its rows
    are not the final ones."""
    import jax.numpy as jnp
    from __graft_entry__ import _tiny_problem
    from spaln_tpu.ops.dp_spliced_scan import (collect_batch_results,
                                               prepare_spliced_batch,
                                               run_spliced_batch)
    from spaln_tpu_torch import entry as E
    from spaln_tpu_torch.ops import dp_spliced_cuda as K
    from spaln_tpu_torch.ops.dp_spliced import collect_batch_results as pc
    fn, args = E.entry("cpu")
    row = fn(*args)
    assert tuple(row.shape) == (4, 97)
    prm, queries, genomes = _tiny_problem(4, 24, 96)
    bp = prepare_spliced_batch(queries, genomes, prm, L=8)
    row_h, rc_h, _ = run_spliced_batch(bp, prm, score_only=True)
    np.testing.assert_array_equal(row.max(dim=1).values.numpy(),
                                  np.asarray(jnp.max(row_h, axis=1)))
    scores, ends, _ = collect_batch_results(bp, row_h, rc_h, None, True,
                                            prm=prm)
    pprm, _, _ = E._tiny_problem(4, 24, 96)
    _, rc = K.spliced_slab_score(args[0], pprm)
    ps, pe, _ = pc(args[0], pprm, row, rc)
    np.testing.assert_array_equal(ps, scores)
    np.testing.assert_array_equal(pe, ends)


def test_dryrun_multichip_gloo():
    from spaln_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2, device="cpu")


def test_counts_hold_under_threads():
    """The counters the shard threads bump (metrics, the kernels' launch
    counts) lose no update: 16 threads x 2,000 bumps each, with the
    interpreter switching threads as often as it can."""
    import sys
    import threading
    from spaln_tpu_torch.ops import dp_spliced_cuda as K
    from spaln_tpu_torch.utils.metrics import Metrics
    m = Metrics()
    name = "spliced_slab_score"
    before = K.launches[name]

    def work():
        for _ in range(2000):
            m.bump("x")
            m.add_time("t", 1.0)
            K.count_launch(name)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        got = K.launches[name] - before
        K.launches[name] = before
    assert m.counters["x"] == m.calls["t"] == got == 32000
    assert m.timings["t"] == 32000.0
