"""The port's align subcommand against spaln_tpu's, end to end on the CPU:
both CLIs align cDNA queries onto given genomic segments, and the -O0
(GFF3) and -O4 (exon table) text must be byte-identical.  The port runs
with --device cpu, so its DP runs the plain PyTorch versions of the
kernels; spaln_tpu runs its scan engine on the JAX CPU backend.

Fixtures: a short two-exon gene; two genes with an intron over BIG_GAP
(the long-intron split, one joined by a single splice junction and one
through a micro exon); a window pushed through the port's UDH path by
lowering its 96 MB rule (UDH and planes give identical results, so the
reference's plane path is the yardstick); a diverged cDNA with no seed
chain on either strand, so the DP spans the whole segment (on planes,
and on UDH as in most whole-chunk windows of a long segment); a 100 kb
segment with a gene across a chunk seam through annotate_segment of
both packages.
"""
import io

import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu.align.driver import AlignerContext as RefContext
from spaln_tpu.align.segment import annotate_segment as ref_annotate
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.align import driver as port_driver
from spaln_tpu_torch.align.segment import annotate_segment as port_annotate
from spaln_tpu_torch.score.tables import TableDir as PTableDir
from spaln_tpu_torch.utils.errors import DeviceDPError
from spaln_tpu_torch.utils.metrics import metrics

LANES = "32"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of steps of tiny tensor ops,
    where intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng, n):
    return "".join(rng.choice(np.array(list("ACGT")), n))


def _intron(rng, n, donor="GTAAGT", acceptor="TTTCTAG"):
    return donor + _mk(rng, n - len(donor) - len(acceptor)) + acceptor


def _mutate(rng, s, rate):
    return "".join("ACGT"[("ACGT".index(c) + int(rng.integers(1, 4))) % 4]
                   if rng.random() < rate else c for c in s)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("align")
    rng = np.random.default_rng(3)
    # short two-exon gene
    e1, e2 = _mk(rng, 90), _mk(rng, 80)
    (d / "short.fa").write_text(">g1\n" + _mk(rng, 300) + e1
                                + _intron(rng, 220) + e2 + _mk(rng, 300)
                                + "\n")
    (d / "short_q.fa").write_text(">q1\n" + e1 + e2 + "\n")
    # two genes with an ~17-18 kb intron: a plain junction and a micro
    # exon between the two anchors
    a1, a2, a3 = _mk(rng, 80), _mk(rng, 70), _mk(rng, 90)
    gene_a = (a1 + _intron(rng, 18000) + a2
              + _intron(rng, 300, "GTGAGT", "TTTACAG") + a3)
    rng0 = np.random.default_rng(0)
    b1, bx, b3 = _mk(rng0, 150), _mk(rng0, 10), _mk(rng0, 160)
    gene_b = (b1 + "GTAAGT" + _mk(rng0, 17000) + "TTTCTAG" + bx + "GTAAGT"
              + _mk(rng0, int(rng0.integers(300, 2000))) + "TTTCAG" + b3)
    (d / "long.fa").write_text(">g2\n" + _mk(rng, 200) + gene_a
                               + _mk(rng, 5000) + gene_b + _mk(rng, 200)
                               + "\n")
    (d / "long_q.fa").write_text(f">qa\n{a1 + a2 + a3}\n>qb\n{b1 + bx + b3}\n")
    # three exons, a query of 5 slabs at 32 lanes
    c = [_mk(rng, n) for n in (50, 40, 50)]
    (d / "window.fa").write_text(">g3\n" + _mk(rng, 300) + c[0]
                                 + _intron(rng, 200) + c[1]
                                 + _intron(rng, 300) + c[2] + _mk(rng, 300)
                                 + "\n")
    (d / "window_q.fa").write_text(">q3\n" + "".join(c) + "\n")
    # a two-exon gene and its cDNA at 22% substitutions: no seed chain on
    # either strand, so align_cdna runs the DP over the whole segment
    rng1 = np.random.default_rng(1)
    n1, n2 = _mk(rng1, 60), _mk(rng1, 50)
    (d / "nochain.fa").write_text(">g4\n" + _mk(rng1, 200) + n1
                                  + _intron(rng1, 163) + n2
                                  + _mk(rng1, 200) + "\n")
    (d / "nochain_q.fa").write_text(">q4\n" + _mutate(rng1, n1 + n2, 0.22)
                                    + "\n")
    return d


def _align(main, d, name, fmt, tag, extra=()):
    out = d / f"{name}.{tag}.O{fmt}"
    assert main(["align", str(d / f"{name}.fa"), str(d / f"{name}_q.fa"),
                 "-O", fmt, "--lanes", LANES, "-o", str(out), *extra]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("name", ["short", "long", "window", "nochain",
                                  "nochain_udh"])
def test_align_text_identical(fixtures, name, monkeypatch):
    udh = name in ("window", "nochain_udh")
    if udh:
        monkeypatch.setattr(port_driver, "WINDOW_PLANE_BYTES", 0)
    stem = name.split("_")[0]
    for fmt in ("0", "4"):
        ref = _align(ref_cli.main, fixtures, stem, fmt, "ref")
        metrics.reset()
        port = _align(port_cli.main, fixtures, stem, fmt, "port",
                      ("--device", "cpu"))
        assert port == ref
        assert ref.count(b"\n") >= 2
    c = metrics.counters
    assert not c.get("skipped_queries")
    if name == "long":
        assert c["align_long"] == 2
        assert c["long_join_splice"] == 1 and c["long_join_micro_exon"] == 1
        assert ref.count(b"\n") == 6          # 3 + 3 exon rows
    elif udh:
        assert c["udh_windows"] == 1 and not c.get("plane_windows")
    else:
        assert c["plane_windows"] == 1 and not c.get("udh_windows")
    if stem == "nochain":
        assert c["unchained_windows"] == 1
        assert ref.count(b"\n") == 2          # two exon rows (-O4)
    else:
        assert not c.get("unchained_windows")


def test_dp_failure_in_align_raises(fixtures, monkeypatch):
    """A failed DP launch stops align (no quiet skip of the query), while
    a host-side failure after the DP still skips only that query."""
    def boom(*a, **k):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(port_driver, "run_bucket", boom)
    with pytest.raises(DeviceDPError, match="launch failed"):
        port_cli.main(["align", str(fixtures / "short.fa"),
                       str(fixtures / "short_q.fa"), "--device", "cpu"])
    monkeypatch.undo()
    monkeypatch.setattr(port_driver, "_finish_job", boom)
    metrics.reset()
    assert port_cli.main(["align", str(fixtures / "short.fa"),
                          str(fixtures / "short_q.fa"), "--device", "cpu",
                          "-o", str(fixtures / "skip.O0")]) == 0
    assert metrics.counters["skipped_queries"] == 1


def test_engine_options_reach_the_context():
    """-A 3 forces the UDH path, -V sets the plane budget (k/M/G)."""
    args = port_cli.build_parser().parse_args(
        ["align", "g.fa", "q.fa", "-A", "3", "-V", "2G"])
    opts = port_cli._dna_options(args)
    assert opts["force_udh"] and opts["plane_budget"] == 2 * 10**9
    args = port_cli.build_parser().parse_args(["map", "q.fa", "-d", "g"])
    opts = port_cli._dna_options(args)
    assert not opts["force_udh"]
    assert opts["plane_budget"] == port_driver.PLANE_BYTES_BUDGET


def test_annotate_segment_seam_identical(table_dir):
    """A 100 kb segment cut into 40 kb chunks overlapping by 8 kb, with a
    gene across the first seam and a mutated paralog in the last chunk:
    the first chunk's clipped copy is dropped, and both packages report
    the same structures, formatted alike.  (Every chunk holds a copy, so
    no query runs the whole-chunk DP that align_cdna runs where it finds
    no chain.)"""
    rng = np.random.default_rng(11)
    ex = [_mk(rng, n) for n in (70, 60, 80)]
    gene = ex[0] + _intron(rng, 300) + ex[1] + _intron(rng, 350) + ex[2]
    para = "".join("ACGT"[("ACGT".index(c) + 1) % 4]
                   if rng.random() < 0.02 else c for c in gene)
    seam, copy = 39_500, 85_000
    genome = encode_dna(_mk(rng, seam) + gene
                        + _mk(rng, copy - seam - len(gene)) + para
                        + _mk(rng, 100_000 - copy - len(para)))
    qs = [encode_dna("".join(ex))]
    kw = dict(q_names=["q0"], g_name="seg", lanes=128, chunk=40_000,
              overlap=8_000)
    ref = ref_annotate(genome, qs, ctx=RefContext.create(table_dir), **kw)
    metrics.reset()
    port = port_annotate(
        genome, qs,
        ctx=port_driver.AlignerContext.create(PTableDir(table_dir.root),
                                              "cpu"), **kw)
    assert metrics.counters["segment_chunks"] == 3
    assert metrics.counters["seam_dropped"] == 1
    texts = []
    for mod, res in ((ref_cli, ref), (port_cli, port)):
        buf = io.StringIO()
        sink = mod.OutputSink([0, 4], buf)
        for gs in res:
            sink.emit([gs], len(qs[0]))
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert [g.g_span[0] for g in port] == [seam, copy]


def test_align_device_cuda_without_gpu_is_an_error(fixtures, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_cli.main(["align", str(fixtures / "short.fa"),
                       str(fixtures / "short_q.fa")])


def test_chunks_that_never_advance_are_refused(table_dir):
    """With -G under the default 64 kb overlap the chunk walk would never
    advance (a loop without end in the reference); the port refuses."""
    ctx = port_driver.AlignerContext.create(PTableDir(table_dir.root), "cpu")
    with pytest.raises(ValueError, match="never advance"):
        port_annotate(encode_dna("ACGT" * 30_000), [encode_dna("ACGT" * 40)],
                      ctx=ctx, chunk=40_000)
