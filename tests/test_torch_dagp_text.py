"""`map -y l3` and `align -y l3` (double-affine gaps, the K5 mode of the
slab kernels) end to end on the CPU: the port's CLI with --device cpu
(the kernels' plain PyTorch versions) against spaln_tpu's CLI (its scan
engine on the JAX CPU backend).  The -O0,4 text (GFF3 genes and the exon
table in one run) must be byte-identical.

The corpus plants multi-exon genes with one 30-60 nt deletion inside an
exon of the genome (a long horizontal gap, E2) and one insertion inside
an exon of a cDNA (a long vertical gap, F2).  The map runs the plane
path and, with -A 3, the UDH path (the reference's plane path is the
yardstick for both: they give the same text).
"""
import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu.seq.codec import comrev, decode_dna, encode_dna
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.utils.metrics import metrics


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


def _gene(rng, indel):
    """Three exons of 90-130 nt, GTAAGT..TTTCTAG introns of 80-300 nt;
    ``indel`` "del" puts 30-60 genome-only nt in the middle of exon 2,
    "ins" 30-60 cDNA-only nt there."""
    exons = [_mk(rng, int(rng.integers(90, 130))) for _ in range(3)]
    # A/C only: no GT..AG inside the indel, so it stays a gap and is not
    # taken as a short intron
    extra = "".join(rng.choice(np.array(list("AC")),
                               int(rng.integers(30, 61))))
    mid = len(exons[1]) // 2
    g_ex, q_ex = list(exons), list(exons)
    if indel == "del":
        g_ex[1] = exons[1][:mid] + extra + exons[1][mid:]
    elif indel == "ins":
        q_ex[1] = exons[1][:mid] + extra + exons[1][mid:]
    parts = []
    for i, e in enumerate(g_ex):
        parts.append(e)
        if i < 2:
            parts.append("GTAAGT" + _mk(rng, int(rng.integers(67, 287)))
                         + "TTTCTAG")
    return "".join(q_ex), "".join(parts)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(31)
    d = tmp_path_factory.mktemp("yl3")
    contig = _mk(rng, 12000)
    queries, pos = [], 1500
    for i, indel in enumerate(("del", "ins", "del")):
        q, g = _gene(rng, indel)
        if i == 1:                        # minus-strand gene, sense cDNA
            g = decode_dna(comrev(encode_dna(g)))
        contig = contig[:pos] + g + contig[pos + len(g):]
        queries.append(q)
        pos += len(g) + 2500
    (d / "genome.fa").write_text(">c1\n" + contig + "\n")
    (d / "cdna.fa").write_text("".join(f">q{i}\n{q}\n"
                                       for i, q in enumerate(queries)))
    return d


def _run(main, argv, out):
    assert main([*argv, "-y", "l3", "-O", "0,4", "-o", str(out)]) == 0
    return out.read_bytes()


def _long_gaps(text: bytes) -> int:
    """Exon-table rows (-O4) whose exon holds a gap of 30 or more bases:
    their query and genome spans differ by that much."""
    n = 0
    for line in text.decode().splitlines():
        f = line.split("\t")
        if len(f) == 14:
            q_len = int(f[4]) - int(f[3])
            g_len = int(f[6]) - int(f[5])
            n += abs(q_len - g_len) >= 29
    return n


def test_map_yl3_text_identical(corpus, monkeypatch):
    monkeypatch.setenv("SPALN_UDH", "0")          # reference plane path
    d = corpus
    assert ref_cli.main(["index", str(d / "genome.fa"), "-p",
                         str(d / "ref")]) == 0
    assert port_cli.main(["index", str(d / "genome.fa"), "-p",
                          str(d / "port")]) == 0
    ref = _run(ref_cli.main, ["map", str(d / "cdna.fa"), "-d",
                              str(d / "ref")], d / "ref.map")
    texts = {}
    for mode, extra in (("planes", []), ("udh", ["-A", "3"])):
        metrics.reset()
        texts[mode] = _run(port_cli.main,
                           ["map", str(d / "cdna.fa"), "-d", str(d / "port"),
                            "--device", "cpu", *extra], d / f"{mode}.map")
        c = metrics.counters
        assert c.get("udh_buckets" if mode == "udh" else "device_buckets")
        assert not c.get("skipped_queries")
    assert texts["planes"] == ref
    assert texts["udh"] == ref
    assert ref.count(b"\tgene\t") == 3
    assert _long_gaps(ref) >= 2


def test_align_yl3_text_identical(corpus):
    d = corpus
    argv = ["align", str(d / "genome.fa"), str(d / "cdna.fa")]
    ref = _run(ref_cli.main, argv, d / "ref.aln")
    metrics.reset()
    port = _run(port_cli.main, [*argv, "--device", "cpu"], d / "port.aln")
    assert port == ref
    assert not metrics.counters.get("skipped_queries")
    assert ref.count(b"\tgene\t") == 3
    assert _long_gaps(ref) >= 2
