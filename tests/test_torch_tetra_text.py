"""`map -A 3` (every multi-slab bucket on the linear-space UDH path) and
`map -y l3 -A 3` on a cut tetrapod-shaped corpus, end to end on the
CPU: the port's CLI with --device cpu (the kernels' plain PyTorch
versions) against spaln_tpu's CLI on its plane path (SPALN_UDH=0; its
scan engine on the JAX CPU backend).  The -O0,4 text must be
byte-identical.

Three genes with kilobase introns (0.5-1.2 kb, GC ~38%) in a genome of
GC ~41%, as in chip_smoke.py's tetrapod corpus but cut to a 30 kb
contig: the bands are about two thousand columns wide, the queries span
2 and 3 slabs of 128 lanes, and the genes fall in two buckets, so the
text comes from the UDH retrace of whole slab runs in one launch per
bucket and the strips of each launch walked in one launch.
"""
import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu.seq.codec import comrev, decode_dna, encode_dna
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.utils.metrics import metrics


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of steps of tiny tensor ops,
    where intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(rng, n, gc):
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    return "".join(np.array(list("ACGT"))[rng.choice(4, n, p=p)])


# (exon lengths, intron lengths) of the three genes
GENES = [((120, 130, 110), (600, 1100)),
         ((120, 110), (1200,)),
         ((100, 110, 90), (500, 520))]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(2026)
    d = tmp_path_factory.mktemp("tetra")
    contig = _seq(rng, 30000, 0.41)
    queries, pos = [], 3000
    for k, (exons, introns) in enumerate(GENES):
        ex = [_seq(rng, n, 0.5) for n in exons]
        g = ex[0] + "".join("GTAAGT" + _seq(rng, n - 12, 0.38) + "TTTCAG" + e
                            for n, e in zip(introns, ex[1:]))
        if k == 1:                        # minus-strand gene, sense cDNA
            g = decode_dna(comrev(encode_dna(g)))
        contig = contig[:pos] + g + contig[pos + len(g):]
        q = np.array(list("".join(ex)))
        hit = np.flatnonzero(rng.random(len(q)) < 0.01)
        q[hit] = [("ACGT".replace(c, ""))[rng.integers(3)] for c in q[hit]]
        queries.append("".join(q))
        pos += len(g) + 6000
    (d / "genome.fa").write_text(">chr1\n" + contig + "\n")
    (d / "cdna.fa").write_text("".join(f">t{i}\n{q}\n"
                                       for i, q in enumerate(queries)))
    assert ref_cli.main(["index", str(d / "genome.fa"), "-p",
                         str(d / "ref")]) == 0
    assert port_cli.main(["index", str(d / "genome.fa"), "-p",
                          str(d / "port")]) == 0
    return d


@pytest.mark.parametrize("y", [[], ["-y", "l3"]], ids=["single", "yl3"])
def test_map_udh_text_identical(corpus, monkeypatch, y):
    monkeypatch.setenv("SPALN_UDH", "0")          # reference plane path
    d = corpus
    argv = ["map", str(d / "cdna.fa"), "-T", "Tetrapod", "-O", "0,4", *y]
    ref_out, port_out = d / f"ref{len(y)}.txt", d / f"port{len(y)}.txt"
    assert ref_cli.main([*argv, "-d", str(d / "ref"), "-o",
                         str(ref_out)]) == 0
    metrics.reset()
    before = dict(K.plain_calls)
    assert port_cli.main([*argv, "-d", str(d / "port"), "-o", str(port_out),
                          "--device", "cpu", "-A", "3"]) == 0
    c = dict(metrics.counters)
    n = {k: K.plain_calls[k] - before[k] for k in K.KERNELS}
    retrace = "spliced_slab_retrace_dagp" if y else "spliced_slab_retrace"
    assert c.get("udh_buckets", 0) == 2 and not c.get("device_buckets")
    assert not c.get("skipped_queries")
    # one retrace and one strip launch per bucket: whole slab runs
    assert n[retrace] == n["spliced_tb_strips"] == 2
    ref = ref_out.read_bytes()
    assert port_out.read_bytes() == ref
    assert ref.count(b"\tgene\t") == 3
