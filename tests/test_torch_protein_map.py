"""The port's protein path end to end on the CPU, against spaln_tpu: both
CLIs build the 6-frame protein index (`index -K P`, with the nucleotide
index for the mixed file: -K DP), map planted protein genes on both
strands (`map -O0,4`, then `-y l3`, then a file mixing protein and cDNA
queries) and align a protein onto a short genomic segment (`align
-O0,4`); every text must be byte-identical.

The port runs with --device cpu, so its DP runs the plain PyTorch
versions of K7 and K8; spaln_tpu runs its tron scan on the JAX CPU
backend (and walks on the host, as it does there).
"""
import numpy as np
import pytest

from spaln_tpu import cli as ref_cli
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch import constants as C
from spaln_tpu_torch.seq.codec import encode_protein

AMINO = "ARNDCQEGHILKMFPSTWYV"
_CODON = {}
for _i in range(64):
    _CODON.setdefault(int(C.GENCODE[_i]), "ACGT"[(_i >> 4) & 3]
                      + "ACGT"[(_i >> 2) & 3] + "ACGT"[_i & 3])


def _mk(rng, n):
    return "".join(rng.choice(list("ACGT"), n, p=[0.3, 0.2, 0.2, 0.3]))


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _protein_gene(rng, n_aa, n_introns):
    """A protein of n_aa residues (one substitution in 15 in its query
    copy) back-translated with introns of 90-250 nt at random phases."""
    p = "M" + "".join(rng.choice(list(AMINO), n_aa - 1))
    nt = "".join(_CODON[int(c)] for c in encode_protein(p)) + "TAA"
    cuts = sorted(int(c) for c in rng.choice(
        np.arange(40, len(nt) - 40), n_introns, replace=False))
    parts, prev = [], 0
    for c in cuts:
        parts += [nt[prev:c],
                  "GTAAGT" + _mk(rng, int(rng.integers(90, 250))) + "TTTCAG"]
        prev = c
    parts.append(nt[prev:])
    q = list(p)
    for j in rng.choice(np.arange(1, n_aa), n_aa // 15, replace=False):
        q[j] = str(rng.choice(list(AMINO)))
    return "".join(q), "".join(parts)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(7001)
    d = tmp_path_factory.mktemp("protein")
    contig, prots = _mk(rng, 1500), []
    for k, (n_aa, n_in) in enumerate(((85, 2), (110, 1), (95, 2))):
        q, g = _protein_gene(rng, n_aa, n_in)
        if k == 1:
            g = _revcomp(g)                 # a minus-strand gene
        contig += g + _mk(rng, 2500)
        prots.append(q)
    # one cDNA gene for the mixed query file
    ex = [_mk(rng, int(rng.integers(120, 200))) for _ in range(3)]
    contig += (ex[0] + "GTAAGT" + _mk(rng, 150)
               + "TTTCTAG" + ex[1] + "GTAAGT" + _mk(rng, 200) + "TTTCTAG"
               + ex[2] + _mk(rng, 1500))
    (d / "genome.fa").write_text(">c1\n" + contig + "\n")
    (d / "prot.fa").write_text("".join(f">p{i}\n{p}\n"
                                       for i, p in enumerate(prots)))
    # the cDNA first, then the proteins in one batch of prot.fa's shape
    (d / "mixed.fa").write_text(f">n0\n{''.join(ex)}\n" + "".join(
        f">p{i}\n{p}\n" for i, p in enumerate(prots)))
    # a short segment around the first gene for align
    (d / "seg.fa").write_text(">seg\n" + contig[1000:2000 + 3 * 85 + 600]
                              + "\n")
    (d / "one.fa").write_text(f">p0\n{prots[0]}\n")
    for main, name in ((ref_cli.main, "ref"), (port_cli.main, "port")):
        assert main(["index", str(d / "genome.fa"), "-p", str(d / name),
                     "-K", "DP"]) == 0
    return d


def _both(corpus, argv_ref, argv_port, out):
    texts = []
    for main, argv, tag in ((ref_cli.main, argv_ref, "ref"),
                            (port_cli.main, argv_port, "port")):
        path = corpus / f"{tag}.{out}"
        assert main([a.format(d=corpus) for a in argv]
                    + ["-o", str(path)]) == 0
        texts.append(path.read_bytes())
    return texts


@pytest.mark.parametrize("queries,extra,genes", [
    ("prot.fa", [], 3), ("prot.fa", ["-y", "l3"], 3),
    ("mixed.fa", [], 4)])
def test_protein_map_text_identical(corpus, monkeypatch, queries, extra,
                                    genes):
    monkeypatch.setenv("SPALN_UDH", "0")          # reference plane path
    base = ["map", "{d}/" + queries, "-O", "0,4", *extra]
    ref, port = _both(corpus, base + ["-d", "{d}/ref"],
                      base + ["-d", "{d}/port", "--device", "cpu"],
                      f"{queries}{len(extra)}.O04")
    assert port == ref
    assert ref.count(b"\tgene\t") == genes
    if queries == "prot.fa":
        assert b"\t-\t" in ref                     # the minus-strand gene


def test_protein_align_text_identical(corpus):
    base = ["align", "{d}/seg.fa", "{d}/one.fa", "-O", "0,4"]
    ref, port = _both(corpus, base, base + ["--device", "cpu"], "align.O04")
    assert port == ref
    assert ref.count(b"\tgene\t") == 1


def test_protein_map_device_cuda_without_gpu_is_an_error(corpus,
                                                         monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_cli.main(["map", str(corpus / "prot.fa"), "-d",
                       str(corpus / "port")])
