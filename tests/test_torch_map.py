"""The port's index + map, end to end on the CPU, against spaln_tpu: both
CLIs index and map one small genome with multi-exon genes planted on
both strands, and the -O0 (GFF3) and -O4 (exon table) text must be
byte-identical.  Index files built by either package load in the other.

The port runs with --device cpu, so its DP runs the plain PyTorch
versions of the kernels; spaln_tpu runs its scan engine on the JAX CPU
backend.
"""
import numpy as np
import pytest

from spaln_tpu import cli as ref_cli
from spaln_tpu.seq.codec import comrev, decode_dna, encode_dna
from spaln_tpu_torch import cli as port_cli


def _mk(rng, n):
    return "".join(rng.choice(np.array(list("ACGT")), n))


def _gene(rng, n_exons):
    """Planted gene (recipe of tests/test_batched_mapping.py): exons of
    90-160 nt, GTAAGT..TTTCTAG introns of 80-400 nt."""
    exons = [_mk(rng, int(rng.integers(90, 160))) for _ in range(n_exons)]
    parts = []
    for i, e in enumerate(exons):
        parts.append(e)
        if i < n_exons - 1:
            ilen = int(rng.integers(80, 400))
            parts.append("GTAAGT" + _mk(rng, ilen - 13) + "TTTCTAG")
    return "".join(exons), "".join(parts)


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("planted")
    contig = _mk(rng, 36000)
    queries = []
    pos = 3000
    for i in range(4):
        q, g = _gene(rng, 2 + (i % 2))
        if i % 3 == 2:                    # minus-strand gene, sense cDNA
            g = decode_dna(comrev(encode_dna(g)))
        contig = contig[:pos] + g + contig[pos + len(g):]
        queries.append(q)
        pos += len(g) + 2500
    (d / "genome.fa").write_text(">c1\n" + contig + "\n")
    (d / "cdna.fa").write_text("".join(f">q{i}\n{q}\n"
                                       for i, q in enumerate(queries)))
    (d / "prot.fa").write_text(">p0\nMKWVTFISLLLLFSSAYSRGVFRRDTHKSEIAHRFKDLGE"
                               "ENFKALVLIAFAQYLQQCPFEDHVKLVNEVTEFAKT\n")
    return d


def _index(main, d, name):
    assert main(["index", str(d / "genome.fa"), "-p", str(d / name)]) == 0


def _map(main, d, db, fmt, out, extra=()):
    assert main(["map", str(d / "cdna.fa"), "-d", str(d / db), "-O", fmt,
                 "-o", str(d / out), *extra]) == 0
    return (d / out).read_bytes()


def test_map_text_identical(planted, monkeypatch):
    monkeypatch.setenv("SPALN_UDH", "0")          # reference plane path
    d = planted
    _index(ref_cli.main, d, "ref")
    _index(port_cli.main, d, "port")
    for fmt in ("0", "4"):
        ref = _map(ref_cli.main, d, "ref", fmt, f"ref.O{fmt}")
        port = _map(port_cli.main, d, "port", fmt, f"port.O{fmt}",
                    ("--device", "cpu"))
        assert port == ref
        assert ref.count(b"\n") > 4
    # the index files keep their format: each package maps on the other's
    cross = _map(port_cli.main, d, "ref", "4", "cross_port.O4",
                 ("--device", "cpu"))
    assert cross == (d / "ref.O4").read_bytes()
    cross = _map(ref_cli.main, d, "port", "4", "cross_ref.O4")
    assert cross == (d / "ref.O4").read_bytes()


def test_map_device_cuda_without_gpu_is_an_error(planted, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_cli.main(["map", str(planted / "cdna.fa"), "-d",
                       str(planted / "port")])


def _subcommands(parser) -> set:
    import argparse
    return {name for a in parser._actions
            if isinstance(a, argparse._SubParsersAction)
            for name in a.choices}


def test_subcommands_equal_reference():
    """The port's CLI has spaln_tpu's eight subcommands, none raising
    NotImplementedError (sortgrcd, seq and ild: test_torch_sortgrcd.py,
    test_torch_seq.py, test_torch_ild.py)."""
    port = _subcommands(port_cli.build_parser())
    assert port == _subcommands(ref_cli.build_parser())
    assert len(port) == 8


def test_map_wide_lanes_text_identical(planted, monkeypatch):
    """--lanes 1024, past every slab-kernel instance's thread budget (the
    card runs two lanes a thread there): the port's text equals
    spaln_tpu's, which takes any lane count."""
    monkeypatch.setenv("SPALN_UDH", "0")          # reference plane path
    d = planted
    for main, db in ((ref_cli.main, "ref"), (port_cli.main, "port")):
        if not (d / f"{db}.bkn.npz").exists():
            _index(main, d, db)
    wide = ("--lanes", "1024")
    ref = _map(ref_cli.main, d, "ref", "0,4", "ref_wide.O04", wide)
    port = _map(port_cli.main, d, "port", "0,4", "port_wide.O04",
                ("--device", "cpu", *wide))
    assert port == ref
    assert ref.count(b"\tgene\t") == 4
