"""The port's protein-DB search (the spaln -a mode) against spaln_tpu's, on
the CPU: search_protein_db's score pass runs the plain version of the
score-only slab kernel (K5) and its top hits the plane path (K1, K2e,
K3), where spaln_tpu runs its scan engine.  Integer DP: hit names,
scores, spans and identities are equal, and so is the CLI text of
`search` and `pair --mode every`.

DB cases are those of tests/test_protein_search.py, with the parameter
tables of find_table_dir() (the vendored data_tables/).
"""
import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu.align.protein_search import search_protein_db as ref_search
from spaln_tpu.seed.dbindex import ProteinDbIndex as RefIndex
from spaln_tpu.seq.codec import encode_protein
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.align import protein_search as port_ps
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.seed.dbindex import ProteinDbIndex as PortIndex
from spaln_tpu_torch.utils.errors import DeviceDPError

AAS = list("ARNDCQEGHILKMFPSTWYV")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of steps of tiny tensor ops,
    where intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mut(rng, s, rate):
    return "".join(rng.choice(AAS) if rng.random() < rate else c for c in s)


def _rand(rng, n):
    return "".join(rng.choice(AAS, n))


def _db_case(name, table_dir):
    """(query, db, search kwargs) of tests/test_protein_search.py's
    cases."""
    rng = np.random.default_rng(42)
    if name == "homolog":
        target = _rand(rng, 120)
        db = [(f"decoy{i}", encode_protein(_rand(rng, int(rng.integers(
            80, 160))))) for i in range(20)]
        db.insert(7, ("homolog", encode_protein(_mut(rng, target, 0.15))))
        kw = dict(max_hits=5, align_top=1, table_dir=table_dir.root)
    elif name == "blosum":
        target = _rand(rng, 80)
        db = [("self", encode_protein(target)),
              ("junk", encode_protein(_rand(rng, 80)))]
        kw = dict(max_hits=2, matrix=table_dir.path("blosum62"))
    else:                                       # homologs of 3 divergences
        target = _rand(rng, 100)
        db = [(f"decoy{i}", encode_protein(_rand(rng, int(rng.integers(
            60, 140))))) for i in range(60)]
        for j, rate in enumerate((0.05, 0.2, 0.35)):
            db.insert(11 * (j + 1),
                      (f"hom{j}", encode_protein(_mut(rng, target, rate))))
        kw = dict(max_hits=4, align_top=2, table_dir=table_dir.root)
    return encode_protein(target), db, kw


def _key(hits):
    return [(h.name, h.score, tuple(h.q_span), tuple(h.s_span), h.identity,
             h.structure is not None) for h in hits]


@pytest.mark.parametrize("prefilter", [False, True])
@pytest.mark.parametrize("name", ["homolog", "blosum", "prefilter"])
def test_search_equals_reference(table_dir, name, prefilter):
    q, db, kw = _db_case(name, table_dir)
    ref = ref_search(q, db, lanes=32, prefilter=prefilter, **kw)
    before = dict(K.plain_calls)
    port = port_ps.search_protein_db(q, db, lanes=32, prefilter=prefilter,
                                     device="cpu", **kw)
    assert _key(port) == _key(ref)
    assert port[0].name in ("homolog", "self", "hom0")
    assert port[0].structure is not None and port[0].identity > 0.7
    for k in K.SCORE_PATH:
        assert K.plain_calls[k] > before[k]
    assert K.plain_calls["spliced_slab_trace"] == \
        before["spliced_slab_trace"] + kw.get("align_top", 1)
    for a, b in zip(port, ref):
        if a.structure is not None:
            assert (a.structure.exons[0].__dict__
                    == b.structure.exons[0].__dict__)


def test_db_index_candidates_equal():
    """tests/test_protein_search.py's pruning case: the carried-over index
    gives the reference's tables and candidates."""
    rng = np.random.default_rng(42)
    target = _rand(rng, 120)
    db = [(f"d{i}", encode_protein(_rand(rng, 120))) for i in range(200)]
    db.append(("hom", encode_protein(_mut(rng, target, 0.1))))
    ref, port = RefIndex.build(db), PortIndex.build(db)
    for f in ("offsets", "entries", "wscr"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    q = encode_protein(target)
    for kw in (dict(max_cand=50, min_hits=5), dict(max_cand=200,
                                                   min_hits=10)):
        cand = port.candidates(q, **kw)
        np.testing.assert_array_equal(cand, ref.candidates(q, **kw))
    assert cand[0] == 200 and len(cand) < 100


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """A 300-entry DB (so search builds the k-mer index and prefilters)
    with two planted homologs, two queries; and 4 equal-length entries
    for pair (one geometry for spaln_tpu's compiled engine)."""
    d = tmp_path_factory.mktemp("search")
    rng = np.random.default_rng(9)
    targets = [_rand(rng, 90), _rand(rng, 70)]
    db = [(f"e{i:03d}", _rand(rng, int(rng.integers(40, 80))))
          for i in range(300)]
    db[17] = ("hom_a", _mut(rng, targets[0], 0.1))
    db[230] = ("hom_b", _mut(rng, targets[1], 0.2))
    (d / "db.fa").write_text("".join(f">{n}\n{s}\n" for n, s in db))
    (d / "q.fa").write_text(f">qa\n{targets[0]}\n>qb\n{targets[1]}\n")
    base = _rand(rng, 60)
    (d / "pairs.fa").write_text("".join(
        f">p{i}\n{_mut(rng, base, 0.1 * i)}\n" for i in range(4)))
    return d


def _cli(main, argv, out):
    assert main([*argv, "-o", str(out)]) == 0
    return out.read_bytes()


def test_search_cli_text_identical(fasta):
    argv = ["search", str(fasta / "q.fa"), "-a", str(fasta / "db.fa"),
            "--max-hits", "5", "--align-top", "1", "--lanes", "32",
            "-O", "0,1,2,3"]
    ref = _cli(ref_cli.main, argv, fasta / "ref.search")
    port = _cli(port_cli.main, [*argv, "--device", "cpu"],
                fasta / "port.search")
    assert port == ref
    lines = ref.decode().splitlines()
    assert lines[0].startswith("qa\thom_a\t")
    assert any(x.startswith("qb\thom_b\t") for x in lines)


def test_pair_cli_text_identical(fasta):
    argv = ["pair", str(fasta / "pairs.fa"), "--mode", "every", "--lanes",
            "32", "-O", "0,1,3"]
    ref = _cli(ref_cli.main, argv, fasta / "ref.pair")
    port = _cli(port_cli.main, [*argv, "--device", "cpu"],
                fasta / "port.pair")
    assert port == ref
    assert ref.decode().count("\n") > 6


def test_search_dp_failure_raises(fasta, monkeypatch, table_dir):
    """A failed DP stops search (DeviceDPError passes per-query
    isolation), and the local search too."""
    def boom(*a, **k):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(port_ps, "forward_spliced_batch", boom)
    with pytest.raises(DeviceDPError, match="launch failed"):
        port_cli.main(["search", str(fasta / "q.fa"), "-a",
                       str(fasta / "db.fa"), "--device", "cpu"])
    monkeypatch.setattr(port_ps, "spliced_slab_trace", boom)
    with pytest.raises(DeviceDPError, match="launch failed"):
        port_ps.search_protein_local(np.zeros(20, np.int8),
                                     [("e", np.zeros(30, np.int8))],
                                     table_dir=table_dir.root,
                                     device="cpu")
