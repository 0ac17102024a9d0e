"""The port's `seq` subcommand and tools/seqextras against spaln_tpu: every
op of both CLIs on the same seeded inputs prints byte-identical text, and
seqextras' functions return what spaln_tpu's return."""
import numpy as np
import pytest

from spaln_tpu import cli as ref_cli
from spaln_tpu.tools import seqextras as R
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.tools import seqextras as P

GBK = """LOCUS       TESTA       60 bp    DNA   linear   UNA 01-JAN-2000
DEFINITION  test entry.
FEATURES             Location/Qualifiers
     source          1..60
     CDS             join(4..9,16..21)
                     /product="demo protein"
     CDS             complement(25..33)
                     /product="minus one"
ORIGIN
        1 atgAAATTTc cccccGGGCC Ctttatgcat gcatgcatcc ccccccccgg ggggggtttt
//
LOCUS       TESTB       36 bp    DNA   linear   UNA 01-JAN-2000
FEATURES             Location/Qualifiers
     CDS             1..12
ORIGIN
        1 atggcctgca aagaattcgg gcccgtaagt tggtga
//
"""


def _mk(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(np.array(list(alphabet)), n))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A nucleotide file (ORFs, a poly-A tail, a poly-T head, restriction
    sites), a protein file and a GenBank file, from numpy seed 5."""
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("seq")
    orf = "ATG" + "".join(rng.choice(["GCC", "AAA", "CTG", "GGT", "TCA"],
                                     120)) + "TAA"
    nt = [("n1", _mk(rng, 300) + orf + _mk(rng, 200) + "A" * 40),
          ("n2", "T" * 35 + _mk(rng, 500) + "GAATTC" + _mk(rng, 300)),
          ("n3", _mk(rng, 80) + "CCCGGG" + _mk(rng, 900) + "GGATCC"
           + _mk(rng, 120))]
    (d / "nt.fa").write_text("".join(f">{n}\n{s}\n" for n, s in nt))
    aa = [("p1", _mk(rng, 150, "ARNDCQEGHILKMFPSTWYV")),
          ("p2", _mk(rng, 90, "ARNDCQEGHILKMFPSTWYV"))]
    (d / "aa.fa").write_text("".join(f">{n}\n{s}\n" for n, s in aa))
    (d / "cds.gbk").write_text(GBK)
    (d / "renz").write_text("EcoR1     GAATTC         1\n"
                            "Sma1      CCCGGG         3\n"
                            "BamH1     GGATCC         1\n"
                            "Acc1      GTMKAC         2\n")
    return d


SEQ_CASES = {
    "orf": ["orf", "{d}/nt.fa"],
    "orf_min": ["orf", "{d}/nt.fa", "--min-orf", "90"],
    "polya": ["polya", "{d}/nt.fa"],
    "comp_nt": ["comp", "{d}/nt.fa"],
    "comp_aa": ["comp", "{d}/aa.fa"],
    "mutate_nt": ["mutate", "{d}/nt.fa", "--sub", "0.1", "--ins", "0.02",
                  "--del", "0.03", "--seed", "11"],
    "mutate_aa": ["mutate", "{d}/aa.fa", "--sub", "0.2", "--seed", "3"],
    "forge_nt": ["forge", "--count", "3", "--length", "250", "--seed", "7"],
    "forge_aa": ["forge", "--count", "2", "--length", "120", "--aa",
                 "--seed", "9"],
    "resite_table": ["resite", "{d}/nt.fa"],
    "resite_file": ["resite", "{d}/nt.fa", "--enzymes", "{d}/renz"],
    "resite_unique": ["resite", "{d}/nt.fa", "--enzymes", "{d}/renz",
                      "--unique"],
    "extcds": ["extcds", "{d}/cds.gbk"],
}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_seq_text_identical(inputs, case):
    argv = [a.format(d=inputs) for a in SEQ_CASES[case]]
    texts = []
    for tag, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        out = inputs / f"{case}.{tag}"
        assert main(["seq", *argv, "-o", str(out)]) == 0
        texts.append(out.read_bytes())
    assert texts[0] == texts[1]
    assert texts[0]


def test_seq_without_input_is_an_error(inputs):
    with pytest.raises(SystemExit, match="needs an input file"):
        port_cli.main(["seq", "orf"])


def test_montseq_mutate_pick_equal():
    for kw in (dict(seed=1), dict(composition=[0.7, 0.1, 0.1, 0.1], seed=2),
               dict(protein=True, seed=3)):
        assert P.montseq(3, 400, **kw) == R.montseq(3, 400, **kw)
    s = R.montseq(1, 2000, seed=4)[0]
    for kw in (dict(sub=0.1, seed=5), dict(ins=0.05, del_=0.05, seed=6),
               dict(sub=0.2, protein=True, seed=7)):
        assert P.mutate_seq(s, **kw) == R.mutate_seq(s, **kw)
    names = [f"s{i}" for i in range(12)]
    for kw in (dict(every=3), dict(count=5, seed=8),
               dict(indices=[2, 99, 5]), {}):
        assert P.pick_members(names, **kw) == R.pick_members(names, **kw)
    assert P.revcomp("ACGTNRYacgt") == R.revcomp("ACGTNRYacgt")


def test_resite_renzyme_extcds_equal(inputs, table_dir):
    import os
    path = os.path.join(table_dir.root, "renzyme")
    enz_p, enz_r = P.read_renzyme(path), R.read_renzyme(path)
    assert [vars(e) for e in enz_p] == [vars(e) for e in enz_r]
    assert len(enz_p) > 10
    seq = (inputs / "nt.fa").read_text().split("\n")[3]
    for uniq in (False, True):
        assert ([vars(s) for s in P.resite(seq, enz_p, unique_only=uniq)]
                == [vars(s) for s in R.resite(seq, enz_r, unique_only=uniq)])
    got = P.extcds(str(inputs / "cds.gbk"))
    want = R.extcds(str(inputs / "cds.gbk"))
    assert [vars(r) for r in got] == [vars(r) for r in want]
    # spaln_tpu's extcds drops the open CDS of an entry that another
    # entry follows (TESTA's complement one; ROADMAP.md Queue 3), and the
    # port keeps its output
    assert [r.entry for r in got] == ["TESTA", "TESTB"]
