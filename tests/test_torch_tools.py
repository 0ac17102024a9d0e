"""The port's species-parameter tools against spaln_tpu on the same seeded
inputs: kmers, divergence, exinpot, npssm and makmdm write byte-identical
tables; make_ssp writes byte-identical files but AlnParam, whose -yI
values (fit_ild: torch.optim.Adam here, optax there) are held to the fit
tolerance of tests/test_torch_ild.py."""
import numpy as np
import pytest

from spaln_tpu.constants import NT_REDUCE4
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu.tools import divergence as RD, exinpot as RE, kmers as RK, \
    makmdm as RM, npssm as RN
from spaln_tpu_torch.tools import divergence as PD, exinpot as PE, \
    kmers as PK, makmdm as PM, npssm as PN

from test_torch_ild import assert_fit_close


def _mk(rng, n, p=None):
    return "".join(rng.choice(np.array(list("ACGT")), n, p=p))


def _seqs(seed, n, length, p=None):
    rng = np.random.default_rng(seed)
    return [encode_dna(_mk(rng, length, p)) for _ in range(n)]


def test_kmers_equal(tmp_path):
    seqs = _seqs(1, 3, 700)
    for k in (1, 2, 3, 5):
        np.testing.assert_array_equal(PK.count_kmers(seqs, k),
                                      RK.count_kmers(seqs, k))
    assert PK.kmer_string(27, 3) == RK.kmer_string(27, 3)
    RK.write_wdfq(str(tmp_path / "r.wdfq"), seqs, kmax=4)
    PK.write_wdfq(str(tmp_path / "p.wdfq"), seqs, kmax=4)
    assert (tmp_path / "p.wdfq").read_bytes() == \
        (tmp_path / "r.wdfq").read_bytes()
    for a, b in zip(PK.read_wdfq(str(tmp_path / "r.wdfq"), kmax=4),
                    RK.read_wdfq(str(tmp_path / "r.wdfq"), kmax=4)):
        np.testing.assert_array_equal(a, b)


def test_divergence_equal():
    rng = np.random.default_rng(2)
    for is_aa in (False, True):
        a = RD.random_seq(rng, 600, is_aa=is_aa)
        b = a.copy()
        hit = rng.random(600) < 0.2
        b[hit] = RD.random_seq(rng, int(hit.sum()), is_aa=is_aa)
        fns = (("poisson_aa", "kimura_aa") if is_aa
               else ("jukes_cantor", "kimura_2p"))
        assert PD.p_distance(a, b, is_aa) == RD.p_distance(a, b, is_aa)
        for fn in fns:
            assert getattr(PD, fn)(a, b) == getattr(RD, fn)(a, b)
    comp = {"A": 0.4, "C": 0.1, "G": 0.1, "T": 0.4}
    np.testing.assert_array_equal(
        PD.random_seq(np.random.default_rng(3), 500, comp),
        RD.random_seq(np.random.default_rng(3), 500, comp))


def test_exinpot_codepot_tables_identical(tmp_path):
    fg = _seqs(4, 20, 400, p=[.4, .1, .1, .4])
    bg = _seqs(5, 4, 4000)
    for morder in (2, 4):
        pot = PE.build_exinpot(fg, bg, morder=morder)
        np.testing.assert_array_equal(pot, RE.build_exinpot(fg, bg,
                                                            morder=morder))
        for tag, mod in (("p", PE), ("r", RE)):
            mod.write_exinpot(str(tmp_path / f"I{morder}.{tag}"), pot,
                              nsupport=20, avlen=400.)
        assert (tmp_path / f"I{morder}.p").read_bytes() == \
            (tmp_path / f"I{morder}.r").read_bytes()
    rng = np.random.default_rng(6)
    cds = [encode_dna("".join("GC" + rng.choice(list("ACGT"))
                              for _ in range(100))) for _ in range(10)]
    cpot = PE.build_codepot(cds, bg, morder=3)
    np.testing.assert_array_equal(cpot, RE.build_codepot(cds, bg, morder=3))
    PE.write_codepot(str(tmp_path / "C.p"), cpot)
    RE.write_codepot(str(tmp_path / "C.r"), cpot)
    assert (tmp_path / "C.p").read_bytes() == (tmp_path / "C.r").read_bytes()


def test_npssm_tables_identical(tmp_path):
    rng = np.random.default_rng(7)
    wins = [encode_dna(_mk(rng, 1) + "GTAAG" + _mk(rng, 2, [.5, .1, .2, .2])
                       + _mk(rng, 2)) for _ in range(300)]
    bg = _seqs(8, 1, 8000)
    tabs = [RK.count_kmers(bg, k) for k in (1, 2, 3)]
    for morder in (0, 1, 2):
        w = [x[:len(x) - 2 + morder] for x in wins]
        pp = PN.build_pssm(w, 1, *tabs, morder=morder)
        rp = RN.build_pssm(w, 1, *tabs, morder=morder)
        PN.write_pssm(str(tmp_path / f"S{morder}.p"), pp)
        RN.write_pssm(str(tmp_path / f"S{morder}.r"), rp)
        assert (tmp_path / f"S{morder}.p").read_bytes() == \
            (tmp_path / f"S{morder}.r").read_bytes()
        mtx = np.asarray(pp.mtx)
        ws = NT_REDUCE4[np.stack([np.asarray(x, np.int64) for x in w])]
        np.testing.assert_array_equal(PN.scan_windows(mtx, ws, morder),
                                      RN.scan_windows(mtx, ws, morder))


def test_makmdm_tables_identical(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    PM.write_mdm(str(tmp_path / "p"))
    RM.write_mdm(str(tmp_path / "r"))
    for name in ("mdm_mtx", "mdm_cmp"):
        got = (tmp_path / "p" / name).read_bytes()
        assert got == (tmp_path / "r" / name).read_bytes()
        assert len(got) > 1000 or name == "mdm_cmp"


def test_makmdm_main_writes_tables(tmp_path):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "spaln_tpu_torch.tools.makmdm",
                        str(tmp_path)], cwd=root, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    (tmp_path / "ref").mkdir()
    RM.write_mdm(str(tmp_path / "ref"))
    for name in ("mdm_mtx", "mdm_cmp"):
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


def test_make_ssp_files_identical(tmp_path):
    """make_ssp over a 60-intron genome (test_tools.py's recipe):
    Splice5, Splice3 and IntronPotTab byte-identical, AlnParam's -yI
    values within the fit tolerance, with the fit on the CPU."""
    from spaln_tpu.constants import DNA
    from spaln_tpu.seq.fasta import SeqRecord
    from spaln_tpu.seq.genome import GenomeStore as RStore
    from spaln_tpu.tools.fitild import IldFit
    from spaln_tpu.tools.fitild import sample_frechet_mixture
    from spaln_tpu.tools.make_ssp import make_ssp as ref_make_ssp
    from spaln_tpu_torch.seq.genome import GenomeStore as PStore
    from spaln_tpu_torch.tools.make_ssp import make_ssp as port_make_ssp

    rng = np.random.default_rng(42)
    parts, introns, pos = [], [], 0
    for _ in range(60):
        parts.append(_mk(rng, 150))
        pos += 150
        ilen = int(sample_frechet_mixture(rng, 1, [1.], [25.], [80.],
                                          [1.4])[0]) + 20
        parts.append("GTAAGT" + _mk(rng, ilen - 13) + "TTTCTAG")
        introns.append(("c1", "+", pos, pos + ilen))
        pos += ilen
    parts.append(_mk(rng, 150))
    codes = encode_dna("".join(parts))
    cds = [encode_dna(_mk(rng, 300)) for _ in range(5)]
    rs = RStore.from_records([SeqRecord("c1", codes, DNA)])
    ps = PStore.from_records([SeqRecord("c1", codes, DNA)])
    ref = ref_make_ssp(str(tmp_path / "r"), rs, introns, cds_seqs=cds,
                       fit_steps=400)
    got = port_make_ssp(str(tmp_path / "p"), ps, introns, cds_seqs=cds,
                        fit_steps=400, device="cpu")
    assert got["files"] == ref["files"]
    assert (got["n_donor"], got["n_accept"]) == (60, 60)
    for name in got["files"]:
        p = (tmp_path / "p" / name).read_bytes()
        r = (tmp_path / "r" / name).read_bytes()
        if name != "AlnParam":
            assert p == r, name
    assert_fit_close(got["ild"], IldFit(**vars(ref["ild"])))

    def yi(path):
        return [float(t) for t in
                path.read_text().strip()[4:-1].split()]
    vp, vr = yi(tmp_path / "p" / "AlnParam"), yi(tmp_path / "r" / "AlnParam")
    assert len(vp) == len(vr) == 8
    # a, k, m, t a component, printed to 4 and 2 decimals
    for i in range(0, 8, 4):
        a_p, k_p, m_p, t_p = vp[i:i + 4]
        a_r, k_r, m_r, t_r = vr[i:i + 4]
        assert abs(a_p - a_r) <= 0.005 + 1e-4
        assert abs(k_p - k_r) <= 0.01 * k_r + 1e-4
        assert abs(t_p - t_r) <= 0.01 * t_r + 0.01
        assert abs(m_p - m_r) <= 0.01 * t_r + 0.01
