"""The protein path's top row (``ops/dp_tron.py`` ``tron_init_row``) as
one compiled pass of the native library against spaln_tpu's Python loop
(``spaln_tpu.ops.dp_tron_scan.tron_init_row``): H and its direction
must be identical element for element (integer recurrence, fixed
tie-breaks: tolerance 0) on signals of real windows, on hand-made
signals with ties and int32 wrap-around, at every TransInit cut and
window size edge; ``prepare_tron_batch``'s boundary rows are those of
the plain loop, and the counters say which path ran."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from spaln_tpu.config import Config, PvsG, resolve
from spaln_tpu.ops.dp_tron_ref import TronDpParams as RefTronDpParams
from spaln_tpu.ops.dp_tron_scan import tron_init_row as ref_init_row
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.tables import find_table_dir

from spaln_tpu_torch.native import get_lib
from spaln_tpu_torch.ops import dp_tron as TD
from spaln_tpu_torch.ops.convert import tron_params_from_reference
from spaln_tpu_torch.ops.params import DpFlags
from spaln_tpu_torch.ops.tron_params import DEAD, HOR1, HOR2, HORI
from spaln_tpu_torch.score.codepot import build_tron_signals
from spaln_tpu_torch.score.tables import TableDir
from spaln_tpu_torch.seq.codec import encode_dna
from spaln_tpu_torch.utils.metrics import metrics

I32 = np.iinfo(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _native():
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")


@pytest.fixture(scope="module")
def env():
    """(cfg, Tetrapod tables, the reference's params and their double
    affine copy, each with its port twin)."""
    cfg = resolve(Config(), PvsG)
    root = find_table_dir()
    tables = TableDir(root, species="Tetrapod")
    ref = RefTronDpParams.build(cfg, Simmtx.protein(root, slot=0).tron().mtx)
    lgep = -int(0.6 * cfg.aln.scale)
    ref_d = dataclasses.replace(ref, dagp=True, lgep=lgep,
                                lgop=ref.gop - (lgep - ref.gep) * 7)
    return dict(cfg=cfg, tables=tables,
                prm=(ref, tron_params_from_reference(ref)),
                dagp=(ref_d, tron_params_from_reference(ref_d)))


def _window(env, n, seed):
    rng = np.random.default_rng(seed)
    g = "".join(rng.choice(list("ACGT"), n, p=[0.29, 0.21, 0.21, 0.29]))
    return build_tron_signals(encode_dna(g), env["cfg"], env["tables"])


def _hand(n, seed, lo, hi):
    """sigS and sigE uniform in [lo, hi]: negative, zero and positive."""
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        sigS=rng.integers(lo, hi + 1, n).astype(np.int32),
        sigE=rng.integers(lo, hi + 1, n).astype(np.int32))


# a small range where the three moves and the reseed often tie: gep + a
# sigE of 0 against w1 and w2 one less
TIES = SimpleNamespace(gep=-2, gap_w1=-3, gap_w2=-3)


def _case(env, name):
    """(signals, (reference params, port params), N, a_exgl, sigs_until)."""
    prm = env["prm"]
    if name == "window_1k":
        return _window(env, 1000, 1901), prm, 1000, True, None
    if name == "window_100k":
        return _window(env, 100_000, 1902), prm, 100_000, True, None
    if name.startswith("until_"):
        at = {"0": 0, "mid": 500, "N-5": 995, "N": 1000, "neg": -10,
              "far": 5000}[name[6:]]
        return _window(env, 1000, 1903), prm, 1000, True, at
    if name == "hand_small":
        return _hand(2000, 1904, -3, 3), (TIES, TIES), 2000, True, None
    if name == "hand_ties_until":
        return _hand(2000, 1905, -3, 3), (TIES, TIES), 2000, True, 700
    if name == "hand_large":
        # int32 extremes: H leaves the int32 range and wraps when cast
        sig = _hand(3000, 1906, -4, 4)
        sig.sigE[:40] = I32.max
        sig.sigE[1500:1540] = I32.min
        sig.sigS[2000:2003] = I32.max
        return sig, prm, 3000, True, None
    if name == "no_exgl":
        return _window(env, 1000, 1907), prm, 1000, False, None
    if name.startswith("N"):
        n = int(name[1:])
        return _hand(n, 1908 + n, -5, 9), (TIES, TIES), n, True, None
    if name == "dagp":
        return _window(env, 5000, 1912), env["dagp"], 5000, True, 2500
    raise KeyError(name)


CASES = ["window_1k", "window_100k", "until_0", "until_mid", "until_N-5",
         "until_N", "until_neg", "until_far", "hand_small",
         "hand_ties_until", "hand_large", "no_exgl", "N0", "N1", "N2", "N3",
         "dagp"]


def _ties(sig, prm, h, until):
    """Columns n >= 3 at which two of HORI, HOR1, HOR2 and the reseed
    tie for the best, recomputed from H."""
    N = len(h) - 2
    seed = np.zeros(N + 3, np.int64)
    k = min(N, N if until is None else until + 4)
    seed[1:k] = np.maximum(sig.sigS[1:k], 0)
    out = 0
    for n in range(3, N + 2):
        e = int(sig.sigE[n - 3]) if n - 3 < N else 0
        c = [h[n - 3] + prm.gep + e, h[n - 1] + prm.gap_w1,
             h[n - 2] + prm.gap_w2, seed[n + 1]]
        out += c.count(max(c)) > 1
    return out


@pytest.mark.parametrize("name", CASES)
def test_init_row_equals_reference(env, name):
    sig, (rprm, pprm), N, a_exgl, until = _case(env, name)
    metrics.reset()
    h, hd = TD.tron_init_row(sig, pprm, N, a_exgl, sigs_until=until)
    assert metrics.counters["init_row_native"] == 1
    assert "init_row_plain" not in metrics.counters
    rh, rhd = ref_init_row(sig, rprm, N, a_exgl, sigs_until=until)
    assert h.dtype == rh.dtype == np.int32
    assert hd.dtype == rhd.dtype == np.int32
    assert len(h) == len(hd) == N + 2
    np.testing.assert_array_equal(h, rh)
    np.testing.assert_array_equal(hd, rhd)
    if not a_exgl:
        assert not h.any() and (hd == DEAD).all()
    if name in ("hand_small", "hand_ties_until"):
        assert _ties(sig, pprm, h.astype(np.int64), until) > 50
    if name == "hand_large":
        # in int64, H[6] = H[3] + gep + 2**31 - 1: the cast wrapped it
        assert hd[6] == HORI and h[6] < h[3]
    if name in ("window_1k", "window_100k", "hand_small",
                "hand_ties_until"):
        assert {DEAD, HORI, HOR1, HOR2} <= set(np.unique(hd).tolist())


def test_plain_path_counts_and_equals_reference(env, monkeypatch):
    """Without the library the Python loop runs, counted apart."""
    sig, (rprm, pprm), N, a_exgl, until = _case(env, "until_mid")
    monkeypatch.setattr(TD, "tron_init_row_native", lambda *a: None)
    metrics.reset()
    h, hd = TD.tron_init_row(sig, pprm, N, a_exgl, sigs_until=until)
    assert metrics.counters["init_row_plain"] == 1
    assert "init_row_native" not in metrics.counters
    rh, rhd = ref_init_row(sig, rprm, N, a_exgl, sigs_until=until)
    np.testing.assert_array_equal(h, rh)
    np.testing.assert_array_equal(hd, rhd)


def test_prepare_tron_batch_rows_equal_plain(env, monkeypatch):
    """The batch's boundary H and direction rows, free and anchored
    problems, are the plain loop's; init_row once a problem."""
    rng = np.random.default_rng(1913)
    _, pprm = env["prm"]
    Ns = [900, 1500, 2400]
    gs = [encode_dna("".join(rng.choice(list("ACGT"), n))) for n in Ns]
    sigs = [build_tron_signals(g, env["cfg"], env["tables"]) for g in gs]
    qs = [rng.integers(3, 23, m).astype(np.int8) for m in (60, 90, 130)]
    lbs = [(1 << 30, -(1 << 30)), (400, 1200), (-20, 2000)]
    ipen = IntronPenalty(env["cfg"], PvsG).penalty(np.arange(4000))

    def batch():
        metrics.reset()
        bp = TD.prepare_tron_batch(qs, gs, sigs, pprm, ipen,
                                   flags=DpFlags(), L=32, loc_bounds=lbs)
        assert metrics.calls["init_row"] == len(gs)
        return bp.bnd0.numpy(), dict(metrics.counters)

    nat, c_nat = batch()
    assert c_nat.get("init_row_native") == len(gs)
    assert "init_row_plain" not in c_nat
    monkeypatch.setattr(TD, "tron_init_row_native", lambda *a: None)
    plain, c_plain = batch()
    assert c_plain.get("init_row_plain") == len(gs)
    assert "init_row_native" not in c_plain
    for k in (TD.B_H, TD.B_HD):
        np.testing.assert_array_equal(nat[k], plain[k])
