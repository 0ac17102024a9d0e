"""The port's CUDA kernels against their plain PyTorch versions on the
card, at test sizes (L = 16 and 32 lanes, one to five slabs): exact
equality of every output, and run_bucket on the card equal to the CPU
run.  Needs an NVIDIA GPU; skipped without one.  The machine with the
card has no JAX, so run these without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from spaln_tpu_torch.config import Config, resolve, CvsG
from spaln_tpu_torch.ops import dp_spliced as dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops.params import DpParams
from spaln_tpu_torch.score.intron import IntronPenalty
from spaln_tpu_torch.score.simmtx import Simmtx
from spaln_tpu_torch.score.splice import build_splice_signals
from spaln_tpu_torch.score.tables import TableDir, find_table_dir
from spaln_tpu_torch.seq.codec import encode_dna

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup():
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    return cfg, prm, TableDir(find_table_dir())


def _problems(cfg, tables, B, M, ilen, seed):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    qs, gs, ss = [], [], []
    for i in range(B):
        e1 = "".join(rng.choice(bases, M // 2))
        e2 = "".join(rng.choice(bases, M - M // 2))
        gi = "GTAAGT" + "".join(rng.choice(bases, ilen - 13)) + "TTTCTAG"
        g = ("".join(rng.choice(bases, 11 + i)) + e1 + gi + e2
             + "".join(rng.choice(bases, 7 + (i % 5))))
        qs.append(encode_dna(e1 + e2))
        gc = encode_dna(g)
        gs.append(gc)
        ss.append(build_splice_signals(gc, cfg, tables))
    return qs, gs, ss


GEOMS = [(8, 40, 60, 16, None), (3, 70, 120, 32, None),
         (4, 64, 90, 16, [-20, -36, -28, -44])]


@pytest.mark.parametrize("B,M,ilen,L,lws", GEOMS)
def test_kernels_equal_plain_on_card(cuda, setup, B, M, ilen, L, lws):
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, B, M, ilen, seed=B + L)
    band = dict(lws=lws, W=256) if lws else {}
    bp = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=L, device=cuda,
                                  **band)
    k1 = K.spliced_slab_trace(bp, prm)
    p1 = K.slab_trace_plain(bp, prm)
    for a, b in zip(k1, p1):
        assert torch.equal(a, b)
    se = K.spliced_last_ends(bp, prm, k1[2], k1[3])
    assert torch.equal(se, K.last_ends_plain(bp, prm, k1[2], k1[3]))
    recs = K.spliced_tb_walk(bp, k1[0], k1[1], se)
    assert torch.equal(recs, K.tb_walk_plain(bp, k1[0], k1[1], se))
    torch.cuda.synchronize()


def test_run_bucket_on_card_equals_cpu(cuda, setup):
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, 5, 150, 200, seed=9)
    before = dict(K.launches)
    on_card = K.run_bucket(dp.prepare_spliced_batch(
        qs, gs, prm, sigs=ss, L=32, device=cuda), prm)
    on_cpu = K.run_bucket(dp.prepare_spliced_batch(
        qs, gs, prm, sigs=ss, L=32, device="cpu"), prm)
    np.testing.assert_array_equal(on_card[0], on_cpu[0])
    assert on_card[1:] == on_cpu[1:]
    assert all(K.launches[k] == before[k] + 1 for k in K.KERNELS)


def test_wrapper_checks_raise(cuda, setup):
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, 2, 40, 60, seed=1)
    bp = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=16, device=cuda)
    fl, spj, row, rc = K.spliced_slab_trace(bp, prm)
    with pytest.raises(ValueError, match="dtype"):
        K.spliced_last_ends(bp, prm, row.long(), rc)
    with pytest.raises(ValueError, match="on cpu"):
        K.spliced_last_ends(bp, prm, row.cpu(), rc)
    with pytest.raises(ValueError, match="contiguous"):
        K.spliced_tb_walk(bp, fl, spj, torch.zeros(
            3, bp.B, dtype=torch.int32, device=cuda).t())
