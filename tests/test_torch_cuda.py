"""The port's CUDA kernels against their plain PyTorch versions on the
card, at test sizes (L = 16 and 32 lanes, one to five slabs, and 19
slabs of problems of different lengths, so that the slab kernel's
rounds of k slabs in flight wrap twice and end part-full; and L = 1000
and 1024, two lanes a thread): exact equality of every output, single
and double affine and score-only, and run_bucket, the UDH path (its
retrace at several plane budgets), `map --lanes 1024` and the protein
search on the card equal to the CPU run; K6, the local and -yJ modes of
K1 (with the local emission) and K4, at the same sizes, on 19 slabs and
at two lanes a thread, the retrace of (problem, slab) pairs and the
strips with a slab a walk after a K6 links pass, the UDH path in K6's
modes and the local protein search on the card equal to the CPU run;
the tron kernels K7 and K8 at
the rule's geometry and forced ones (1-11 slabs, 9-1,024 lanes) and the
protein map; the step probes at 4-32 warps, the slab kernel's "none"
knock-out build against the production one, and the production
instances' registers; every step skeleton (csrc/mosaic_repro.cu) at the
script's inputs, the knock-out builds of time_kernel_pieces and
bisect_mosaic (each launched, "none" and each forced k equal to the
production kernel) and the bench's scores against the plain versions;
fit_ild on the card against the CPU fit, a map split in two shards on
one card against the unsharded map, and the entry module (entry(),
dryrun_multichip(1) over NCCL).  Needs an NVIDIA GPU; skipped
without one.  The machine with the card has no JAX, so run these
without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from spaln_tpu_torch.config import Config, resolve, CvsG
from spaln_tpu_torch.ops import dp_spliced as dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops.params import DpParams
from spaln_tpu_torch.probes import PROBES
from spaln_tpu_torch.probes import _cuda as PC
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
    """B planted one-intron genes; M is the query length, or a list of
    lengths taken in turn."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    qs, gs, ss = [], [], []
    Ms = M if isinstance(M, list) else [M]
    for i in range(B):
        M = Ms[i % len(Ms)]
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


@pytest.mark.parametrize("dagp", [False, True])
def test_walk_steps_and_tile_loads_equal_model_on_card(cuda, setup, dagp):
    """K3, a strip launch and K8 report each walk's steps and tile loads;
    they equal the models' (walk_stats, tron_walk_stats) on the same
    records, and the records equal the plain versions'."""
    from spaln_tpu_torch.ops import dp_tron as TD
    from spaln_tpu_torch.ops import dp_tron_cuda as TK
    from spaln_tpu_torch.ops.params import DpFlags
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, 5, 150, 200, seed=9)
    bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=16, device=cuda)
    fl, spj, row, rc = K.spliced_slab_trace(bp, p)
    se = K.spliced_last_ends(bp, p, row, rc)
    st = torch.empty((bp.B, 2), dtype=torch.int32, device=cuda)
    recs = K.spliced_tb_walk(bp, fl, spj, se, stats=st)
    assert torch.equal(recs, K.tb_walk_plain(bp, fl, spj, se))
    assert torch.equal(st.cpu(), K.walk_stats(recs, fl, bp.lws_t))
    starts = torch.tensor([[min((s + 1) * 16, bp.Ms[b]),
                            min((s + 1) * 16, bp.Ms[b]) + bp.lws[b]
                            + bp.W // 2, (0, 2)[(b + s) % 2], s * 16, b]
                           for b in range(bp.B) for s in range(1, bp.S)],
                          dtype=torch.int32, device=cuda)
    IT = dp.strip_walk_bound(16, bp.W)
    sst = torch.empty((starts.shape[0], 2), dtype=torch.int32, device=cuda)
    r = K.spliced_tb_strips(fl[1:].contiguous(), spj[1:].contiguous(),
                            starts, bp.lws_t, 1, IT, stats=sst)
    assert torch.equal(r, K.tb_strips_plain(fl[1:].contiguous(),
                                            spj[1:].contiguous(), starts,
                                            bp.lws_t, 1, IT))
    col = starts[:, 4].long()
    assert torch.equal(sst.cpu(), K.walk_stats(
        r, fl[1:].contiguous(), bp.lws_t[col], 1, starts[:, 2], col))
    tcfg, tprm, ipen = _tron_setup(dagp)
    tq, tg, ts, lws, W, lbs = _tron_problems(tcfg, 4, seed=21)
    tbp = TD.prepare_tron_batch(tq, tg, ts, tprm, ipen, lws=lws, W=W, L=32,
                                flags=DpFlags(local=True), loc_bounds=lbs,
                                device=cuda)
    planes, row, rc, loc = TK.tron_forward(tbp, tprm)
    ends = TD.collect_tron_ends(tbp, row.cpu().numpy(), rc.cpu().numpy(),
                                loc.cpu().numpy())
    et = torch.tensor([[e[1], e[2]] for e in ends], dtype=torch.int32,
                      device=cuda)
    tst = torch.empty((tbp.B, 2), dtype=torch.int32, device=cuda)
    recs, counts = TK.tron_walk(tbp, planes, et, stats=tst)
    precs, pcounts, _ = TK.tron_walk_plain(tbp, planes, et)
    assert torch.equal(counts, pcounts)
    for b in range(tbp.B):
        assert torch.equal(recs[b, :int(counts[b])],
                           precs[b, :int(counts[b])])
    assert torch.equal(tst.cpu(), TK.tron_walk_stats(tbp, planes[0], et,
                                                     recs, counts))
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,M,ilen,L,lws", GEOMS)
def test_ends_kernels_equal_plain_on_card(cuda, setup, B, M, ilen, L, lws):
    """K2e and the fused K2e + K3 (spliced_ends_tb_walk) against their
    plain versions, the fused
    entry's walk stats against walk_stats, on K1's rows and on every
    tie kind of chip_smoke.tie_rows."""
    import chip_smoke
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, B, M, ilen, seed=B + L)
    band = dict(lws=lws, W=256) if lws else {}
    bp = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=L, device=cuda,
                                  **band)
    fl, spj, row, rc = K.spliced_slab_trace(bp, prm)
    for kind in ("K1", *chip_smoke.TIE_KINDS):
        r, c = ((row, rc) if kind == "K1"
                else chip_smoke.tie_rows(kind, bp, row, rc, seed=B))
        want = K.last_ends_plain(bp, prm, r, c)
        assert torch.equal(K.spliced_last_ends(bp, prm, r, c), want), kind
        st = torch.empty((bp.B, 2), dtype=torch.int32, device=cuda)
        se, recs = K.spliced_ends_tb_walk(bp, prm, fl, spj, r, c, stats=st)
        assert torch.equal(se, want), kind
        assert torch.equal(recs, K.tb_walk_plain(bp, fl, spj, want)), kind
        assert torch.equal(st.cpu(), K.walk_stats(recs, fl, bp.lws_t)), kind
    torch.cuda.synchronize()


@pytest.mark.parametrize("Nmax,Mpad", [(1000, 256), (1001, 257),
                                       (1002, 258), (1003, 259),
                                       (5003, 1537)])
def test_ends_on_odd_strides_on_card(cuda, setup, Nmax, Mpad):
    """K2e on rows of every stride mod 4 (so the segments' 16-byte
    boundaries fall anywhere), with bands that leave either segment
    empty, on random and tie-heavy rows under each end-gap rule: equal to
    the plain version."""
    import chip_smoke
    from spaln_tpu_torch.ops.params import DpFlags
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, 2, 40, 60, seed=1)
    base = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=16, device=cuda)
    rng = np.random.default_rng(Nmax)
    B, W = 11, 300
    Ms = rng.integers(1, Mpad + 1, B)
    Ns = rng.integers(1, Nmax + 1, B)
    lws = Ns - Ms + rng.integers(-W - 5, 10, B)
    lws[0], lws[1] = Ns[0] - Ms[0] + 2, Ns[1] - Ms[1] - W     # empty row, rc
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=cuda)
    bp = dataclasses.replace(
        base, B=B, W=W, Nmax=Nmax, Mpad=Mpad, Ms=Ms.tolist(),
        Ns=Ns.tolist(), lws=lws.tolist(), Ms_t=t(Ms), Ns_t=t(Ns),
        lws_t=t(lws))
    row = t(rng.integers(-50_000, 50_000, (B, Nmax + 1)))
    rc = t(rng.integers(-50_000, 50_000, (B, Mpad + 1)))
    for ar, br in ((1, 1), (1, 0), (0, 1)):
        for al, bl in ((1, 1), (0, 0)):
            b = dataclasses.replace(bp, flags=DpFlags(
                a_exgl=bool(al), a_exgr=bool(ar), b_exgl=bool(bl),
                b_exgr=bool(br)))
            for kind in ("random", *chip_smoke.TIE_KINDS):
                r, c = ((row, rc) if kind == "random"
                        else chip_smoke.tie_rows(kind, b, row, rc, seed=7))
                want = K.last_ends_plain(b, prm, r, c)
                assert torch.equal(K.spliced_last_ends(b, prm, r, c),
                                   want), (kind, ar, br, al)
    torch.cuda.synchronize()


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("Nmax,Mpad", [(200, 140), (201, 141), (202, 142),
                                       (203, 143)])
def test_ends_on_every_segment_length_on_card(cuda, setup, Nmax, Mpad,
                                              offset):
    """K2e where problem b's final-row segment holds b cells (0-130) and
    its right-column segment 130 - b, with row and rc starting
    ``offset`` ints past a 16-byte boundary: every head, int4 body and
    tail split of ends_partition, read by the kernel itself, on random
    and tie-heavy rows: equal to the plain version."""
    import chip_smoke
    from spaln_tpu_torch.ops.params import DpFlags
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, 2, 40, 60, seed=1)
    base = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=16, device=cuda)
    B, W = 131, 131
    n = np.arange(B)
    Ns, Ms = Nmax - n % 7, Mpad - n % 5
    lws = Ns - Ms - n                     # row [N - b, N), rc [M + b - 130, M)
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=cuda)
    bp = dataclasses.replace(
        base, B=B, W=W, Nmax=Nmax, Mpad=Mpad, Ms=Ms.tolist(),
        Ns=Ns.tolist(), lws=lws.tolist(), Ms_t=t(Ms), Ns_t=t(Ns),
        lws_t=t(lws), flags=DpFlags(a_exgl=True, a_exgr=True, b_exgl=True,
                                    b_exgr=True))
    segs = chip_smoke._segments(bp)
    assert [h - lo for (lo, h), _ in segs] == list(range(B))
    assert [h - lo for _, (lo, h) in segs] == list(range(B - 1, -1, -1))

    def shifted(x):
        buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
        v = buf[offset:offset + x.numel()].view(x.shape)
        v.copy_(x)
        assert v.data_ptr() // 4 % 4 == offset
        return v

    rng = np.random.default_rng(Nmax + offset)
    row = t(rng.integers(-50_000, 50_000, (B, Nmax + 1)))
    rc = t(rng.integers(-50_000, 50_000, (B, Mpad + 1)))
    for kind in ("random", *chip_smoke.TIE_KINDS):
        r, c = ((row, rc) if kind == "random"
                else chip_smoke.tie_rows(kind, bp, row, rc, seed=offset))
        want = K.last_ends_plain(bp, prm, r, c)
        assert torch.equal(K.spliced_last_ends(bp, prm, shifted(r),
                                               shifted(c)), want), kind
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
    assert all(K.launches[k] == before[k] + 1 for k in K.PLANE_PATH)


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
    with pytest.raises(ValueError, match="shape"):
        K.spliced_ends_tb_walk(bp, prm, fl, spj, row[:, :-1].contiguous(),
                               rc)


@pytest.mark.parametrize("B,M,ilen,L,lws", GEOMS)
def test_links_retrace_strip_equal_plain_on_card(cuda, setup, B, M, ilen,
                                                 L, lws):
    """K4 against its plain version; K1's retrace of every slab, and of
    every run s0..S-1 in one launch, from K4's snapshot against the full
    K1 planes, byte for byte; K3's strip mode over every strip of a
    launch against its plain version."""
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, B, M, ilen, seed=B + L)
    band = dict(lws=lws, W=256) if lws else {}
    bp = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=L, device=cuda,
                                  **band)
    k4 = K.spliced_slab_links(bp, prm)
    for a, b in zip(k4, K.slab_links_plain(bp, prm)):
        assert torch.equal(a, b)
    flags, spj, _, _ = K.spliced_slab_trace(bp, prm)
    links, snaps = k4[0], k4[1]
    sel = torch.arange(B - 1, -1, -1, dtype=torch.int32, device=cuda)
    for s in range(bp.S):
        snap = snaps[s].index_select(1, sel.long()).contiguous()
        fl, sp = K.spliced_slab_retrace(bp, prm, s, 1, snap, sel)
        assert torch.equal(fl[0], flags[s][:, sel.long()])
        assert torch.equal(sp[0], spj[s][:, :, sel.long()])
        pl = K.slab_retrace_plain(bp, prm, s, 1, snap, sel)
        assert torch.equal(fl, pl[0]) and torch.equal(sp, pl[1])
    _retrace_runs_and_strips(bp, prm, snaps, (flags, spj), sel, (0, 2))
    torch.cuda.synchronize()


def _retrace_runs_and_strips(bp, prm, snaps, planes, sel, states):
    """The retrace of slabs s0..S-1 in one launch from K4's snapshot of
    s0, for every s0, equal to K1's planes; then K3's strip mode over
    every (slab, problem) strip of the s0 = 0 launch, starting in the
    given states by turns, equal to its plain version."""
    idx = sel.long()
    for s0 in range(bp.S):
        fl, sp = K.spliced_slab_retrace(
            bp, prm, s0, bp.S - s0, snaps[s0].index_select(1, idx)
            .contiguous(), sel)
        assert torch.equal(fl, planes[0][s0:][:, :, idx])
        assert torch.equal(sp, planes[1][s0:][:, :, :, idx])
    L = bp.L
    starts = []
    for j, b in enumerate(sel.tolist()):
        for s in range(bp.S):
            top = min((s + 1) * L, bp.Ms[b])
            starts.append([top, top + bp.lws[b] + bp.W // 2,
                           states[(j + s) % len(states)], s * L, j])
    starts = torch.tensor(starts, dtype=torch.int32, device=bp.device)
    lws_sel = bp.lws_t.index_select(0, idx)
    IT = dp.strip_walk_bound(L, bp.W)
    before = K.launches["spliced_tb_strips"]
    r = K.spliced_tb_strips(fl, sp, starts, lws_sel, 0, IT)
    assert K.launches["spliced_tb_strips"] == before + 1
    assert torch.equal(r, K.tb_strips_plain(fl, sp, starts, lws_sel, 0, IT))
    assert (r[:, :, 0] != 0).any()


@pytest.mark.parametrize("slabs", [None, 1, 2])
def test_udh_on_card_equals_cpu(cuda, setup, slabs):
    """The UDH path on the card and on the CPU; the retrace at the default
    plane budget (every run in one launch: one retrace and one strip
    launch) and at budgets of one and two problem-slabs a launch."""
    from spaln_tpu_torch.ops.dp_spliced_udh import run_spliced_batch_udh
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, 5, 150, 200, seed=9)
    res, n = {}, {}
    for dev in (cuda, "cpu"):
        bp = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=32, device=dev)
        budget = (dp.PLANE_BYTES_BUDGET if slabs is None else
                  slabs * bp.T * bp.L * dp.plane_bytes_per_cell(prm))
        before = dict(K.launches)
        res[dev] = run_spliced_batch_udh(bp, prm, budget)
        n = n or {k: K.launches[k] - before[k] for k in K.UDH_PATH}
    np.testing.assert_array_equal(res[cuda][0], res["cpu"][0])
    np.testing.assert_array_equal(res[cuda][1], res["cpu"][1])
    assert res[cuda][2] == res["cpu"][2]
    assert n["spliced_slab_links"] == 1
    assert n["spliced_slab_retrace"] == n["spliced_tb_strips"] >= 1
    if slabs is None:
        assert n["spliced_slab_retrace"] == 1


def _dagp(prm):
    return dataclasses.replace(prm, dagp=True, lgop=prm.gop // 2,
                               lgep=prm.gep // 3)


@pytest.mark.parametrize("B,M,ilen,L,lws", GEOMS)
def test_dagp_and_score_kernels_equal_plain_on_card(cuda, setup, B, M,
                                                    ilen, L, lws):
    """K5: the *_dagp entries (K1, K4, K1 retrace) and the 5-state K3
    walk and strip against their plain versions; the score-only entry,
    single and double affine, against its plain version and K1's row
    and right column."""
    cfg, prm, tables = setup
    prm3 = _dagp(prm)
    qs, gs, ss = _problems(cfg, tables, B, M, ilen, seed=B + L)
    band = dict(lws=lws, W=256) if lws else {}
    bp = dp.prepare_spliced_batch(qs, gs, prm3, sigs=ss, L=L, device=cuda,
                                  **band)
    k1 = K.spliced_slab_trace(bp, prm3)
    assert k1[1].shape[1] == 5
    for a, b in zip(k1, K.slab_trace_plain(bp, prm3)):
        assert torch.equal(a, b)
    se = K.spliced_last_ends(bp, prm3, k1[2], k1[3])
    recs = K.spliced_tb_walk(bp, k1[0], k1[1], se)
    assert torch.equal(recs, K.tb_walk_plain(bp, k1[0], k1[1], se))
    k4 = K.spliced_slab_links(bp, prm3)
    for a, b in zip(k4, K.slab_links_plain(bp, prm3)):
        assert torch.equal(a, b)
    snaps = k4[1]
    sel = torch.arange(B - 1, -1, -1, dtype=torch.int32, device=cuda)
    for s in range(bp.S):
        snap = snaps[s].index_select(1, sel.long()).contiguous()
        fl, sp = K.spliced_slab_retrace(bp, prm3, s, 1, snap, sel)
        assert torch.equal(fl[0], k1[0][s][:, sel.long()])
        assert torch.equal(sp[0], k1[1][s][:, :, sel.long()])
    _retrace_runs_and_strips(bp, prm3, snaps, k1[:2], sel, (4, 0, 2))
    for p in (prm, prm3):
        row, rc = K.spliced_slab_score(bp, p)
        pr, pc = K.slab_score_plain(bp, p)
        assert torch.equal(row, pr) and torch.equal(rc, pc)
    assert torch.equal(row, k1[2]) and torch.equal(rc, k1[3])
    torch.cuda.synchronize()


def test_dagp_paths_on_card_equal_cpu(cuda, setup):
    """run_bucket and the UDH path with double-affine gaps, on the card
    and on the CPU, through the *_dagp entries."""
    from spaln_tpu_torch.ops.dp_spliced_udh import run_spliced_batch_udh
    cfg, prm, tables = setup
    prm3 = _dagp(prm)
    qs, gs, ss = _problems(cfg, tables, 5, 150, 200, seed=9)
    before = dict(K.launches)
    res = {}
    for dev in (cuda, "cpu"):
        for fn in (K.run_bucket, run_spliced_batch_udh):
            res[dev, fn] = fn(dp.prepare_spliced_batch(
                qs, gs, prm3, sigs=ss, L=32, device=dev), prm3)
    for fn in (K.run_bucket, run_spliced_batch_udh):
        a, b = res[cuda, fn], res["cpu", fn]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
        assert a[2] == b[2]
    assert all(K.launches[k] > before[k]
               for k in K.PLANE_PATH_DAGP + K.UDH_PATH_DAGP)


def test_protein_search_on_card_equals_cpu(cuda):
    """search_protein_db's score pass (full band, alphabet 25) on the
    score-only entry, and its top hit on K1/K2e/K3, equal the CPU run."""
    from spaln_tpu_torch.align.protein_search import search_protein_db
    from spaln_tpu_torch.seq.codec import encode_protein
    rng = np.random.default_rng(3)
    aas = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    target = "".join(rng.choice(aas, 150))
    db = [(f"d{i}", encode_protein("".join(rng.choice(aas, int(
        rng.integers(80, 300)))))) for i in range(40)]
    hom = "".join(c if rng.random() > 0.2 else rng.choice(aas)
                  for c in target)
    db.insert(13, ("hom", encode_protein(hom)))
    before = dict(K.launches)
    kw = dict(table_dir=find_table_dir(), max_hits=5, align_top=2,
              lanes=64)
    on_card = search_protein_db(encode_protein(target), db, device=cuda,
                                **kw)
    on_cpu = search_protein_db(encode_protein(target), db, device="cpu",
                               **kw)
    key = [(h.name, h.score, h.q_span, h.s_span, h.identity)
           for h in on_card]
    assert key == [(h.name, h.score, h.q_span, h.s_span, h.identity)
                   for h in on_cpu]
    assert key[0][0] == "hom"
    assert K.launches["spliced_slab_score"] == \
        before["spliced_slab_score"] + 1
    assert K.launches["spliced_slab_trace"] == \
        before["spliced_slab_trace"] + 2


@pytest.mark.parametrize("dagp,B", [(False, 3), (True, 3), (False, 45)])
def test_tall_slab_rounds_equal_plain_on_card(cuda, setup, dagp, B):
    """19 slabs of L = 16 and queries of 300, 170 and 260 rows: K1 runs
    7 slabs in flight (K1-dagp 5, K4 4, the score entries 8 and 4), so its
    rounds wrap twice and the last is part-full, and later sub-slabs
    hold rows past a shorter query; the rounds run on a cluster of one
    CTA per round, or with B = 45 problems on fewer CTAs than rounds.
    Every slab entry equals its plain version, K4's links and snapshots
    at every position; the retrace of slabs 1..18 (more than k) from
    K4's snapshot equals K1's planes and its plain version, and so does
    the retrace of every run s0..18 (with B = 45, the retrace's rounds
    outnumber the CTAs a problem may take); K3's strip mode over every
    strip equals its plain version."""
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, B, [300, 170, 260], 70, seed=11)
    bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=16, device=cuda,
                                  lws=[-20, -28, -24] * (B // 3), W=128)
    A = bp.qprof.shape[2]
    ks = [K.slab_geometry(m, dagp, 16, A, bp.S)[0]
          for m in ("trace", "links", "score")]
    assert bp.S == 19 and all(bp.S >= 2 * k + 1 for k in ks)
    k1 = K.spliced_slab_trace(bp, p)
    for a, b in zip(k1, K.slab_trace_plain(bp, p)):
        assert torch.equal(a, b)
    assert (k1[1] > 0).any()
    k4 = K.spliced_slab_links(bp, p)
    for a, b in zip(k4, K.slab_links_plain(bp, p)):
        assert torch.equal(a, b)
    row, rc = K.spliced_slab_score(bp, p)
    pr, pc = K.slab_score_plain(bp, p)
    assert torch.equal(row, pr) and torch.equal(rc, pc)
    assert torch.equal(row, k1[2]) and torch.equal(rc, k1[3])
    sel = torch.arange(B, dtype=torch.int32, device=cuda).roll(1)
    idx = sel.long()
    snap = k4[1][1].index_select(1, idx).contiguous()
    fl, sp = K.spliced_slab_retrace(bp, p, 1, 18, snap, sel)
    assert torch.equal(fl, k1[0][1:][:, :, idx])
    assert torch.equal(sp, k1[1][1:][:, :, :, idx])
    pl = K.slab_retrace_plain(bp, p, 1, 18, snap, sel)
    assert torch.equal(fl, pl[0]) and torch.equal(sp, pl[1])
    _retrace_runs_and_strips(bp, p, k4[1], k1[:2], sel,
                             (0, 2, 4) if dagp else (0, 2))
    torch.cuda.synchronize()


def test_refused_slab_launch_raises_on_card(cuda, setup):
    """A geometry the slab kernel cannot take raises: in slab_geometry
    before the launch, and from the C entry's refusal (more sub-slabs
    than the instance's thread budget) through _launch; nothing falls
    back to fewer slabs in flight or to the plain version."""
    cfg, prm, tables = setup
    qs, gs, ss = _problems(cfg, tables, 2, 40, 60, seed=1)
    wide = dp.prepare_spliced_batch(qs, gs, _dagp(prm), sigs=ss, L=1400,
                                    device=cuda)
    before = dict(K.plain_calls)
    with pytest.raises(ValueError, match="lanes L=1400"):
        K.spliced_slab_trace(wide, _dagp(prm))
    bp = dp.prepare_spliced_batch(qs, gs, prm, sigs=ss, L=16, device=cuda)
    A = bp.qprof.shape[2]
    bnd = K._scratch(bp, prm, bp.B)
    out = [torch.empty(1, dtype=torch.int32, device=cuda) for _ in range(4)]
    smem = K.slab_smem("trace", False, 128 * 16, A)
    prog = torch.empty(bp.B * bp.S, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        K._launch("spliced_slab_trace", cuda, *K._operand_ptrs(bp), bp.B,
                  16, A, bp.S, 128, smem, 1, K._ptr(prog),
                  *K._dp_ints(bp, prm), K._ptr(bnd), *map(K._ptr, out),
                  None, 0, None, None)
    assert K.plain_calls == before


@pytest.mark.parametrize("dagp,L", [(False, 1000), (True, 1000),
                                    (False, 1024), (True, 1024)])
def test_wide_lanes_equal_plain_on_card(cuda, setup, dagp, L):
    """L = 1000 and 1024, past every instance's thread budget (two lanes
    a thread in K4 and the dagp modes, one slab per CTA): K1, K4 and the
    score entry against their plain versions, two slabs; the retrace of
    slab 1 and of the run 0..1 from K4's snapshots against K1's planes
    and its plain version; K3's strip mode over both slabs' strips
    against its plain version."""
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, 2, [L + 120, L + 60], 70, seed=L)
    bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=L, device=cuda,
                                  lws=[-20, -24], W=48)
    assert bp.S == 2
    A = bp.qprof.shape[2]
    for mode in ("trace", "links", "score"):
        k, threads, _ = K.slab_geometry(mode, dagp, L, A, bp.S)
        assert k * L > threads or L <= K.SLAB_MAX_THREADS[mode, dagp]
    k1 = K.spliced_slab_trace(bp, p)
    for a, b in zip(k1, K.slab_trace_plain(bp, p)):
        assert torch.equal(a, b)
    k4 = K.spliced_slab_links(bp, p)
    for a, b in zip(k4, K.slab_links_plain(bp, p)):
        assert torch.equal(a, b)
    row, rc = K.spliced_slab_score(bp, p)
    assert torch.equal(row, k1[2]) and torch.equal(rc, k1[3])
    sel = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    snap = k4[1][1].index_select(1, sel.long()).contiguous()
    fl, sp = K.spliced_slab_retrace(bp, p, 1, 1, snap, sel)
    pl = K.slab_retrace_plain(bp, p, 1, 1, snap, sel)
    assert torch.equal(fl, pl[0]) and torch.equal(sp, pl[1])
    _retrace_runs_and_strips(bp, p, k4[1], k1[:2], sel,
                             (0, 2, 4) if dagp else (0, 2))
    torch.cuda.synchronize()


def _k6(bp, cips: bool, local: bool):
    """bp in K6's modes: the local switch, and a -yJ bonus on every other
    problem's rows (a few hundred, at rows 3 mod 7)."""
    cip = None
    if cips:
        c = torch.zeros((bp.B, bp.Mpad + bp.L), dtype=torch.int32)
        c[::2, 2::7] = 300 + 100 * (torch.arange(c[:, 2::7].shape[1]) % 5)
        cip = c.to(bp.device)
    return dataclasses.replace(bp, flags=dataclasses.replace(
        bp.flags, local=local), cip=cip)


def _k6_check(bp, p, local: bool) -> None:
    """K1 (with the emission in local mode) and K4 in bp's K6 modes
    against their plain versions: every output equal."""
    k1 = K.spliced_slab_trace(bp, p, emit_local=local)
    p1 = K.slab_trace_plain(bp, p, emit_local=local)
    assert len(k1) == len(p1) == (6 if local else 4)
    for a, b in zip(k1, p1):
        assert torch.equal(a, b)
    if local:
        assert ((k1[0] >= 128) & (k1[0] != 255)).any()
    k4 = K.spliced_slab_links(bp, p)
    for a, b in zip(k4, K.slab_links_plain(bp, p)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


K6_MODES = [(False, True, False), (True, False, False), (True, True, False),
            (False, True, True), (True, True, True)]


@pytest.mark.parametrize("local,cips,dagp", K6_MODES)
@pytest.mark.parametrize("B,M,ilen,L,lws", GEOMS)
def test_k6_modes_equal_plain_on_card(cuda, setup, B, M, ilen, L, lws,
                                      local, cips, dagp):
    """K6: K1 and K4 in the local mode (the zero floor, flag bit 7, K1's
    step emission of each slab's best H and first lane) and with the -yJ
    bonus, single and double affine, at test sizes: exactly their plain
    versions'."""
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, B, M, ilen, seed=B + L + 5)
    band = dict(lws=lws, W=256) if lws else {}
    bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=L, device=cuda,
                                  **band)
    _k6_check(_k6(bp, cips, local), p, local)


@pytest.mark.parametrize("dagp,B", [(False, 3), (True, 3), (False, 45)])
def test_k6_tall_slab_rounds_equal_plain_on_card(cuda, setup, dagp, B):
    """K6 at test_tall_slab_rounds_equal_plain_on_card's geometry (19
    slabs of L = 16: rounds of k slabs in flight that wrap twice, on a
    cluster of CTAs, or with B = 45 on fewer CTAs than rounds), local
    with the bonus: K1 with the emission and K4 equal their plain
    versions."""
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, B, [300, 170, 260], 70, seed=11)
    bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=16, device=cuda,
                                  lws=[-20, -28, -24] * (B // 3), W=128)
    _k6_check(_k6(bp, True, True), p, True)


@pytest.mark.parametrize("dagp,L", [(False, 1000), (True, 1024)])
def test_k6_wide_lanes_equal_plain_on_card(cuda, setup, dagp, L):
    """K6 at two lanes a thread (L = 1000 and 1024): K1 with the emission
    (its reduction over a slab wider than the CTA) and K4, local with the
    bonus, equal their plain versions."""
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, 2, [L + 120, L + 60], 70, seed=L)
    bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=L, device=cuda,
                                  lws=[-20, -24], W=48)
    _k6_check(_k6(bp, True, True), p, True)


@pytest.mark.parametrize("dagp", [False, True])
@pytest.mark.parametrize("B,M,ilen,L,lws", GEOMS)
def test_k6_retrace_pairs_equal_plain_on_card(cuda, setup, B, M, ilen, L,
                                              lws, dagp):
    """The retrace of (problem, slab) pairs: every pair of the bucket in
    one launch, in a shuffled order, from K4's snapshots of a local links
    pass with the -yJ bonus, equal to its plain version on the card, to
    the one-slab retrace of each slab and to K1's planes; K3's strip mode
    over its planes with a slab a walk equal to its plain version, and
    its steps and tile loads to the model's."""
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, B, M, ilen, seed=B + L + 9)
    band = dict(lws=lws, W=256) if lws else {}
    bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=L, device=cuda,
                                  **band)
    snaps = K.spliced_slab_links(_k6(bp, True, True), p)[1]
    flags, spj, _, _ = K.spliced_slab_trace(bp, p)
    rng = np.random.default_rng(B + L)
    pairs = [(b, s) for b in range(B) for s in range(bp.S)]
    pairs = [pairs[i] for i in rng.permutation(len(pairs))]
    ids = torch.tensor(pairs, dtype=torch.int32, device=cuda).T
    sel, slabs = ids[0].contiguous(), ids[1].contiguous()
    snap = snaps[slabs.long(), :, sel.long()].transpose(0, 1).contiguous()
    name = K.entry("spliced_slab_retrace_pairs", p)
    before = K.launches[name]
    fl, sp = K.spliced_slab_retrace_pairs(bp, p, slabs, snap, sel)
    assert K.launches[name] == before + 1
    pl = K.slab_retrace_pairs_plain(bp, p, slabs, snap, sel)
    assert torch.equal(fl, pl[0]) and torch.equal(sp, pl[1])
    k4 = K.spliced_slab_links(bp, p)[1]         # K6 off: K1's boundaries
    for j, (b, s) in enumerate(pairs):
        one = K.spliced_slab_retrace(bp, p, s, 1,
                                     snap[:, j:j + 1].contiguous(),
                                     sel[j:j + 1].contiguous())
        assert torch.equal(fl[:, :, j:j + 1], one[0])
        assert torch.equal(sp[:, :, :, j:j + 1], one[1])
        if torch.equal(snaps[s, :, b], k4[s, :, b]):
            assert torch.equal(fl[0, :, j], flags[s, :, b])
    starts = []
    for j, (b, s) in enumerate(pairs):
        top = min((s + 1) * L, bp.Ms[b])
        starts.append([top, top + bp.lws[b] + bp.W // 2,
                       (0, 2, 4)[j % (3 if dagp else 2)], s * L, j])
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
    lws_sel = bp.lws_t.index_select(0, sel.long())
    IT = dp.strip_walk_bound(L, bp.W)
    st = torch.empty((len(pairs), 2), dtype=torch.int32, device=cuda)
    r = K.spliced_tb_strips(fl, sp, starts, lws_sel, slabs, IT, stats=st)
    assert torch.equal(r, K.tb_strips_plain(fl, sp, starts, lws_sel, slabs,
                                            IT))
    col = starts[:, 4].long()
    assert torch.equal(st.cpu(), K.walk_stats(r, fl, lws_sel[col],
                                              slabs[col], starts[:, 2], col))
    assert (r[:, :, 0] != 0).any()
    torch.cuda.synchronize()


@pytest.mark.parametrize("local,cips,dagp", [(True, False, False),
                                             (False, True, False),
                                             (True, True, True)])
def test_k6_udh_on_card_equals_cpu(cuda, setup, local, cips, dagp):
    """The UDH path after a local and/or -yJ links pass on the card and on
    the CPU: one retrace-of-pairs launch and one strip launch on the
    card, never the one-slab retrace; the same scores, ends and op
    streams."""
    from spaln_tpu_torch.ops.dp_spliced_udh import run_spliced_batch_udh
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    qs, gs, ss = _problems(cfg, tables, 5, 150, 200, seed=13)
    res, n = {}, {}
    for dev in (cuda, "cpu"):
        bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=32, device=dev)
        bp = _k6(bp, cips, local)
        before = dict(K.launches)
        res[dev] = run_spliced_batch_udh(bp, p)
        n = n or {k: K.launches[k] - before[k] for k in K.KERNELS}
    np.testing.assert_array_equal(res[cuda][0], res["cpu"][0])
    np.testing.assert_array_equal(res[cuda][1], res["cpu"][1])
    assert res[cuda][2] == res["cpu"][2]
    d = "_dagp" if dagp else ""
    assert n["spliced_slab_retrace_pairs" + d] == n["spliced_tb_strips"] == 1
    assert n["spliced_slab_retrace" + d] == 0
    assert n["spliced_slab_links" + d] == 1


@pytest.mark.parametrize("dagp,L", [(False, 48), (True, 16),
                                    (False, 1000)])
def test_emission_rows_build_equals_registers_on_card(cuda, setup, dagp,
                                                      L):
    """The timing build of the local emission's store-and-scan form
    (-DSLAB_EMIT_ROWS=1, chip_smoke.py --emission-timing) gives the
    production build's outputs, the reduction from registers, on local
    buckets with the bonus: warps straddling sub-slabs (L = 48, 16 on 19
    slabs) and two lanes a thread (L = 1000)."""
    import chip_smoke
    cfg, prm, tables = setup
    p = _dagp(prm) if dagp else prm
    if L == 1000:
        qs, gs, ss = _problems(cfg, tables, 2, [L + 120, L + 60], 70,
                               seed=L)
        band = dict(lws=[-20, -24], W=48)
    else:
        qs, gs, ss = _problems(cfg, tables, 3, [300, 170, 260], 70, seed=L)
        band = dict(lws=[-20, -28, -24], W=128)
    bp = _k6(dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=L, device=cuda,
                                      **band), True, True)
    want = K.spliced_slab_trace(bp, p, emit_local=True)
    with chip_smoke._emit_rows_build(K):
        got = K.spliced_slab_trace(bp, p, emit_local=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()


def test_local_search_on_card_equals_cpu(cuda):
    """search_protein_local on the card (K1 in local mode with the
    emission, B = 64 and 6 entries, L = 64 and 32) gives the CPU run's
    hits, also with its batches cut by a small plane budget."""
    from spaln_tpu_torch.align import protein_search as PS
    from spaln_tpu_torch.seq.codec import encode_protein
    rng = np.random.default_rng(7)
    aas = list("ARNDCQEGHILKMFPSTWYV")
    blk = ["".join(rng.choice(aas, 24)), "".join(rng.choice(aas, 20))]
    q = blk[0] + "".join(rng.choice(aas, 90)) + blk[1]
    db = [(f"d{i}", "".join(rng.choice(aas, int(rng.integers(50, 400)))))
          for i in range(70)]
    for k in (3, 40, 66):
        db[k] = (f"h{k}", db[k][1][:30] + blk[0] + db[k][1][30:90] + blk[1])
    db = [(n, encode_protein(s)) for n, s in db]
    qc = encode_protein(q)

    def key(hits):
        return [(h.name, h.score, h.q_span, h.s_span, h.identity)
                for h in hits]

    kw = dict(table_dir=find_table_dir())
    for lanes in (64, 32):
        before = K.launches["spliced_slab_trace"]
        got = PS.search_protein_local(qc, db, lanes=lanes, device=cuda, **kw)
        assert K.launches["spliced_slab_trace"] - before == 2
        assert key(got) == key(PS.search_protein_local(
            qc, db, lanes=lanes, device="cpu", **kw))
        assert {h.name for h in got} >= {"h3", "h40", "h66"}
        if lanes == 64:
            before = K.launches["spliced_slab_trace"]
            cut = PS.search_protein_local(qc, db, lanes=64, device=cuda,
                                          plane_budget=64 << 20, **kw)
            assert K.launches["spliced_slab_trace"] - before > 2
            assert key(cut) == key(got)


def test_map_wide_lanes_on_card_equals_cpu(cuda, tmp_path):
    """`map --lanes 1024` on the card (two lanes a thread), on planes and
    with every multi-slab bucket on UDH (-A 3), gives the -O0,4 text of
    --device cpu (the plain versions)."""
    from spaln_tpu_torch import cli
    rng = np.random.default_rng(17)
    bases = np.array(list("ACGT"))

    def mk(n):
        return "".join(rng.choice(bases, n))

    contig, queries, pos = mk(30000), [], 2000
    for n_ex in (2, 3, 6):
        ex = [mk(int(rng.integers(150, 260))) for _ in range(n_ex)]
        g = ex[0] + "".join("GTAAGT" + mk(int(rng.integers(120, 400)))
                            + "TTTCTAG" + e for e in ex[1:])
        contig = contig[:pos] + g + contig[pos + len(g):]
        queries.append("".join(ex))
        pos += len(g) + 3000
    (tmp_path / "g.fa").write_text(">c1\n" + contig + "\n")
    (tmp_path / "q.fa").write_text("".join(f">q{i}\n{q}\n"
                                           for i, q in enumerate(queries)))
    assert cli.main(["index", str(tmp_path / "g.fa"), "-p",
                     str(tmp_path / "g")]) == 0
    texts = {}
    for dev, extra in (("cuda", []), ("cuda", ["-A", "3"]), ("cpu", [])):
        out = tmp_path / f"{dev}{len(extra)}.txt"
        assert cli.main(["map", str(tmp_path / "q.fa"), "-d",
                         str(tmp_path / "g"), "-O", "0,4", "--lanes",
                         "1024", "-o", str(out), "--device", dev,
                         *extra]) == 0
        texts[dev, len(extra)] = out.read_bytes()
    assert texts["cuda", 0] == texts["cpu", 0] == texts["cuda", 2]
    assert texts["cuda", 0].count(b"\tgene\t") == 3


# ------------------------------------------------------------ tron path
def _tron_setup(dagp):
    from spaln_tpu_torch.config import PvsG
    from spaln_tpu_torch.ops.tron_params import TronDpParams
    cfg = resolve(Config(), PvsG)
    prm = TronDpParams.build(
        cfg, Simmtx.protein(find_table_dir(), slot=0).tron().mtx)
    if dagp:
        lgep = -int(0.6 * cfg.aln.scale)
        prm = dataclasses.replace(prm, dagp=True, lgep=lgep,
                                  lgop=prm.gop - (lgep - prm.gep) * 7)
    ipen = IntronPenalty(cfg, PvsG).penalty(np.arange(20000))
    return cfg, prm, ipen


def _tron_problems(cfg, B, seed, extra=0):
    """B planted protein genes of two exons (introns at phases 0, 1, 2 in
    turn, one with a 1-nt frameshift, one with a 45-nt insertion) with
    different band placements and Local bounds; proteins of 70 + 9 b +
    ``extra`` residues."""
    from spaln_tpu_torch import constants as C
    from spaln_tpu_torch.score.codepot import build_tron_signals
    codon = {}
    for c in range(64):
        codon.setdefault(int(C.GENCODE[c]), "ACGT"[(c >> 4) & 3]
                         + "ACGT"[(c >> 2) & 3] + "ACGT"[c & 3])
    rng = np.random.default_rng(seed)
    tables = TableDir(find_table_dir())

    def mk(n):
        return "".join(rng.choice(list("ACGT"), n))

    qs, gs, ss, lws, lbs = [], [], [], [], []
    for b in range(B):
        aa = rng.choice(range(3, 23), 70 + 9 * b + extra).astype(np.int8)
        nt = "".join(codon[int(x)] for x in aa)
        cut = 90 + b % 3
        g = (mk(25 + 4 * b) + nt[:cut] + "GTAAGT" + mk(140 + 20 * b)
             + "TTTCTAG" + nt[cut:] + mk(30))
        if b == 1:
            g = g[:200] + g[201:]
        if b == 2:
            g = g[:90] + "".join(rng.choice(list("AC"), 45)) + g[90:]
        gc = encode_dna(g)
        qs.append(aa)
        gs.append(gc)
        ss.append(build_tron_signals(gc, cfg, tables))
        lws.append(-3 * len(aa) + 25 * b)
        lbs.append((60 + 10 * b, 200 + 5 * b) if b % 2 == 0
                   else (1 << 30, -(1 << 30)))
    W = max(len(g) - lw for g, lw in zip(gs, lws)) + 2
    return qs, gs, ss, lws, W, lbs


# (dagp, local, L, extra residues, forced (k, CTAs per problem)): the
# rule's geometry (None) and forced ones, 1 to 11 slabs, pieces of a
# 1,024-lane slab (3 of 342 lanes, 4 of 256 under dagp)
TRON_CASES = [
    (False, False, 64, 0, [(1, 1), (2, 2), (3, 1)]),
    (False, True, 64, 0, [(1, 1), (1, 2)]),
    (True, False, 32, 0, [(1, 1), (2, 2), (1, 4)]),
    (True, True, 64, 0, [(1, 1), (2, 1)]),
    (False, True, 9, 0, [(1, 1), (3, 4), (2, 8), (1, 3)]),
    (True, True, 9, 0, [(1, 1), (2, 3), (1, 8)]),
    (False, True, 128, 200, [(1, 1), (2, 2), (3, 3)]),
    (True, False, 256, 200, [(1, 1), (1, 2)]),
    (False, True, 1024, 0, [(1, 1), (1, 2)]),
    (True, False, 1024, 0, [(1, 1), (1, 3)]),
]


@pytest.mark.parametrize("dagp,local,L,extra,forced", TRON_CASES)
def test_tron_kernels_equal_plain_on_card(cuda, dagp, local, L, extra,
                                          forced):
    """K7 (3 and 5 states, Local on and off) at the rule's geometry and
    at forced (k, CTAs per problem) pairs, and K8, on 4 problems of 1-11
    slabs of 9-1,024 lanes: every output exactly equal to the plain
    version; the walks end."""
    from spaln_tpu_torch.ops import dp_tron as TD
    from spaln_tpu_torch.ops import dp_tron_cuda as TK
    from spaln_tpu_torch.ops.params import DpFlags
    cfg, prm, ipen = _tron_setup(dagp)
    qs, gs, ss, lws, W, lbs = _tron_problems(cfg, 4, seed=5 + L,
                                             extra=extra)
    bp = TD.prepare_tron_batch(qs, gs, ss, prm, ipen, lws=lws, W=W, L=L,
                               flags=DpFlags(local=local), loc_bounds=lbs,
                               device=cuda)
    assert bp.S >= (2 if L < 1024 else 1)
    before = dict(TK.launches)
    want = TK.tron_forward_plain(bp, prm)
    want = list(want[0]) + list(want[1:])
    got = None
    for geom in [None] + forced:
        out = TK.tron_forward(bp, prm, geometry=geom)
        for a, b in zip(list(out[0]) + list(out[1:]), want):
            assert torch.equal(a, b), geom
        got = got or out
    ends = TD.collect_tron_ends(bp, got[1].cpu().numpy(),
                                got[2].cpu().numpy(), got[3].cpu().numpy())
    et = torch.tensor([[e[1], e[2]] for e in ends], dtype=torch.int32,
                      device=cuda)
    recs, counts = TK.tron_walk(bp, got[0], et)
    precs, pcounts, pdone = TK.tron_walk_plain(bp, got[0], et)
    assert torch.equal(counts, pcounts) and bool(pdone.all())
    for b in range(bp.B):
        n = int(counts[b])
        assert n > 0 and torch.equal(recs[b, :n], precs[b, :n])
    assert TK.launches[TK.forward_entry(prm)] == \
        before[TK.forward_entry(prm)] + 1 + len(forced)
    assert TK.launches["tron_walk"] == before["tron_walk"] + 1
    torch.cuda.synchronize()


def test_refused_tron_geometry_raises(cuda):
    """A forced geometry the kernel does not take raises before a
    launch: more slabs a CTA than the thread budget holds, more CTAs
    than a portable cluster, a piece of a wide slab with k > 1."""
    from spaln_tpu_torch.ops import dp_tron as TD
    from spaln_tpu_torch.ops import dp_tron_cuda as TK
    cfg, prm, ipen = _tron_setup(False)
    for L, geom in ((128, (4, 1)), (64, (1, 9)), (1024, (2, 1))):
        qs, gs, ss, lws, W, lbs = _tron_problems(cfg, 2, seed=1)
        bp = TD.prepare_tron_batch(qs, gs, ss, prm, ipen, lws=lws, W=W,
                                   L=L, loc_bounds=lbs, device=cuda)
        before = dict(TK.launches)
        with pytest.raises(ValueError, match="geometry"):
            TK.tron_forward(bp, prm, geometry=geom)
        assert TK.launches == before


def test_protein_map_on_card_equals_cpu(cuda, tmp_path):
    """`index -K P` + `map` of 3 planted protein genes (one on the minus
    strand) on the card, default and -y l3, gives the -O0,4 text of
    --device cpu (the plain versions)."""
    from spaln_tpu_torch import cli
    from spaln_tpu_torch import constants as C
    from spaln_tpu_torch.ops import dp_tron_cuda as TK
    codon = {}
    for c in range(64):
        codon.setdefault(int(C.GENCODE[c]), "ACGT"[(c >> 4) & 3]
                         + "ACGT"[(c >> 2) & 3] + "ACGT"[c & 3])
    rng = np.random.default_rng(23)
    amino = "ARNDCQEGHILKMFPSTWYV"
    from spaln_tpu_torch.seq.codec import encode_protein

    def mk(n):
        return "".join(rng.choice(list("ACGT"), n))

    contig, prots = mk(2000), []
    for k, n_aa in enumerate((80, 110, 95)):
        p = "M" + "".join(rng.choice(list(amino), n_aa - 1))
        nt = "".join(codon[int(x)] for x in encode_protein(p)) + "TAA"
        c1, c2 = 70 + k, 160 + 2 * k
        g = (nt[:c1] + "GTAAGT" + mk(300) + "TTTCAG" + nt[c1:c2]
             + "GTAAGT" + mk(200 + 50 * k) + "TTTCAG" + nt[c2:])
        if k == 1:
            g = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
        contig += g + mk(3000)
        prots.append(p)
    (tmp_path / "g.fa").write_text(">c1\n" + contig + "\n")
    (tmp_path / "p.fa").write_text("".join(f">p{i}\n{p}\n"
                                           for i, p in enumerate(prots)))
    assert cli.main(["index", str(tmp_path / "g.fa"), "-p",
                     str(tmp_path / "g"), "-K", "P"]) == 0
    for extra in ([], ["-y", "l3"]):
        texts = {}
        before = dict(TK.launches)
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"{dev}{len(extra)}.txt"
            assert cli.main(["map", str(tmp_path / "p.fa"), "-d",
                             str(tmp_path / "g"), "-O", "0,4", "-o",
                             str(out), "--device", dev, *extra]) == 0
            texts[dev] = out.read_bytes()
        assert texts["cuda"] == texts["cpu"]
        assert texts["cuda"].count(b"\tgene\t") == 3
        assert TK.launches["tron_walk"] > before["tron_walk"]


# ---------------------------------------------------------------- probes
@pytest.mark.parametrize("name", PROBES)
def test_probe_kernels_equal_plain_on_card(cuda, name):
    """Every body of a step probe (csrc/probes.cu) equal to its plain
    version on the card, 64 steps on the script's inputs, at 128, 256,
    512 and 1024 threads: the CTA's size changes nothing."""
    m = importlib.import_module(f"spaln_tpu_torch.probes.{name}")
    for c in m.cases(cuda):
        want = c.plain(64)
        for th in PC.THREADS:
            before = PC.launches.get(f"{c.entry}:{c.body}", 0)
            got = c.run(64, th)
            assert torch.equal(got, want), (c.body, th)
            assert PC.launches[f"{c.entry}:{c.body}"] == before + 1


def test_probe_launch_refuses_a_thread_count(cuda):
    from spaln_tpu_torch.probes import pallas_probe
    x = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    tab = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pallas_probe.run("base", x, tab, 4, threads=96)
    with pytest.raises(ValueError, match="shape"):
        pallas_probe.run("take1k_along", x, tab, 4)


def test_knockout_none_build_equals_production(cuda):
    """The SLAB_ABLATE=0 build of spliced_dp.cu (a library of its own)
    gives the production score kernel's (row, rc) on the search batch of
    chip_smoke.py's phase 1; a knocked-out build launches too, under the
    same C entry."""
    import chip_smoke
    from spaln_tpu_torch.probes import ablate_pallas
    bp, prm = chip_smoke._protein_batch(dp)
    want = K.spliced_slab_score(bp, prm)
    got = K.spliced_slab_score(bp, prm, ablate_pallas.defines("none"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K._library(ablate_pallas.defines("none")) is not K._library()
    K.spliced_slab_score(bp, prm, ablate_pallas.defines("noclose"))
    torch.cuda.synchronize()


# (registers a thread, spill stores, spill loads) of every instance of the
# production spliced_dp.cu, from nvcc 12.8's -Xptxas -v on the card:
# slab_kernel<MODE, DAGP, MULTI, MAXT, P, K6>, K6 = 0 off (the main
# path), 1 the local and -yJ modes, 2 those with the local emission
# (trace mode), 3 the retrace of (problem, slab) pairs (trace mode, no
# cluster).  Read off the card when the emission got instances of its
# own and the pairs theirs: every K6 = 0 instance, the links and score
# modes' and the walks' as before; the K6 = 1 trace instances without
# the emission's code (fewer registers or spills than before); the
# K6 = 2 instances as the emission's reduction from registers has them;
# tb_walk_kernel's as the warp-a-walk band walk has them; K2e's
# last_ends_kernel and the fused ends_tb_walk_kernel as the warp-shuffle
# end reduction has them
SLAB_PTXAS = {
    "slab_kernel<2,0,0,1024,2,0>": (64, 88, 116),
    "slab_kernel<2,0,1,1024,2,0>": (64, 100, 124),
    "slab_kernel<2,0,0,1024,1,0>": (64, 0, 0),
    "slab_kernel<2,0,1,1024,1,0>": (63, 0, 0),
    "slab_kernel<2,1,0,512,2,0>": (125, 0, 0),
    "slab_kernel<2,1,1,512,2,0>": (127, 0, 0),
    "slab_kernel<2,1,0,512,1,0>": (103, 0, 0),
    "slab_kernel<2,1,1,512,1,0>": (97, 0, 0),
    "slab_kernel<1,1,0,512,2,1>": (128, 0, 0),
    "slab_kernel<1,1,1,512,2,1>": (128, 12, 12),
    "slab_kernel<1,1,0,512,1,1>": (120, 0, 0),
    "slab_kernel<1,1,1,512,1,1>": (128, 0, 0),
    "slab_kernel<1,1,0,512,2,0>": (127, 0, 0),
    "slab_kernel<1,1,1,512,2,0>": (128, 0, 0),
    "slab_kernel<1,1,0,512,1,0>": (122, 0, 0),
    "slab_kernel<1,1,1,512,1,0>": (128, 0, 0),
    "slab_kernel<1,0,0,512,2,1>": (118, 0, 0),
    "slab_kernel<1,0,1,512,2,1>": (128, 0, 0),
    "slab_kernel<1,0,0,512,1,1>": (112, 0, 0),
    "slab_kernel<1,0,1,512,1,1>": (120, 0, 0),
    "slab_kernel<1,0,0,512,2,0>": (122, 0, 0),
    "slab_kernel<1,0,1,512,2,0>": (128, 0, 0),
    "slab_kernel<1,0,0,512,1,0>": (108, 0, 0),
    "slab_kernel<1,0,1,512,1,0>": (116, 0, 0),
    "slab_kernel<0,1,0,640,2,1>": (96, 32, 36),
    "slab_kernel<0,1,0,640,2,2>": (96, 68, 112),
    "slab_kernel<0,1,0,640,2,3>": (96, 28, 36),
    "slab_kernel<0,1,1,640,2,1>": (96, 60, 80),
    "slab_kernel<0,1,1,640,2,2>": (96, 76, 140),
    "slab_kernel<0,1,0,640,1,1>": (95, 0, 0),
    "slab_kernel<0,1,0,640,1,2>": (96, 0, 0),
    "slab_kernel<0,1,0,640,1,3>": (85, 0, 0),
    "slab_kernel<0,1,1,640,1,1>": (94, 0, 0),
    "slab_kernel<0,1,1,640,1,2>": (96, 0, 0),
    "slab_kernel<0,1,0,640,2,0>": (96, 28, 36),
    "slab_kernel<0,1,1,640,2,0>": (96, 48, 60),
    "slab_kernel<0,1,0,640,1,0>": (88, 0, 0),
    "slab_kernel<0,1,1,640,1,0>": (95, 0, 0),
    "slab_kernel<0,0,0,896,2,1>": (72, 76, 136),
    "slab_kernel<0,0,0,896,2,2>": (72, 140, 272),
    "slab_kernel<0,0,0,896,2,3>": (72, 76, 128),
    "slab_kernel<0,0,1,896,2,1>": (72, 96, 156),
    "slab_kernel<0,0,1,896,2,2>": (72, 116, 220),
    "slab_kernel<0,0,0,896,1,1>": (70, 0, 0),
    "slab_kernel<0,0,0,896,1,2>": (72, 0, 0),
    "slab_kernel<0,0,0,896,1,3>": (70, 0, 0),
    "slab_kernel<0,0,1,896,1,1>": (70, 0, 0),
    "slab_kernel<0,0,1,896,1,2>": (72, 4, 4),
    "slab_kernel<0,0,0,896,2,0>": (72, 76, 128),
    "slab_kernel<0,0,1,896,2,0>": (72, 108, 164),
    "slab_kernel<0,0,0,896,1,0>": (70, 0, 0),
    "slab_kernel<0,0,1,896,1,0>": (68, 0, 0),
    "ends_tb_walk_kernel": (48, 0, 0),
    "tb_walk_kernel": (50, 0, 0),
    "last_ends_kernel": (39, 0, 0),
}


def _ptxas_pins(log: str) -> dict:
    """kernel instance -> [registers, spill stores, spill loads] from an
    nvcc -Xptxas -v log."""
    import re
    import chip_smoke
    got, name = {}, None
    for line in chip_smoke._ptxas_report(log):
        if not line.startswith("  "):
            name = line
            got[name] = [0, 0, 0]
        elif "registers" in line:
            got[name][0] = int(re.search(r"Used (\d+) registers", line)[1])
        elif "spill" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            got[name][1:] = [int(m[1]), int(m[2])]
    return {k: tuple(v) for k, v in got.items()}


def test_tron_walk_registers_pinned(cuda):
    """K8's walk kernel (a warp a problem on bands staged in shared
    memory) keeps the registers and no spills nvcc -Xptxas -v gave it on
    the card."""
    from spaln_tpu_torch.ops import dp_tron_cuda as TK
    _, _, log = TK.build_library(TK.SOURCE)
    assert _ptxas_pins(log)["tron_walk_kernel"] == (64, 0, 0)


def test_production_registers_unchanged(cuda):
    """Every instance of the production spliced_dp.cu keeps the registers
    and spills nvcc -Xptxas -v gave it on the card (SLAB_PTXAS)."""
    _, _, log = K.build_library()
    assert _ptxas_pins(log) == SLAB_PTXAS


# ------------------------------------------- skeletons, pieces, the bench
def test_skeleton_levels_equal_plain_on_card(cuda):
    """Every mosaic_repro level the script distinguishes, at the script's
    inputs and shapes (B=16; 32-46 at B=8) and at 3 chunks with --sop8's
    stack: all four outputs equal to the plain version's on the card."""
    from spaln_tpu_torch.probes import mosaic_repro as MR
    for lev in MR.LEVELS:
        B = MR.script_B(lev)
        for chunks, sop8 in ((MR.N_CHUNKS, False), (3, True)):
            a = MR.level_inputs(lev, MR.inputs(B, chunks, sop8), cuda)
            before = MR.launches.get(f"level{lev}", 0)
            got = MR.run(lev, a, chunks)
            want = MR.plain(lev, a, chunks)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), lev
            assert MR.launches[f"level{lev}"] == before + 1


def test_kernel_piece_builds_on_card(cuda):
    """Every variant build of bisect_mosaic launches on its batch ("orig"
    equal to the production kernel), and the production build at each
    forced k of time_kernel_pieces gives the production geometry's
    outputs."""
    from spaln_tpu_torch.probes import ablate_pallas as AB
    from spaln_tpu_torch.probes import bisect_mosaic as BM
    from spaln_tpu_torch.probes import time_kernel_pieces as TKP
    AB.build_all(AB.BUILDS)
    bp, prm = BM.bisect_batch(cuda)
    res = BM.bisect(bp, prm, list(BM.VARIANTS))
    assert all(r == "PASS" for v, r in res.items()
               if BM.VARIANTS[v] is not None), res
    t = AB.ablate(bp, prm, [], TKP.TILINGS, reps=1)["knockouts"]
    assert set(t) == {"none", "k=1", "k=2", "k=4"}


def test_bench_scores_equal_plain_on_card(cuda):
    """The bench's workload at a cut size on the card: its scores (held
    inside against the plain version on the card) equal the plain
    version's on the CPU."""
    from spaln_tpu_torch import bench
    bp, prm = bench.bench_batch(4, 96, 2048, cuda)
    res = bench.measure(bp, prm, iters=2)
    cbp, cprm = bench.bench_batch(4, 96, 2048, "cpu")
    want = bench.scores_of(cbp, cprm, K.spliced_slab_score(cbp, cprm))
    assert np.array_equal(res["scores"], want)
    assert res["max_abs_err"] == 0
    assert res["value"] > 0 and res["device"] == torch.cuda.get_device_name()


def test_bench_holds_row_rc_not_only_scores(cuda, monkeypatch):
    """A plain (row, rc) one lower at each problem's smallest row cell
    leaves every score as it was, and the bench still refuses it."""
    from spaln_tpu_torch import bench
    bp, prm = bench.bench_batch(4, 96, 2048, cuda)
    plain = K.slab_score_plain

    def off(bp, prm):
        row, rc = plain(bp, prm)
        row = row.clone()
        j = row.argmin(dim=1)
        row[torch.arange(row.shape[0]), j] -= 1
        return row, rc
    assert np.array_equal(bench.scores_of(bp, prm, off(bp, prm)),
                          bench.scores_of(bp, prm, plain(bp, prm)))
    monkeypatch.setattr(K, "slab_score_plain", off)
    with pytest.raises(AssertionError, match="by up to 1"):
        bench.measure(bp, prm, iters=1)


# ------------------------------------------- tools and data parallelism
def test_fit_ild_on_card_equals_cpu(cuda):
    """fit_ild on the card (torch.optim.Adam over autograd, the best
    step kept on the device) within the fit tolerance of the CPU fit:
    NLL relative 1e-5, weights absolute 0.005, theta and kappa relative
    1%, mu within 1% of its component's theta."""
    from spaln_tpu_torch.tools.fitild import fit_ild, sample_frechet_mixture
    lens = sample_frechet_mixture(np.random.default_rng(2), 4000,
                                  [0.7, 0.3], [30., 30.], [60., 600.],
                                  [1.2, 1.8])
    got = fit_ild(lens, n_modes=2, steps=1500)
    want = fit_ild(lens, n_modes=2, steps=1500, device="cpu")
    assert got.n == want.n == 4000
    assert abs(got.nll - want.nll) <= 1e-5 * abs(want.nll)
    for g, w in zip(got.weights, want.weights):
        assert abs(g - w) <= 0.005
    for key in ("thetas", "kappas"):
        for g, w in zip(getattr(got, key), getattr(want, key)):
            assert abs(g - w) <= 0.01 * abs(w)
    for g, w, th in zip(got.mus, want.mus, want.thetas):
        assert abs(g - w) <= 0.01 * th


@pytest.mark.parametrize("udh", [False, True])
def test_two_shard_map_on_card_equals_unsharded(cuda, udh):
    """map_queries_sharded on [cuda:0, cuda:0] (every batch in two
    shards run at once, plane buckets or -A 3's UDH ones) gives the
    unsharded map's gene structures, on the kernels."""
    from spaln_tpu_torch.align.driver import AlignerContext
    from spaln_tpu_torch.align.mapper import GenomeMapper
    from spaln_tpu_torch.constants import DNA
    from spaln_tpu_torch.parallel import map_queries_sharded
    from spaln_tpu_torch.seed.blockindex import BlockIndex
    from spaln_tpu_torch.seq.fasta import SeqRecord
    from spaln_tpu_torch.seq.genome import GenomeStore
    from spaln_tpu_torch.utils.metrics import metrics
    rng = np.random.default_rng(42)
    bases = np.array(list("ACGT"))

    def mk(n):
        return "".join(rng.choice(bases, n))

    contigs, queries = [], []
    for ci in range(3):
        parts = [mk(2000)]
        for _ in range(3):
            e1, e2 = mk(int(rng.integers(150, 300))), mk(130)
            parts += [e1 + "GTAAGT" + mk(int(rng.integers(100, 300)))
                      + "TTTCTAG" + e2, mk(1500)]
            queries.append(encode_dna(e1 + e2))
        contigs.append(SeqRecord(name=f"c{ci}", molc=DNA,
                                 codes=encode_dna("".join(parts))))
    store = GenomeStore.from_records(contigs)
    ctx = AlignerContext.create(TableDir(find_table_dir()), cuda,
                                force_udh=udh)
    mapper = GenomeMapper(store, BlockIndex.build(store), ctx)

    def key(res):
        return [[(g.g_name, g.strand, g.score,
                  [(e.g_start, e.g_end) for e in g.exons]) for g in r]
                for r in res]
    want = mapper.map_queries(queries, lanes=64, max_batch=8)
    metrics.reset()
    before = dict(K.launches)
    got = map_queries_sharded(mapper, queries, lanes=64, max_batch=8,
                              devices=[torch.device("cuda", 0)] * 2)
    assert metrics.counters.get("sharded_batches", 0) >= 1
    first = "spliced_slab_links" if udh else "spliced_slab_trace"
    assert K.launches[first] - before[first] >= 2
    assert key(got) == key(want)
    assert sum(map(bool, got)) == 9


def test_entry_and_dryrun_on_card(cuda):
    """entry()'s K5 forward on the card equals its plain version's rows;
    dryrun_multichip(1) runs over NCCL."""
    from spaln_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry()
    assert args[0].device.type == "cuda"
    fn_c, args_c = entry("cpu")
    assert torch.equal(fn(*args).cpu(), fn_c(*args_c))
    dryrun_multichip(1)
