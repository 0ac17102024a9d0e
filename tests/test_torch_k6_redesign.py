"""K6's two device costs as the port runs them on the H100, on the CPU:
the UDH retrace after a local or -yJ links pass as launches of (problem,
slab) pairs (pair_launches, the plain version of
spliced_slab_retrace_pairs, K3's strips with a slab a walk), held
against the one-slab retrace it replaces, K1's planes and spaln_tpu's
UDH path; and K1's local emission reduced from registers in two levels
(emission_partials: a (best, first lane) partial a warp and sub-slab,
then a combine a sub-slab) against the plain emission.  All integer: the tolerance is
exact.

Tables come from find_table_dir() (the vendored data_tables/).
"""
import dataclasses

import numpy as np
import pytest
import torch

from spaln_tpu.ops import dp_spliced_scan as ref_scan
from spaln_tpu.ops import dp_spliced_udh as ref_udh
from spaln_tpu.ops.params import DpFlags
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch.ops import dp_spliced as port_dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops import dp_spliced_udh as port_udh
from spaln_tpu_torch.ops.convert import params_from_reference
from spaln_tpu_torch.ops.dp_spliced_udh import pair_launches

from test_torch_local import one_thread, prms  # noqa: F401
from test_torch_udh import _gene

NEV = port_dp.NEV


# ------------------------------------------------------- the launch plan
def _runs(rng):
    runs = []
    for i in range(int(rng.integers(1, 40))):
        sf = int(rng.integers(0, 20))
        runs.append((i, int(rng.integers(0, sf + 1)), sf))
    return runs


@pytest.mark.parametrize("seed", range(30))
def test_pair_launches_cover_every_pair_once(seed):
    """Random runs (problem, first slab, end slab) and budgets in
    problem-slabs: every (problem, slab) pair of every run in exactly one
    launch, no launch past the budget, and as few launches as the budget
    allows."""
    rng = np.random.default_rng(seed)
    runs = _runs(rng)
    max_ps = int(rng.integers(1, 500))
    launches = pair_launches(runs, max_ps)
    flat = [p for pairs in launches for p in pairs]
    want = [(i, s) for i, a, b in runs for s in range(a, b + 1)]
    assert sorted(flat) == sorted(want) and len(set(flat)) == len(flat)
    assert all(1 <= len(pairs) <= max_ps for pairs in launches)
    assert len(launches) == -(-len(want) // max_ps)


@pytest.mark.parametrize("dagp,max_ps,sizes", [
    (False, None, [384]),                 # 13 B a cell: one launch
    (True, None, [384]),                  # 21 B a cell: one launch
    (False, 100, [100, 100, 100, 84])])   # a budget that splits
def test_pair_launches_of_a_tetrapod_bucket(dagp, max_ps, sizes):
    """32 problems of 12 slabs at tetrapod width (T = 16,638, L = 128):
    the 384 pairs fit the default plane budget in one launch, single and
    double affine; a smaller budget cuts them into its fewest pieces."""
    T, L = 16638, 128
    cell = 21 if dagp else 13
    if max_ps is None:
        max_ps = port_dp.PLANE_BYTES_BUDGET // (T * L * cell)
    launches = pair_launches([(i, 0, 11) for i in range(32)], max_ps)
    assert [len(p) for p in launches] == sizes


# ------------------------------------------- the retrace of pairs, plain
@pytest.fixture(scope="module")
def bucket(prms, table_dir):
    """Three planted two-exon genes at L = 16 (queries of 70-90 nt: five
    or six slabs), a band of 128 columns, on the CPU; per gap model the
    port's K1 and K4 plain runs."""
    cfg, p = prms
    rng = np.random.default_rng(15)
    qs, gs = [], []
    for k in range(3):
        q, g = _gene(rng, (40 + 5 * k, 35 + 5 * k), (60 + 10 * k,),
                     mut=0.03)
        qs.append(encode_dna(q))
        gs.append(encode_dna(g))
    sigs = [build_splice_signals(g, cfg, table_dir) for g in gs]
    out = {}
    for dagp in (False, True):
        pprm = params_from_reference(p[dagp])
        bp = port_dp.prepare_spliced_batch(qs, gs, pprm, sigs=sigs, L=16,
                                           lws=[-20, -26, -23], W=128)
        out[dagp] = dict(bp=bp, pprm=pprm,
                         k1=K.spliced_slab_trace(bp, pprm),
                         snaps=K.spliced_slab_links(bp, pprm)[1])
    return out


def _pairs(bp, rng):
    """Every (problem, slab) pair of the bucket, in a random order."""
    pairs = [(b, s) for b in range(bp.B) for s in range(bp.S)]
    return [pairs[i] for i in rng.permutation(len(pairs))]


def _pairs_args(snaps, pairs):
    ids = torch.tensor(pairs, dtype=torch.int32).T.contiguous()
    sel, slabs = ids[0].contiguous(), ids[1].contiguous()
    snap = snaps[slabs.long(), :, sel.long()].transpose(0, 1).contiguous()
    return slabs, snap, sel


@pytest.mark.parametrize("dagp", [False, True], ids=["single", "dagp"])
def test_retrace_pairs_equals_one_slab_retraces(bucket, dagp):
    """The retrace of pairs (its plain version, as the wrapper runs it on
    the CPU) in one call: pair j's planes in column j, equal to the
    one-slab retrace of that slab from the same snapshot (the route it
    replaces) and to K1's planes of that slab and problem."""
    r = bucket[dagp]
    bp, pprm, (flags, spj, _, _) = r["bp"], r["pprm"], r["k1"]
    assert bp.S >= 5
    pairs = _pairs(bp, np.random.default_rng(3))
    slabs, snap, sel = _pairs_args(r["snaps"], pairs)
    name = K.entry("spliced_slab_retrace_pairs", pprm)
    before = K.plain_calls[name]
    fl, sp = K.spliced_slab_retrace_pairs(bp, pprm, slabs, snap, sel)
    assert K.plain_calls[name] == before + 1
    assert fl.shape == (1, bp.T, len(pairs), bp.L)
    assert sp.shape == (1, port_dp.n_states(pprm), bp.T, len(pairs), bp.L)
    for j, (b, s) in enumerate(pairs):
        one = K.spliced_slab_retrace(bp, pprm, s, 1,
                                     snap[:, j:j + 1].contiguous(),
                                     sel[j:j + 1].contiguous())
        assert torch.equal(fl[:, :, j:j + 1], one[0])
        assert torch.equal(sp[:, :, :, j:j + 1], one[1])
        assert torch.equal(fl[0, :, j], flags[s, :, b])
        assert torch.equal(sp[0, :, :, j], spj[s, :, :, b])
    assert (sp > 0).any()                        # introns closed


def test_retrace_pairs_refuses_k6_modes(bucket):
    """Like the one-slab retrace, the retrace of pairs runs neither the
    local mode nor the -yJ bonus (the reference's retrace drops both)."""
    r = bucket[False]
    bp, pprm = r["bp"], r["pprm"]
    slabs, snap, sel = _pairs_args(r["snaps"], [(0, 0), (1, 2)])
    local = dataclasses.replace(bp, flags=dataclasses.replace(bp.flags,
                                                              local=True))
    with pytest.raises(ValueError, match="retrace"):
        K.spliced_slab_retrace_pairs(local, pprm, slabs, snap, sel)


@pytest.mark.parametrize("dagp", [False, True], ids=["single", "dagp"])
def test_strips_with_a_slab_a_walk(bucket, dagp):
    """K3's strip mode over the planes of a retrace of pairs, each walk
    in its own column's slab (s0 a tensor): the same records as the same
    walks over K1's full planes, and the same steps and tile loads
    (walk_stats with a slab a walk)."""
    r = bucket[dagp]
    bp, pprm, (flags, spj, _, _) = r["bp"], r["pprm"], r["k1"]
    L = bp.L
    pairs = _pairs(bp, np.random.default_rng(4))
    slabs, snap, sel = _pairs_args(r["snaps"], pairs)
    fl, sp = K.spliced_slab_retrace_pairs(bp, pprm, slabs, snap, sel)
    states = (0, 2, 4) if dagp else (0, 2)
    starts, full = [], []
    for j, (b, s) in enumerate(pairs):
        top = min((s + 1) * L, bp.Ms[b])
        row = [top, top + bp.lws[b] + bp.W // 2, states[j % len(states)],
               s * L]
        starts.append(row + [j])
        full.append(row + [b])
    starts = torch.tensor(starts, dtype=torch.int32)
    full = torch.tensor(full, dtype=torch.int32)
    IT = port_dp.strip_walk_bound(L, bp.W)
    lws = bp.lws_t.index_select(0, sel.long())
    st = torch.empty((len(pairs), 2), dtype=torch.int32)
    got = K.spliced_tb_strips(fl, sp, starts, lws, slabs, IT, stats=st)
    st_full = torch.empty_like(st)
    want = K.spliced_tb_strips(flags, spj, full, bp.lws_t, 0, IT,
                               stats=st_full)
    assert torch.equal(got, want)
    assert torch.equal(st, st_full)
    assert (got[:, :, 0] != 0).any() and (st[:, 0] > 1).any()


@pytest.mark.parametrize("local,cip,dagp", [
    (True, False, False), (False, True, False), (True, True, False),
    (True, True, True)], ids=["local", "cip", "local_cip", "local_cip_dagp"])
def test_udh_retrace_of_pairs_equals_reference(prms, table_dir, local, cip,
                                               dagp):
    """The UDH path after a local and/or -yJ links pass (two multi-slab
    problems at L = 32, bonuses near their junctions): at the default
    plane budget one retrace-of-pairs call and one strip call, at a
    budget of one pair a call as many calls as pairs; the op streams,
    scores and ends of both equal spaln_tpu's UDH path (its retrace
    re-runs every slab from its own snapshot, without either mode)."""
    cfg, p = prms
    prm = p[dagp]
    pprm = params_from_reference(prm)
    qs, gs = [], []
    for s in (0, 1):
        q, g = _gene(np.random.default_rng(s), (60, 80, 50), (150, 120),
                     mut=0.08)
        qs.append(encode_dna(q))
        gs.append(encode_dna(g))
    sigs = [build_splice_signals(g, cfg, table_dir) for g in gs]
    cips = ([{55: 600, 57: 600, 138: 600, 143: 600}, {61: 300, 140: 900}]
            if cip else None)
    flags = DpFlags(local=local)
    rbp = ref_scan.prepare_spliced_batch(qs, gs, prm, sigs=sigs, L=32,
                                         flags=flags, cips=cips)
    s_ref, e_ref, ops_ref = ref_udh.run_spliced_batch_udh(rbp, prm,
                                                          engine="scan")
    bp = port_dp.prepare_spliced_batch(qs, gs, pprm, sigs=sigs, L=32,
                                       flags=flags, cips=cips)
    name = K.entry("spliced_slab_retrace_pairs", pprm)
    one_pair = bp.T * bp.L * port_dp.plane_bytes_per_cell(pprm)
    calls = {}
    for budget in (port_dp.PLANE_BYTES_BUDGET, one_pair):
        before = dict(K.plain_calls)
        s, e, ops = port_udh.run_spliced_batch_udh(bp, pprm, budget)
        calls[budget] = {k: K.plain_calls[k] - before[k]
                         for k in (name, "spliced_tb_strips",
                                   K.entry("spliced_slab_retrace", pprm))}
        np.testing.assert_array_equal(s, np.asarray(s_ref))
        assert [tuple(x) for x in e] == [tuple(int(v) for v in x)
                                         for x in e_ref]
        assert ops == ops_ref
    assert all(any(o[0] == "I" for o in x) for x in ops_ref)
    n_pairs = calls[one_pair][name]
    assert calls[port_dp.PLANE_BYTES_BUDGET] == {
        name: 1, "spliced_tb_strips": 1,
        K.entry("spliced_slab_retrace", pprm): 0}
    assert n_pairs >= 2 * 2 and calls[one_pair]["spliced_tb_strips"] == \
        n_pairs


# ------------------------------------------------- the local emission
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("L", [48, 64, 96, 128])
def test_emission_partials_equal_plain_emission(L, P):
    """The kernel's two-level reduction of the local emission
    (emission_partials: per (warp, sub-slab) partials, then one combine
    a sub-slab) gives the plain emission's best and first lane at every
    sub-slab that steps there and nowhere else, with no two partials in
    one slot and every slot below EMIT_SLOTS, for every k the trace
    instance runs (P = 1: up to its 896 threads, warps straddling
    sub-slabs where L is not a multiple of 32; P = 2: one sub-slab, two
    lanes a thread), with ties within and across warps and across a
    thread's two lanes, inactive lanes (NEV), sub-slabs wholly inactive,
    and sub-slabs not yet started or done."""
    rng = np.random.default_rng(L * 10 + P)
    ks = range(1, 896 // max(L, 128) + 1) if P == 1 else [1]
    T = 300
    for k in ks:
        KL = k * L
        nthr = -(-KL // P)
        for trial in range(24):
            h = rng.integers(-2, 3, KL).astype(np.int64) * 10
            if trial % 4 == 1:                    # inactive lanes
                h[rng.random(KL) < 0.4] = NEV
            elif trial % 4 == 2:                  # ties across warps
                h[:] = 0
                h[rng.choice(KL, 3, replace=False)] = 50
                if P == 2:                        # and a thread's lanes
                    g = int(rng.integers(0, KL - nthr))
                    h[[g, g + nthr]] = 60
            elif trial % 4 == 3:                  # a sub-slab inactive
                j = trial // 4 % k
                h[j * L:(j + 1) * L] = NEV
            tau = int(rng.integers(0, T + 2 * k * L))
            slabs = k if trial % 7 else max(1, k - 1)
            out, slots = K.emission_partials(h, L, k, P, tau, T, slabs)
            want = {j for j in range(slabs) if 0 <= tau - 2 * j * L < T}
            assert set(out) == want
            assert all(s < K.EMIT_SLOTS for s in slots)
            for j, (bv, bi) in out.items():
                b, f = K.local_emission_plain(
                    torch.tensor(h[j * L:(j + 1) * L]))
                assert (bv, bi) == (int(b), int(f))


@pytest.mark.parametrize("dagp", [False, True])
def test_emission_geometry(dagp):
    """A trace launch with the emission takes EMIT_INTS ints more shared
    memory than without, within the card's, at the same k or a smaller
    one, and its warps plus sub-slabs fit EMIT_SLOTS partials: the local
    search's protein slabs (A = 25) up to L = 256, and every L the kernel
    takes for DNA."""
    maxt = K.SLAB_MAX_THREADS["trace", dagp]
    n = 0
    for A, top in ((25, 256), (5, 2 * maxt)):
        for L in range(3, top + 1):
            for S in (1, 6, 12):
                try:
                    k0 = K.slab_geometry("trace", dagp, L, A, S)[0]
                except ValueError:          # past the shared memory
                    continue
                n += 1
                k, threads, smem = K.slab_geometry("trace", dagp, L, A, S,
                                                   emit=True)
                base = K.slab_smem("trace", dagp, k * L, A)
                assert 1 <= k <= k0
                assert smem == base + 4 * K.EMIT_INTS <= K.SMEM_MAX
                assert -(-threads // 32) + k <= K.EMIT_SLOTS
    assert n > 1000
