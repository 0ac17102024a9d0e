"""The slab kernel's geometry and the order its tall schedule relies on,
on the CPU (no card, no kernel).

csrc/spliced_dp.cu runs k consecutive slabs of a problem in one CTA at
once: sub-slab j of a round is at its local step t = tau - 2*j*L at the
round's global step tau.  Lane 0 of every sub-slab reads the previous
slab's last row from the boundary row in global memory, which lane L-1
of each slab writes for its active cells.  The kernel's outputs equal
the slabs' sequential order only if every such read sees every write of
the earlier slabs and none of the later ones; K4's snapshots are the
values lane 0 reads (and one column copied at the round's start).  A
problem's rounds may run on a cluster of CTAs, each round at most as far
as the previous round's published progress allows.  A model of the
orders, in global steps, checks that for random geometries, together
with slab_geometry's and slab_ctas' limits, the retrace's own choice of
k and CTAs (retrace_geometry) and the UDH retrace's launches of whole
slab runs within the plane budget (retrace_launches).
"""
import numpy as np
import pytest

from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops.dp_spliced_udh import retrace_launches

MODES = ("trace", "links", "score")


@pytest.mark.parametrize("A", [5, 25])
@pytest.mark.parametrize("L", [3, 16, 32, 128, 256])
@pytest.mark.parametrize("dagp", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_geometry_within_card_limits(mode, dagp, L, A):
    maxt = K.SLAB_MAX_THREADS[mode, dagp]
    for S in range(1, 41):
        k, threads, smem = K.slab_geometry(mode, dagp, L, A, S)
        assert 1 <= k <= S
        assert threads == k * L <= min(maxt, 1024)   # one lane a thread
        assert k * max(L, K.K_LANES) <= maxt or k == 1
        assert smem == K.slab_smem(mode, dagp, threads, A) <= K.SMEM_MAX
        if k < min(maxt // max(L, K.K_LANES), S):       # cut by memory
            assert K.slab_smem(mode, dagp, (k + 1) * L, A) > K.SMEM_MAX


@pytest.mark.parametrize("mode,dagp,k", [("trace", False, 7),
                                         ("trace", True, 5),
                                         ("links", False, 4),
                                         ("links", True, 4)])
def test_main_path_runs_k_slabs_in_flight(mode, dagp, k):
    """At the map's L = 128, the cDNA alphabet (17) and the protein one
    (25), K1 and K4 run k >= 4 slabs of a problem at once."""
    for A in (17, 25):
        assert K.slab_geometry(mode, dagp, 128, A, 40)[0] == k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dagp", [False, True])
@pytest.mark.parametrize("L", [600, 897, 1000, 1023, 1024])
def test_geometry_takes_wide_slabs(mode, dagp, L):
    """Slabs of more lanes than an instance's thread budget run one slab
    per CTA, each thread carrying P = ceil(L / budget) <= 2 lanes (v =
    thread + p * threads), so every mode takes L up to 1024 at the cDNA
    alphabet (17), with threads within its __launch_bounds__."""
    maxt = K.SLAB_MAX_THREADS[mode, dagp]
    for S in (1, 2, 9):
        k, threads, smem = K.slab_geometry(mode, dagp, L, 17, S)
        P = -(-k * L // threads)
        assert threads <= maxt and P <= K.LANES_PER_THREAD
        assert threads == -(-k * L // P) and (P - 1) * threads < k * L
        assert (k, P) == ((1, 2) if L > maxt else (k, 1))
        assert smem == K.slab_smem(mode, dagp, k * L, 17) <= K.SMEM_MAX


@pytest.mark.parametrize("mode,L,A,match", [("trace", 2, 17, "lanes"),
                                            ("links", 1025, 17, "lanes"),
                                            ("score", 128, 300, "alphabet"),
                                            ("score", 1024, 200,
                                             "shared memory")])
def test_geometry_refuses(mode, L, A, match):
    with pytest.raises(ValueError, match=match):
        K.slab_geometry(mode, False, L, A, 4)


def _writes(L, W, T, M, N, m0, lw):
    """Columns lane L-1 of the slab at row m0 writes at local steps
    0..T-1 (-1 where its cell is inactive)."""
    t = np.arange(T)
    col = m0 + lw + 1 + t - (L - 1)
    r_off = t - 2 * (L - 1)
    act = ((r_off >= 0) & (r_off < W) & (col >= 1) & (col <= N)
           & (m0 + L - 1 <= M))
    return np.where(act, col, -1)


def _round_times(T, L, k, nslab, ncta):
    """Time of every global step of every round when the rounds run on
    ncta CTAs as early as the kernel lets them: round r runs on CTA
    r % ncta after that CTA's previous round, one step a time unit, and
    before its steps tau0 .. tau0+C-1 (tau0 a multiple of STAGE_C) waits
    until round r-1 has done min(tau0 + 2 k' L + C, its steps), k' its
    slabs (the kernel publishes progress only every STAGE_C steps; here
    it is seen at once, the earliest case)."""
    C = K.STAGE_C
    times = []
    for r in range(-(-nslab // k)):
        live = min(k, nslab - r * k)
        nstep = T + 2 * (live - 1) * L
        t = times[r - ncta][-1] + 1 if r >= ncta else 0
        out = np.empty(nstep, dtype=np.int64)
        for tau in range(nstep):
            if tau % C == 0 and r > 0:
                prev = times[r - 1]
                kp = min(k, nslab - (r - 1) * k)
                need = min(tau + 2 * kp * L + C, len(prev))
                t = max(t, prev[need - 1] + 1)
            out[tau] = t
            t += 1
        times.append(out)
    return times


def _model(L, W, k, s0, nslab, lw, M, N, Np, ncta=1):
    """Replay lane L-1's boundary writes and lane 0's boundary reads in
    the sequential order and in the tall one on ncta CTAs.  Returns
    (snapshots of the sequential order, of the tall one) as (nslab, T+2)
    arrays of the value labels lane 0 saw; asserts the ordering on the
    way."""
    T = W + 2 * (L - 1)
    nbnd = Np + 1
    out = -10 ** 9                       # the NEV of a column outside
    init = -1 - np.arange(nbnd)          # distinct entry values
    m0s = [(s0 + ls) * L + 1 for ls in range(nslab)]
    writes = [_writes(L, W, T, M, N, m0, lw) for m0 in m0s]

    def label(ls, t):                    # the value slab ls writes at t
        return ls * T + t

    def window(bnd, m0):
        cols = m0 + lw + np.arange(T + 2)
        ok = (cols >= 0) & (cols < nbnd)
        return np.where(ok, bnd[np.clip(cols, 0, nbnd - 1)], out)

    # the sequential order: the snapshot is the row at the slab's start
    bnd = init.copy()
    seq = np.empty((nslab, T + 2), dtype=np.int64)
    for ls in range(nslab):
        seq[ls] = window(bnd, m0s[ls])
        for t, c in enumerate(writes[ls]):
            if c >= 0:
                bnd[c] = label(ls, t)
    # the tall order: rounds of k slabs, each at its steps' times
    times = _round_times(T, L, k, nslab, ncta)
    if ncta == 1:
        assert sum(map(len, times)) == K.slab_serial_steps(T, L, k, nslab)
    when = np.full((nslab, nbnd), -1, dtype=np.int64)   # write time
    for r, tr in enumerate(times):
        for j in range(min(k, nslab - r * k)):
            ls = r * k + j
            # every local step of the sub-slab falls inside the round
            assert 2 * j * L + T <= len(tr)
            for t, c in enumerate(writes[ls]):
                if c >= 0:
                    when[ls, c] = tr[2 * j * L + t]
    tall = np.empty((nslab, T + 2), dtype=np.int64)
    bnd = init.copy()
    events = []                          # (time, order, ...): reads first
    for r, tr in enumerate(times):
        for j in range(min(k, nslab - r * k)):
            ls = r * k + j
            m0 = m0s[ls]
            # entry T+1, a column lane 0 never reads: at the round start
            events.append((tr[0] - 0.5, 0, "read", ls, T + 1,
                           m0 + lw + T + 1))
            for t in range(T):
                step = tr[2 * j * L + t]
                n = m0 + lw + 1 + t
                events.append((step, 0, "read", ls, t + 1, n))
                if t == 0:
                    events.append((step, 0, "read", ls, 0, n - 1))
                c = writes[ls][t]
                if c >= 0:
                    events.append((step, 1, "write", ls, t, c))
    for step, _, kind, ls, x, c in sorted(events, key=lambda e: e[:2]):
        if kind == "write":
            bnd[c] = label(ls, x)
            continue
        tall[ls, x] = bnd[c] if 0 <= c < nbnd else out
        if 0 <= c < nbnd and x <= T:     # a read of lane 0 at its step
            w = when[:, c]
            earlier, later = w[:ls], w[ls:]
            assert (earlier[earlier >= 0] < step).all()
            assert (later[later >= 0] > step).all()
    return seq, tall


@pytest.mark.parametrize("seed", range(40))
def test_tall_schedule_keeps_the_sequential_order(seed):
    """Random geometries, the rounds on one CTA (even seeds) or on a
    cluster of slab_ctas' CTAs (odd seeds)."""
    rng = np.random.default_rng(seed)
    L = int(rng.integers(3, 21))
    W = int(rng.integers(1, 70))
    k = int(rng.integers(1, 9))
    nslab = int(rng.integers(1, 3 * k + 3))
    s0 = int(rng.integers(0, 3)) if seed % 2 else 0
    M = int(rng.integers(1, (s0 + nslab) * L + 1))
    N = int(rng.integers(1, 160))
    Np = N + 1 + int(rng.integers(0, 6))
    lw = int(rng.integers(-(s0 + nslab) * L - 5, 31))
    ncta = K.slab_ctas(k, nslab, 4, 132) if seed % 2 else 1
    seq, tall = _model(L, W, k, s0, nslab, lw, M, N, Np, ncta)
    np.testing.assert_array_equal(tall, seq)


@pytest.mark.parametrize("ncta", [1, 2, 3])
def test_tall_schedule_wraps_rounds(ncta):
    """A case that wraps two rounds, ends part-full and holds rows past
    M in its later sub-slabs, with a band that crosses every slab; on
    one CTA and with the rounds on a cluster."""
    seq, tall = _model(L=4, W=90, k=3, s0=1, nslab=7, lw=-6, M=21, N=140,
                       Np=144, ncta=ncta)
    np.testing.assert_array_equal(tall, seq)
    assert K.slab_serial_steps(9 + 6, 4, 3, 7) == 2 * (15 + 16) + 15


@pytest.mark.parametrize("dagp,nslab,nb,k,ncta", [
    (False, 12, 32, 3, 4),      # a map bucket at tetrapod width
    (True, 12, 32, 3, 4),
    (False, 11, 32, 3, 4),
    (False, 5, 1, 1, 5),        # align's one-problem windows
    (False, 12, 1, 2, 6),
    (True, 40, 1, 5, 8),        # longer runs than the CTAs hold: k grows
    (False, 40, 2, 5, 8),
    (False, 12, 64, 6, 2),
    (False, 60, 2, 7, 8),       # at most the thread budget's k
    (False, 9, 200, 7, 1),      # more problems than SMs: K1's k
    (True, 9, 200, 5, 1),
    (False, 1, 8, 1, 1)])
def test_retrace_geometry(dagp, nslab, nb, k, ncta):
    """The retrace takes the smallest k whose rounds fit the CTAs a
    problem may have (min(8, 132 // nb)), else K1's largest k; its CTAs
    per problem are slab_ctas' for that k."""
    kk, threads, smem = K.retrace_geometry(dagp, 128, 17, nslab, nb, 132)
    assert (kk, K.slab_ctas(kk, nslab, nb, 132)) == (k, ncta)
    assert (threads, smem) == K.slab_geometry("trace", dagp, 128, 17, kk)[1:]


def test_retrace_geometry_leaves_the_other_modes_alone():
    """K1, K4 and K5 keep their own geometry: the largest k the thread
    budget holds (PR 5's schedule)."""
    assert [K.slab_geometry(m, d, 128, 17, 12)[0] for m, d in
            [("trace", False), ("trace", True), ("links", False),
             ("links", True), ("score", False), ("score", True)]] == \
        [7, 5, 4, 4, 8, 4]


def _launch_check(runs, max_ps):
    launches = retrace_launches(runs, max_ps)
    covered = {}
    for a, nslab, members in launches:
        assert nslab >= 1 and members and len(set(members)) == len(members)
        assert len(members) * nslab <= max_ps or (len(members), nslab) == \
            (1, 1)
        for i in members:
            covered.setdefault(i, []).append((a, a + nslab))
    for i, s0, sf in runs:             # every slab of every run, once
        slabs = sorted(s for a, b in covered[i] for s in range(a, b)
                       if s0 <= s <= sf)
        assert slabs == list(range(s0, sf + 1))
    return launches


@pytest.mark.parametrize("seed", range(30))
def test_retrace_launches_within_the_budget(seed):
    """Random runs (problem, first slab, end slab) and budgets in
    problem-slabs: every launch's planes (problems x slabs) fit the
    budget, and every slab of every run is retraced in exactly one
    launch."""
    rng = np.random.default_rng(seed)
    runs = []
    for i in range(int(rng.integers(1, 40))):
        sf = int(rng.integers(0, 20))
        runs.append((i, int(rng.integers(0, sf + 1)) if seed % 3 else 0, sf))
    _launch_check(runs, int(rng.integers(1, 500)))


@pytest.mark.parametrize("max_ps,want", [
    (620, [(0, 12, 32)]),                 # a tetrapod-width bucket, 13 B
    (384, [(0, 12, 32)]),                 # ... and 21 B a cell (-yl3)
    (383, [(0, 12, 31), (0, 12, 1)]),
    (12, [(0, 12, 1)] * 32),              # one whole run a launch
    (5, [(0, 5, 1), (5, 5, 1), (10, 2, 1)] * 32),   # runs split mid-way
    (1, [(s, 1, 1) for s in range(12)] * 32)])
def test_retrace_launches_of_a_bucket(max_ps, want):
    """32 problems of 12 slabs each: one launch while 32 x 12 problem-
    slabs fit, then fewer problems a launch, then pieces of runs."""
    launches = _launch_check([(i, 0, 11) for i in range(32)], max_ps)
    assert [(a, n, len(m)) for a, n, m in launches] == want


@pytest.mark.parametrize("k,nslab,nb,n_sm,ncta", [(7, 12, 32, 132, 2),
                                                  (4, 12, 32, 132, 3),
                                                  (4, 40, 32, 132, 4),
                                                  (4, 40, 2, 132, 8),
                                                  (7, 5, 8, 132, 1),
                                                  (1, 1, 64, 132, 1),
                                                  (4, 9, 200, 132, 1)])
def test_ctas_per_problem(k, nslab, nb, n_sm, ncta):
    """One CTA per round of k slabs, at most a portable cluster of 8 and
    no more than the card's SMs hold for every problem at once."""
    assert K.slab_ctas(k, nslab, nb, n_sm) == ncta


@pytest.mark.parametrize("k,nslab,ncta", [(7, 12, 2), (4, 12, 3), (4, 40, 4),
                                          (5, 19, 4), (7, 3, 1), (4, 9, 1)])
def test_serial_steps_on_a_cluster(k, nslab, ncta):
    """The critical path of rounds on a cluster lies between the slabs'
    full wavefront (T + 2 (S-1) L) and one CTA's rounds, and is no
    shorter than the model's earliest schedule."""
    T, L = 16638, 128
    one = K.slab_serial_steps(T, L, k, nslab)
    many = K.slab_serial_steps(T, L, k, nslab, ncta)
    earliest = max(int(t[-1]) + 1
                   for t in _round_times(T, L, k, nslab, ncta))
    assert T + 2 * (nslab - 1) * L <= earliest <= many <= one
    assert (many == one) == (ncta == 1)
