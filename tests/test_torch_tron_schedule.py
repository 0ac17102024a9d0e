"""K7's geometry and the order its schedule relies on, on the CPU (no
card, no kernel).

csrc/tron_dp.cu runs a problem's slabs at once: lane i of slab s is at
its local step t = tau - 6 s L at the problem's global step tau, k slabs
in lockstep in a CTA and the rounds of k slabs on a cluster of CTAs,
each round at most as far as the previous round's published progress
allows.  Lane 0 of every slab reads the previous slab's last row (H,
its dir, F at columns n0-3..n0, n0 = c0 + t) from the boundary rows in
global memory, which lane L-1 of each slab rewrites in place for its
active cells, 3(L-1) nt behind.  A slab wider than the thread budget
runs as pieces, one a round: lane 0 of a later piece reads lane PL-1 of
the piece before at t-3..t-6 through a row indexed by step.  The
kernel's outputs equal the slabs' sequential order only if every read
sees the writes of the earlier slabs (and pieces) and none of the later
ones; a model of the orders, in global steps, checks that for random
geometries, together with tron_geometry's limits and tron_serial_steps.
"""
import numpy as np
import pytest

from spaln_tpu_torch.ops import dp_tron_cuda as TK

N_SM = 132
# registers a thread of each K7 instance (nvcc -Xptxas -v on the card)
REGS = TK.TRON_REGISTERS


@pytest.mark.parametrize("B", [1, 4, 24, 200])
@pytest.mark.parametrize("L", [3, 64, 128, 256, 1024])
@pytest.mark.parametrize("dagp", [False, True])
def test_geometry_within_card_limits(dagp, L, B):
    maxt = TK.TRON_MAX_THREADS[dagp]
    assert maxt * REGS[dagp] <= 65_536
    pieces, PL = TK.tron_pieces(dagp, L)
    assert PL <= maxt and (pieces - 1) * PL < L <= pieces * PL
    for S in range(1, 13):
        k, threads, ncta, smem = TK.tron_geometry(dagp, L, S, B, N_SM)
        assert threads == k * PL <= min(maxt, 1024)
        assert threads * REGS[dagp] <= 65_536
        assert smem == TK.tron_smem(dagp, threads) <= 227 * 1024
        assert 1 <= ncta <= 8 and (ncta == 1 or B * ncta <= N_SM)
        assert (k == 1) if pieces > 1 else (1 <= k <= min(maxt // L, S))
        rounds = -(-S * pieces // k)
        assert ncta == min(rounds, 8, max(1, N_SM // B))
        # the smallest k whose rounds fit the CTAs, else the largest
        if k > 1:
            assert -(-S * pieces // (k - 1)) > max(1, min(8, N_SM // B))
            if rounds > ncta:
                assert k == min(maxt // L, S)


@pytest.mark.parametrize("dagp,L,S,B,want", [
    (False, 128, 3, 4, (1, 128, 3)),     # phase 1's tron batch
    (True, 128, 3, 4, (1, 128, 3)),
    (False, 128, 11, 1, (2, 256, 6)),    # phase 8's one-problem batch
    (True, 128, 11, 1, (2, 256, 6)),
    (False, 128, 3, 24, (1, 128, 3)),    # 24 problems: 5 CTAs each
    (False, 128, 9, 24, (2, 256, 5)),
    (False, 128, 12, 40, (3, 384, 3)),   # the thread budget caps k
    (True, 128, 12, 40, (2, 256, 3)),
    (False, 128, 5, 200, (3, 384, 1)),   # more problems than SMs
    (False, 1024, 2, 4, (1, 342, 6)),    # pieces: 3 of 342 lanes
    (True, 1024, 2, 1, (1, 256, 8))])    # 4 of 256
def test_geometry_rule(dagp, L, S, B, want):
    assert TK.tron_geometry(dagp, L, S, B, N_SM)[:3] == want


@pytest.mark.parametrize("L", [2, 1025])
def test_geometry_refuses(L):
    with pytest.raises(ValueError, match="lanes"):
        TK.tron_geometry(False, L, 2, 1, N_SM)


def _active_cols(L, W, T, M, N, m0, lw, i):
    """Column lane i of the slab at row m0 computes at local steps
    0..T-1, -1 where its cell is inactive."""
    t = np.arange(T)
    n = 3 * m0 + lw - 1 - 3 * i + t
    r_off = t - 6 * i
    act = ((r_off >= 0) & (r_off < W) & (n >= 0) & (n <= N)
           & (m0 + i <= M))
    return np.where(act, n, -1)


def _round_times(T, L, k, S, ncta, pieces):
    """Time of every global step of every round when the rounds run on
    ncta CTAs as early as the kernel lets them: round r runs on CTA
    r % ncta after that CTA's previous round, one step a time unit, and
    before its steps tau0 .. tau0+C-1 (tau0 a multiple of TRON_STAGE)
    waits until round r-1 has done min(tau0 + 6 L (s - s') + C, its
    steps), s and s' the rounds' first slabs (the kernel publishes
    progress only every TRON_STAGE steps; here it is seen at once, the
    earliest case).  Returns the times and each round's first slab."""
    C = TK.TRON_STAGE
    units = S * pieces
    times, firsts = [], []
    for r in range(-(-units // k)):
        u0 = r * k
        sf = u0 // pieces
        nstep = T + 6 * L * ((min(u0 + k, units) - 1) // pieces - sf)
        t = times[r - ncta][-1] + 1 if r >= ncta else 0
        out = np.empty(nstep, dtype=np.int64)
        for tau in range(nstep):
            if tau % C == 0 and r > 0 and ncta > 1:
                prev = times[r - 1]
                need = min(tau + 6 * L * (sf - firsts[r - 1]) + C,
                           len(prev))
                t = max(t, prev[need - 1] + 1)
            out[tau] = t
            t += 1
        times.append(out)
        firsts.append(sf)
    return times, firsts


def _model(L, W, k, S, lw, M, N, ncta=1, pieces=1):
    """Replay lane L-1's boundary writes and lane 0's boundary reads (and,
    for pieces, the piece rows) in the slabs' sequential order and in
    the round/cluster order.  Returns (the labels lane 0 of every slab
    saw at every step in the sequential order, in the other) and
    asserts the ordering of every read on the way."""
    T = W + 6 * (L - 1)
    PL = -(-L // pieces)
    nbnd = N + 2
    init = -1 - np.arange(nbnd)              # distinct entry values
    out = -10 ** 9                           # a read outside 3..N
    m0s = [s * L + 1 for s in range(S)]
    writes = [_active_cols(L, W, T, M, N, m0, lw, L - 1) for m0 in m0s]

    def label(s, t):                         # the value slab s writes at t
        return s * T + t

    def cols(s, t):                          # what lane 0 reads at t
        n0 = 3 * m0s[s] + lw - 1 + t
        return [n0 - x for x in range(4)] if 3 <= n0 <= N else []

    # the sequential order: slab after slab, the reads of a step first
    bnd = init.copy()
    seq = np.full((S, T, 4), out, dtype=np.int64)
    for s in range(S):
        for t in range(T):
            for x, c in enumerate(cols(s, t)):
                seq[s, t, x] = bnd[c]
            if writes[s][t] >= 0:
                bnd[writes[s][t]] = label(s, t)
    # the round/cluster order
    times, firsts = _round_times(T, L, k, S, ncta, pieces)
    units = S * pieces

    def at(u, t):                            # global time of unit u at t
        r = u // k
        return times[r][t + 6 * L * (u // pieces - firsts[r])]

    for r, tr in enumerate(times):           # every step inside the round
        for u in range(r * k, min(r * k + k, units)):
            assert 6 * L * (u // pieces - firsts[r]) + T <= len(tr)
    when = np.full((S, nbnd), -1, dtype=np.int64)   # write time
    events = []                              # (time, order, ...): reads first
    for s in range(S):
        u0, ul = s * pieces, s * pieces + pieces - 1   # lanes 0 and L-1
        for t in range(T):
            for x, c in enumerate(cols(s, t)):
                events.append((at(u0, t), 0, "read", s, t, x, c))
            c = writes[s][t]
            if c >= 0:
                when[s, c] = at(ul, t)
                events.append((at(ul, t), 1, "write", s, t, 0, c))
        # piece rows: lane PL-1 of piece p writes step t, lane 0 of piece
        # p+1 reads steps t-3..t-6
        for p in range(pieces - 1):
            w = np.array([at(u0 + p, t) for t in range(T)])
            for t in range(T):
                for x in range(3, 7):
                    if t - x >= 0:
                        assert w[t - x] < at(u0 + p + 1, t)
            assert (p + 1) * PL < L            # the next piece has lanes
    tall = np.full((S, T, 4), out, dtype=np.int64)
    bnd = init.copy()
    for step, _, kind, s, t, x, c in sorted(events, key=lambda e: e[:2]):
        if kind == "write":
            bnd[c] = label(s, t)
            continue
        tall[s, t, x] = bnd[c]
        w = when[:, c]
        earlier, later = w[:s], w[s:]
        assert (earlier[earlier >= 0] < step).all()
        assert (later[later >= 0] > step).all()
    return seq, tall


@pytest.mark.parametrize("seed", range(40))
def test_round_schedule_keeps_the_sequential_order(seed):
    """Random geometries: the rounds on one CTA or on a cluster (the
    rule's CTAs or forced ones), slabs cut into pieces for a third of
    the seeds."""
    rng = np.random.default_rng(seed)
    L = int(rng.integers(3, 21))
    S = int(rng.integers(1, 13))
    W = int(rng.integers(1, 90))
    pieces = int(rng.integers(2, 4)) if seed % 3 == 2 else 1
    pieces = min(pieces, L)
    k = 1 if pieces > 1 else int(rng.integers(1, 5))
    ncta = int(rng.integers(1, 5)) if seed % 2 else 1
    M = int(rng.integers(1, S * L + 1))
    N = int(rng.integers(1, 200))
    lw = int(rng.integers(-3 * S * L - 5, 40))
    seq, tall = _model(L, W, k, S, lw, M, N, ncta, pieces)
    np.testing.assert_array_equal(tall, seq)


@pytest.mark.parametrize("ncta,pieces", [(1, 1), (2, 1), (3, 1), (2, 2),
                                         (3, 3)])
def test_round_schedule_full_band(ncta, pieces):
    """Every row inside the matrix and a band that crosses every slab:
    the in-place rewrites of the boundary row follow every read."""
    k = 2 if pieces == 1 else 1
    seq, tall = _model(L=6, W=100, k=k, S=5, lw=-80, M=30, N=120,
                       ncta=ncta, pieces=pieces)
    np.testing.assert_array_equal(tall, seq)


@pytest.mark.parametrize("T,L,k,S,ncta,pieces,want", [
    (16_506, 128, 1, 3, 3, 1, 18_170),     # phase 1's tron batch
    (16_506, 128, 1, 3, 1, 1, 3 * 16_506),  # PR 7's one CTA a problem
    (24_570, 128, 1, 2, 2, 1, 25_402),     # one problem, S = 2
    (24_570, 128, 2, 11, 6, 1, 32_570),    # one problem, S = 11
    (24_570, 128, 1, 11, 1, 1, 11 * 24_570),
    (7_000, 1024, 1, 1, 3, 3, 7_128)])     # three pieces of one slab
def test_serial_steps(T, L, k, S, ncta, pieces, want):
    got = TK.tron_serial_steps(T, L, k, S, ncta, pieces)
    assert got == want
    earliest = max(int(t[-1]) + 1
                   for t in _round_times(T, L, k, S, ncta, pieces)[0])
    assert T + 6 * L * (S - 1) <= earliest <= got


@pytest.mark.parametrize("k,S,ncta", [(1, 3, 3), (2, 11, 6), (1, 8, 8),
                                      (3, 12, 2), (2, 5, 1)])
def test_serial_steps_between_the_bounds(k, S, ncta):
    """The critical path lies between the slabs' full wavefront (T +
    6 (S-1) L) and one CTA's rounds, plus at most two stages a round
    for the publications."""
    T, L = 16_506, 128
    one = TK.tron_serial_steps(T, L, k, S)
    many = TK.tron_serial_steps(T, L, k, S, ncta)
    rounds = -(-S // k)
    assert T + 6 * (S - 1) * L <= many <= one
    assert one == sum(T + 6 * L * (min(k, S - r * k) - 1)
                      for r in range(rounds))
    if ncta >= rounds:
        assert many <= T + 6 * (S - 1) * L + 2 * TK.TRON_STAGE * rounds
    assert (many == one) == (ncta == 1)
