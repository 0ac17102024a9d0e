"""Batch layer of the protein x translated-genome spliced DP (the tron
path): host preparation, the device stages and the end extraction.

The counterpart of spaln_tpu/ops/dp_tron_scan.py.  Lane i of a slab owns
aa row m = m0 + i and at step t computes the cell

    n = 3 m0 + lw - 1 + t - 3 i        (band r = n - 3m in [lw-1, up])

so its neighbours are lane i-1 at t-3..t-6 and its own lane at t-1..t-3;
the slabs of a problem run in order, the last lane of one slab feeding
lane 0 of the next through a boundary row indexed by n.  The math is
the reference's; its TPU layout is not: the genome operands stay in
genome order (one packed code word and three signal words per n) and
each problem's band placement ``lw`` goes to the kernels as a number,
where the reference reverses, phase-splits and pre-shifts them, and
pads M, N and the batch to compile-reuse ladders.  None of that padding
moves a band edge, so dropping it changes no output.

    prepare_tron_batch   host: B problems of one (W, L) geometry
    run_tron_batch       K7 (tron_forward), the end extraction on the
                         host, K8 (tron_walk): (score, m, n, ops) each
    forward_tron         one problem through run_tron_batch
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .tron_params import (TronDpParams, DEAD, HORI, HOR1, HOR2)
from .params import DpFlags, NEVSEL
from ..native import tron_init_row_native
from ..score.codepot import TronSignals
from ..utils.metrics import metrics, stage

NCAND = 4
NEV = int(np.int32(NEVSEL))
# the packed genome code word: btron, dinc5, dinc3, phs5 + 2, phs3 + 2
BT_BITS, D5_SHIFT, D3_SHIFT, P5_SHIFT, P3_SHIFT = 5, 5, 9, 13, 16
CODE_FILL = 2                     # btron fill 2, dincs 0, phases -2
G_CODE, G_SIGE, G_SIG5, G_ACCB = 0, 1, 2, 3
N_GEN = 4
# boundary rows: H, its dir, F, and for double-affine gaps F2, its dir
B_H, B_HD, B_F, B_F2, B_F2D = 0, 1, 2, 3, 4
N_BND = 5
# TRON_TABS layout: the tron matrix, tab53, the two junction-codon
# tables, then the intron penalty by length
A_TRON = 26
T_T53 = A_TRON * A_TRON
T_T1, T_T2, T_IPEN = T_T53 + 256, T_T53 + 512, T_T53 + 768
# one problem's meta row: M, N, lw, Local bounds lo and hi
N_META = 5
# K8 record: kind (1 D, 2 E, 3 F, 4 I, 5 I + D across a split codon),
# m, n, a1 (nb5, or the E/F step), a2 (phase)
N_REC = 5


def n_nodes(prm: TronDpParams) -> int:
    """DP states: H, E, F, and E2, F2 with double-affine gaps."""
    return 5 if prm.dagp else 3


def tron_plane_bytes_per_cell(prm: TronDpParams) -> int:
    """Traceback plane bytes of one (slab, step, lane) cell: a flag byte,
    an int32 junction and an int8 phase per state."""
    return 6 * n_nodes(prm)


@stage("init_row")
def tron_init_row(sig: TronSignals, prm: TronDpParams, N: int,
                  a_exgl: bool = True, sigs_until: int | None = None):
    """Top-row H values/dirs over n = 0..N+1 (initH_ng semantics for the
    default free-end mode: reseed at translation starts, carry coding
    potential, 1/2-nt shifts; tron_init_row,
    spaln_tpu/ops/dp_tron_scan.py:631).

    sigs_until: the TransInit restart bonus applies only at n <= this
    bound (the seed-anchor start): interior segments are anchored
    (seededH_ng inex.exgl=0, fwd2h1.cc:3218-3241), so a strong ATG
    signal inside the anchored span must not out-bid the anchored
    diagonal.

    One compiled pass of the native library; ``tron_init_row_plain``
    where the library cannot be loaded.  The counters ``init_row_native``
    and ``init_row_plain`` count the calls of each."""
    s_cut = len(sig.sigS)
    if sigs_until is not None and sigs_until + 4 < s_cut:
        # where the plain version's sigS[sigs_until + 4:] starts
        s_cut = slice(sigs_until + 4, None).indices(s_cut)[0]
    rows = tron_init_row_native(sig.sigS, sig.sigE, N, a_exgl, s_cut,
                                prm.gep, prm.gap_w1, prm.gap_w2)
    if rows is not None:
        metrics.bump("init_row_native")
        return rows
    metrics.bump("init_row_plain")
    return tron_init_row_plain(sig, prm, N, a_exgl, sigs_until)


def tron_init_row_plain(sig: TronSignals, prm: TronDpParams, N: int,
                        a_exgl: bool = True,
                        sigs_until: int | None = None):
    """``tron_init_row`` as a Python loop, a column at a time."""
    h = np.zeros(N + 2, dtype=np.int64)
    hd = np.full(N + 2, DEAD, dtype=np.int32)
    if not a_exgl:
        return h.astype(np.int32), hd
    sigS = sig.sigS.copy()
    if sigs_until is not None and sigs_until + 4 < len(sigS):
        sigS[sigs_until + 4:] = 0
    sigE = sig.sigE

    def s_at(n):
        return int(sigS[n]) if 0 <= n < N else 0

    h[0] = max(s_at(1), 0)
    for i, n in enumerate(range(1, N + 2), start=1):
        if i < 3:
            h[n] = max(s_at(n + 1), 0)
            hd[n] = DEAD
        else:
            h[n] = h[n - 3] + prm.gep
            hd[n] = HORI
            if 0 <= n - 3 < N:
                h[n] += int(sigE[n - 3])
            x = h[n - 1] + prm.gap_w1
            if x > h[n]:
                h[n], hd[n] = x, HOR1
            x = h[n - 2] + prm.gap_w2
            if x > h[n]:
                h[n], hd[n] = x, HOR2
        x = max(s_at(n + 1), 0)
        if h[n] < x:
            h[n], hd[n] = x, DEAD
    return h.astype(np.int32), hd


def pack_codes(sig: TronSignals) -> np.ndarray:
    """The code word of each genome position: btron, dinc5, dinc3 and
    the two splice phases (+2, so -2 = no site packs as 0)."""
    bt = sig.btron.astype(np.int64)
    if len(bt) and (bt.min() < 0 or bt.max() >= A_TRON):
        raise ValueError(f"tron codes outside 0..{A_TRON - 1}")
    return (bt | (sig.dinc5.astype(np.int64) << D5_SHIFT)
            | (sig.dinc3.astype(np.int64) << D3_SHIFT)
            | ((sig.phs5.astype(np.int64) + 2) << P5_SHIFT)
            | ((sig.phs3.astype(np.int64) + 2) << P3_SHIFT)
            ).astype(np.int32)


def tron_tables(sig: TronSignals, prm: TronDpParams,
                ipen_tab: np.ndarray) -> np.ndarray:
    """The batch-shared tables in one int32 array (TRON_TABS layout)."""
    mtx = np.asarray(prm.qprof_mtx, dtype=np.int32)
    if mtx.shape != (A_TRON, A_TRON):
        raise ValueError(f"tron matrix of shape {mtx.shape}, expected "
                         f"{(A_TRON, A_TRON)}")
    return np.concatenate([
        mtx.reshape(-1), sig.tabs.tab53.astype(np.int32).reshape(-1),
        sig.spj_tron1.astype(np.int32), sig.spj_tron2.astype(np.int32),
        np.asarray(ipen_tab, dtype=np.int32)]).astype(np.int32)


@dataclass
class TronBatchProblem:
    """B tron problems of one geometry (W, L, S slabs) on ``device``.

    Per problem b (aa query a of length M, genome window of length N,
    band r = n - 3m in [lw - 1, lw + W - 2]):
      aa    (B, Mpad+1) int32      a[min(j, M-1)] at row j
      gen   (B, 4, Nmax) int32     per n: code word, sigE, sig5 and the
                                   acceptor base sig3 - tab3[dinc3]
      meta  (B, 5) int32           M, N, lw, Local bounds lo, hi
      bnd0  (5, B, Nmax+2) int32   the init row (H, dir), NEV F and F2
      tabs  int32                  TRON_TABS layout
    """
    aa: torch.Tensor
    gen: torch.Tensor
    meta: torch.Tensor
    bnd0: torch.Tensor
    tabs: torch.Tensor
    Ms: list
    Ns: list
    lws: list
    loc_bounds: list
    B: int
    L: int
    W: int
    T: int                       # steps per slab, W + 6(L-1)
    S: int                       # slabs, ceil(max M / L)
    Mpad: int
    Nmax: int
    IT: int                      # walk step bound
    flags: DpFlags
    sigs: list                   # host signals (sigT for the ends)

    @property
    def device(self) -> torch.device:
        return self.aa.device

    @property
    def n_ipen(self) -> int:
        return self.tabs.shape[0] - T_IPEN


def tron_walk_bound(Mpad: int, W: int, minl: int) -> int:
    """Steps that bound any walk: a D or F move takes an aa (at most
    2 Mpad), the E moves give back at most the band (W) and 3 nt for
    each F, an intron takes at least ``minl`` of the same budget, and a
    state change (no move) comes at most once per move."""
    moves = 2 * Mpad + (W + 3 * Mpad) + (W + 3 * Mpad) // max(minl, 1) + 1
    return 2 * moves + 64


@stage("prep")
def prepare_tron_batch(queries: list, genomes: list, sigs: list,
                       prm: TronDpParams, ipen_tab: np.ndarray,
                       lws: list | None = None, W: int | None = None,
                       flags: DpFlags | None = None, L: int = 64,
                       loc_bounds: list | None = None,
                       device: torch.device | str = "cpu"
                       ) -> TronBatchProblem:
    """Host stage: B tron problems' operands on ``device``
    (prepare_tron_batch, spaln_tpu/ops/dp_tron_scan.py:733).

    loc_bounds: per-problem (lo, hi) genome positions restricting
    Local-mode behavior to outside the chain anchors (see
    protein_driver.prepare_tron_job)."""
    flags = flags or DpFlags()
    if L < 3:
        raise ValueError("the tron slabs need L >= 3 lanes (lane L-1 "
                         "writes the boundary row 3(L-1) nt behind lane "
                         "0's reads)")
    B = len(queries)
    Ms = [len(q) for q in queries]
    Ns = [len(g) for g in genomes]
    if lws is None:
        lws = [-3 * m for m in Ms]
        W = max(n - l for n, l in zip(Ns, lws)) + 2
    if W is None:
        raise ValueError("per-problem band placements need a common W")
    if loc_bounds is None:
        loc_bounds = [(1 << 30, -(1 << 30))] * B
    S = -(-max(Ms) // L)
    Mpad = S * L
    Nmax = max(max(Ns), 1)
    aa = np.zeros((B, Mpad + 1), dtype=np.int32)
    gen = np.zeros((B, N_GEN, Nmax), dtype=np.int32)
    gen[:, G_CODE] = CODE_FILL
    bnd = np.full((N_BND, B, Nmax + 2), NEV, dtype=np.int32)
    bnd[B_HD] = DEAD
    bnd[B_F2D] = DEAD
    for b in range(B):
        a = np.asarray(queries[b], dtype=np.int32)
        M, N, sig = Ms[b], Ns[b], sigs[b]
        aa[b, :M] = a
        aa[b, M:] = a[-1]
        gen[b, G_CODE, :N] = pack_codes(sig)
        gen[b, G_SIGE, :N] = sig.sigE
        gen[b, G_SIG5, :N] = sig.sig5
        gen[b, G_ACCB, :N] = (sig.sig3.astype(np.int32)
                              - sig.tabs.tab3[sig.dinc3])
        lo = loc_bounds[b][0]
        h0, hd0 = tron_init_row(sig, prm, N, flags.a_exgl,
                                sigs_until=lo if lo < (1 << 29) else None)
        bnd[B_H, b, :N + 2] = h0
        bnd[B_HD, b, :N + 2] = hd0
    meta = np.asarray([[Ms[b], Ns[b], lws[b], loc_bounds[b][0],
                        loc_bounds[b][1]] for b in range(B)], np.int32)
    # the intron penalty is read at lengths up to N + 1 (a donor at
    # n - 1 = -1 to an acceptor at N), clamped to the table
    ipen = np.asarray(ipen_tab, dtype=np.int32)[:Nmax + 2]

    def up_(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return TronBatchProblem(
        aa=up_(aa), gen=up_(gen), meta=up_(meta), bnd0=up_(bnd),
        tabs=up_(tron_tables(sigs[0], prm, ipen)), Ms=Ms, Ns=Ns,
        lws=list(lws), loc_bounds=list(loc_bounds), B=B, L=L, W=W,
        T=W + 6 * (L - 1), S=S, Mpad=Mpad, Nmax=Nmax,
        IT=tron_walk_bound(Mpad, W, prm.intron_minl), flags=flags,
        sigs=list(sigs))


def local_modes(flags: DpFlags) -> tuple[bool, bool]:
    """(LocalL, LocalR): restarts at non-positive cells, mid-matrix
    ends (fwd2h1.cc:62, 306-307)."""
    return (flags.local and flags.a_exgl and flags.b_exgl,
            flags.local and flags.a_exgr and flags.b_exgr)


def collect_tron_ends(bp: TronBatchProblem, row: np.ndarray,
                      rc: np.ndarray, loc: np.ndarray) -> list:
    """Per-problem (score, end_m, end_n) from K7's final row, right
    column and best local end (lastH_ng semantics; the end extraction of
    collect_tron_results, spaln_tpu/ops/dp_tron_scan.py:949-1011)."""
    flags = bp.flags
    _, local_r = local_modes(flags)
    out = []
    for b in range(bp.B):
        M, N, lw = bp.Ms[b], bp.Ns[b], bp.lws[b]
        up = lw + bp.W - 2
        row_b, rc_b = row[b].astype(np.int64), rc[b].astype(np.int64)
        sigT = bp.sigs[b].sigT
        if local_r:
            # LocalR: a mid-matrix best end wins unless on the last row
            # (fwd2h1.cc:608-613)
            lv, lm, ln = (int(x) for x in loc[b])
            if lv > NEV and lm != M:
                out.append((lv, lm, ln))
                continue
        best_val, best_m, best_n = row_b[N], M, N
        # each scan below keeps its first strictly larger value, so it
        # ends at the first position of its maximum, if that beats the
        # best so far
        if flags.a_exgr:
            ns = np.arange(max(3 * M + lw - 1, 3), N + 1)
            if len(ns):
                v = row_b[ns]
                st = np.asarray(sigT, np.int64)[np.clip(ns - 2, 0, None)]
                vt = row_b[ns - 3] + st
                v = np.where((ns - 2 < N) & (st > 0) & (vt > v), vt, v)
                j = int(np.argmax(v))
                if v[j] > best_val:
                    best_val, best_m, best_n = v[j], M, int(ns[j])
        if flags.b_exgr:
            rs = np.arange(N - 3 * M + 1, min(up, N) + 1)
            mm = (N - rs) // 3
            mm = mm[((N - rs) % 3 == 0) & (mm >= 1) & (mm < M)]
            if len(mm):
                j = int(np.argmax(rc_b[mm]))
                if rc_b[mm[j]] > best_val:
                    best_val, best_m, best_n = rc_b[mm[j]], int(mm[j]), N
        out.append((int(best_val), int(best_m), int(best_n)))
    return out


def ops_from_tron_records(recs: np.ndarray, counts: np.ndarray) -> list:
    """K8's records (B, IT, 5), each problem's walk from its end cell,
    into ascending op streams (traceback_tron_device's host compaction,
    spaln_tpu/ops/dp_tron_scan.py:1230-1252)."""
    out = []
    for b in range(recs.shape[0]):
        ops = []
        for j in range(int(counts[b])):
            k, m, n, a1, a2 = (int(v) for v in recs[b, j])
            if k == 1:
                ops.append(('D', m, n))
            elif k == 2:
                ops.append(('E', m, n, a1))
            elif k == 3:
                ops.append(('F', m, n, a1))
            else:
                ops.append(('I', m, a1, n - a2, a2))
                if k == 5:
                    ops.append(('D', m, n))
        ops.reverse()
        out.append(ops)
    return out


@stage("device_dp")
def run_tron_batch(bp: TronBatchProblem, prm: TronDpParams) -> list:
    """The device DP of one batch: K7 (tron_forward) writes the planes,
    the final row, the right column and the best local end; the ends
    are extracted on the host; K8 (tron_walk) walks every problem from
    its end on the planes.  One copy back after each kernel.  Returns
    [(score, end_m, end_n, ops)] per problem."""
    from .dp_tron_cuda import tron_forward, tron_walk
    planes, row, rc, loc = tron_forward(bp, prm)
    ends = collect_tron_ends(bp, row.cpu().numpy(), rc.cpu().numpy(),
                             loc.cpu().numpy())
    ends_t = torch.tensor([[e[1], e[2]] for e in ends], dtype=torch.int32,
                          device=bp.device)
    recs, counts = tron_walk(bp, planes, ends_t)
    counts = counts.cpu().numpy()
    recs = recs[:, :max(int(counts.max()), 1)].cpu().numpy()
    ops = ops_from_tron_records(recs, counts)
    return [(s, m, n, o) for (s, m, n), o in zip(ends, ops)]


def forward_tron(a: np.ndarray, bn: np.ndarray, sig: TronSignals,
                 prm: TronDpParams, ipen_tab: np.ndarray,
                 lw: int | None = None, up: int | None = None,
                 flags: DpFlags | None = None, L: int = 64,
                 loc_bounds: tuple | None = None,
                 device: torch.device | str = "cuda"):
    """One problem through run_tron_batch (forward_tron_scan +
    traceback_tron_scan, spaln_tpu/ops/dp_tron_scan.py:1015-1109):
    (score, end_m, end_n, ops)."""
    M, N = len(a), len(bn)
    if lw is None:
        lw, up = -3 * M, N
    bp = prepare_tron_batch([np.asarray(a)], [np.asarray(bn)], [sig], prm,
                            ipen_tab, lws=[lw], W=up - lw + 2, flags=flags,
                            L=L, loc_bounds=([loc_bounds] if loc_bounds
                                             is not None else None),
                            device=device)
    return run_tron_batch(bp, prm)[0]
