"""Batch layer of the banded spliced DP: host operand prep, the batch
geometry, end extraction and host traceback, with torch tensors on an
explicit device.

The counterpart of the batch parts of spaln_tpu/ops/dp_spliced_scan.py.
The recurrence itself (the wavefront over a slab of L query rows, lane i
owning query row m = m0 + i and computing at step t the cell

    n_i(t) = m0 + lw + 1 + t - i

of its band) runs in ops/dp_spliced_cuda.py: the CUDA kernels and
their plain PyTorch versions; ops/dp_spliced_udh.py holds the
linear-space path over them.  Every problem keeps its own band
placement ``lw`` and its own genome-indexed operand rows, so nothing is
reversed, shifted or padded for a compiler: operands are indexed by the
genome boundary position n directly.

Scores are x10 fixed-point int32 and every tie-break follows the scan
engine (spaln_tpu/ops/dp_spliced_scan.py:25-29), so results are
identical to spaln_tpu's, not close.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .params import DpParams, DpFlags, NEVSEL
from ..score.splice import SpliceSignals
from ..utils.metrics import stage

NCAND = 4
NEV = int(np.int32(NEVSEL))

# UDH link streams per slab, (S, n_links(prm), B, T) int32, indexed by
# the wavefront step t at which the slab emits the value (K4,
# spliced_slab_links): the boundary row's H and F (lane L-1, column
# m0 + lw + 2 - L + t), the final row (lane M - m0, column
# m0 + lw + 1 - (M - m0) + t), the right column (the lane at column N,
# row 2*m0 + lw + 1 - N + t) and, with double-affine gaps, the boundary
# row's F2 (the reference's stream 4, spaln_tpu/ops/dp_spliced_udh.py:
# 46).  Beside them each slab keeps a snapshot (S, n_bounds(prm), B,
# T+2) of its entry boundary rows (H, F and F2) over the columns lane 0
# reads, n = m0 + lw + k.  O(S * T) int32 per problem, against the
# planes' plane_bytes_per_cell(prm) * S * T * L bytes.
LK_BND_H, LK_BND_F, LK_ROW, LK_RC, LK_BND_F2 = range(5)

# device-memory budget for the traceback planes of one launch: 16 GiB of
# the H100's 80 GB, leaving room for operands, links, walk records and
# the caching allocator
PLANE_BYTES_BUDGET = 16 << 30


def n_states(prm: DpParams) -> int:
    """DP states with a junction plane: H, E, F, and with double-affine
    gaps (-yl3, prm.dagp) the long-gap states E2 and F2."""
    return 5 if prm.dagp else 3


def n_links(prm: DpParams) -> int:
    """UDH link streams per slab (LK_*): four, and F2's under dagp."""
    return 5 if prm.dagp else 4


def n_bounds(prm: DpParams) -> int:
    """Rows of a slab boundary: H and F, and F2 under dagp."""
    return 3 if prm.dagp else 2


def plane_bytes_per_cell(prm: DpParams) -> int:
    """Traceback plane bytes per cell: a flag byte and one int32 junction
    plane per state (13, or 21 under dagp)."""
    return 1 + 4 * n_states(prm)


# rows of BatchProblem.gops, each indexed by the genome boundary n
G_RES, G_ISDON, G_ISACC, G_SIG5, G_ACCB, G_DINC5 = range(6)
N_GOPS = 6


def _geom_bucket(x: int) -> int:
    """Smallest member of the 1/2/3-scaled power-of-2 ladder
    (1,2,3,4,6,8,12,16,...) >= x."""
    x = max(int(x), 1)
    b = 1
    while True:
        for m in (b, b + b // 2 if b > 1 else None):
            if m is not None and m >= x:
                return m
        b *= 2


@dataclass
class BatchProblem:
    """B problems of one geometry (W, L, S slabs), operands on ``device``.

    Per problem b (query a, genome window g of lengths M, N, band
    n - m in [lw + 1, lw + W]):
      qprof (B, Mpad, A) int32   substitution row of a[m-1]
      gops  (B, 6, Nmax+1) int32 per boundary n: residue g[n-1], donor /
                                 acceptor masks, donor signal sig5,
                                 acceptor base sig3 - tab3[dinc3], donor
                                 dinucleotide code dinc5
      joint (B, Nmax+1, 16) int32 acceptor term acc_joint[n, dinc5]
      ipen  (Nmax+1,) int32      exact intron penalty by length
      cip   (B, Mpad+L) int32    -yJ conserved intron-position bonus of
                                 query row m at [b, m-1], added to every
                                 acceptor close in that row; None
                                 without bonuses
    """
    qprof: torch.Tensor
    gops: torch.Tensor
    joint: torch.Tensor
    ipen: torch.Tensor
    Ms_t: torch.Tensor           # (B,) int32
    Ns_t: torch.Tensor
    lws_t: torch.Tensor
    Ms: list
    Ns: list
    lws: list
    B: int
    L: int
    W: int
    T: int                       # wavefront steps per slab, W + 2(L-1)
    S: int                       # slabs, ceil(max M / L)
    Mpad: int
    Nmax: int
    IT: int                      # traceback walk step bound
    flags: DpFlags
    cip: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.qprof.device


def walk_bound(S: int, L: int, W: int) -> int:
    """Traceback walk step bound, the reference's IT = 2 * (Mpad + W) +
    64 over its geometry-bucketed Mpad (dp_spliced_pallas.py:1201), so a
    walk that would run out of steps ends at the same step in both."""
    return 2 * (_geom_bucket(S) * L + W) + 64


def strip_walk_bound(L: int, W: int) -> int:
    """Step bound of a walk inside one slab: it moves at most L rows and
    L + W columns (the band), and every state change is followed by a
    move."""
    return 2 * (2 * L + W) + 64


def pack_link(col, state):
    """Hirschberg crossing record (dp_spliced_scan.py:212-220): column *
    8 + state of the cell where a path crossed the previous slab
    boundary (state 0 = H, 2 = F)."""
    return col * 8 + state


def unpack_link(lk):
    """(column, state) of a link (floor division: a column may be -1)."""
    return lk // 8, lk % 8


def build_operands(a: np.ndarray, b: np.ndarray, prm: DpParams,
                   sig: SpliceSignals | None, Mpad: int, Np: int):
    """One problem's (qprof (Mpad, A), gops (6, Np), joint (Np, 16))."""
    M, N = len(a), len(b)
    A = prm.qprof_mtx.shape[1]
    if N and not 0 <= int(np.min(b)) <= int(np.max(b)) < A:
        raise ValueError(f"genome residue codes outside 0..{A - 1}")
    if sig is not None and N and int(np.max(sig.dinc5)) >= 16:
        raise ValueError("donor dinucleotide codes outside 0..15")
    qprof = np.zeros((Mpad, A), dtype=np.int32)
    qprof[:M] = prm.qprof_mtx[np.asarray(a, dtype=np.int64)]
    gops = np.zeros((N_GOPS, Np), dtype=np.int32)
    gops[G_RES, 1:N + 1] = np.asarray(b, dtype=np.int32)
    joint = np.zeros((Np, 16), dtype=np.int32)
    if sig is not None:
        gops[G_ISDON, :N] = sig.is_donor
        gops[G_ISACC, :N] = sig.is_accpt
        gops[G_SIG5, :N] = sig.sig5
        gops[G_ACCB, :N] = (sig.sig3.astype(np.int32)
                            - sig.tabs.tab3[sig.dinc3])
        gops[G_DINC5, :N] = sig.dinc5
        joint[:N] = sig.acc_joint
    return qprof, gops, joint


@stage("prep")
def prepare_spliced_batch(queries: list, genomes: list, prm: DpParams,
                          sigs: list | None = None,
                          lw: int = None, up: int = None,
                          flags: DpFlags | None = None,
                          L: int = 128,
                          lws: list | None = None,
                          W: int | None = None,
                          cips: list | None = None,
                          device: torch.device | str = "cpu"
                          ) -> BatchProblem:
    """Host stage: build B problems' operands and move them to ``device``.

    Either one (lw, up) band for the whole batch, or per-problem band
    placements ``lws`` with a common width ``W``.  ``cips`` gives each
    query its -yJ bonuses {m (1-based): bonus} (or None), as
    spaln_tpu/ops/dp_spliced_scan.py:854-866 builds them."""
    flags = flags or DpFlags()
    B = len(queries)
    Ms = [len(q) for q in queries]
    Ns = [len(g) for g in genomes]
    Mmax, Nmax = max(Ms), max(Ns)
    if lws is None:
        if lw is None:
            lw, up = -Mmax, Nmax
        W = up - lw + 1
        lws = [lw] * B
    elif W is None:
        raise ValueError("per-problem band placements need a common W")
    S = -(-Mmax // L)
    Mpad = S * L
    Np = Nmax + 1
    parts = [build_operands(np.asarray(queries[i]), np.asarray(genomes[i]),
                            prm, sigs[i] if sigs is not None else None,
                            Mpad, Np) for i in range(B)]
    any_sig = sigs is not None and any(s is not None for s in sigs)
    # a problem without signals never pushes a donor candidate, so the
    # batch-shared penalty table is inert there
    ipen = (prm.intron_table(Nmax + 1) if any_sig
            else np.full(Nmax + 1, NEVSEL // 2, dtype=np.int32))

    def up_(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    cip = None
    if cips is not None and any(c is not None and len(c) for c in cips):
        ca = np.zeros((B, Mpad + L), dtype=np.int32)
        for i, c in enumerate(cips):
            if not c:
                continue
            for mpos, bonus in (c.items() if hasattr(c, "items")
                                else enumerate(c)):
                if 1 <= mpos <= Mpad:
                    ca[i, mpos - 1] = bonus
        cip = up_(ca)
    return BatchProblem(
        qprof=up_(np.stack([p[0] for p in parts])),
        gops=up_(np.stack([p[1] for p in parts])),
        joint=up_(np.stack([p[2] for p in parts])),
        ipen=up_(ipen.astype(np.int32)),
        Ms_t=up_(np.asarray(Ms, np.int32)),
        Ns_t=up_(np.asarray(Ns, np.int32)),
        lws_t=up_(np.asarray(lws, np.int32)),
        Ms=Ms, Ns=Ns, lws=list(lws), B=B, L=L, W=W, T=W + 2 * (L - 1),
        S=S, Mpad=Mpad, Nmax=Nmax, IT=walk_bound(S, L, W), flags=flags,
        cip=cip)


def collect_batch_results(bp: BatchProblem, prm: DpParams, row, rc,
                          planes=None):
    """Final score/end extraction (lastS_ng semantics) through the end
    kernel, as numpy; with ``planes`` = (flags, spj) from the slab
    kernel, also each problem's SliceTrace for the host walk."""
    from .dp_spliced_cuda import spliced_last_ends
    se = spliced_last_ends(bp, prm, row, rc)
    se = se.cpu().numpy()
    scores = se[:, 0].astype(np.int64)
    ends = se[:, 1:3].astype(np.int64)
    if planes is None:
        return scores, ends, None
    fl = planes[0].cpu().numpy()                      # (S, T, B, L)
    sp = planes[1].cpu().numpy()                      # (S, NS, T, B, L)
    btraces = [SliceTrace(flags=[fl[s, :, b] for s in range(bp.S)],
                          spj=[np.moveaxis(sp[s, :, :, b], 0, -1)
                               for s in range(bp.S)],
                          L=bp.L, lw=bp.lws[b], W=bp.W)
               for b in range(bp.B)]
    return scores, ends, btraces


def forward_spliced_batch(queries: list, genomes: list, prm: DpParams,
                          sigs: list | None = None, lw: int = None,
                          up: int = None, flags: DpFlags | None = None,
                          L: int = 128, score_only: bool = True,
                          device: torch.device | str = "cuda"):
    """Batched forward of B problems on ``device`` (forward_spliced_batch,
    spaln_tpu/ops/dp_spliced_scan.py:1063-1075): prepare, then the
    score-only slab kernel (K5) or the trace slab kernel (K1), then the
    end extraction.  Returns (scores (B,) int64, ends (B, 2) int64,
    None) or, with planes, (scores, ends, per-problem SliceTraces)."""
    from .dp_spliced_cuda import spliced_slab_score, spliced_slab_trace
    bp = prepare_spliced_batch(queries, genomes, prm, sigs=sigs, lw=lw,
                               up=up, flags=flags, L=L, device=device)
    if score_only:
        row, rc = spliced_slab_score(bp, prm)
        return collect_batch_results(bp, prm, row, rc)
    fl, spj, row, rc = spliced_slab_trace(bp, prm)
    return collect_batch_results(bp, prm, row, rc, planes=(fl, spj))


def collect_local_ends(bp: BatchProblem, traces, vthr: int,
                       max_out: int = 16) -> list:
    """SWG colony ends (collect_local_ends, spaln_tpu/ops/
    dp_spliced_scan.py:1007-1033): from each step's best (value, lane)
    per problem, the cells whose value is >= vthr, per problem a list of
    (val, m, n), best first and, among equal values, in (slab, step)
    order.  ``traces`` holds per slab a tuple whose last two entries are
    the (T, B) values and lanes (K1's local emission (S, T, B) as
    ``zip(loc_v, loc_i)``)."""
    lv = np.stack([np.asarray(ys[-2]) for ys in traces])     # (S, T, B)
    li = np.stack([np.asarray(ys[-1]) for ys in traces])
    out = []
    for i in range(bp.B):
        s, t = np.nonzero(lv[:, :, i] >= vthr)
        lane = li[s, t, i].astype(np.int64)
        m = s * bp.L + 1 + lane
        n = s * bp.L + 1 + bp.lws[i] + 1 + t - lane
        ok = (m >= 1) & (m <= bp.Ms[i]) & (n >= 1) & (n <= bp.Ns[i])
        v = lv[s, t, i].astype(np.int64)[ok]
        order = np.argsort(-v, kind="stable")
        out.append([(int(v[k]), int(m[ok][k]), int(n[ok][k]))
                    for k in order])
    return out


def pick_colonies(cands: list, trace_fn, max_out: int = 16,
                  gep: int = -20, vthr: int = 350) -> list:
    """Greedy colony selection (pick_colonies, spaln_tpu/ops/
    dp_spliced_scan.py:1036-1063, the Colonies::detectoverlap role): take
    the best remaining end, trace it with trace_fn(m, n) -> (m0, n0, ops)
    (or None).  An end inside an accepted colony's box is skipped
    untraced, and a traced candidate whose start lies inside one is that
    colony's ridge tail and is dropped."""
    picked = []
    remaining = list(cands)
    while remaining and len(picked) < max_out:
        v, m, n = remaining.pop(0)
        if any(pm0 - 1 <= m <= pm and pn0 - 1 <= n <= pn
               for _, pm, pn, (pm0, pn0, *_x) in picked):
            continue
        traced = trace_fn(m, n)
        if traced is None:
            continue
        m0, n0 = traced[0], traced[1]
        if any(pm0 - 1 <= m0 <= pm and pn0 - 1 <= n0 <= pn
               for _, pm, pn, (pm0, pn0, *_x) in picked):
            continue
        picked.append((v, m, n, traced))
    return picked


def ops_from_records(recs: np.ndarray, B: int) -> list:
    """Compact walk records (IT, B, 4) = (kind, m, n, jnc - 1) into each
    problem's ascending op stream (run_bucket_fused's host compaction,
    dp_spliced_pallas.py:1247-1260)."""
    out = []
    for b in range(B):
        k_b = recs[:, b, 0]
        ops = []
        for j in np.flatnonzero(k_b):
            k, m, n, x = (int(v) for v in recs[j, b])
            if k == 4:
                ops.append(('I', m, x, n))
            else:
                ops.append((('D', 'E', 'F')[k - 1], m, n))
        ops.reverse()
        out.append(ops)
    return out


@dataclass
class SliceTrace:
    """Traceback planes per slab: flags (T, L) uint8, spj (T, L, NS)."""
    flags: list
    spj: list
    L: int
    lw: int
    W: int

    def cell(self, m: int, n: int):
        s = (m - 1) // self.L
        i = (m - 1) % self.L
        t = (n - m) - self.lw - 1 + 2 * i
        return s, t, i

    def hdir(self, m, n):
        s, t, i = self.cell(m, n)
        return int(self.flags[s][t, i]) & 7

    def gopen(self, state, m, n):
        """Did gap state (1=E1, 2=F, 3=E2, 4=F2) open at this cell?"""
        s, t, i = self.cell(m, n)
        bit = (0, 8, 16, 32, 64)[state]
        return bool(self.flags[s][t, i] & bit)

    def spj_at(self, k, m, n):
        s, t, i = self.cell(m, n)
        return int(self.spj[s][t, i, k])

    @property
    def n_spj(self):
        return self.spj[0].shape[-1]


def traceback_spliced_scan(tr: SliceTrace, end_m: int, end_n: int):
    """Same op stream as traceback_spliced_ref, from wavefront planes."""
    return traceback_spliced_strip(tr, end_m, end_n)[0]


def traceback_spliced_strip(tr: SliceTrace, m: int, n: int,
                            state: int = 0, m_stop: int = 0,
                            guard: int = 10_000_000):
    """Walk traceback planes from (m, n, state) down to row ``m_stop``
    (exclusive).  Returns (ops ascending, m, n, state)."""
    ops = []
    steps = 0
    while steps < guard and m > m_stop and n >= 1:
        steps += 1
        if state == 0:
            s, t, i = tr.cell(m, n)
            fl = tr.flags[s][t, i]
            hd = int(fl) & 7
            if fl == 255:
                break
            if fl & 0x80:                 # SWG local-restart origin
                break
            if hd == 0:
                jnc = tr.spj_at(0, m, n)
                if jnc:
                    ops.append(('I', m, jnc - 1, n))
                    n = jnc - 1
                    continue
                ops.append(('D', m, n))
                m, n = m - 1, n - 1
                continue
            if hd > 4:
                break
            state = hd
            continue
        jnc = tr.spj_at(state, m, n) if state < tr.n_spj else 0
        if jnc:
            ops.append(('I', m, jnc - 1, n))
            n = jnc - 1
            continue
        opened = tr.gopen(state, m, n)
        if state in (1, 3):               # horizontal: consume b[n-1]
            ops.append(('E', m, n))
            n -= 1
        else:                             # vertical: consume a[m-1]
            ops.append(('F', m, n))
            m -= 1
        if opened:
            state = 0
    ops.reverse()
    return ops, m, n, state
