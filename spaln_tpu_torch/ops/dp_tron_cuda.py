"""The device DP of the tron path: three C entries over the CUDA kernels
of csrc/tron_dp.cu and their plain PyTorch versions.

  tron_forward       K7: the protein x translated-genome wavefront over
                     every slab of every problem of a batch
                     (_tron_scan_batch's step, spaln_tpu/ops/
                     dp_tron_scan.py:116-629, and its slab loop,
                     _tron_fused 820 / run_tron_batch 845-946): the
                     traceback planes, the final row, the right column
                     and the best local end of each problem
  tron_forward_dagp  K7 with double-affine gaps (-yl3, prm.dagp): the
                     long-gap states E2 and F2, a compile-time switch of
                     the same kernel
  tron_walk          K8: the traceback walk of every problem from its
                     end cell over the planes (_tron_tb_walker,
                     dp_tron_scan.py:1113-1206, with the op stream of
                     traceback_tron_scan, 1039-1109)

Each wrapper runs the plain version for tensors on the CPU, and for
tensors on a CUDA device launches its kernel on the current stream or
raises: nothing falls back.  ``launches`` counts kernel launches per C
entry and ``plain_calls`` calls of the plain versions under the same
names.  The kernels are built at first use with nvcc into csrc/build/
(a shared library of their own, plain C interface, ctypes).

K7 runs a problem's slabs at once: k slabs in lockstep in a CTA, a
problem's rounds of k slabs on a cluster of CTAs, and a slab wider than
the thread budget as pieces, one a round; tron_geometry picks k and the
CTAs, tron_serial_steps gives the critical path of a launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from .dp_spliced_cuda import (CSRC, CLUSTER_MAX, SMEM_MAX, _check, _n_sm,
                              _ptr, band_at, build_library, on_band)
from .dp_tron import (TronBatchProblem, NCAND, NEV, N_META, N_REC, N_GEN,
                      G_CODE, G_SIGE, G_SIG5, G_ACCB, BT_BITS, D5_SHIFT,
                      D3_SHIFT, P5_SHIFT, P3_SHIFT, CODE_FILL, B_H, B_HD,
                      B_F, B_F2, B_F2D, N_BND, A_TRON, T_T53, T_T1, T_T2, T_IPEN,
                      local_modes, n_nodes)
from .tron_params import (TronDpParams, DEAD, RSRV, DIAG, NEWD, VERT, SLA1,
                          SLA2, VERL, HORI, HOR1, HOR2, HORL, SPIN)

SOURCE = CSRC / "tron_dp.cu"
KERNELS = ("tron_forward", "tron_forward_dagp", "tron_walk")
launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}
I32 = torch.int32
U8 = torch.uint8
MAX_LANES = 1024                  # lanes of a slab at most

# K7's geometry, as csrc/tron_dp.cu has it (max_threads, STAGE,
# tron_smem_ints): the most threads of an instance (its
# __launch_bounds__, from its registers so that none spills), the steps
# between two publications of a round's progress, and the ring's depth.
TRON_MAX_THREADS = {False: 384, True: 256}
TRON_REGISTERS = {False: 155, True: 205}   # a thread, -Xptxas -v
TRON_STAGE = 64
RING = 8


def forward_entry(prm: TronDpParams) -> str:
    return "tron_forward_dagp" if prm.dagp else "tron_forward"


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    so, _, _ = build_library(SOURCE)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("tron_forward", "tron_forward_dagp"):
        # operands and outputs (11), shapes, modes and scores (21), the
        # geometry (k, threads, ncta, smem), the scratch (prog, pb, lbest)
        getattr(lib, name).argtypes = [P] * 11 + [I] * 25 + [P] * 3 + [P]
    lib.tron_walk.argtypes = [P] * 8 + [I] * 8 + [P, P]
    for name in KERNELS:
        getattr(lib, name).restype = I
    lib.tron_error_string.argtypes = [I]
    lib.tron_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Call one C entry on ``device``'s current stream; raise unless it
    returned cudaSuccess."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}; the kernels take "
                         f"CUDA tensors and the plain versions CPU ones")
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.tron_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
    launches[name] += 1


def _outputs(bp: TronBatchProblem, prm: TronDpParams):
    B, S, T, L, dev = bp.B, bp.S, bp.T, bp.L, bp.device
    nn = n_nodes(prm)
    return (torch.empty((B, S, T, nn, L), dtype=U8, device=dev),
            torch.empty((B, S, T, nn, L), dtype=I32, device=dev),
            torch.empty((B, S, T, nn, L), dtype=torch.int8, device=dev),
            torch.full((B, bp.Nmax + 2), NEV, dtype=I32, device=dev),
            torch.full((B, bp.Mpad + 2), NEV, dtype=I32, device=dev),
            torch.empty((B, 3), dtype=I32, device=dev))


def _forward_checks(bp: TronBatchProblem, prm: TronDpParams) -> None:
    if not 3 <= bp.L <= MAX_LANES:
        raise ValueError(f"tron slabs of {bp.L} lanes: the kernel takes "
                         f"3..{MAX_LANES}")
    dev = bp.device
    _check("aa", bp.aa, I32, (bp.B, bp.Mpad + 1), dev)
    _check("gen", bp.gen, I32, (bp.B, N_GEN, bp.Nmax), dev)
    _check("meta", bp.meta, I32, (bp.B, N_META), dev)
    _check("bnd0", bp.bnd0, I32, (N_BND, bp.B, bp.Nmax + 2), dev)
    _check("tabs", bp.tabs, I32, (T_IPEN + bp.n_ipen,), dev)


def _gap_ints(prm: TronDpParams) -> tuple:
    return (prm.gop, prm.gep, prm.gap_e1, prm.gap_e2, prm.gap_w1,
            prm.gap_w2, prm.gap_w3, prm.intron_minl, prm.lgop, prm.lgep,
            prm.gap_w3l)


def tron_pieces(dagp: bool, L: int) -> tuple[int, int]:
    """(pieces, lanes a piece) of a slab of L lanes: one piece up to the
    instance's thread budget, else ceil(L / budget) pieces of
    ceil(L / pieces) lanes (the last may have fewer)."""
    pieces = -(-L // TRON_MAX_THREADS[dagp])
    return pieces, -(-L // pieces)


def tron_smem(dagp: bool, threads: int) -> int:
    """Dynamic shared memory (bytes) of one K7 CTA: the tables up to the
    intron penalty and the 8-step rings of H, its dir, F (and F2, its
    dir) of every lane (csrc tron_smem_ints)."""
    return 4 * (T_IPEN + (5 if dagp else 3) * RING * threads)


def _k_max(dagp: bool, L: int) -> int:
    """Slabs a CTA holds at most: as many as the thread budget takes,
    one piece of a wider slab."""
    return max(1, TRON_MAX_THREADS[dagp] // L)


def tron_geometry(dagp: bool, L: int, S: int, B: int,
                  n_sm: int) -> tuple[int, int, int, int]:
    """(k, threads, CTAs per problem, smem bytes) of one K7 launch over B
    problems of S slabs of L lanes: the smallest k whose rounds,
    ceil(S pieces / k), fit the CTAs a problem may have (at most
    CLUSTER_MAX, and B of them at once within the card's n_sm SMs),
    else the largest k the thread budget holds (retrace_geometry's rule:
    the rounds then run at once, so the critical path stays near T +
    6 (S-1) L whatever k, and a smaller k makes each step cheaper).  A
    slab wider than the budget runs as pieces, one a round (k = 1).
    Raises ValueError for lanes the kernel does not take."""
    if not 3 <= L <= MAX_LANES:
        raise ValueError(f"tron slabs of {L} lanes: the kernel takes "
                         f"3..{MAX_LANES}")
    pieces, PL = tron_pieces(dagp, L)
    units = S * pieces
    kmax = min(_k_max(dagp, L), S) if pieces == 1 else 1
    cap = max(1, min(CLUSTER_MAX, n_sm // max(B, 1)))
    k = next((k for k in range(1, kmax) if -(-units // k) <= cap), kmax)
    ncta = max(1, min(cap, -(-units // k)))
    smem = tron_smem(dagp, k * PL)
    if smem > SMEM_MAX:
        raise ValueError(f"K7 needs {smem} B of shared memory (L={L})")
    return k, k * PL, ncta, smem


def tron_serial_steps(T: int, L: int, k: int, S: int, ncta: int = 1,
                      pieces: int = 1) -> int:
    """Global steps of K7's critical path over S slabs (of ``pieces``
    pieces each), k units a round, the rounds on ncta CTAs: a round of
    units from slab s to slab s' takes T + 6 (s' - s) L steps; on one
    CTA the rounds run one after another; on more, round r runs on CTA
    r % ncta after that CTA's previous round, and each TRON_STAGE steps
    of it once round r-1 has published (every TRON_STAGE steps and at
    its end) that it is 6 L (s - its first slab) + TRON_STAGE steps
    ahead or done."""
    C = TRON_STAGE
    units = S * pieces
    starts: list[list[int]] = []     # start of each chunk of each round
    nsteps: list[int] = []
    firsts: list[int] = []

    def end(r):                      # the step after round r's last
        return starts[r][-1] + nsteps[r] - (len(starts[r]) - 1) * C

    for r in range(-(-units // k)):
        u0 = r * k
        sf = u0 // pieces
        nstep = T + 6 * L * ((min(u0 + k, units) - 1) // pieces - sf)
        t = end(r - ncta) if r >= ncta else 0
        chunks = []
        for q in range(-(-nstep // C)):
            if r and ncta > 1:
                need = min(q * C + 6 * L * (sf - firsts[r - 1]) + C,
                           nsteps[r - 1])
                pub = need if need == nsteps[r - 1] else -(-need // C) * C
                t = max(t, starts[r - 1][(pub - 1) // C] + (pub - 1) % C + 1)
            chunks.append(t)
            t += C
        starts.append(chunks)
        nsteps.append(nstep)
        firsts.append(sf)
    return max(end(r) for r in range(len(starts)))


def tron_launch_plan(bp: TronBatchProblem, prm: TronDpParams, n_sm: int,
                     geometry: tuple | None = None) -> dict:
    """K7's launch over ``bp`` on a card of n_sm SMs: k, threads, CTAs
    per problem (ncta), smem, pieces a slab and serial steps, from
    tron_geometry or, for the tests and chip_smoke.py, the forced
    ``geometry`` = (k, ncta)."""
    dagp = prm.dagp
    pieces, PL = tron_pieces(dagp, bp.L)
    if geometry is None:
        k, threads, ncta, smem = tron_geometry(dagp, bp.L, bp.S, bp.B,
                                               n_sm)
    else:
        k, ncta = geometry
        kmax = _k_max(dagp, bp.L) if pieces == 1 else 1
        if not (1 <= k <= kmax and 1 <= ncta <= CLUSTER_MAX):
            raise ValueError(f"K7 geometry k={k}, ncta={ncta}: k takes "
                             f"1..{kmax} at L={bp.L}, ncta 1.."
                             f"{CLUSTER_MAX}")
        threads, smem = k * PL, tron_smem(dagp, k * PL)
    return dict(k=k, threads=threads, ncta=ncta, smem=smem, pieces=pieces,
                rounds=-(-bp.S * pieces // k),
                steps=tron_serial_steps(bp.T, bp.L, k, bp.S, ncta, pieces))


def tron_forward(bp: TronBatchProblem, prm: TronDpParams,
                 geometry: tuple | None = None):
    """K7 (its double-affine mode under prm.dagp): every slab of every
    problem of the batch, k slabs at once in a CTA and a problem's rounds
    on a cluster of CTAs (tron_launch_plan; ``geometry`` = (k, ncta)
    forces them, for the tests and chip_smoke.py).

    Returns (planes, row, rc, loc): planes = (fl (B, S, T, NN, L) uint8,
    spj (B, S, T, NN, L) int32, php int8 of the same shape), NN =
    n_nodes(prm), with the flag byte of H (dir | winner << 5, 255 =
    inactive cell), E, F (E2, F2; dir | 0x80 when opened) and per state
    the 1 + donor position and the phase of the intron closed there;
    row (B, Nmax+2) int32 = H(M, n); rc (B, Mpad+2) = H(m, N) (NEV
    where not reached); loc (B, 3) = the best LocalR end (value, m, n),
    (NEV, 0, 0) if none."""
    _forward_checks(bp, prm)
    if bp.device.type == "cpu":
        return tron_forward_plain(bp, prm)
    plan = tron_launch_plan(bp, prm, _n_sm(bp.device), geometry)
    dev, B = bp.device, bp.B
    fl, spj, php, row, rc, loc = _outputs(bp, prm)
    bnd = bp.bnd0.clone()
    # scratch: each round's progress (zero), the piece rows, each CTA's
    # best local end
    prog = torch.zeros(B * plan["rounds"], dtype=I32, device=dev)
    pb = torch.empty(max(B * bp.S * (plan["pieces"] - 1) * N_BND * bp.T, 1),
                     dtype=I32, device=dev)
    lbest = torch.empty(B * plan["ncta"] * 3, dtype=I32, device=dev)
    local_l, local_r = local_modes(bp.flags)
    _launch(forward_entry(prm), dev, _ptr(bp.gen), _ptr(bp.aa),
            _ptr(bp.meta), _ptr(bp.tabs), _ptr(bnd), _ptr(fl), _ptr(spj),
            _ptr(php), _ptr(row), _ptr(rc), _ptr(loc), B, bp.L, bp.S,
            bp.T, bp.W, bp.Nmax, bp.Mpad, bp.n_ipen, int(local_l),
            int(local_r), int(bp.flags.a_exgr), *_gap_ints(prm),
            plan["k"], plan["threads"], plan["ncta"], plan["smem"],
            _ptr(prog), _ptr(pb), _ptr(lbest))
    return (fl, spj, php), row, rc, loc


# K8's band, as csrc/tron_dp.cu has it (TW_CELLS, TW_STEP_T): a walk
# stages the cells (i - k, t - 6k), k < 32, of its slab, every state,
# from the cell (i, t) of the step that left the band in force
TRON_BAND_CELLS = 32
TRON_BAND_STEP = 6


def tron_walk(bp: TronBatchProblem, planes: tuple, ends: torch.Tensor,
              stats: torch.Tensor | None = None):
    """K8: walk every problem back from its end cell (``ends`` (B, 2)
    int32 = (m, n)) through K7's planes, one warp a problem.  Returns
    (recs (B, IT, 5) int32, counts (B,) int32): problem b's first
    counts[b] records, from the end backwards, are (kind, m, n, a1, a2):
    kind 1 D, 2 E (a1 = nt), 3 F (a1 = nt), 4 I (a1 = donor position
    nb5, a2 = phase), 5 an I across a split codon followed by its D.
    ``stats`` (B, 2) int32, if given, receives each walk's steps and tile
    loads.  Raises if a walk has not ended within bp.IT steps."""
    fl, spj, php = planes
    dev = bp.device
    B, S, T, L = bp.B, bp.S, bp.T, bp.L
    nn = fl.shape[3]
    for name, t, dt in (("fl", fl, U8), ("spj", spj, I32),
                        ("php", php, torch.int8)):
        _check(name, t, dt, (B, S, T, nn, L), dev)
    _check("ends", ends, I32, (B, 2), dev)
    if stats is not None:
        _check("stats", stats, I32, (B, 2), dev)
    if dev.type == "cpu":
        recs, counts, done = tron_walk_plain(bp, planes, ends)
        if stats is not None:
            stats.copy_(tron_walk_stats(bp, fl, ends, recs, counts))
    else:
        recs = torch.empty((B, bp.IT, N_REC), dtype=I32, device=dev)
        counts = torch.empty((B,), dtype=I32, device=dev)
        done = torch.empty((B,), dtype=I32, device=dev)
        _launch("tron_walk", dev, _ptr(fl), _ptr(spj), _ptr(php),
                _ptr(bp.meta), _ptr(ends), _ptr(recs), _ptr(counts),
                _ptr(done), B, S, T, L, nn, bp.IT, N_META, N_REC,
                None if stats is None else _ptr(stats))
    if not bool(done.bool().all()):
        raise RuntimeError(f"tron walk: a walk did not end within "
                           f"{bp.IT} steps")
    return recs, counts


def tron_walk_tiles(bp: TronBatchProblem, fl: torch.Tensor,
                    ends: torch.Tensor, recs: torch.Tensor,
                    counts: torch.Tensor) -> list:
    """The bands K8's kernel stages, problem by problem, from the walks'
    records and end cells and from the flags plane ``fl`` (B, S, T, NN,
    L) at the records' cells (the one fact the records leave out: the
    state in which the walk arrives at a cell, which decides where an
    intron close at phase 2 resumes): for each problem (steps, [(step,
    (s, i, t, 1, 6, n))]), the cells (i - k, t - 6k), k < n, of slab s loaded
    at step ``step``.  The kernel reads the walk's cell every step
    (twice where state 0 hands over to a gap state) while the cell lies
    in the planes; where it is off the band in force, it first stages
    the band from it: n = min(32, i + 1, t // 6 + 1)."""
    B, S, T, nn, L = fl.shape
    lw = bp.meta[:, 2].cpu().numpy().astype(np.int64)
    counts = counts.cpu().numpy()
    n_max = max(int(counts.max()), 1) if B else 1
    rec = recs[:, :n_max].cpu().numpy().astype(np.int64)
    ends = ends.cpu().numpy().astype(np.int64)

    def cell(b, m, n):
        s = (m - 1) // L
        i = (m - 1) - s * L
        return s, i, n - 3 * (s * L + 1) - lw[b] + 1 + 3 * i

    # the flags of every state at each record's cell, in one gather
    bb = np.repeat(np.arange(B), n_max)
    s, i, t = cell(bb, rec[:, :, 1].reshape(-1), rec[:, :, 2].reshape(-1))
    live = np.arange(n_max)[None, :] < counts[:, None]
    idx = [torch.as_tensor(np.where(live.reshape(-1), x, 0), device=fl.device)
           for x in (bb, s, t, i)]
    flv = fl[idx[0], idx[1], idx[2], :, idx[3]].cpu().numpy().reshape(
        B, n_max, nn).astype(np.int64)
    out = []
    for b in range(B):
        m, n = int(ends[b, 0]), int(ends[b, 1])
        st = steps = 0
        tiles, cur = [], None

        def read(m, n):
            nonlocal cur, steps
            c = cell(b, m, n)
            if not (0 <= c[2] < T and c[0] < S):
                return False
            if cur is None or not on_band(cur, *c):
                cur = band_at(*c, 1, TRON_BAND_STEP, TRON_BAND_CELLS)
                tiles.append((steps, cur))
            steps += 1
            return True

        for j in range(int(counts[b])):
            k, rm, rn, a1, a2 = (int(v) for v in rec[b, j])
            if (rm, rn) != (m, n) or not read(m, n):
                raise ValueError(f"tron walk {b}: record {j} at {(rm, rn)}, "
                                 f"the walk at {(m, n)}")
            if st == 0 and flv[b, j, 0] >> 5 & 7:
                st = int(flv[b, j, 0] >> 5 & 7)       # the hand-over step
                steps += 1
            if k == 1:
                m, n = m - 1, n - 3
            elif k == 5:
                m, n = m - 1, a1 - 2
            elif k == 4:
                n = a1 + a2 if st else (a1 if a2 == 0 else a1 - 1)
            else:
                m, n = m - (k == 3), n - a1
                if flv[b, j, st] & 0x80:
                    st = 0
        if m >= 1 and n >= 1:
            read(m, n)                          # the dead cell that ends it
        out.append((steps, tiles))
    return out


def tron_walk_stats(bp: TronBatchProblem, fl: torch.Tensor,
                    ends: torch.Tensor, recs: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """(B, 2) int32 (steps, band loads) of K8's walks from their records:
    what the kernel writes to ``stats``."""
    return torch.tensor([[steps, len(tiles)] for steps, tiles in
                         tron_walk_tiles(bp, fl, ends, recs, counts)],
                        dtype=I32).reshape(-1, 2)


# ------------------------------------------------------- plain versions
@contextlib.contextmanager
def _host_threads(device: torch.device):
    """One intra-op thread while a plain version steps on the CPU: its
    ops are (B, L)-sized, and a thread pool makes them slower (2.7x on
    8 cores) and stalls under contention."""
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (B, X) at idx (B, ...) clamped into range."""
    B = src.shape[0]
    flat = idx.clamp(0, src.shape[1] - 1).reshape(B, -1).long()
    return torch.gather(src, 1, flat).reshape(idx.shape)


def _genome_streams(bp: TronBatchProblem, n: torch.Tensor) -> dict:
    """The operands every (step, lane) of a slab reads, n (T, B, L):
    out-of-window positions take the reference's fill values (btron 2,
    phases -2, signals 0)."""
    N = bp.meta[:, 1].view(-1, 1, 1)
    nb = n.permute(1, 0, 2)                            # (B, T, L)
    out = {}
    for o in (-2, -1, 0, 1):
        idx = nb + o
        ok = ((idx >= 0) & (idx < N)).permute(1, 0, 2)
        g = {}
        for key, k, fill in (("code", G_CODE, CODE_FILL), ("sigE", G_SIGE, 0),
                             ("sig5", G_SIG5, 0), ("accb", G_ACCB, 0)):
            v = _gather(bp.gen[:, k], idx).permute(1, 0, 2)
            g[key] = torch.where(ok, v, torch.full_like(v, fill))
        code = g["code"]
        g["bt"] = code & ((1 << BT_BITS) - 1)
        g["d5"] = (code >> D5_SHIFT) & 15
        g["d3"] = (code >> D3_SHIFT) & 15
        g["phs5"] = ((code >> P5_SHIFT) & 7) - 2
        g["phs3"] = ((code >> P3_SHIFT) & 7) - 2
        out[o] = g
    return out


def _first_max(vals: torch.Tensor, dim: int, pos: torch.Tensor):
    """(max, index of its first occurrence) along ``dim``; ``pos`` holds
    each element's index along ``dim``, broadcastable to vals."""
    best = vals.max(dim).values
    first = torch.where(vals == best.unsqueeze(dim), pos,
                        vals.shape[dim]).min(dim).values
    return best, first


NEV_LOW = int(NEV) - (1 << 40)        # below every int32 value


@functools.lru_cache(maxsize=None)
def _slots(device) -> torch.Tensor:
    return torch.arange(NCAND, device=device)


def _insert(cands: torch.Tensor, new: torch.Tensor,
            push: torch.Tensor) -> torch.Tensor:
    """Insert the entries of ``new`` (4, B, L, K) = (value, donor
    position, state, codes) where ``push`` (B, L, K), one after the
    other in k order, into the lists ``cands`` (4, B, L, NCAND) sorted
    by value, keeping the first NCAND; an entry goes before those of
    equal value (_insert_cand, dp_tron_scan.py:48-62).  So the lists
    end sorted by (value, k) descending, the old entries as k = -1 in
    their order: one stable sort of the union."""
    K = new.shape[-1]
    late = torch.arange(1, K + 1, device=new.device)
    key = torch.cat([cands[0].long() * 8,
                     torch.where(push, new[0].long(), NEV_LOW) * 8 + late],
                    -1)
    top = torch.sort(key, stable=True, dim=-1, descending=True).indices[
        ..., :NCAND]
    return torch.gather(torch.cat([cands, new], -1), 3,
                        top.expand(4, *top.shape))


def tron_forward_plain(bp: TronBatchProblem, prm: TronDpParams):
    """Plain version of K7 (both gap models): the step of
    _tron_scan_batch over (B, L) tensors, one slab after the other."""
    plain_calls[forward_entry(prm)] += 1
    with _host_threads(bp.device):
        return _tron_forward_steps(bp, prm)


def _tron_forward_steps(bp: TronBatchProblem, prm: TronDpParams):
    dev = bp.device
    B, L, S, T, W = bp.B, bp.L, bp.S, bp.T, bp.W
    dagp = prm.dagp
    nn = n_nodes(prm)
    local_l, local_r = local_modes(bp.flags)
    a_exgr = bp.flags.a_exgr
    gop, gep, ge1, ge2, gw1, gw2, gw3, minl, lgop, lgep, gw3l = \
        _gap_ints(prm)
    M = bp.meta[:, 0:1]
    N = bp.meta[:, 1:2]
    lw = bp.meta[:, 2:3]
    loc_lo = bp.meta[:, 3:4]
    loc_hi = bp.meta[:, 4:5]
    tabs = bp.tabs
    mtx = tabs[:A_TRON * A_TRON].view(A_TRON, A_TRON)
    t53 = tabs[T_T53:T_T53 + 256]
    t1 = tabs[T_T1:T_T1 + 256]
    t2 = tabs[T_T2:T_T2 + 256]
    ipen = tabs[T_IPEN:]
    P = ipen.numel()
    fl, spj_o, php_o, row, rc, loc = _outputs(bp, prm)
    bnd = bp.bnd0.clone()
    bidx = torch.arange(B, device=dev)
    lanes = torch.arange(L, device=dev)
    loc_v = torch.full((B,), NEV, dtype=torch.int64, device=dev)
    loc_m = torch.zeros((B,), dtype=torch.int64, device=dev)
    loc_n = torch.zeros((B,), dtype=torch.int64, device=dev)

    @functools.lru_cache(maxsize=None)
    def full(v):                  # constants, never written in place
        return torch.full((B, L), v, dtype=I32, device=dev)

    sel = torch.where

    nbnd = 5 if dagp else 3                 # the rows this mode writes
    # the slabs that hold a problem's last row
    row_hit_all = [((M[:, 0] - (s * L + 1) >= 0) & (M[:, 0] - (s * L + 1) < L))
                   for s in range(S)]
    row_slab = [bool(h.any()) for h in row_hit_all]
    lane4 = torch.arange(-3, 1, device=dev).view(1, 4)
    bfill = torch.tensor([NEV, DEAD, NEV, NEV, DEAD], dtype=I32,
                         device=dev).view(N_BND, 1, 1)
    cand0 = torch.tensor([NEV, 0, 0, 0], dtype=I32,
                         device=dev).view(4, 1, 1, 1)  # an empty slot
    states3 = torch.arange(nn, device=dev).view(nn, 1, 1)
    states4 = states3.view(nn, 1, 1, 1).to(I32)
    spin_dirs = (torch.tensor((DIAG, HORI, VERT, HORL, VERL)[:nn],
                              dtype=I32, device=dev) | SPIN).view(nn, 1, 1)
    states_last = states3.view(1, 1, nn).to(I32)
    gap_open = torch.tensor((0, 0, gop, gop, lgop)[:nn], dtype=I32,
                            device=dev).view(nn, 1, 1)
    for s in range(S):
        m0 = s * L + 1
        m = m0 + lanes                                    # (L,)
        qp0 = mtx[bp.aa[:, m0 - 1:m0 - 1 + L].long()]    # (B, L, A)
        qp1 = mtx[bp.aa[:, m0:m0 + L].long()]
        c0 = 3 * m0 + lw - 1                              # (B, 1)
        tt = torch.arange(T, device=dev).view(T, 1, 1)
        nT = c0.view(1, B, 1) + tt - 3 * lanes.view(1, 1, L)
        G = _genome_streams(bp, nT)
        hh = [full(NEV) for _ in range(6)]
        hd = [full(0) for _ in range(6)]
        ff = [full(NEV) for _ in range(3)]
        ff2 = [full(NEV) for _ in range(3)]
        fd2 = [full(0) for _ in range(3)]
        ee = [full(NEV) for _ in range(3)]
        ed = [full(0) for _ in range(3)]
        ee2 = [full(NEV) for _ in range(3)]
        ed2 = [full(0) for _ in range(3)]
        # per phase: (value, donor position, state, codes) x NCAND
        cands = [cand0.expand(4, B, L, NCAND) for _ in range(3)]
        internal = (~torch.tensor(a_exgr, device=dev)) | (m.view(1, L) < M)
        for t in range(T):
            n = nT[t]                                     # (B, L)
            r_off = t - 6 * lanes
            active = (((r_off >= 0) & (r_off < W) & (m >= 1)).view(1, L)
                      & (n >= 0) & (n <= N) & (m.view(1, L) <= M))
            first = (r_off == 0).view(1, L)
            q = t % 3
            g2, g1, g0, gp = G[-2], G[-1], G[0], G[1]
            bt_n2 = g2["bt"][t]
            bt_n1p = gp["bt"][t]
            sigE_n2, sigE_n1p = g2["sigE"][t], gp["sigE"][t]
            phs5_n, phs3_n = g0["phs5"][t], g0["phs3"][t]
            sig5 = {-1: gp["sig5"][t], 0: g0["sig5"][t], 1: g1["sig5"][t]}
            accb = {-1: gp["accb"][t], 0: g0["accb"][t], 1: g1["accb"][t]}
            d5 = {-1: gp["d5"][t], 0: g0["d5"][t], 1: g1["d5"][t]}
            d3 = {-1: gp["d3"][t], 0: g0["d3"][t], 1: g1["d3"][t]}

            # lane 0 reads the previous slab's last row (or the init row)
            # at n0-3..n0 where 3 <= n0 <= N, the others lane i-1
            n0 = c0[:, 0] + t
            okb = ((n0 >= 3) & (n0 <= N[:, 0])).view(1, B, 1)
            cols = (n0.view(B, 1) + lane4).clamp(0, bp.Nmax + 1)
            b4 = torch.where(okb, bnd.gather(2, cols.expand(N_BND, B, 4)),
                             bfill)                       # (5, B, 4)

            def sh(v, col):                   # lane i <- lane i-1
                return torch.cat([col.view(B, 1), v[:, :-1]], 1)

            up_h3, up_d3 = sh(hh[2], b4[B_H, :, 3]), sh(hd[2], b4[B_HD, :, 3])
            up_h4, up_d4 = sh(hh[3], b4[B_H, :, 2]), sh(hd[3], b4[B_HD, :, 2])
            up_h5, up_d5 = sh(hh[4], b4[B_H, :, 1]), sh(hd[4], b4[B_HD, :, 1])
            hq_v, hq_d = sh(hh[5], b4[B_H, :, 0]), sh(hd[5], b4[B_HD, :, 0])
            up_f3 = sh(ff[2], b4[B_F, :, 3])
            if dagp:
                up_f23 = sh(ff2[2], b4[B_F2, :, 3])
                up_fd23 = sh(fd2[2], b4[B_F2D, :, 3])
            left1, left2, left3 = hh[0], hh[1], hh[2]
            ld1, ld3 = hd[0], hd[2]
            nev = full(NEV)
            # band top: the vertical sources lie past up
            if t >= W - 3:
                at_top = (r_off >= W - 1).view(1, L)
                at_top2 = (r_off >= W - 2).view(1, L)
                at_top3 = (r_off >= W - 3).view(1, L)
                up_h3 = sel(at_top3, nev, up_h3)
                up_f3 = sel(at_top3, nev, up_f3)
                if dagp:
                    up_f23 = sel(at_top3, nev, up_f23)
                up_h4 = sel(at_top2, nev, up_h4)
                up_h5 = sel(at_top, nev, up_h5)
            # lane (re)activation resets (lane t/6 at t = 0, 6, ...)
            if t % 6 == 0 and t // 6 < L:
                ee = [sel(first, nev, v) for v in ee]
                ed = [sel(first, full(0), v) for v in ed]
                ee2 = [sel(first, nev, v) for v in ee2]
                ed2 = [sel(first, full(0), v) for v in ed2]
                fc = first.view(1, L, 1)
                cands = [sel(fc, cand0, c) for c in cands]

            # ---- diagonal
            score = torch.gather(qp0, 2, bt_n2.long()[..., None])[..., 0]
            h_ok = n >= 3
            h_val = sel(h_ok, hq_v + score + sigE_n2, nev)
            h_dir = sel(h_ok, sel((hq_d == DIAG) | (hq_d == NEWD)
                                | (hq_d == (DIAG | SPIN)), full(DIAG),
                                full(NEWD)), full(DEAD))
            mx_val, mx_k, mx_dir = h_val, full(0), h_dir

            def isvert(d):
                dm = d & 15
                return (dm >= VERT) & (dm <= VERL)

            # ---- vertical
            y = up_f3 + gep
            x = up_h5 + sel(isvert(up_d5), full(ge1), full(gw1))
            f_open = x > y
            f_val = sel(f_open, x, y)
            f_dir = sel(f_open, full(SLA2), full(VERT))
            x = up_h4 + sel(isvert(up_d4), full(ge2), full(gw2))
            c = x > f_val
            f_val, f_dir, f_open = sel(c, x, f_val), sel(c, full(SLA1), f_dir), \
                f_open | c
            x = up_h3 + gw3
            c3 = x >= f_val
            f_val, f_dir = sel(c3, x, f_val), sel(c3, full(VERT), f_dir)
            f_open = f_open | c3
            c4 = (~c3) & (y >= f_val)
            f_val, f_dir = sel(c4, y, f_val), sel(c4, full(VERT), f_dir)
            f_open = f_open & ~c4
            c = f_val > mx_val
            mx_val, mx_k, mx_dir = (sel(c, f_val, mx_val), sel(c, full(2), mx_k),
                                    sel(c, f_dir, mx_dir))
            # ---- long deletion F2
            f2_val, f2_dir = nev, full(0)
            f2_open = torch.zeros_like(active)
            if dagp:
                x = up_h3 + gw3l
                y = up_f23 + lgep
                f2_open = x >= y
                f2_val = sel(f2_open, x, y)
                f2_dir = sel(f2_open, full(VERL), up_fd23)
                c = f2_val > mx_val
                mx_val, mx_k, mx_dir = (sel(c, f2_val, mx_val),
                                        sel(c, full(4), mx_k),
                                        sel(c, f2_dir, mx_dir))
            # ---- horizontal (rotating queue slot q)
            ev, edir = ee[q], ed[q]
            ok3 = (r_off > 2).view(1, L)
            x = sel(ok3, left3 + gw3, nev)
            ev3 = ev + gep
            opened3 = ok3 & (x > ev3)
            spin3 = sel(opened3, ld3 & SPIN, edir & SPIN)
            sigE2 = sel(n >= 2, sigE_n2, full(0))
            ev = sel(ok3, sel(opened3, x, ev3) + sigE2, ev)
            edir = sel(ok3, spin3 | HORI, edir)
            e_open = opened3
            ev2, edir2 = ee2[q], ed2[q]
            e2_open = torch.zeros_like(active)
            if dagp:
                x2 = sel(ok3, left3 + gw3l, nev)
                ev23 = ev2 + lgep
                e2_open = ok3 & (x2 > ev23)
                spin23 = sel(e2_open, ld3 & SPIN, edir2 & SPIN)
                ev2 = sel(ok3, sel(e2_open, x2, ev23) + sigE2, ev2)
                edir2 = sel(ok3, spin23 | HORL, edir2)
                c = ev2 > mx_val
                mx_val, mx_k, mx_dir = (sel(c, ev2, mx_val), sel(c, full(3), mx_k),
                                        sel(c, edir2, mx_dir))
            ok2 = (r_off > 1).view(1, L)
            x = sel(ok2, left2 + gw2, nev)
            c = x > ev
            ev, edir = sel(c, x, ev), sel(c, (hd[1] & SPIN) | HOR2, edir)
            e_open = e_open | c
            x = left1 + gw1
            c = x > ev
            ev, edir = sel(c, x, ev), sel(c, (ld1 & SPIN) | HOR1, edir)
            e_open = e_open | c
            c = ev > mx_val
            mx_val, mx_k, mx_dir = (sel(c, ev, mx_val), sel(c, full(1), mx_k),
                                    sel(c, edir, mx_dir))

            state_v = [h_val, ev, f_val, ev2, f2_val][:nn]
            state_d = [h_dir, edir, f_dir, edir2, f2_dir][:nn]
            # ---- acceptor closes over phases -1, 0, +1, all states at
            # once: (nn, B, L) values, dirs, junctions and phases
            sv, sd = torch.stack(state_v), torch.stack(state_d)
            sj = torch.zeros_like(sv)
            sp = torch.zeros_like(sv)
            acc_any = internal & active & (n < N) & (phs3_n != -2)
            for phs in (-1, 0, 1):
                pm = acc_any & (((phs3_n == 2) & (phs != 0))
                                | (phs3_n == phs))
                if not bool(pm.any()):        # no acceptor of the phase
                    continue
                pi = phs + 1
                cv, cj, cd, c3d = cands[pi]
                nb = n - phs
                ilen = nb[..., None] - cj
                pen = ipen[ilen.clamp(0, P - 1).long()]
                jsel = (16 * (c3d & 15) + d3[phs][..., None]).clamp(0, 255)
                xc = cv + pen + accb[phs][..., None] + t53[jsel.long()]
                if phs != 0:
                    w4 = (16 * ((c3d >> 4) & 15)
                          + d5[phs][..., None]).clamp(0, 255).long()
                    if phs == 1:
                        tr = t1[w4].clamp(0, A_TRON - 1).long()
                        adj = torch.gather(qp0, 2, tr)
                    else:
                        tr = t2[w4].clamp(0, A_TRON - 1).long()
                        adj = torch.gather(qp1, 2, tr)
                        bt_adj = torch.gather(
                            qp1, 2, bt_n1p.clamp(0, A_TRON - 1).long()[..., None])
                        adj = torch.where((n + 1 < N)[..., None],
                                          adj - bt_adj - sigE_n1p[..., None],
                                          torch.zeros_like(adj))
                    xc = xc + torch.where(cd == 0, adj, torch.zeros_like(adj))
                okc = pm[..., None] & (ilen >= minl) & (cv > NEV // 2)
                if phs == 1:
                    okc = okc & (cd != 2)
                xc = torch.where(okc, xc, torch.full_like(xc, NEV))
                # per state the first largest candidate, if it beats the
                # state (a strict > chain over the list)
                valid = (cd == states4) & okc
                vals = torch.where(valid, xc.long(), NEV_LOW)
                best, li = _first_max(vals, -1, _slots(dev))
                take = best > sv.long()
                sv = sel(take, best.to(I32), sv)
                cj_l = torch.gather(cj.expand(nn, B, L, NCAND), 3,
                                    li[..., None])[..., 0]
                sj = sel(take, cj_l + 1, sj)
                sp = sel(take, full(phs), sp)
                sd = sel(sj > 0, spin_dirs, sd)
                # the strict > chain over the states into the winner:
                # the first state of the largest closed value
                bv, bk = _first_max(torch.where(sj > 0, sv.long(), NEV_LOW),
                                    0, states3)
                c = bv > mx_val.long()
                mx_val = sel(c, bv.to(I32), mx_val)
                mx_k = sel(c, bk.to(I32), mx_k)
                mx_dir = sel(c, sd.gather(0, bk[None])[0], mx_dir)
            state_v, state_d = list(sv.unbind(0)), list(sd.unbind(0))
            spj_j, spj_p = list(sj.unbind(0)), list(sp.unbind(0))
            h_val, ev, f_val = state_v[:3]
            h_dir, edir, f_dir = state_d[:3]
            if dagp:
                ev2, f2_val = state_v[3:]
                edir2, f2_dir = state_d[3:]

            # ---- winner into H
            h_out, hd_out, mx_k_tr = mx_val, mx_dir, mx_k
            # ---- Local mode: LocalR end candidates, LocalL restarts
            if local_r:
                y_gt = (mx_k == 0) & (h_out > hq_v)
                ok = active & y_gt & (n >= loc_hi)
                if local_l:
                    start_case = (hq_d == DEAD) & ((hd_out & SPIN) == 0)
                    ok = ok & ~start_case
                # best by (value desc, m asc, n asc)
                key_v = torch.where(ok, h_out.long(),
                                    torch.full_like(h_out, NEV).long())
                bv, bl = _first_max(key_v, 1, lanes.view(1, L))  # lowest m
                bn = n[bidx, bl].long()
                bm = (m0 + bl).long()
                better = (bv > NEV) & ((bv > loc_v) | ((bv == loc_v) & (
                    (bm < loc_m) | ((bm == loc_m) & (bn < loc_n)))))
                loc_v = torch.where(better, bv, loc_v)
                loc_m = torch.where(better, bm, loc_m)
                loc_n = torch.where(better, bn, loc_n)
            if local_l:
                clamp = active & (h_out <= 0) & (n <= loc_lo)
                h_out = sel(clamp, full(0), h_out)
                hd_out = sel(clamp, full(DEAD), hd_out)
                mx_k_tr = sel(clamp, full(0), mx_k)
                spj_j[0] = sel(clamp, full(0), spj_j[0])
                c0m = clamp & (mx_k == 0)
                mx_val = sel(c0m, full(0), mx_val)
                mx_dir = sel(c0m, full(DEAD), mx_dir)

            # ---- donor pushes over phases
            don_any = internal & active & (n < N) & (phs5_n != -2)
            dm = mx_dir & 15
            hd_nod = sel(dm <= RSRV, full(-1), sel(dm <= NEWD, full(0), sel(
                dm <= SLA2, full(2), sel(dm == VERL, full(4), sel(
                    dm <= HOR2, full(1), full(3))))))
            # every state's push at once, (nn, B, L); at phase +1 state H
            # pushes the cell above-left across the split codon (cross)
            fv = torch.stack((h_out, ev, f_val, ev2, f2_val)[:nn])
            fd = torch.stack((hd_out, edir, f_dir, edir2, f2_dir)[:nn])
            z = mx_val + sel((hd_nod == 0) | (((states3 - hd_nod) & 1) != 0),
                             gap_open, 0)
            elig = ((fd != DEAD) & ((fd & SPIN) == 0)
                    & ~((states3 != hd_nod) & (hd_nod >= 0) & (fv <= z)))
            elig[0] &= hd_nod == 0
            cross_ok = (hq_d != DEAD) & ((hq_d & SPIN) == 0)
            for phs in (-1, 0, 1):
                pm = don_any & (((phs5_n == 2) & (phs != 0))
                                | (phs5_n == phs))
                if not bool(pm.any()):        # no donor of the phase
                    continue
                pi = phs + 1
                code = ((d3[phs] & 15) << 4) | (d5[phs] & 15)
                if phs == 1:
                    v = torch.cat([hq_v[None], fv[1:]])
                    ok = torch.cat([cross_ok[None], elig[1:]]) & pm
                else:
                    v, ok = fv, elig & pm
                if not bool(ok.any()):
                    continue
                new = torch.stack([(v + sig5[phs]).permute(1, 2, 0),
                                   (n - phs)[..., None].expand(B, L, nn),
                                   states_last.expand(B, L, nn),
                                   code[..., None].expand(B, L, nn)])
                cands[pi] = _insert(cands[pi], new, ok.permute(1, 2, 0))

            # ---- masked commit
            h_c = sel(active, h_out, nev)
            hd_c = sel(active, hd_out, full(DEAD))
            f_c = sel(active, f_val, nev)
            ee[q] = sel(active, ev, ee[q])
            ed[q] = sel(active, edir, ed[q])
            f2_c = sel(active, f2_val, nev)
            f2d_c = sel(active, f2_dir, full(DEAD))
            ee2[q] = sel(active, ev2, ee2[q])
            ed2[q] = sel(active, edir2, ed2[q])

            # ---- emissions: the last lane's boundary row, the final
            # row and the right column
            wl = active[:, L - 1]
            if bool(wl.any()):
                nl = n[:, L - 1].clamp(0, bp.Nmax + 1).long().view(1, B, 1)
                vals = [h_c, hd_c, f_c, f2_c, f2d_c][:nbnd]
                new = torch.stack([v[:, L - 1] for v in vals]).view(nbnd, B, 1)
                idx = nl.expand(nbnd, B, 1)
                cur = bnd[:nbnd].gather(2, idx)
                bnd[:nbnd].scatter_(2, idx,
                                    torch.where(wl.view(1, B, 1), new, cur))
            if row_slab[s]:
                li = (M[:, 0] - m0).clamp(0, L - 1).long()
                hit = row_hit_all[s] & active[bidx, li]
                hb = hit.nonzero()[:, 0]
                row[hb, n[hb, li[hb]].long()] = h_c[hb, li[hb]]
            rcm = (n == N) & active
            rc[:, m0:m0 + L] = torch.where(rcm, h_c, rc[:, m0:m0 + L])

            # ---- planes
            fl[:, s, t, 0] = ((hd_out.clamp(0, 31) | (mx_k_tr << 5))
                              .masked_fill(~active, 255).to(U8))
            fl[:, s, t, 1] = ((edir & 31) | (e_open.to(I32) << 7)).to(U8)
            fl[:, s, t, 2] = ((f_dir & 31) | (f_open.to(I32) << 7)).to(U8)
            if dagp:
                fl[:, s, t, 3] = ((edir2 & 31)
                                  | (e2_open.to(I32) << 7)).to(U8)
                fl[:, s, t, 4] = ((f2_dir & 31)
                                  | (f2_open.to(I32) << 7)).to(U8)
            spj_o[:, s, t] = torch.stack(spj_j, 1)
            php_o[:, s, t] = torch.stack(spj_p, 1).to(torch.int8)

            hh = [h_c] + hh[:5]
            hd = [hd_c] + hd[:5]
            ff = [f_c] + ff[:2]
            ff2 = [f2_c] + ff2[:2]
            fd2 = [f2d_c] + fd2[:2]
    loc[:, 0] = loc_v.to(I32)
    loc[:, 1] = loc_m.to(I32)
    loc[:, 2] = loc_n.to(I32)
    return (fl, spj_o, php_o), row, rc, loc


def tron_walk_plain(bp: TronBatchProblem, planes: tuple,
                    ends: torch.Tensor):
    """Plain version of K8: the walk of every problem at once, a step at
    a time (_tron_tb_walker's step), keeping only the records of moves.
    Returns (recs, counts, done)."""
    plain_calls["tron_walk"] += 1
    with _host_threads(ends.device):
        return _tron_walk_steps(bp, planes, ends)


def _tron_walk_steps(bp: TronBatchProblem, planes: tuple,
                     ends: torch.Tensor):
    fl, spj, php = planes
    dev = fl.device
    B, S, T, nn, L = fl.shape
    IT = bp.IT
    lw = bp.meta[:, 2].long()
    m = ends[:, 0].long().clone()
    n = ends[:, 1].long().clone()
    st = torch.zeros(B, dtype=torch.long, device=dev)
    done = (m < 1) | (n < 1)
    recs = torch.zeros((B, IT, 5), dtype=I32, device=dev)
    counts = torch.zeros(B, dtype=torch.long, device=dev)
    bidx = torch.arange(B, device=dev)
    for _ in range(IT):
        if bool(done.all()):
            break
        s = torch.div(m - 1, L, rounding_mode="floor")
        i = (m - 1) - s * L
        t = n - 3 * (s * L + 1) - lw + 1 + 3 * i
        ok = (~done) & (m >= 1) & (n >= 1) & (t >= 0) & (t < T) \
            & (s >= 0) & (s < S)
        sc, tc, ic = s.clamp(0, S - 1), t.clamp(0, T - 1), i.clamp(0, L - 1)
        stc = st.clamp(0, nn - 1)
        jnc = torch.where(ok, spj[bidx, sc, tc, stc, ic].long(),
                          torch.zeros_like(m))
        phs = torch.where(ok, php[bidx, sc, tc, stc, ic].long(),
                          torch.zeros_like(m))
        flh = torch.where(ok, fl[bidx, sc, tc, 0, ic].long(),
                          torch.full_like(m, 255))
        is0 = st == 0
        winner = (flh >> 5) & 7
        dead0 = is0 & ((flh == 255) | ((winner == 0) & (jnc == 0)
                                       & ((flh & 15) == DEAD)))
        trans = is0 & ~dead0 & (winner != 0)
        close0 = is0 & ~dead0 & (winner == 0) & (jnc > 0)
        diag = is0 & ~dead0 & (winner == 0) & (jnc == 0)
        is_e = (st == 1) | (st == 3)
        is_f = (st == 2) | (st == 4)
        close_g = (is_e | is_f) & (jnc > 0)
        plane = torch.where(is_e | is_f, st, torch.zeros_like(st)) \
            .clamp(0, nn - 1)
        fg = fl[bidx, sc, tc, plane, ic].long()
        base = fg & 15
        ew = torch.where(base == HOR2, 2, torch.where(base == HOR1, 1, 3))
        fstep = torch.where(base == SLA2, 2, torch.where(base == SLA1, 1, 0))
        e_mv = is_e & ~close_g
        f_mv = is_f & ~close_g
        nb5 = jnc - 1
        cross = close0 & (phs == 1)
        kind = torch.where(~ok | dead0 | trans, 0, torch.where(
            cross, 5, torch.where(close0 | close_g, 4, torch.where(
                diag, 1, torch.where(e_mv, 2, 3)))))
        a1 = torch.where(kind >= 4, nb5, torch.where(kind == 2, ew, fstep))
        a2 = torch.where(kind >= 4, phs, torch.zeros_like(phs))
        rec = torch.stack([kind, m, n, a1, a2], 1).to(I32)
        w = (kind != 0).nonzero()[:, 0]
        recs[w, counts[w]] = rec[w]
        counts = counts + (kind != 0).long()
        n2 = torch.where(diag, n - 3, torch.where(
            cross, nb5 - 2, torch.where(
                close0 & (phs == 0), nb5, torch.where(
                    close0, nb5 - 1, torch.where(
                        close_g, nb5 + phs, torch.where(
                            e_mv, n - ew, torch.where(f_mv, n - fstep,
                                                      n)))))))
        m2 = torch.where(diag | cross | f_mv, m - 1, m)
        opened = (e_mv | f_mv) & ((fg & 0x80) != 0)
        st = torch.where(trans, winner, torch.where(
            close0 | opened, torch.zeros_like(st), st))
        done = done | dead0 | ~ok | (m2 < 1) | (n2 < 1)
        m, n = m2, n2
    return recs, counts.to(I32), done.to(I32)
