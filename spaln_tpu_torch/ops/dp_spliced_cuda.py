"""The device DP of one geometry bucket: three CUDA kernels
(csrc/spliced_dp.cu), their plain PyTorch versions, and run_bucket.

  spliced_slab_trace  K1: the trace-forward banded spliced DP over all
                      slabs of every problem (spaln_tpu's Pallas kernel
                      _make_kernel(emit_trace=True),
                      dp_spliced_pallas.py:195, and the per-slab loop of
                      _fused_call, 1103-1121)
  spliced_last_ends   K2e: the lastS end extraction
                      (dp_spliced_pallas.py:1122-1178, with the
                      collect_batch_results semantics of
                      dp_spliced_scan.py:938-1006)
  spliced_tb_walk     K3: the traceback walk (_tb_walker,
                      dp_spliced_scan.py:1127-1196)

Each wrapper runs the plain version for tensors on the CPU, and for
tensors on a CUDA device launches its kernel on the current stream or
raises: nothing falls back.  ``launches`` counts kernel launches per
wrapper and ``plain_calls`` calls of the plain versions, so a run can
show which path it took.

The kernels are built at first use with nvcc into csrc/build/ (one
shared library with a plain C interface, bound with ctypes); a failed
build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .dp_spliced import (BatchProblem, NCAND, NEV, NSPJ, N_GOPS, G_RES,
                         G_ISDON, G_ISACC, G_SIG5, G_ACCB, G_DINC5,
                         ops_from_records)
from .params import DpParams

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = CSRC / "spliced_dp.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("spliced_slab_trace", "spliced_last_ends", "spliced_tb_walk")
launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}

PSP_BIT = (4, 1, 8)               # psp orphan-exon bit per state (aln.h)
I32 = torch.int32


# ------------------------------------------------------------------ build
def build_library() -> tuple[Path, float, str]:
    """Compile csrc/spliced_dp.cu (once per source content) and return
    (library path, seconds spent compiling, nvcc's -Xptxas -v log)."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libspliced_dp_{tag}.so"
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return so, 0.0, log
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n"
                           f"{r.stdout}\n{r.stderr}")
    log_path.write_text(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so, dt, r.stdout + r.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    so, _, _ = build_library()
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.spliced_slab_trace.argtypes = (
        [P] * 7 + [I] * 15 + [P] * 6 + [P])
    lib.spliced_last_ends.argtypes = [P] * 5 + [I] * 10 + [P, P]
    lib.spliced_tb_walk.argtypes = [P] * 4 + [I] * 5 + [P, P]
    for name in KERNELS:
        getattr(lib, name).restype = I
    lib.spliced_error_string.argtypes = [I]
    lib.spliced_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


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
        msg = lib.spliced_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
    launches[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _operand_checks(bp: BatchProblem) -> None:
    dev = bp.device
    A = bp.qprof.shape[2]
    Np = bp.Nmax + 1
    _check("qprof", bp.qprof, I32, (bp.B, bp.Mpad, A), dev)
    _check("gops", bp.gops, I32, (bp.B, N_GOPS, Np), dev)
    _check("joint", bp.joint, I32, (bp.B, Np, 16), dev)
    _check("ipen", bp.ipen, I32, (Np,), dev)
    for nm in ("Ms_t", "Ns_t", "lws_t"):
        _check(nm, getattr(bp, nm), I32, (bp.B,), dev)


# ------------------------------------------------------------------- K1
def spliced_slab_trace(bp: BatchProblem, prm: DpParams):
    """K1: every slab of every problem in the bucket.

    Returns (flags (S, T, B, L) uint8, spj (S, 3, T, B, L) int32,
    row (B, Nmax+1) int32 = H(M, n), rc (B, Mpad+1) int32 = H(m, N)).
    flags: bits 0-2 winner state, bit 3 E opened, bit 4 F opened, 255 =
    inactive cell; spj[k]: 1 + donor boundary of the intron closed into
    state k here, 0 if none."""
    if prm.dagp or bp.flags.local:
        raise NotImplementedError(
            "double-affine and local modes of the slab kernel are not "
            "ported yet (ROADMAP.md Queue 2, K5/K6)")
    if bp.device.type == "cpu":
        return slab_trace_plain(bp, prm)
    B, L, S, T = bp.B, bp.L, bp.S, bp.T
    A = bp.qprof.shape[2]
    if not 3 <= L <= 256:
        raise ValueError(f"lanes L={L}: the slab kernel runs 3..256")
    smem = (5 * L + L * A) * 4
    if smem > 48 * 1024:
        raise ValueError(f"slab kernel needs {smem} B of shared memory")
    _operand_checks(bp)
    dev, Np = bp.device, bp.Nmax + 1
    flags = torch.empty((S, T, B, L), dtype=torch.uint8, device=dev)
    spj = torch.empty((S, NSPJ, T, B, L), dtype=I32, device=dev)
    row = torch.empty((B, Np), dtype=I32, device=dev)
    rc = torch.empty((B, bp.Mpad + 1), dtype=I32, device=dev)
    bnd = torch.empty((2, B, Np + 1), dtype=I32, device=dev)   # scratch
    fl = bp.flags
    _launch("spliced_slab_trace", dev,
            _ptr(bp.qprof), _ptr(bp.gops), _ptr(bp.joint), _ptr(bp.ipen),
            _ptr(bp.Ms_t), _ptr(bp.Ns_t), _ptr(bp.lws_t),
            B, L, A, S, bp.W, T, bp.Mpad, Np, prm.gop, prm.gep,
            prm.intron_llmt, int(fl.a_exgl), int(fl.a_exgr),
            int(fl.b_exgl), smem,
            _ptr(bnd[0]), _ptr(bnd[1]), _ptr(flags), _ptr(spj), _ptr(row),
            _ptr(rc))
    return flags, spj, row, rc


def _colinit(k: torch.Tensor, prm: DpParams, b_exgl: bool) -> torch.Tensor:
    """H[m][0] initial column (build_operands colinit)."""
    if b_exgl:
        return torch.zeros_like(k)
    return torch.where(k == 0, 0, prm.gop + prm.gep * k).to(I32)


def _insert_candidate(cv, x, do_push, *fields):
    """Masked insertion of x (+ companion fields as (arr, new) pairs)
    into the sorted candidate lists (B, L, NCAND), evicting the worst;
    ties keep existing entries first (fwd2s1.cc:393-398)."""
    pos = (cv >= x[..., None]).sum(-1)
    slot = torch.arange(NCAND, device=cv.device)
    ins_here = (slot == pos[..., None]) & do_push[..., None]
    shift = (slot > pos[..., None]) & do_push[..., None]

    def place(arr, new):
        shifted = torch.cat([arr[..., :1], arr[..., :-1]], dim=-1)
        return torch.where(ins_here, new[..., None],
                           torch.where(shift, shifted, arr))

    return (place(cv, x),) + tuple(place(a, nw) for a, nw in fields)


def slab_trace_plain(bp: BatchProblem, prm: DpParams):
    """Plain version of K1: the scan engine's step (_make_step,
    dp_spliced_scan.py:223-577; trace mode, single affine, not local,
    no cip) looped over slabs and steps, vectorized over (B, L), in its
    exact operation order."""
    plain_calls["spliced_slab_trace"] += 1
    B, L, S, T, W = bp.B, bp.L, bp.S, bp.T, bp.W
    dev, Np = bp.device, bp.Nmax + 1
    fl = bp.flags
    gop, gep, llmt = prm.gop, prm.gep, prm.intron_llmt
    lanes = torch.arange(L, device=dev, dtype=I32)
    bi = torch.arange(B, device=dev)[:, None]
    M = bp.Ms_t[:, None]
    N = bp.Ns_t[:, None]
    lw = bp.lws_t[:, None]
    nev = torch.tensor(NEV, dtype=I32, device=dev)
    flags = torch.empty((S, T, B, L), dtype=torch.uint8, device=dev)
    spj = torch.empty((S, NSPJ, T, B, L), dtype=I32, device=dev)
    row = torch.full((B, Np), NEV, dtype=I32, device=dev)
    rc = torch.full((B, bp.Mpad + 1), NEV, dtype=I32, device=dev)
    # boundary rows H/F of the previous slab's last row, by n (row 0 first)
    nn = torch.arange(Np + 1, device=dev, dtype=I32)[None, :]
    row0 = (torch.zeros_like(nn) if fl.a_exgl
            else torch.where(nn == 0, 0, gop + gep * nn).to(I32))
    bnd_h = torch.where(nn <= N, row0, nev)
    bnd_f = torch.full_like(bnd_h, NEV)
    e_const = torch.where(lw >= -M,
                          _colinit(torch.clamp(-lw, min=0), prm, fl.b_exgl),
                          nev)
    negcol = torch.full((B, 1), NEV, dtype=I32, device=dev)
    zero = torch.zeros((B, L), dtype=I32, device=dev)
    r_off = torch.arange(T, device=dev, dtype=I32)[:, None] - 2 * lanes
    for s in range(S):
        m0 = s * L + 1
        m = m0 + lanes
        qp = bp.qprof[:, m0 - 1:m0 - 1 + L, :].long()
        col_m = _colinit(m, prm, fl.b_exgl)
        col_m1 = _colinit(m - 1, prm, fl.b_exgl)
        internal = (~torch.tensor(fl.a_exgr, device=dev)) | (m[None] < M)
        h1 = torch.full((B, L), NEV, dtype=I32, device=dev)
        h2, f1, e1 = h1.clone(), h1.clone(), h1.clone()
        psp = torch.zeros((B, L), dtype=I32, device=dev)
        cv = torch.full((B, L, NCAND), NEV, dtype=I32, device=dev)
        cj = torch.zeros((B, L, NCAND), dtype=I32, device=dev)
        cd, c5 = cj.clone(), cj.clone()
        # rows / lanes this slab reports for the end extraction
        li = M[:, 0] - m0
        li_ok = (li >= 0) & (li < L)
        li_c = li.clamp(0, L - 1)[:, None].long()
        li_any = bool(li_ok.any())
        for t in range(T):
            ro = r_off[t][None, :]
            n = (m0 + 1 + t) + lw - lanes[None, :]                # (B, L)
            active = ((ro >= 0) & (ro < W) & (n >= 1) & (n <= N)
                      & (m[None, :] <= M))
            first = ro == 0
            nc = n.clamp(0, Np - 1).long()
            g = torch.gather(bp.gops, 2, nc[:, None, :].expand(B, N_GOPS, L))
            sig_ok = active & (n < N)
            res = g[:, G_RES].long()
            isdon = (g[:, G_ISDON] != 0) & sig_ok
            isacc = (g[:, G_ISACC] != 0) & sig_ok
            sig5 = g[:, G_SIG5]
            accb = g[:, G_ACCB]
            dinc5 = g[:, G_DINC5]
            score = torch.gather(qp, 2, res[..., None])[..., 0].to(I32)
            # ---- neighbour values: lane i-1 at t-1 (up) and t-2 (diag);
            # lane 0 reads the previous slab's last row
            up_h = torch.cat([negcol, h1[:, :-1]], dim=1)
            up_f = torch.cat([negcol, f1[:, :-1]], dim=1)
            diag_h = torch.cat([negcol, h2[:, :-1]], dim=1)
            n0 = n[:, 0]
            ok_up = (n0 >= 0) & (n0 <= N[:, 0] + 1)
            ok_dg = (n0 >= 1) & (n0 - 1 <= N[:, 0])
            iu = n0.clamp(0, Np)[:, None].long()
            idg = (n0 - 1).clamp(0, Np)[:, None].long()
            up_h[:, 0] = torch.where(ok_up, bnd_h.gather(1, iu)[:, 0], nev)
            up_f[:, 0] = torch.where(ok_up, bnd_f.gather(1, iu)[:, 0], nev)
            diag_h[:, 0] = torch.where(ok_dg, bnd_h.gather(1, idg)[:, 0],
                                       nev)
            # column 0 and the band's left edge; a lane (re)starts at
            # r_off = t - 2i = 0, and the band's top edge is r_off >= W-1
            any_first = t % 2 == 0 and t // 2 < L
            if any_first:
                edge = first & (n != 1)
                left_h = torch.where(edge, e_const,
                                     torch.where(first, nev, h1))
            else:
                left_h = h1
            left_h = torch.where(n == 1, col_m[None, :], left_h)
            diag_h = torch.where(n == 1, col_m1[None, :], diag_h)
            if t >= W - 1:
                at_top = ro >= W - 1
                up_h = torch.where(at_top, nev, up_h)
                up_f = torch.where(at_top, nev, up_f)
            if any_first:
                e1 = torch.where(first, nev, e1)
                psp = torch.where(first, 0, psp)
                fc = first[..., None]
                cv = torch.where(fc, nev, cv)
                cj = torch.where(fc, 0, cj)
                cd = torch.where(fc, 0, cd)
                c5 = torch.where(fc, 0, c5)
            # ---- recurrence (order = fwd2s1.cc:276-431)
            h_val = diag_h + score
            mx_val, mx_k = h_val, torch.zeros_like(h_val)
            xo = up_h + gop
            f_open = xo >= up_f
            f_val = torch.where(f_open, xo, up_f) + gep
            gt = f_val > mx_val
            mx_val = torch.where(gt, f_val, mx_val)
            mx_k = torch.where(gt, 2, mx_k)
            prev_psp = psp
            xo = left_h + gop
            e_open = xo >= e1
            e_val = torch.where(e_open, xo, e1) + gep
            psp = torch.where(e_open, (prev_psp != 0).to(I32), prev_psp & 1)
            ge = e_val >= mx_val
            mx_val = torch.where(ge, e_val, mx_val)
            mx_k = torch.where(ge, 1, mx_k)
            # ---- acceptor close (fwd2s1.cc:333-354); steps without an
            # open acceptor or donor skip work that would change nothing
            state_vals = [h_val, e_val, f_val]
            jn = [zero] * NSPJ
            acc_ok = isacc & internal
            if acc_ok.any():
                ilen = n[..., None] - cj
                pen = torch.where(ilen < 0, NEV // 2,
                                  bp.ipen[ilen.clamp(0, Np - 1).long()])
                j16 = torch.gather(bp.joint[bi, nc], 2, c5.long())
                cand_ok = (acc_ok[..., None] & (ilen >= llmt)
                           & (cv > NEV // 2))
                xc = torch.where(cand_ok, cv + pen + accb[..., None] + j16,
                                 nev)
                for k in range(NSPJ):
                    cur = state_vals[k]
                    jnc = zero
                    for c in range(NCAND):          # best-first order
                        take = ((cd[..., c] == k) & (xc[..., c] >= cur)
                                & cand_ok[..., c])
                        cur = torch.where(take, xc[..., c], cur)
                        jnc = torch.where(take, cj[..., c] + 1, jnc)
                    state_vals[k] = cur
                    jn[k] = jnc
                    closed = jnc > 0
                    psp = torch.where(closed, psp | PSP_BIT[k], psp)
                    ge = closed & (cur >= mx_val)
                    mx_val = torch.where(ge, cur, mx_val)
                    mx_k = torch.where(ge, k, mx_k)
            # ---- donor push (fwd2s1.cc:380-406)
            don_ok = isdon & internal
            if don_ok.any():
                for k in range(NSPJ):
                    fv = state_vals[k]
                    elig = don_ok & ((psp & PSP_BIT[k]) == 0)
                    if k == 0:               # pushed only when diag won
                        elig = elig & (mx_k == 0)
                    gk = 0 if k // 2 == 0 else gop       # GOP[k // 2]
                    z = mx_val + torch.where(
                        (mx_k == 0) | ((k - mx_k) % 2 != 0), gk, 0)
                    elig = elig & ~((mx_k != k) & (fv <= z))
                    kdir = torch.full_like(fv, k)
                    cv, cj, cd, c5 = _insert_candidate(
                        cv, fv + sig5, elig, (cj, n), (cd, kdir),
                        (c5, dinc5))
            # ---- masked commit
            h_out = torch.where(active, mx_val, nev)
            f_out = torch.where(active, state_vals[2], nev)
            e1 = torch.where(active, state_vals[1], e1)
            h2, h1, f1 = h1, h_out, f_out
            fl8 = mx_k | (e_open.to(I32) << 3) | (f_open.to(I32) << 4)
            flags[s, t] = torch.where(active, fl8, 255).to(torch.uint8)
            spj[s, :, t] = torch.stack(jn)
            # ---- H(M, n), H(m, N) and the boundary for the next slab
            if li_any:
                a_li = active.gather(1, li_c)[:, 0] & li_ok
                _put(row, n.gather(1, li_c)[:, 0],
                     h_out.gather(1, li_c)[:, 0], a_li)
            rcl = n0 - N[:, 0]
            rcl_ok = (rcl >= 0) & (rcl < L)
            if rcl_ok.any():
                rcl_c = rcl.clamp(0, L - 1)[:, None].long()
                a_rc = active.gather(1, rcl_c)[:, 0] & rcl_ok
                _put(rc, m0 + rcl_c[:, 0].to(I32),
                     h_out.gather(1, rcl_c)[:, 0], a_rc)
            a_last = active[:, L - 1]
            _put(bnd_h, n[:, L - 1], h_out[:, L - 1], a_last)
            _put(bnd_f, n[:, L - 1], f_out[:, L - 1], a_last)
    return flags, spj, row, rc


def _put(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
         mask: torch.Tensor) -> None:
    """dst[b, idx[b]] = val[b] where mask[b] (in place)."""
    ic = idx.clamp(0, dst.shape[1] - 1)[:, None].long()
    old = dst.gather(1, ic)
    dst.scatter_(1, ic, torch.where(mask[:, None], val[:, None], old))


# ------------------------------------------------------------------ K2e
def spliced_last_ends(bp: BatchProblem, prm: DpParams, row: torch.Tensor,
                      rc: torch.Tensor, out: torch.Tensor | None = None):
    """K2e: per problem (score, end_m, end_n) as a (B, 3) int32 tensor —
    the best of H(M, N), the free-end corners, the final row under
    a_exgr and the right column under b_exgr, with strict > between
    candidate groups and the first maximum within a segment."""
    if bp.device.type == "cpu":
        return last_ends_plain(bp, prm, row, rc)
    dev = bp.device
    _check("row", row, I32, (bp.B, bp.Nmax + 1), dev)
    _check("rc", rc, I32, (bp.B, bp.Mpad + 1), dev)
    for nm in ("Ms_t", "Ns_t", "lws_t"):
        _check(nm, getattr(bp, nm), I32, (bp.B,), dev)
    if out is None:
        out = torch.empty((bp.B, 3), dtype=I32, device=dev)
    _check("out", out, I32, (bp.B, 3), dev)
    fl = bp.flags
    _launch("spliced_last_ends", dev,
            _ptr(row), _ptr(rc), _ptr(bp.Ms_t), _ptr(bp.Ns_t),
            _ptr(bp.lws_t), bp.B, bp.Nmax + 1, bp.Mpad, bp.W, prm.gop,
            prm.gep, int(fl.a_exgl), int(fl.a_exgr), int(fl.b_exgl),
            int(fl.b_exgr), _ptr(out))
    return out


def _seg_best(vals: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """(max, first argmax, non-empty) of vals[b, lo[b]:hi[b]]."""
    iota = torch.arange(vals.shape[1], device=vals.device)[None, :]
    inseg = (iota >= lo[:, None]) & (iota < hi[:, None])
    low = torch.iinfo(torch.int32).min
    segv = torch.where(inseg, vals, low)
    return (segv.max(dim=1).values, segv.argmax(dim=1).to(I32),
            inseg.any(dim=1))


def last_ends_plain(bp: BatchProblem, prm: DpParams, row: torch.Tensor,
                    rc: torch.Tensor) -> torch.Tensor:
    """Plain version of K2e (collect_batch_results, vectorized over B)."""
    plain_calls["spliced_last_ends"] += 1
    fl = bp.flags
    M, N, lw = bp.Ms_t, bp.Ns_t, bp.lws_t
    up = lw + (bp.W - 1)
    nev = torch.full_like(M, NEV)
    bv = row.gather(1, N[:, None].long())[:, 0]
    bm, bn = M.clone(), N.clone()

    def take(upd, v, m, n):
        return (torch.where(upd, v, bv), torch.where(upd, m, bm),
                torch.where(upd, n, bn))

    def col(mm):
        return torch.zeros_like(mm) if fl.b_exgl else prm.gop + prm.gep * mm

    if fl.a_exgr:
        n_first = torch.clamp(M + lw, min=0)
        c1 = lw >= -M
        v = torch.where(c1, col(-lw), torch.where(n_first == 0, col(M), nev))
        n_c = torch.where(c1, n_first, 0)
        bv, bm, bn = take(v > bv, v, M, n_c)
        smax, sarg, ne = _seg_best(row, torch.clamp(n_first, min=1), N)
        bv, bm, bn = take(ne & (smax > bv), smax, M, sarg)
    if fl.b_exgr:
        corner = torch.clamp(N - up, min=0) == 0
        vc = (torch.zeros_like(N) if fl.a_exgl else prm.gop + prm.gep * N)
        bv, bm, bn = take(corner & (vc > bv), vc, torch.zeros_like(M), N)
        smax, sarg, ne = _seg_best(rc, torch.clamp(N - up, min=1), M)
        bv, bm, bn = take(ne & (smax > bv), smax, sarg, N)
    return torch.stack([bv, bm, bn], dim=1).to(I32)


# ------------------------------------------------------------------- K3
def spliced_tb_walk(bp: BatchProblem, flags: torch.Tensor,
                    spj: torch.Tensor, ends: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K3: walk every problem's path back from its end cell through the
    planes.  ``ends`` is K2e's (B, 3) (score, m, n).  Returns records
    (IT, B, 4) int32 = (kind, m, n, jnc - 1), kind 1 D, 2 E, 3 F, 4 I
    (0 = no op); all zero once a walk has ended."""
    if bp.device.type == "cpu":
        return tb_walk_plain(bp, flags, spj, ends)
    dev = bp.device
    S, T, B, L = bp.S, bp.T, bp.B, bp.L
    _check("flags", flags, torch.uint8, (S, T, B, L), dev)
    _check("spj", spj, I32, (S, NSPJ, T, B, L), dev)
    _check("ends", ends, I32, (B, 3), dev)
    _check("lws_t", bp.lws_t, I32, (B,), dev)
    if out is None:
        out = torch.zeros((bp.IT, B, 4), dtype=I32, device=dev)
    _check("out", out, I32, (bp.IT, B, 4), dev)
    _launch("spliced_tb_walk", dev,
            _ptr(flags), _ptr(spj), _ptr(ends), _ptr(bp.lws_t),
            B, L, S, T, bp.IT, _ptr(out))
    return out


def tb_walk_plain(bp: BatchProblem, flags: torch.Tensor, spj: torch.Tensor,
                  ends: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 (_tb_walker): a loop over the walk's steps,
    vectorized over B."""
    plain_calls["spliced_tb_walk"] += 1
    S, T, B, L, IT = bp.S, bp.T, bp.B, bp.L, bp.IT
    dev = flags.device
    FL = flags.reshape(-1)
    SPJ = spj.reshape(-1)
    barr = torch.arange(B, device=dev, dtype=torch.int64)
    bits = torch.tensor([0, 8, 16, 32, 64], dtype=I32, device=dev)
    m = ends[:, 1].clone()
    n = ends[:, 2].clone()
    st = torch.zeros(B, dtype=I32, device=dev)
    lw = bp.lws_t
    done = (m < 1) | (n < 1)
    recs = torch.zeros((IT, B, 4), dtype=I32, device=dev)
    for it in range(IT):
        if it % 64 == 0 and bool(done.all()):
            break
        s = torch.div(m - 1, L, rounding_mode="floor")
        i = (m - 1) - s * L
        t = (n - m) - lw - 1 + 2 * i
        ok = ((~done) & (m >= 1) & (n >= 1) & (t >= 0) & (t < T)
              & (s >= 0) & (s < S))
        sc, tc, ic = (s.clamp(0, S - 1).long(), t.clamp(0, T - 1).long(),
                      i.clamp(0, L - 1).long())
        stc = st.clamp(0, NSPJ - 1).long()
        fl = torch.where(ok, FL[((sc * T + tc) * B + barr) * L + ic].to(I32),
                         255)
        jnc_s = torch.where(
            ok, SPJ[(((sc * NSPJ + stc) * T + tc) * B + barr) * L + ic], 0)
        jnc_0 = torch.where(
            ok, SPJ[((sc * NSPJ * T + tc) * B + barr) * L + ic], 0)
        hd = fl & 7
        is0 = st == 0
        dead = is0 & ((fl == 255) | ((fl & 0x80) != 0) | (hd > 4))
        i_close0 = is0 & ~dead & (hd == 0) & (jnc_0 > 0)
        diag = is0 & ~dead & (hd == 0) & (jnc_0 == 0)
        trans = is0 & ~dead & (hd > 0) & (hd <= 4)
        gsel = ~is0
        i_close_g = gsel & (jnc_s > 0)
        horiz = gsel & (jnc_s == 0) & ((st == 1) | (st == 3))
        vert = gsel & (jnc_s == 0) & ((st == 2) | (st == 4))
        opened = (fl & bits[st.clamp(0, 4).long()]) != 0
        i_close = i_close0 | i_close_g
        jncv = torch.where(is0, jnc_0, jnc_s)
        kind = torch.where(~ok | dead | trans, 0,
                           torch.where(i_close, 4,
                                       torch.where(diag, 1,
                                                   torch.where(horiz, 2, 3))))
        kind = kind.to(I32)
        live = ~done
        recs[it] = torch.where(live[:, None],
                               torch.stack([kind, m, n, jncv - 1], dim=1), 0)
        n2 = torch.where(i_close, jncv - 1,
                         torch.where(diag | horiz, n - 1, n))
        m2 = torch.where(diag | vert, m - 1, m)
        st = torch.where(trans, hd,
                         torch.where((horiz | vert) & opened, 0, st))
        done = done | dead | ~ok | (m2 < 1) | (n2 < 1)
        m, n = m2, n2
    return recs


# ----------------------------------------------------------- one bucket
def run_bucket(bp: BatchProblem, prm: DpParams):
    """One geometry bucket on the device: K1 -> K2e -> K3 on one stream,
    then one device-to-host copy of the packed walk records, scores and
    ends.  Returns (scores (B,) int64, ends [(m, n)], ops_all) with the
    contract of spaln_tpu's run_bucket_fused (dp_spliced_pallas.py:
    1190-1261)."""
    B, IT = bp.B, bp.IT
    flags, spj, row, rc = spliced_slab_trace(bp, prm)
    nrec = IT * B * 4
    packed = torch.zeros(nrec + 3 * B, dtype=I32, device=bp.device)
    se = spliced_last_ends(bp, prm, row, rc,
                           out=packed[nrec:].view(B, 3))
    recs = spliced_tb_walk(bp, flags, spj, se,
                           out=packed[:nrec].view(IT, B, 4))
    if recs.data_ptr() != packed.data_ptr():     # plain versions
        packed[:nrec] = recs.reshape(-1)
        packed[nrec:] = se.reshape(-1)
    host = packed.cpu().numpy()
    se_h = host[nrec:].reshape(B, 3)
    scores = se_h[:, 0].astype(np.int64)
    ends = [(int(se_h[b, 1]), int(se_h[b, 2])) for b in range(B)]
    return scores, ends, ops_from_records(host[:nrec].reshape(IT, B, 4), B)
