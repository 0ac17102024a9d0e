"""The device DP of one geometry bucket: thirteen C entries over the CUDA
kernels of csrc/spliced_dp.cu, their plain PyTorch versions, and
run_bucket.

  spliced_slab_trace    K1: the trace-forward banded spliced DP over all
                        slabs of every problem (spaln_tpu's Pallas kernel
                        _make_kernel(emit_trace=True),
                        dp_spliced_pallas.py:195, and the per-slab loop
                        of _fused_call, 1103-1121)
  spliced_slab_retrace  K1, retrace mode: chosen slabs of chosen problems
                        from an entry boundary restored from K4's
                        snapshot (the _scan_slab(emit_trace=True) re-run
                        of dp_spliced_udh.py:_retrace, 157-201)
  spliced_slab_retrace_pairs
                        K1, retrace of (problem, slab) pairs: a CTA a
                        pair, each slab from its own K4 snapshot, every
                        pair of a bucket in one launch (the reference's
                        per-slab re-run after a local or -yJ links pass)
  spliced_slab_links    K4: the UDH links forward, K1's recurrence with
                        a crossing link per value and no planes
                        (_make_kernel(emit_links=True),
                        dp_spliced_pallas.py:195 via 991)
  spliced_slab_score    K5, score-only mode: K1's recurrence with no
                        planes and no links, only the final row and right
                        column (_make_kernel(emit_trace=False), via
                        run_spliced_batch_pallas(score_only=True),
                        dp_spliced_pallas.py:991-1070); one entry for
                        both gap models
  *_dagp                K5, double-affine mode (-yl3, DpParams.dagp) of
                        the four above: the long-gap states E2 and F2
                        (_make_kernel(dagp=True)), five junction planes,
                        a fifth link stream and a third boundary row
  spliced_last_ends     K2e: the lastS end extraction
                        (dp_spliced_pallas.py:1122-1178, with the
                        collect_batch_results semantics of
                        dp_spliced_scan.py:938-1006), a CTA a problem
  spliced_tb_walk       K3: the traceback walk over 3 or 5 states
                        (_tb_walker, dp_spliced_scan.py:1127-1196)
  spliced_tb_strips     K3, strip mode: the walks of every (slab, problem)
                        strip of one retrace launch's planes, each from
                        its start down to its slab's upper boundary
                        (traceback_spliced_strip, dp_spliced_scan.py:1235);
                        after a retrace of pairs each planes column has
                        its own slab
  spliced_ends_tb_walk  K2e as the prologue of K3's launch, the plane
                        path's (the fusion of _fused_call,
                        dp_spliced_pallas.py:1075-1178): the ends of a
                        problem by a CTA, then its walk by one warp

K6 is two modes of K1 and K4 (and of their double-affine entries), set
by the bucket: Smith-Waterman local (bp.flags.local: the zero floor,
flag bit 7, and on request K1's per-step emission of each slab's best
(H, lane)) and the -yJ bonus (bp.cip), the scan engine's
_make_step(local=True, cip=True) (dp_spliced_scan.py:223), which
spaln_tpu runs only there.  The score-only and retrace entries refuse
both: no path of the reference runs them so.

Each wrapper runs the plain version for tensors on the CPU, and for
tensors on a CUDA device launches its kernel on the current stream or
raises: nothing falls back.  ``launches`` counts kernel launches per C
entry and ``plain_calls`` calls of the plain versions under the same
names, so a run can show which path it took.

The slab entries run k slabs of a problem at once in one CTA, and a
problem's rounds of k slabs on a cluster of CTAs: slab_geometry picks k
and the shared memory (retrace_geometry for the retrace), slab_ctas the
CTAs per problem, for each launch; a slab of more lanes than an
instance's thread budget runs alone in its CTA, two lanes a thread; a
launch the kernel cannot take raises.

The kernels are built at first use with nvcc into csrc/build/ (one
shared library with a plain C interface, bound with ctypes); a failed
build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .dp_spliced import (BatchProblem, NCAND, NEV, N_GOPS, G_RES, G_ISDON,
                         G_ISACC, G_SIG5, G_ACCB, G_DINC5, n_bounds,
                         n_links, n_states, ops_from_records, pack_link)
from .params import DpParams
from ..utils.metrics import stage

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = CSRC / "spliced_dp.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("spliced_slab_trace", "spliced_slab_trace_dagp",
           "spliced_slab_retrace", "spliced_slab_retrace_dagp",
           "spliced_slab_retrace_pairs", "spliced_slab_retrace_pairs_dagp",
           "spliced_slab_links", "spliced_slab_links_dagp",
           "spliced_slab_score", "spliced_last_ends", "spliced_tb_walk",
           "spliced_tb_strips", "spliced_ends_tb_walk")
# the C entries each path launches once per batch (the UDH path launches
# the retrace and strip entries once per sub-batch of slab runs);
# spliced_tb_walk, K3 alone, is on no path: the tests and the timing
# call it
PLANE_PATH = ("spliced_slab_trace", "spliced_ends_tb_walk")
PLANE_PATH_DAGP = ("spliced_slab_trace_dagp", "spliced_ends_tb_walk")
UDH_PATH = ("spliced_slab_links", "spliced_last_ends",
            "spliced_slab_retrace", "spliced_tb_strips")
UDH_PATH_DAGP = ("spliced_slab_links_dagp", "spliced_last_ends",
                 "spliced_slab_retrace_dagp", "spliced_tb_strips")
# the UDH path after a local or -yJ links pass (K6): every slab retraced
# from its own snapshot, the pairs of a sub-batch in one launch
UDH_PATH_K6 = ("spliced_slab_links", "spliced_last_ends",
               "spliced_slab_retrace_pairs", "spliced_tb_strips")
UDH_PATH_K6_DAGP = ("spliced_slab_links_dagp", "spliced_last_ends",
                    "spliced_slab_retrace_pairs_dagp", "spliced_tb_strips")
SCORE_PATH = ("spliced_slab_score", "spliced_last_ends")
launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}

PSP_BIT = (4, 1, 8, 2, 16)        # psp orphan-exon bit per state (aln.h)
I32 = torch.int32


def entry(name: str, prm: DpParams) -> str:
    """The C entry of a slab-kernel mode for prm's gap model."""
    return f"{name}_dagp" if prm.dagp else name


# ------------------------------------------------------------------ build
def build_tag(source: Path, defines: tuple[str, ...] = ()) -> str:
    """The build's hash: of the source's content and of the nvcc defines
    (``NAME`` or ``NAME=VALUE``), in their order; with no defines, of the
    source alone."""
    h = hashlib.sha256(source.read_bytes())
    for d in defines:
        h.update(b"\0-D" + d.encode())
    return h.hexdigest()[:16]


def build_library(source: Path = SOURCE, defines: tuple[str, ...] = ()
                  ) -> tuple[Path, float, str]:
    """Compile a CUDA source of csrc/ (spliced_dp.cu unless named), with
    ``-D`` for each of ``defines``, once per (source content, defines),
    and return (library path, seconds spent compiling, nvcc's -Xptxas -v
    log)."""
    so = BUILD_DIR / f"lib{source.stem}_{build_tag(source, defines)}.so"
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
    r = subprocess.run([nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines),
                        "-o", str(tmp), str(source)],
                       capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n"
                           f"{r.stdout}\n{r.stderr}")
    log_path.write_text(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so, dt, r.stdout + r.stderr


@functools.lru_cache(maxsize=None)
def _library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library of spliced_dp.cu built with ``defines`` (none: the
    production build; SLAB_ABLATE=n: a knock-out of the score mode)."""
    so, _, _ = build_library(SOURCE, defines)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    # operands (7), then B, L, A, S, k, smem, ncta, prog and the 12 of
    # _dp_ints
    slab = [P] * 7 + [I] * 7 + [P] + [I] * 12
    # the local and -yJ modes: (cip, local, loc_v, loc_i) after the
    # outputs of K1, (cip, local) after K4's
    for name in ("spliced_slab_trace", "spliced_slab_trace_dagp"):
        getattr(lib, name).argtypes = slab + [P] * 5 + [P, I, P, P] + [P]
    for name in ("spliced_slab_retrace", "spliced_slab_retrace_dagp"):
        getattr(lib, name).argtypes = ([P] * 8 + [I] * 8 + [P] + [I] * 12
                                       + [P] * 4 + [P])
    # operands, sel, slabs, then nb, L, A, k, smem, ncta, prog, ...
    for name in ("spliced_slab_retrace_pairs",
                 "spliced_slab_retrace_pairs_dagp"):
        getattr(lib, name).argtypes = ([P] * 9 + [I] * 6 + [P] + [I] * 12
                                       + [P] * 4 + [P])
    for name in ("spliced_slab_links", "spliced_slab_links_dagp"):
        getattr(lib, name).argtypes = slab + [P] * 5 + [P, I] + [P]
    lib.spliced_slab_score.argtypes = slab + [I] + [P] * 3 + [P]
    lib.spliced_last_ends.argtypes = [P] * 5 + [I] * 10 + [P, P]
    lib.spliced_ends_tb_walk.argtypes = [P] * 7 + [I] * 15 + [P] * 3 + [P]
    lib.spliced_tb_walk.argtypes = [P] * 4 + [I] * 6 + [P, P, P]
    lib.spliced_tb_strips.argtypes = [P] * 4 + [I] * 8 + [P] + [P, P, P]
    for name in KERNELS:
        getattr(lib, name).restype = I
    lib.spliced_retrace_pairs_occupancy.argtypes = [I] * 4 + [P]
    lib.spliced_retrace_pairs_occupancy.restype = I
    lib.spliced_error_string.argtypes = [I]
    lib.spliced_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.spliced_error_string
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


def _launch(name: str, device: torch.device, *args,
            defines: tuple[str, ...] = (), loader=None) -> None:
    """Call one C entry on ``device``'s current stream and raise unless it
    returned cudaSuccess.  The entry is of the library ``loader()``
    returns (one bound with its ``error_string``), or else of this
    source's library built with ``defines``, and then counted in
    ``launches``."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}; the kernels take "
                         f"CUDA tensors and the plain versions CPU ones")
    lib = loader() if loader else _library(defines)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
    if not loader:
        count_launch(name)


_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """One more launch of ``name`` in ``launches``, under a lock: the
    shards of a batch split over devices launch from threads of their
    own (align/driver.py execute_jobs)."""
    with _count_lock:
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
    if bp.cip is not None:
        _check("cip", bp.cip, I32, (bp.B, bp.Mpad + bp.L), dev)


# The slab kernel's geometry, as csrc/spliced_dp.cu has it (max_threads,
# STAGE_C, slab_smem_ints): the most threads of each instance (mode,
# dagp), its __launch_bounds__, set from its registers (nvcc -Xptxas -v)
# so that none spills; genome columns per staged chunk; and the shared
# memory one block of an H100 may take.
SLAB_MAX_THREADS = {("trace", False): 896, ("trace", True): 640,
                    ("links", False): 512, ("links", True): 512,
                    ("score", False): 1024, ("score", True): 512}
STAGE_C = 32
SMEM_MAX = 232_448
K_LANES = 128        # k sub-slabs at most as fit the thread budget at L=128
CLUSTER_MAX = 8      # CTAs per problem at most (a portable cluster)
LANES_PER_THREAD = 2     # lanes a thread carries at most (a wide slab)
# K6's local emission: (warp, sub-slab) partials at most (warps plus
# sub-slabs: 28 + 7 at 896 threads), two buffers of (value, lane)
EMIT_SLOTS = 64
EMIT_INTS = 4 * EMIT_SLOTS


def slab_smem(mode: str, dagp: bool, KL: int, A: int,
              emit: bool = False) -> int:
    """Dynamic shared memory (bytes) of one CTA of KL threads: joint rows
    and packed operands of k*L + 2*STAGE_C staged genome columns, two
    landing chunks of the raw operand rows, the H/F(/F2) rings (and their
    links in links mode) and the substitution rows (csrc slab_smem_ints),
    and with ``emit`` (K6's local emission) EMIT_INTS ints of its
    partials."""
    rings = 7 if dagp else 5                 # H x3, F x2 (, F2 x2)
    if mode == "links":
        rings *= 2
    return 4 * (19 * (KL + 2 * STAGE_C) + 12 * STAGE_C + rings * KL
                + KL * A + (EMIT_INTS if emit else 0))


def slab_geometry(mode: str, dagp: bool, L: int, A: int,
                  S: int, emit: bool = False) -> tuple[int, int, int]:
    """(k, threads, smem bytes) of one launch of the slab kernel in
    ``mode`` ("trace", "links" or "score") over S slabs of L lanes and an
    alphabet of A: k slabs of a problem in flight per CTA, as many as the
    instance's thread budget holds at L = 128 (k * max(L, 128) <= its
    threads), no more than S, and fewer where the shared memory (with
    ``emit``, the local emission's partials too) would pass the card's.
    A slab of more lanes than the budget runs alone in its CTA, each
    thread carrying P = ceil(L / budget) lanes (at most
    LANES_PER_THREAD), so threads = ceil(k L / P).  Raises ValueError for
    what the kernel cannot take even one slab at a time."""
    maxt = SLAB_MAX_THREADS[mode, dagp]
    if not 3 <= L <= LANES_PER_THREAD * maxt:
        raise ValueError(f"lanes L={L}: the slab kernel runs "
                         f"3..{LANES_PER_THREAD * maxt} in {mode} mode")
    if A > 256:
        raise ValueError(f"alphabet of {A}: residue codes are packed in a "
                         f"byte")
    k = max(1, min(maxt // max(L, K_LANES), S))
    while k > 1 and slab_smem(mode, dagp, k * L, A, emit) > SMEM_MAX:
        k -= 1
    smem = slab_smem(mode, dagp, k * L, A, emit)
    if smem > SMEM_MAX:
        raise ValueError(f"slab kernel needs {smem} B of shared memory "
                         f"(L={L}, A={A})")
    P = -(-k * L // maxt)
    return k, -(-k * L // P), smem


def retrace_geometry(dagp: bool, L: int, A: int, nslab: int, nb: int,
                     n_sm: int) -> tuple[int, int, int]:
    """slab_geometry of a retrace launch over nb problems of nslab slabs:
    the smallest k whose rounds, ceil(nslab / k), fit the CTAs a problem
    may take (slab_ctas' cap, min(CLUSTER_MAX, n_sm // nb)), else the
    largest.  The rounds then run at once on a cluster, so the critical
    path stays near T + 2 (nslab - 1) L global steps whatever k, and a
    smaller k makes each step cheaper (fewer warps per barrier)."""
    kmax = slab_geometry("trace", dagp, L, A, nslab)[0]
    cap = max(1, min(CLUSTER_MAX, n_sm // max(nb, 1)))
    k = next((k for k in range(1, kmax) if -(-nslab // k) <= cap), kmax)
    return slab_geometry("trace", dagp, L, A, k)


def slab_ctas(k: int, nslab: int, nb: int, n_sm: int) -> int:
    """CTAs per problem (a cluster) for nb problems of nslab slabs, k in
    flight: one per round of k slabs, at most CLUSTER_MAX, and no more
    than the card's n_sm SMs hold for all nb problems at once (one CTA
    fills an SM)."""
    rounds = -(-nslab // k)
    return max(1, min(CLUSTER_MAX, rounds, n_sm // max(nb, 1)))


def slab_serial_steps(T: int, L: int, k: int, nslab: int,
                      ncta: int = 1) -> int:
    """Global steps of the critical path of nslab slabs, k at a time, on
    ncta CTAs: a round of k' slabs takes T + 2 (k' - 1) L steps; on one
    CTA the rounds run one after another, on more, round r runs on CTA
    r % ncta after that CTA's previous round, and each STAGE_C steps of
    it as soon as round r-1 has published (every STAGE_C steps) that it
    is 2 k' L + STAGE_C steps ahead or done."""
    C = STAGE_C
    starts: list[list[int]] = []     # start of each chunk of each round
    nsteps: list[int] = []

    def end(r):                      # the step after round r's last
        return starts[r][-1] + nsteps[r] - (len(starts[r]) - 1) * C

    for r in range(-(-nslab // k)):
        nstep = T + 2 * (min(k, nslab - r * k) - 1) * L
        t = end(r - ncta) if r >= ncta else 0
        chunks = []
        for q in range(-(-nstep // C)):
            if r and ncta > 1:
                kp = min(k, nslab - (r - 1) * k)
                need = min(q * C + 2 * kp * L + C, nsteps[r - 1])
                # round r-1 publishes at its chunk ends and at its end
                pub = need if need == nsteps[r - 1] else -(-need // C) * C
                t = max(t, starts[r - 1][(pub - 1) // C] + (pub - 1) % C + 1)
            chunks.append(t)
            t += C
        starts.append(chunks)
        nsteps.append(nstep)
    return max(end(r) for r in range(len(starts)))


def _slab_checks(bp: BatchProblem, prm: DpParams, mode: str,
                 nslab: int, emit: bool = False) -> tuple[int, int] | None:
    """What the slab kernel (every mode) does not take; for tensors on a
    CUDA device, the (k, smem) of slab_geometry for a launch over nslab
    slabs.  The local and -yJ modes run in trace and links mode only:
    no path of spaln_tpu runs them score-only or in a retrace (its UDH
    retrace drops both, spaln_tpu/ops/dp_spliced_udh.py:159-163)."""
    if mode == "score" and (bp.flags.local or bp.cip is not None):
        raise ValueError("the score-only slab kernel runs neither the local "
                         "mode nor the -yJ bonus: no path of the "
                         "reference asks for them")
    if mode == "links" and bp.Nmax >= (1 << 28) - 2:
        raise ValueError(f"window of {bp.Nmax} columns: links are "
                         f"column * 8 + state in int32")
    if bp.device.type == "cpu":
        return None
    k, _, smem = slab_geometry(mode, prm.dagp, bp.L, bp.qprof.shape[2],
                               nslab, emit)
    _operand_checks(bp)
    return k, smem


def _geom_args(bp: BatchProblem, geom: tuple[int, int], nb: int,
               nslab: int) -> tuple[torch.Tensor, tuple]:
    """The progress scratch (nb * rounds ints, set by the kernel; the
    caller holds it until the launch is queued) and the (k, smem, ncta,
    prog) arguments of a launch over nb problems of nslab slabs, ncta
    from slab_ctas for this card."""
    k, smem = geom
    prog = torch.empty(nb * -(-nslab // k), dtype=I32, device=bp.device)
    return prog, (k, smem, slab_ctas(k, nslab, nb, _n_sm(bp.device)),
                  _ptr(prog))


def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dp_ints(bp: BatchProblem, prm: DpParams) -> tuple:
    fl = bp.flags
    return (bp.W, bp.T, bp.Mpad, bp.Nmax + 1, prm.gop, prm.gep, prm.lgop,
            prm.lgep, prm.intron_llmt, int(fl.a_exgl), int(fl.a_exgr),
            int(fl.b_exgl))


def _operand_ptrs(bp: BatchProblem) -> tuple:
    return (_ptr(bp.qprof), _ptr(bp.gops), _ptr(bp.joint), _ptr(bp.ipen),
            _ptr(bp.Ms_t), _ptr(bp.Ns_t), _ptr(bp.lws_t))


def _scratch(bp: BatchProblem, prm: DpParams, nb: int) -> torch.Tensor:
    """The slab kernel's boundary rows (n_bounds, nb, Nmax + 2)."""
    return torch.empty((n_bounds(prm), nb, bp.Nmax + 2), dtype=I32,
                       device=bp.device)


# ------------------------------------------------------------------- K1
def spliced_slab_trace(bp: BatchProblem, prm: DpParams,
                       emit_local: bool = False):
    """K1 (K5's double-affine mode under prm.dagp): every slab of every
    problem in the bucket, Smith-Waterman local under bp.flags.local
    and with the -yJ bonus bp.cip where it is set (K6).

    Returns (flags (S, T, B, L) uint8, spj (S, NS, T, B, L) int32,
    row (B, Nmax+1) int32 = H(M, n), rc (B, Mpad+1) int32 = H(m, N)),
    NS = n_states(prm).  flags: bits 0-2 winner state, bit 3 E opened,
    bit 4 F opened, bit 5 E2 opened, bit 6 F2 opened, bit 7 local
    restart (H floored at 0), 255 = inactive cell; spj[k]: 1 + donor
    boundary of the intron closed into state k here, 0 if none.  With
    ``emit_local`` (local mode only) also (loc_v, loc_i) (S, T, B)
    int32: each slab's best H at each step over its lanes and the first
    lane that holds it, for collect_local_ends."""
    if emit_local and not bp.flags.local:
        raise ValueError("emit_local: the emission is the local mode's")
    geom = _slab_checks(bp, prm, "trace", bp.S, emit_local)
    if bp.device.type == "cpu":
        return slab_trace_plain(bp, prm, emit_local)
    B, L, S, T = bp.B, bp.L, bp.S, bp.T
    dev, Np = bp.device, bp.Nmax + 1
    flags = torch.empty((S, T, B, L), dtype=torch.uint8, device=dev)
    spj = torch.empty((S, n_states(prm), T, B, L), dtype=I32, device=dev)
    row = torch.empty((B, Np), dtype=I32, device=dev)
    rc = torch.empty((B, bp.Mpad + 1), dtype=I32, device=dev)
    loc = ((torch.empty((S, T, B), dtype=I32, device=dev),
            torch.empty((S, T, B), dtype=I32, device=dev))
           if emit_local else (None, None))
    bnd = _scratch(bp, prm, B)
    prog, gargs = _geom_args(bp, geom, B, S)
    _launch(entry("spliced_slab_trace", prm), dev, *_operand_ptrs(bp), B,
            L, bp.qprof.shape[2], S, *gargs, *_dp_ints(bp, prm), _ptr(bnd),
            _ptr(flags), _ptr(spj), _ptr(row), _ptr(rc), *_mode_args(bp),
            *(None if x is None else _ptr(x) for x in loc))
    if emit_local:
        return flags, spj, row, rc, *loc
    return flags, spj, row, rc


def _mode_args(bp: BatchProblem) -> tuple:
    """(cip pointer or null, local) of a K1 or K4 launch."""
    return (None if bp.cip is None else _ptr(bp.cip), int(bp.flags.local))


def spliced_slab_retrace(bp: BatchProblem, prm: DpParams, s0: int,
                         nslab: int, snap: torch.Tensor,
                         sel: torch.Tensor):
    """K1, retrace mode: slabs s0 .. s0+nslab-1 of the problems ``sel``
    (B' int32 indices into the bucket), each starting from its entry
    boundary ``snap`` (n_bounds, B', T+2) int32: H, F (and F2) of the
    boundary row at columns n = s0*L + 1 + lw + k, k = 0..T+1 (K4's
    snapshot of slab s0).  Returns (flags (nslab, T, B', L), spj (nslab,
    NS, T, B', L)), equal to K1's planes of those slabs and problems.
    k and the CTAs per problem come from retrace_geometry.  No path of
    spaln_tpu retraces in local mode or with the -yJ bonus (its UDH
    retrace drops both, dp_spliced_udh.py:159-163), so neither is
    taken."""
    if bp.flags.local or bp.cip is not None:
        raise ValueError("the retrace runs neither the local mode nor the "
                         "-yJ bonus: the reference's UDH retrace drops "
                         "both (spaln_tpu/ops/dp_spliced_udh.py:159-163)")
    _slab_checks(bp, prm, "trace", nslab)
    nb = int(sel.shape[0])
    if not 0 <= s0 < s0 + nslab <= bp.S:
        raise ValueError(f"slabs {s0}..{s0 + nslab - 1} of {bp.S}")
    if bp.device.type == "cpu":
        return slab_retrace_plain(bp, prm, s0, nslab, snap, sel)
    dev, L, T = bp.device, bp.L, bp.T
    _check("sel", sel, I32, (nb,), dev)
    _check("snap", snap, I32, (n_bounds(prm), nb, T + 2), dev)
    flags = torch.empty((nslab, T, nb, L), dtype=torch.uint8, device=dev)
    spj = torch.empty((nslab, n_states(prm), T, nb, L), dtype=I32,
                      device=dev)
    bnd = _scratch(bp, prm, nb)
    k, _, smem = retrace_geometry(prm.dagp, L, bp.qprof.shape[2], nslab, nb,
                                  _n_sm(dev))
    prog, gargs = _geom_args(bp, (k, smem), nb, nslab)
    _launch(entry("spliced_slab_retrace", prm), dev, *_operand_ptrs(bp),
            _ptr(sel), nb, L, bp.qprof.shape[2], s0, nslab, *gargs,
            *_dp_ints(bp, prm), _ptr(snap), _ptr(bnd), _ptr(flags),
            _ptr(spj))
    return flags, spj


def spliced_slab_retrace_pairs(bp: BatchProblem, prm: DpParams,
                               slabs: torch.Tensor, snap: torch.Tensor,
                               sel: torch.Tensor):
    """K1, retrace of (problem, slab) pairs: pair j is slab ``slabs[j]``
    of problem ``sel[j]`` (P int32 each), run alone from its own entry
    boundary ``snap[:, j]`` (snap (n_bounds, P, T+2) int32, K4's snapshot
    of that slab), a CTA a pair.  Returns (flags (1, T, P, L), spj (1,
    NS, T, P, L)): pair j's planes in column j, equal to
    spliced_slab_retrace of that slab alone.  The reference re-runs
    every slab from its own snapshot after a local or -yJ links pass
    (spaln_tpu/ops/dp_spliced_udh.py:159-163); this runs every such slab
    of a bucket in one launch, k = 1 (retrace_geometry of one slab) and
    several CTAs to an SM.  Neither K6 mode is taken (see
    spliced_slab_retrace)."""
    if bp.flags.local or bp.cip is not None:
        raise ValueError("the retrace runs neither the local mode nor the "
                         "-yJ bonus: the reference's UDH retrace drops "
                         "both (spaln_tpu/ops/dp_spliced_udh.py:159-163)")
    _slab_checks(bp, prm, "trace", 1)
    nb = int(sel.shape[0])
    if bp.device.type == "cpu":
        return slab_retrace_pairs_plain(bp, prm, slabs, snap, sel)
    dev, L, T = bp.device, bp.L, bp.T
    _check("sel", sel, I32, (nb,), dev)
    _check("slabs", slabs, I32, (nb,), dev)
    _check("snap", snap, I32, (n_bounds(prm), nb, T + 2), dev)
    flags = torch.empty((1, T, nb, L), dtype=torch.uint8, device=dev)
    spj = torch.empty((1, n_states(prm), T, nb, L), dtype=I32, device=dev)
    if not nb:
        return flags, spj
    bnd = _scratch(bp, prm, nb)
    k, _, smem = retrace_geometry(prm.dagp, L, bp.qprof.shape[2], 1, nb,
                                  _n_sm(dev))
    prog, gargs = _geom_args(bp, (k, smem), nb, 1)
    _launch(entry("spliced_slab_retrace_pairs", prm), dev,
            *_operand_ptrs(bp), _ptr(sel), _ptr(slabs), nb, L,
            bp.qprof.shape[2], *gargs, *_dp_ints(bp, prm), _ptr(snap),
            _ptr(bnd), _ptr(flags), _ptr(spj))
    return flags, spj


def retrace_pairs_occupancy(dagp: bool, L: int, A: int,
                            device: torch.device) -> tuple[int, int, int]:
    """(CTAs an SM holds at once, threads, smem bytes) of a retrace of
    pairs over L lanes and an alphabet of A on ``device`` (double affine
    under ``dagp``), from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    _, threads, smem = retrace_geometry(dagp, L, A, 1, 1, 1)
    lib = _library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.spliced_retrace_pairs_occupancy(
            int(dagp), -(-L // threads), threads, smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"spliced_retrace_pairs_occupancy: CUDA error "
                           f"{rc}: {lib.error_string(rc).decode()}")
    return out.value, threads, smem


# ------------------------------------------------------------------- K4
def spliced_slab_links(bp: BatchProblem, prm: DpParams):
    """K4 (K5's double-affine mode under prm.dagp): the UDH links forward
    over every slab of every problem, Smith-Waterman local under
    bp.flags.local and with the -yJ bonus bp.cip where it is set (K6).

    Returns (links (S, NLK, B, T) int32, snaps (S, NB, B, T+2) int32,
    row, rc as K1's), NLK = n_links(prm), NB = n_bounds(prm).
    links[s, k, b, t] is the link (column * 8 + state) of the value slab
    s emits at step t: k = 0 boundary H and 1 boundary F of lane L-1, 2
    the final-row lane clamp(M - m0, 0, L-1), 3 the lane with n == N (0
    where there is none), 4 boundary F2 of lane L-1.  snaps[s] is the H,
    F (and F2) boundary lane 0 reads in slab s, columns n = m0 + lw + k
    for k = 0..T+1 (NEV outside 0..Nmax+1)."""
    geom = _slab_checks(bp, prm, "links", bp.S)
    if bp.device.type == "cpu":
        return slab_links_plain(bp, prm)
    B, L, S, T = bp.B, bp.L, bp.S, bp.T
    dev, Np = bp.device, bp.Nmax + 1
    links = torch.empty((S, n_links(prm), B, T), dtype=I32, device=dev)
    snaps = torch.empty((S, n_bounds(prm), B, T + 2), dtype=I32,
                        device=dev)
    row = torch.empty((B, Np), dtype=I32, device=dev)
    rc = torch.empty((B, bp.Mpad + 1), dtype=I32, device=dev)
    bnd = _scratch(bp, prm, B)
    prog, gargs = _geom_args(bp, geom, B, S)
    _launch(entry("spliced_slab_links", prm), dev, *_operand_ptrs(bp), B,
            L, bp.qprof.shape[2], S, *gargs, *_dp_ints(bp, prm), _ptr(bnd),
            _ptr(row), _ptr(rc), _ptr(links), _ptr(snaps), *_mode_args(bp))
    return links, snaps, row, rc


# ------------------------------------------------------------- K5 score
def spliced_slab_score(bp: BatchProblem, prm: DpParams,
                       defines: tuple[str, ...] = ()):
    """K5, score-only mode: every slab of every problem with no planes
    and no links (single or double affine, by prm.dagp).  Returns (row,
    rc) as K1's, for K2e.  ``defines`` selects another build of the
    kernel (SLAB_ABLATE=n: a knock-out, for timing only)."""
    geom = _slab_checks(bp, prm, "score", bp.S)
    if bp.device.type == "cpu":
        return slab_score_plain(bp, prm)
    B, L, S = bp.B, bp.L, bp.S
    dev, Np = bp.device, bp.Nmax + 1
    row = torch.empty((B, Np), dtype=I32, device=dev)
    rc = torch.empty((B, bp.Mpad + 1), dtype=I32, device=dev)
    bnd = _scratch(bp, prm, B)
    prog, gargs = _geom_args(bp, geom, B, S)
    _launch("spliced_slab_score", dev, *_operand_ptrs(bp), B, L,
            bp.qprof.shape[2], S, *gargs, *_dp_ints(bp, prm), int(prm.dagp),
            _ptr(bnd), _ptr(row), _ptr(rc), defines=defines)
    return row, rc


def _select(bp: BatchProblem, sel: torch.Tensor) -> BatchProblem:
    """The problems ``sel`` of a bucket as a bucket of their own (same
    geometry)."""
    idx = sel.long()
    host = sel.tolist()
    return dataclasses.replace(
        bp, qprof=bp.qprof[idx], gops=bp.gops[idx], joint=bp.joint[idx],
        cip=None if bp.cip is None else bp.cip[idx],
        Ms_t=bp.Ms_t[idx], Ns_t=bp.Ns_t[idx], lws_t=bp.lws_t[idx],
        Ms=[bp.Ms[i] for i in host], Ns=[bp.Ns[i] for i in host],
        lws=[bp.lws[i] for i in host], B=len(host))


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


def _window(src: torch.Tensor, start: torch.Tensor, width: int):
    """src[b, start[b] + k] for k < width, NEV where the column is
    outside src."""
    k = start[:, None] + torch.arange(width, device=src.device)[None, :]
    ok = (k >= 0) & (k < src.shape[1])
    return torch.where(ok, src.gather(1, k.clamp(0, src.shape[1] - 1)),
                       NEV)


def _write(dst: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
           mask: torch.Tensor) -> None:
    """dst[b, cols[b, t]] = vals[b, t] where mask[b, t] (in place; the
    columns of one row are distinct where the mask holds)."""
    b = torch.arange(dst.shape[0], device=dst.device)[:, None]
    b = b.expand_as(cols)
    dst[b[mask], cols[mask].long()] = vals[mask]


def _slab_plain(bp: BatchProblem, prm: DpParams, mode: str = "trace",
                s0: int = 0, nslab: int | None = None,
                snap: torch.Tensor | None = None, emit_local: bool = False):
    """Plain version of the slab kernel in every mode: the scan engine's
    step (_make_step, dp_spliced_scan.py:223-577; trace, links or
    score-only mode, single or double affine by prm.dagp, Smith-Waterman
    local by bp.flags.local, the -yJ bonus by bp.cip) looped over slabs
    and steps, vectorized over (B, L), in its exact operation order.

    Local mode floors the committed H of an active cell at 0 where it is
    <= 0 and flags the cell with bit 7 (478-484, 566-567); the donor push
    and the E/F states read the value before the floor.  ``emit_local``
    (trace mode) also returns each step's best committed H over the
    slab's lanes and its lane, the first on ties (529-533).  The bonus of
    query row m is added to every acceptor close candidate of the row
    (442-445).

    What depends only on the step (operands, masks) is gathered for the
    whole slab first.  So are lane 0's reads of the boundary rows: lane
    L-1 rewrites a column only L-2 or more steps after lane 0 read it
    (L >= 3), so lane 0 reads the rows as the previous slab left them,
    and the rows, the final row and the right column are written once
    the slab is done.

    ``mode`` "trace" returns (flags, spj, row, rc) for slabs s0 ..
    s0+nslab-1, from row 0 or, with ``snap`` (NB, B, T+2), from that
    entry boundary of slab s0, and with ``emit_local`` also (loc_v,
    loc_i) (nslab, T, B); "links" returns (links, snaps, row, rc) and
    "score" (row, rc) of every slab."""
    B, L, T, W = bp.B, bp.L, bp.T, bp.W
    if L < 3:
        raise ValueError(f"lanes L={L}: the slab runs 3 or more lanes")
    links, trace = mode == "links", mode == "trace"
    local = bool(bp.flags.local)
    dagp = prm.dagp
    NS, NB = n_states(prm), n_bounds(prm)
    nslab = bp.S - s0 if nslab is None else nslab
    dev, Np = bp.device, bp.Nmax + 1
    fl = bp.flags
    gop, gep, llmt = prm.gop, prm.gep, prm.intron_llmt
    lgop, lgep = prm.lgop, prm.lgep
    gopk = (0, 0, gop, gop, lgop)                 # GOP[k // 2] by state
    lanes = torch.arange(L, device=dev, dtype=I32)
    bi = torch.arange(B, device=dev)[:, None]
    M = bp.Ms_t[:, None]
    N = bp.Ns_t[:, None]
    lw = bp.lws_t[:, None]
    nev = torch.tensor(NEV, dtype=I32, device=dev)
    if links:
        lk_out = torch.empty((bp.S, n_links(prm), B, T), dtype=I32,
                             device=dev)
        snaps = torch.empty((bp.S, NB, B, T + 2), dtype=I32, device=dev)
    elif trace:
        flags = torch.empty((nslab, T, B, L), dtype=torch.uint8,
                            device=dev)
        spj = torch.zeros((nslab, NS, T, B, L), dtype=I32, device=dev)
        if emit_local:
            loc_v = torch.empty((nslab, T, B), dtype=I32, device=dev)
            loc_i = torch.empty((nslab, T, B), dtype=I32, device=dev)
    row = torch.full((B, Np), NEV, dtype=I32, device=dev)
    rc = torch.full((B, bp.Mpad + 1), NEV, dtype=I32, device=dev)
    # boundary rows H, F (, F2) of the previous slab's last row, by n
    nn = torch.arange(Np + 1, device=dev, dtype=I32)[None, :]
    if snap is None:
        row0 = (torch.zeros_like(nn) if fl.a_exgl
                else torch.where(nn == 0, 0, gop + gep * nn).to(I32))
        bnd = [torch.where(nn <= N, row0, nev)]
        bnd += [torch.full_like(bnd[0], NEV) for _ in range(NB - 1)]
    else:
        k = nn - (s0 * L + 1 + lw)
        inw = (k >= 0) & (k < T + 2)
        kc = k.clamp(0, T + 1).expand(B, -1).long()
        bnd = [torch.where(inw, snap[r].gather(1, kc), nev)
               for r in range(NB)]
    e_const = torch.where(lw >= -M,
                          _colinit(torch.clamp(-lw, min=0), prm, fl.b_exgl),
                          nev)
    zero = torch.zeros((B, L), dtype=I32, device=dev)
    tt = torch.arange(T, device=dev, dtype=I32)[:, None, None]
    ro_all = tt - 2 * lanes                               # (T, 1, L)
    g_rows = bp.gops.permute(0, 2, 1)                     # (B, Np, 6)
    bi3 = bi[None]
    li3 = lanes.long()[None, None, :]
    for ls in range(nslab):
        s = s0 + ls
        m0 = s * L + 1
        m = m0 + lanes
        if links:
            for r in range(NB):
                snaps[s, r] = _window(bnd[r], m0 + lw[:, 0], T + 2)
        col_m = _colinit(m, prm, fl.b_exgl)
        col_m1 = _colinit(m - 1, prm, fl.b_exgl)
        internal = (~torch.tensor(fl.a_exgr, device=dev)) | (m[None] < M)
        # ---- per step, for the whole slab: cells, operands, masks
        n_all = (m0 + 1 + tt) + lw[None] - lanes          # (T, B, L)
        active_all = ((ro_all >= 0) & (ro_all < W) & (n_all >= 1)
                      & (n_all <= N[None]) & (m[None, :] <= M)[None])
        g_all = g_rows[bi3, n_all.clamp(0, Np - 1).long()]  # (T, B, L, 6)
        sig_ok = active_all & (n_all < N[None]) & internal[None]
        isdon_all = (g_all[..., G_ISDON] != 0) & sig_ok
        isacc_all = (g_all[..., G_ISACC] != 0) & sig_ok
        qp = bp.qprof[:, m0 - 1:m0 - 1 + L, :]
        score_all = qp[bi3, li3, g_all[..., G_RES].long()]
        # -yJ bonus of each lane's row, added to its close candidates
        cip = (bp.cip[:, m0 - 1:m0 - 1 + L, None] if bp.cip is not None
               else 0)
        n1_all = n_all == 1
        any_n1 = n1_all.flatten(1).any(1).tolist()
        any_acc = isacc_all.flatten(1).any(1).tolist()
        any_don = isdon_all.flatten(1).any(1).tolist()
        # lane 0 reads the previous slab's last row (see the docstring)
        n0_all = n_all[:, :, 0].T                         # (B, T)
        iu = n0_all.clamp(0, Np).long()
        idg = (n0_all - 1).clamp(0, Np).long()
        ok_up = (n0_all >= 0) & (n0_all <= N + 1)
        ok_dg = (n0_all >= 1) & (n0_all - 1 <= N)
        up0 = [torch.where(ok_up, x.gather(1, iu), nev).T[..., None]
               for x in bnd]                              # (T, B, 1) each
        dg0_h = torch.where(ok_dg, bnd[0].gather(1, idg), nev).T[..., None]
        if links:
            n0 = n0_all.T[..., None]                      # (T, B, 1)
            lk0_h, lk0_f = pack_link(n0, 0), pack_link(n0, 2)
            lk0_f2 = pack_link(n0, 4)
            lk0_dg = pack_link(n0 - 1, 0)
        # rows / lanes this slab reports for the end extraction
        li = M[:, 0] - m0
        li_ok = (li >= 0) & (li < L)
        li_c = li.clamp(0, L - 1)[:, None].long()
        rcl_all = n0_all - N                              # (B, T)
        rcl_ok = (rcl_all >= 0) & (rcl_all < L)
        rcl_c = rcl_all.clamp(0, L - 1).T[..., None].long()   # (T, B, 1)
        b_last = torch.empty((NB, T, B), dtype=I32, device=dev)
        h_row = torch.empty((T, B), dtype=I32, device=dev)
        h_rc = torch.empty((T, B), dtype=I32, device=dev)
        h1 = torch.full((B, L), NEV, dtype=I32, device=dev)
        h2, f1, e1 = h1.clone(), h1.clone(), h1.clone()
        f2_1, e2 = h1.clone(), h1.clone()
        psp = torch.zeros((B, L), dtype=I32, device=dev)
        cv = torch.full((B, L, NCAND), NEV, dtype=I32, device=dev)
        cj = torch.zeros((B, L, NCAND), dtype=I32, device=dev)
        cd, c5, lkc = cj.clone(), cj.clone(), cj.clone()
        lkh1, lkh2, lkf, lke, lkf2, lke2 = (zero,) * 6
        for t in range(T):
            n = n_all[t]
            active = active_all[t]
            score = score_all[t]
            # ---- neighbour values: lane i-1 at t-1 (up) and t-2 (diag)
            up_h = torch.cat([up0[0][t], h1[:, :-1]], dim=1)
            up_f = torch.cat([up0[1][t], f1[:, :-1]], dim=1)
            diag_h = torch.cat([dg0_h[t], h2[:, :-1]], dim=1)
            if dagp:
                up_f2 = torch.cat([up0[2][t], f2_1[:, :-1]], dim=1)
            # column 0 and the band's left edge; a lane (re)starts at
            # r_off = t - 2i = 0, and the band's top edge is r_off >= W-1
            any_first = t % 2 == 0 and t // 2 < L
            if any_first:
                first = ro_all[t] == 0
                edge = first & (n != 1)
                left_h = torch.where(edge, e_const,
                                     torch.where(first, nev, h1))
            else:
                left_h = h1
            if any_n1[t]:
                n1 = n1_all[t]
                left_h = torch.where(n1, col_m[None, :], left_h)
                diag_h = torch.where(n1, col_m1[None, :], diag_h)
            if t >= W - 1:
                at_top = ro_all[t] >= W - 1
                up_h = torch.where(at_top, nev, up_h)
                up_f = torch.where(at_top, nev, up_f)
                if dagp:
                    up_f2 = torch.where(at_top, nev, up_f2)
            if any_first:
                e1 = torch.where(first, nev, e1)
                if dagp:
                    e2 = torch.where(first, nev, e2)
                psp = torch.where(first, 0, psp)
                fc = first[..., None]
                cv = torch.where(fc, nev, cv)
                cj = torch.where(fc, 0, cj)
                cd = torch.where(fc, 0, cd)
                c5 = torch.where(fc, 0, c5)
            # ---- recurrence (order = fwd2s1.cc:276-431)
            h_val = diag_h + score
            mx_val, mx_k = h_val, torch.zeros_like(h_val)
            xo = up_h + gop                       # F: new gap >= extend
            f_open = xo >= up_f
            f_val = torch.where(f_open, xo, up_f) + gep
            gt = f_val > mx_val
            mx_val = torch.where(gt, f_val, mx_val)
            mx_k = torch.where(gt, 2, mx_k)
            if dagp:                              # F2: strict > into max
                xo = up_h + lgop
                f2_open = xo >= up_f2
                f2_val = torch.where(f2_open, xo, up_f2) + lgep
                gt2 = f2_val > mx_val
                mx_val = torch.where(gt2, f2_val, mx_val)
                mx_k = torch.where(gt2, 4, mx_k)
            prev_psp = psp                        # pre-E, feeds E2 too
            xo = left_h + gop
            e_open = xo >= e1
            e_val = torch.where(e_open, xo, e1) + gep
            psp = torch.where(e_open, (prev_psp != 0).to(I32), prev_psp & 1)
            ge = e_val >= mx_val
            mx_val = torch.where(ge, e_val, mx_val)
            mx_k = torch.where(ge, 1, mx_k)
            if dagp:                              # E2: >= into the max
                xo = left_h + lgop
                e2_open = xo >= e2
                e2_val = torch.where(e2_open, xo, e2) + lgep
                psp = torch.where(e2_open,
                                  torch.where(prev_psp != 0, psp | 2, psp),
                                  psp | (prev_psp & 2))
                ge2 = e2_val >= mx_val
                mx_val = torch.where(ge2, e2_val, mx_val)
                mx_k = torch.where(ge2, 3, mx_k)
            if links:
                # lane 0's sources sit on the boundary row: their link is
                # their own (column, state); column 0 and the band edge
                # descend from column 0 (dp_spliced_scan.py:347-366)
                lk_up_h = torch.cat([lk0_h[t], lkh1[:, :-1]], dim=1)
                lk_up_f = torch.cat([lk0_f[t], lkf[:, :-1]], dim=1)
                lk_diag = torch.cat([lk0_dg[t], lkh2[:, :-1]], dim=1)
                lk_left = torch.where(first, 0, lkh1) if any_first else lkh1
                if any_n1[t]:
                    lk_left = torch.where(n1, 0, lk_left)
                    lk_diag = torch.where(n1, 0, lk_diag)
                lkf_new = torch.where(f_open, lk_up_h, lk_up_f)
                lk_mx = torch.where(gt, lkf_new, lk_diag)
                if dagp:
                    lk_up_f2 = torch.cat([lk0_f2[t], lkf2[:, :-1]], dim=1)
                    lkf2_new = torch.where(f2_open, lk_up_h, lk_up_f2)
                    lk_mx = torch.where(gt2, lkf2_new, lk_mx)
                lke = torch.where(e_open, lk_left, lke)
                lk_mx = torch.where(ge, lke, lk_mx)
                lks = [lk_diag, lke, lkf_new]
                if dagp:
                    lke2 = torch.where(e2_open, lk_left, lke2)
                    lk_mx = torch.where(ge2, lke2, lk_mx)
                    lks += [lke2, lkf2_new]
            # ---- acceptor close (fwd2s1.cc:333-354); steps without an
            # open acceptor or donor skip work that would change nothing
            state_vals = [h_val, e_val, f_val]
            if dagp:
                state_vals += [e2_val, f2_val]
            if any_acc[t]:
                acc_ok = isacc_all[t]
                g = g_all[t]
                nc = n.clamp(0, Np - 1).long()
                ilen = n[..., None] - cj
                pen = torch.where(ilen < 0, NEV // 2,
                                  bp.ipen[ilen.clamp(0, Np - 1).long()])
                j16 = torch.gather(bp.joint[bi, nc], 2, c5.long())
                cand_ok = (acc_ok[..., None] & (ilen >= llmt)
                           & (cv > NEV // 2))
                xc = torch.where(cand_ok,
                                 cv + pen + g[..., G_ACCB, None] + j16 + cip,
                                 nev)
                jn = [zero] * NS
                for k in range(NS):
                    # candidates that could close into state k (skipping
                    # the others skips selects that would change nothing)
                    cand_k = cand_ok & (cd == k)
                    live = cand_k.flatten(0, 1).any(0).tolist()
                    if not any(live):
                        continue
                    cur = state_vals[k]
                    jnc = zero
                    for c in range(NCAND):          # best-first order
                        if not live[c]:
                            continue
                        take = cand_k[..., c] & (xc[..., c] >= cur)
                        cur = torch.where(take, xc[..., c], cur)
                        jnc = torch.where(take, cj[..., c] + 1, jnc)
                        if links:
                            lks[k] = torch.where(take, lkc[..., c], lks[k])
                    state_vals[k] = cur
                    jn[k] = jnc
                    closed = jnc > 0
                    psp = torch.where(closed, psp | PSP_BIT[k], psp)
                    ge = closed & (cur >= mx_val)
                    mx_val = torch.where(ge, cur, mx_val)
                    mx_k = torch.where(ge, k, mx_k)
                    if links:
                        lk_mx = torch.where(ge, lks[k], lk_mx)
                if trace:
                    spj[ls, :, t] = torch.stack(jn)
            # ---- donor push (fwd2s1.cc:380-406); a candidate carries its
            # value's link
            if any_don[t]:
                don_ok = isdon_all[t]
                g = g_all[t]
                for k in range(NS):
                    fv = state_vals[k]
                    elig = don_ok & ((psp & PSP_BIT[k]) == 0)
                    if k == 0:               # pushed only when diag won
                        elig = elig & (mx_k == 0)
                    z = mx_val + torch.where(
                        (mx_k == 0) | ((k - mx_k) % 2 != 0), gopk[k], 0)
                    elig = elig & ~((mx_k != k) & (fv <= z))
                    if not bool(elig.any()):
                        continue
                    kdir = torch.full_like(fv, k)
                    extra = ((lkc, lks[k]),) if links else ()
                    cv, cj, cd, c5, *rest = _insert_candidate(
                        cv, fv + g[..., G_SIG5], elig, (cj, n), (cd, kdir),
                        (c5, g[..., G_DINC5]), *extra)
                    if links:
                        lkc = rest[0]
            # ---- masked commit; local mode restarts at the zero floor
            h_out = torch.where(active, mx_val, nev)
            if local:
                reset = active & (mx_val <= 0)
                h_out = torch.where(reset, 0, h_out)
            f_out = torch.where(active, state_vals[2], nev)
            e1 = torch.where(active, state_vals[1], e1)
            h2, h1, f1 = h1, h_out, f_out
            b_last[0, t] = h_out[:, L - 1]
            b_last[1, t] = f_out[:, L - 1]
            if dagp:
                f2_1 = torch.where(active, state_vals[4], nev)
                e2 = torch.where(active, state_vals[3], e2)
                b_last[2, t] = f2_1[:, L - 1]
            h_row[t] = h_out.gather(1, li_c)[:, 0]
            h_rc[t] = h_out.gather(1, rcl_c[t])[:, 0]
            if links:
                lkh_c = torch.where(active, lk_mx, 0)
                lkh2, lkh1, lkf, lke = lkh1, lkh_c, lks[2], lks[1]
                lk_out[s, 0, :, t] = lkh_c[:, L - 1]
                lk_out[s, 1, :, t] = lkf[:, L - 1]
                lk_out[s, 2, :, t] = lkh_c.gather(1, li_c)[:, 0]
                lk_out[s, 3, :, t] = lkh_c.gather(1, rcl_c[t])[:, 0]
                if dagp:
                    lkf2, lke2 = lks[4], lks[3]
                    lk_out[s, 4, :, t] = lkf2[:, L - 1]
            elif trace:
                fl8 = mx_k | (e_open.to(I32) << 3) | (f_open.to(I32) << 4)
                if dagp:
                    fl8 = (fl8 | (e2_open.to(I32) << 5)
                           | (f2_open.to(I32) << 6))
                if local:
                    fl8 = fl8 | (reset.to(I32) << 7)
                flags[ls, t] = torch.where(active, fl8, 255).to(torch.uint8)
                if emit_local:
                    loc_v[ls, t], loc_i[ls, t] = local_emission_plain(h_out)
        # ---- H(M, n), H(m, N) and the boundary rows for the next slab
        if links:
            lk_out[s, 3] = torch.where(rcl_ok, lk_out[s, 3], 0)
        a_last = active_all[:, :, L - 1].T
        n_last = n_all[:, :, L - 1].T
        for r in range(NB):
            _write(bnd[r], n_last, b_last[r].T, a_last)
        li_t = li_c[None].expand(T, B, 1)
        _write(row, n_all.gather(2, li_t)[..., 0].T, h_row.T,
               active_all.gather(2, li_t)[..., 0].T & li_ok[:, None])
        _write(rc, m0 + rcl_all, h_rc.T,
               active_all.gather(2, rcl_c)[..., 0].T & rcl_ok)
    if links:
        return lk_out, snaps, row, rc
    if trace:
        if emit_local:
            return flags, spj, row, rc, loc_v, loc_i
        return flags, spj, row, rc
    return row, rc


def local_emission_plain(h: torch.Tensor) -> tuple:
    """K6's local emission of one step, plain: the best committed H over
    the last axis (a slab's lanes) and the first lane that holds it
    (jnp.argmax's rule, written out: torch leaves the tie order open)."""
    best = h.max(dim=-1).values
    lanes = torch.arange(h.shape[-1], device=h.device, dtype=I32)
    return best, torch.where(h == best[..., None], lanes,
                             h.shape[-1]).min(dim=-1).values


def emission_partials(h: np.ndarray, L: int, k: int, P: int, tau: int,
                      T: int, slabs: int) -> tuple:
    """The slab kernel's two-level reduction of K6's local emission at
    global step tau, modelled thread by thread: ``h`` (k*L,) the
    committed H of the round's lanes there (NEV where a cell was
    inactive, as the ring holds it), k sub-slabs of L lanes, P lanes a
    thread (thread g runs lanes g + p * nthr), T steps a slab and
    ``slabs`` of the round's sub-slabs in use.  Each warp reduces its
    lanes of each sub-slab j that steps there (t = tau - 2 j L in [0, T))
    to a (best, first lane) partial in slot warp + j: at P = 1 the lowest
    of the group's threads that holds the best (its threads hold
    consecutive lanes), at P = 2 each thread's two lanes first (the later
    only if strictly better), then the lowest lane among those holding
    the best.  Then sub-slab j's partials, warp by warp, are merged by
    (value descending, lane ascending).  Returns ({j: (best, first
    lane)}, {slot: (warp, j)} of the partials written); raises
    AssertionError where two partials would share a slot."""
    KL = k * L
    nthr = -(-KL // P)
    if P > 1 and k > 1:
        raise ValueError("two lanes a thread run one sub-slab (k = 1)")
    steps = {j for j in range(min(k, slabs)) if 0 <= tau - 2 * j * L < T}
    part, slots = {}, {}
    for w0 in range(0, nthr, 32):
        warp = w0 // 32
        groups: dict = {}
        for g in range(w0, min(w0 + 32, nthr)):
            bv, bi = int(h[g]), g % L
            for p in range(1, P):
                v = g + p * nthr
                if v < KL and h[v] > bv:
                    bv, bi = int(h[v]), v % L
            groups.setdefault(g // L, []).append((bv, bi))
        for j, grp in groups.items():
            if j not in steps:
                continue
            best = max(bv for bv, _ in grp)
            first = min(bi for bv, bi in grp if bv == best)
            if warp + j in slots:
                raise AssertionError(f"slot {warp + j}: {slots[warp + j]} "
                                     f"and {(warp, j)}")
            slots[warp + j] = (warp, j)
            part[warp + j] = (best, first)
    out = {}
    for j in sorted(steps):
        ws = (range((j * L) >> 5, ((j * L + L - 1) >> 5) + 1) if P == 1
              else range(-(-nthr // 32)))
        out[j] = min((part[w + j] for w in ws), key=lambda x: (-x[0], x[1]))
    return out, slots


# ------------------------------------------------------------------ K2e
# K2e's geometry, as csrc/spliced_dp.cu has it: a CTA of ENDS_THREADS
# (8 warps) a problem.  On the H100 it runs within 1 us of an empty
# kernel's launch up to 1,024 columns; a warp a problem was slower from
# 256 columns and within the noise at 128, shorter than any path's rows
# (PERF.md: PR 12).
ENDS_THREADS = 256


def ends_partition(base: int, lo: int, hi: int) -> list:
    """Which thread of K2e's CTA reads which index of a segment [lo, hi)
    of an int32 array whose element 0 lies ``base`` elements past a
    16-byte boundary (its address / 4 mod 4): the scalar head [lo, a) up
    to the first boundary, thread j index lo + j; whole int4 from a,
    int4 c by thread c mod ENDS_THREADS; the scalar tail after the last
    whole int4, thread j its j-th index.  Returns a list per thread of
    the indices it reads (the kernel's loop bounds, bucket_ends).

    The card's tests hold the kernel itself on strides of every residue
    mod 4, but they run only where there is a card and show a wrong split
    only as a wrong end; this model is checked on every CPU run and names
    the index that a wrong split skips or reads twice."""
    reads = [[] for _ in range(ENDS_THREADS)]
    hi = max(hi, lo)
    a = min(hi, lo + (4 - (base + lo) % 4) % 4)
    nv = (hi - a) // 4
    for j, k in enumerate(range(lo, a)):
        reads[j].append(k)
    for c in range(nv):
        reads[c % ENDS_THREADS].extend(range(a + 4 * c, a + 4 * c + 4))
    for j, k in enumerate(range(a + 4 * nv, hi)):
        reads[j].append(k)
    return reads


def _ends_args(bp: BatchProblem, prm: DpParams, row: torch.Tensor,
               rc: torch.Tensor) -> tuple:
    """K2e's operands checked, and its arguments after (row, rc): Ms, Ns,
    lws and the ints of both C entries' order."""
    dev = bp.device
    _check("row", row, I32, (bp.B, bp.Nmax + 1), dev)
    _check("rc", rc, I32, (bp.B, bp.Mpad + 1), dev)
    for nm in ("Ms_t", "Ns_t", "lws_t"):
        _check(nm, getattr(bp, nm), I32, (bp.B,), dev)
    fl = bp.flags
    return ((_ptr(bp.Ms_t), _ptr(bp.Ns_t), _ptr(bp.lws_t)),
            (bp.Nmax + 1, bp.Mpad, bp.W, prm.gop, prm.gep, int(fl.a_exgl),
             int(fl.a_exgr), int(fl.b_exgl), int(fl.b_exgr)))


def spliced_last_ends(bp: BatchProblem, prm: DpParams, row: torch.Tensor,
                      rc: torch.Tensor, out: torch.Tensor | None = None):
    """K2e: per problem (score, end_m, end_n) as a (B, 3) int32 tensor —
    the best of H(M, N), the free-end corners, the final row under
    a_exgr and the right column under b_exgr, with strict > between
    candidate groups and the first maximum within a segment."""
    if bp.device.type == "cpu":
        return last_ends_plain(bp, prm, row, rc)
    dev = bp.device
    ptrs, ints = _ends_args(bp, prm, row, rc)
    if out is None:
        out = torch.empty((bp.B, 3), dtype=I32, device=dev)
    _check("out", out, I32, (bp.B, 3), dev)
    _launch("spliced_last_ends", dev, _ptr(row), _ptr(rc), *ptrs, bp.B,
            *ints, _ptr(out))
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
# K3's band, as csrc/spliced_dp.cu has it (TB_CELLS, TB_STEP_T): from the
# cell (i, t) of the step that left the band in force, a walk stages the
# cells (i - di k, t - dt k), k < 32, of its slab: (di, dt) = (1, 2) in
# state 0, (0, 1) in a horizontal state (1, 3), (1, 1) in a vertical one
TB_BAND_CELLS = 32
TB_BAND_STEP = 2
OPEN_BIT = (0, 8, 16, 32, 64)     # flags' gap-open bit of each state


def _walk_out(name: str, t: torch.Tensor | None, shape, dev):
    """A caller's output tensor (or a new zeroed one), checked; the
    kernel stores records 16 bytes at a time."""
    if t is None:
        return torch.zeros(shape, dtype=I32, device=dev)
    _check(name, t, I32, shape, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
    return t


def spliced_tb_walk(bp: BatchProblem, flags: torch.Tensor,
                    spj: torch.Tensor, ends: torch.Tensor,
                    out: torch.Tensor | None = None,
                    stats: torch.Tensor | None = None) -> torch.Tensor:
    """K3: walk every problem's path back from its end cell through the
    planes (3 states, or 5 under double affine: spj's second axis).
    ``ends`` is K2e's (B, 3) (score, m, n).  Returns records (IT, B, 4)
    int32 = (kind, m, n, jnc - 1), kind 1 D, 2 E, 3 F, 4 I (0 = no op);
    all zero once a walk has ended.  ``stats`` (B, 2) int32, if given,
    receives each walk's steps (records written) and tile loads."""
    if bp.device.type == "cpu":
        recs = tb_walk_plain(bp, flags, spj, ends)
        if stats is not None:
            stats.copy_(walk_stats(recs, flags, bp.lws_t))
        return recs
    dev = bp.device
    S, T, B, L = bp.S, bp.T, bp.B, bp.L
    NS = _walk_states(spj)
    _check("flags", flags, torch.uint8, (S, T, B, L), dev)
    _check("spj", spj, I32, (S, NS, T, B, L), dev)
    _check("ends", ends, I32, (B, 3), dev)
    _check("lws_t", bp.lws_t, I32, (B,), dev)
    out = _walk_out("out", out, (bp.IT, B, 4), dev)
    if stats is not None:
        _check("stats", stats, I32, (B, 2), dev)
    _launch("spliced_tb_walk", dev,
            _ptr(flags), _ptr(spj), _ptr(ends), _ptr(bp.lws_t),
            B, L, S, T, bp.IT, NS, _ptr(out),
            None if stats is None else _ptr(stats))
    return out


def spliced_tb_strips(flags: torch.Tensor, spj: torch.Tensor,
                      starts: torch.Tensor, lws: torch.Tensor,
                      s0: int | torch.Tensor, IT: int,
                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """K3, strip mode: every strip of one retrace launch in one launch.
    ``flags`` (S', T, B', L) and ``spj`` are the planes of slabs s0.. of
    B' problems, or, with ``s0`` a (B',) int32 tensor (a retrace of
    pairs), column b's of slabs s0[b]..; ``starts`` (nw, 5) int32 = (m,
    n, state, m_stop, b), one walk per row, from cell (m, n) in
    ``state`` down to row m_stop (exclusive) through the planes of
    problem column b; ``lws`` (B',) are the problems' band placements.
    Records as K3's, (IT, nw, 4); ``stats`` (nw, 2), if given, as
    K3's."""
    S, T, B, L = flags.shape
    if flags.device.type == "cpu":
        recs = tb_strips_plain(flags, spj, starts, lws, s0, IT)
        if stats is not None:
            col = starts[:, 4].long()
            stats.copy_(walk_stats(recs, flags, lws[col],
                                   _walk_slab0(s0, col), starts[:, 2], col))
        return recs
    dev = flags.device
    NS = _walk_states(spj)
    nw = int(starts.shape[0])
    _check("flags", flags, torch.uint8, (S, T, B, L), dev)
    _check("spj", spj, I32, (S, NS, T, B, L), dev)
    _check("starts", starts, I32, (nw, 5), dev)
    _check("lws", lws, I32, (B,), dev)
    slab0 = None
    if isinstance(s0, torch.Tensor):
        _check("s0", s0, I32, (B,), dev)
        slab0, s0 = s0, 0
    out = _walk_out("out", None, (IT, nw, 4), dev)
    if stats is not None:
        _check("stats", stats, I32, (nw, 2), dev)
    if nw:
        _launch("spliced_tb_strips", dev, _ptr(flags), _ptr(spj),
                _ptr(starts), _ptr(lws), nw, B, L, S, T, IT, NS, s0,
                None if slab0 is None else _ptr(slab0), _ptr(out),
                None if stats is None else _ptr(stats))
    return out


def _walk_slab0(s0, col: torch.Tensor):
    """The first slab of each walk's planes: s0, or s0[col] of a (B',)
    tensor (a retrace of pairs)."""
    return s0[col].long() if isinstance(s0, torch.Tensor) else s0


def spliced_ends_tb_walk(bp: BatchProblem, prm: DpParams,
                         flags: torch.Tensor, spj: torch.Tensor,
                         row: torch.Tensor, rc: torch.Tensor,
                         ends: torch.Tensor | None = None,
                         out: torch.Tensor | None = None,
                         stats: torch.Tensor | None = None):
    """K2e and K3 in one launch, the plane path's: each problem's ends
    from K1's ``row`` and ``rc``, then its walk from them through the
    planes.  Returns (ends (B, 3), records (IT, B, 4)) as
    spliced_last_ends and spliced_tb_walk give them; ``ends``, ``out``
    and ``stats`` (B, 2), if given, receive them."""
    if bp.device.type == "cpu":
        se, recs = ends_tb_walk_plain(bp, prm, flags, spj, row, rc)
        if stats is not None:
            stats.copy_(walk_stats(recs, flags, bp.lws_t))
        return se, recs
    dev = bp.device
    S, T, B, L = bp.S, bp.T, bp.B, bp.L
    NS = _walk_states(spj)
    _check("flags", flags, torch.uint8, (S, T, B, L), dev)
    _check("spj", spj, I32, (S, NS, T, B, L), dev)
    ptrs, ints = _ends_args(bp, prm, row, rc)
    if ends is None:
        ends = torch.empty((B, 3), dtype=I32, device=dev)
    _check("ends", ends, I32, (B, 3), dev)
    out = _walk_out("out", out, (bp.IT, B, 4), dev)
    if stats is not None:
        _check("stats", stats, I32, (B, 2), dev)
    _launch("spliced_ends_tb_walk", dev, _ptr(flags), _ptr(spj), _ptr(row),
            _ptr(rc), *ptrs, B, L, S, T, bp.IT, NS, *ints, _ptr(ends),
            _ptr(out), None if stats is None else _ptr(stats))
    return ends, out


def ends_tb_walk_plain(bp: BatchProblem, prm: DpParams, flags, spj, row,
                       rc):
    """Plain version of spliced_ends_tb_walk: K2e's, then K3's."""
    plain_calls["spliced_ends_tb_walk"] += 1
    se = last_ends_plain(bp, prm, row, rc)
    return se, tb_walk_plain(bp, flags, spj, se)


def tb_walk_tiles(recs, flags, lw, s0=0, st0=None, col=None) -> list:
    """The bands K3's kernel stages, walk by walk, from the walks' records
    (IT, nw, 4) over planes whose flags are ``flags`` (S, T, B, L) (slabs
    s0.., or a walk's own s0[w] where s0 is a tensor (nw,)), band
    placements lw (nw,), start states st0 (nw,) (default 0)
    and problem columns col (nw,) (default the walk's index): for each
    walk a list of (step, band), band = (s, i, t, di, dt, n) the cells
    (i - di k, t - dt k), k < n, of slab s (relative to s0), loaded at
    record index step.  The kernel reads the cell of every record that
    lies in the planes; where it is off the band in force, it first
    stages the band from it in the walk's state there.  The flags at the
    cells read give that state (a record of kind 0 that is not the last
    hands state 0 over to the gap state of its flags; a gap move whose
    flags carry its state's open bit returns to state 0)."""
    S, T, B, L = flags.shape
    recs = torch.as_tensor(recs).cpu().numpy()
    nw = recs.shape[1]
    lw = torch.as_tensor(lw).cpu().numpy().astype(np.int64)
    st0 = (np.zeros(nw, np.int64) if st0 is None
           else torch.as_tensor(st0).cpu().numpy())
    col = (np.arange(nw) if col is None
           else torch.as_tensor(col).cpu().numpy().astype(np.int64))
    m = recs[:, :, 1].astype(np.int64)
    n = recs[:, :, 2].astype(np.int64)
    if isinstance(s0, torch.Tensor):
        s0 = s0.cpu().numpy().astype(np.int64)
    s = (m - 1) // L - s0
    i = (m - 1) % L
    t = n - m - lw[None, :] - 1 + 2 * i
    read = (m != 0) & (t >= 0) & (t < T) & (s >= 0) & (s < S)
    idx = [torch.as_tensor(np.where(read, x, 0).reshape(-1),
                           device=flags.device)
           for x in (s, t, np.broadcast_to(col, s.shape), i)]
    fl = flags[idx[0], idx[1], idx[2], idx[3]].cpu().numpy().reshape(
        s.shape).astype(np.int64)
    out = []
    for w in range(nw):
        tiles, cur, st = [], None, int(st0[w])
        rows = np.flatnonzero(m[:, w] != 0)
        for it in rows:
            if not read[it, w]:
                continue
            c = (int(s[it, w]), int(i[it, w]), int(t[it, w]))
            if cur is None or not on_band(cur, *c):
                cur = band_at(*c, *band_step(st), TB_BAND_CELLS)
                tiles.append((int(it), cur))
            kind, f = recs[it, w, 0], fl[it, w]
            if it == rows[-1]:
                break
            if st == 0 and kind == 0:                   # the hand-over
                st = int(f & 7)
            elif kind in (2, 3) and f & OPEN_BIT[st]:
                st = 0
        out.append(tiles)
    return out


def band_step(st: int) -> tuple:
    """K3's band direction (di, dt) in state st."""
    return ((1, TB_BAND_STEP) if st == 0 else (0, 1) if st in (1, 3)
            else (1, 1))


def band_at(s: int, i: int, t: int, di: int, dt: int, cells: int
            ) -> tuple:
    """The band a walk stages from cell (i, t) of slab s in direction
    (di, dt): (s, i, t, di, dt, n), the cells (i - di k, t - dt k) for
    k < n, within lanes >= 0 and rows >= 0."""
    return s, i, t, di, dt, min(cells, i + 1 if di else cells, t // dt + 1)


def on_band(band, s: int, i: int, t: int) -> bool:
    bs, bi, bt, di, dt, n = band
    k = bi - i if di else bt - t
    return (s == bs and 0 <= k < n and i == bi - di * k
            and t == bt - dt * k)


def walk_stats(recs, flags, lw, s0=0, st0=None, col=None) -> torch.Tensor:
    """(nw, 2) int32 (steps, tile loads) of K3's walks from their records
    (the arguments of tb_walk_tiles): what the kernel writes to
    ``stats``."""
    steps = (torch.as_tensor(recs)[:, :, 1] != 0).sum(0).cpu()
    loads = [len(x) for x in tb_walk_tiles(recs, flags, lw, s0, st0, col)]
    return torch.stack([steps.to(I32), torch.tensor(loads, dtype=I32)], 1)


def tb_walk_plain(bp: BatchProblem, flags: torch.Tensor, spj: torch.Tensor,
                  ends: torch.Tensor) -> torch.Tensor:
    """Plain version of K3."""
    plain_calls["spliced_tb_walk"] += 1
    z = torch.zeros_like(ends[:, 0])
    return _walk_plain(flags, spj, bp.lws_t, ends[:, 1], ends[:, 2], z, z,
                       bp.L, 0, bp.IT)


def tb_strips_plain(flags, spj, starts, lws, s0, IT: int):
    """Plain version of K3's strip mode (``s0`` an int, or a (B',) tensor
    of each column's first slab)."""
    plain_calls["spliced_tb_strips"] += 1
    col = starts[:, 4].long()
    return _walk_plain(flags, spj, lws[col], starts[:, 0], starts[:, 1],
                       starts[:, 2], starts[:, 3], flags.shape[3],
                       _walk_slab0(s0, col), IT, col)


def _walk_plain(flags, spj, lw, m, n, st, m_stop, L: int, s0, IT: int,
                col: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K3 (_tb_walker) in both modes: a loop over the
    walk's steps, vectorized over the walks; walk w reads the planes of
    problem column col[w] (default w), whose first slab is s0 (an int,
    or one a walk)."""
    S, T, B, _ = flags.shape
    NS = _walk_states(spj)
    dev = flags.device
    FL = flags.reshape(-1)
    SPJ = spj.reshape(-1)
    barr = (torch.arange(B, device=dev, dtype=torch.int64) if col is None
            else col)
    bits = torch.tensor([0, 8, 16, 32, 64], dtype=I32, device=dev)
    m, n, st = m.clone(), n.clone(), st.clone()
    done = (m <= m_stop) | (n < 1)
    recs = torch.zeros((IT, m.shape[0], 4), dtype=I32, device=dev)
    for it in range(IT):
        if it % 64 == 0 and bool(done.all()):
            break
        s = torch.div(m - 1, L, rounding_mode="floor")
        i = (m - 1) - s * L
        s = s - s0
        t = (n - m) - lw - 1 + 2 * i
        ok = ((~done) & (m >= 1) & (n >= 1) & (t >= 0) & (t < T)
              & (s >= 0) & (s < S))
        sc, tc, ic = (s.clamp(0, S - 1).long(), t.clamp(0, T - 1).long(),
                      i.clamp(0, L - 1).long())
        stc = st.clamp(0, NS - 1).long()
        fl = torch.where(ok, FL[((sc * T + tc) * B + barr) * L + ic].to(I32),
                         255)
        jnc_s = torch.where(
            ok, SPJ[(((sc * NS + stc) * T + tc) * B + barr) * L + ic], 0)
        jnc_0 = torch.where(
            ok, SPJ[((sc * NS * T + tc) * B + barr) * L + ic], 0)
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
        done = done | dead | ~ok | (m2 <= m_stop) | (n2 < 1)
        m, n = m2, n2
    return recs


def _walk_states(spj: torch.Tensor) -> int:
    NS = spj.shape[1]
    if NS not in (3, 5):
        raise ValueError(f"spj: {NS} junction planes, expected 3 or 5")
    return NS


def slab_trace_plain(bp: BatchProblem, prm: DpParams,
                     emit_local: bool = False):
    """Plain version of K1 (and of its double-affine mode)."""
    plain_calls[entry("spliced_slab_trace", prm)] += 1
    return _slab_plain(bp, prm, emit_local=emit_local)


def slab_links_plain(bp: BatchProblem, prm: DpParams):
    """Plain version of K4 (and of its double-affine mode)."""
    plain_calls[entry("spliced_slab_links", prm)] += 1
    return _slab_plain(bp, prm, mode="links")


def slab_score_plain(bp: BatchProblem, prm: DpParams):
    """Plain version of K5's score-only mode."""
    plain_calls["spliced_slab_score"] += 1
    return _slab_plain(bp, prm, mode="score")


def slab_retrace_plain(bp: BatchProblem, prm: DpParams, s0: int,
                       nslab: int, snap: torch.Tensor, sel: torch.Tensor):
    """Plain version of K1's retrace mode (and of its double-affine
    mode)."""
    plain_calls[entry("spliced_slab_retrace", prm)] += 1
    fl, spj, _, _ = _slab_plain(_select(bp, sel), prm, s0=s0, nslab=nslab,
                                snap=snap)
    return fl, spj


def slab_retrace_pairs_plain(bp: BatchProblem, prm: DpParams,
                             slabs: torch.Tensor, snap: torch.Tensor,
                             sel: torch.Tensor):
    """Plain version of the retrace of pairs (and of its double-affine
    mode): the pairs of each slab retraced together from their
    snapshots, each into its own column."""
    plain_calls[entry("spliced_slab_retrace_pairs", prm)] += 1
    nb, dev = int(sel.shape[0]), bp.device
    flags = torch.empty((1, bp.T, nb, bp.L), dtype=torch.uint8, device=dev)
    spj = torch.empty((1, n_states(prm), bp.T, nb, bp.L), dtype=I32,
                      device=dev)
    for s in sorted(set(slabs.tolist())):
        cols = torch.nonzero(slabs == s).flatten().to(dev)
        fl, sp, _, _ = _slab_plain(_select(bp, sel[cols]), prm, s0=s,
                                   nslab=1, snap=snap[:, cols])
        flags[:, :, cols] = fl
        spj[:, :, :, cols] = sp
    return flags, spj


# ----------------------------------------------------------- one bucket
@stage("device_dp")
def run_bucket(bp: BatchProblem, prm: DpParams):
    """One geometry bucket on the device: K1 (its double-affine mode under
    prm.dagp) -> K2e + K3 in one launch (spliced_ends_tb_walk) on one
    stream, then two device-to-host copies: the scores, ends and walk
    stats, then the records' first rows, as many as the longest walk
    wrote.  Returns (scores (B,) int64, ends [(m, n)], ops_all) with the
    contract of spaln_tpu's run_bucket_fused
    (dp_spliced_pallas.py:1190-1261)."""
    B, IT = bp.B, bp.IT
    flags, spj, row, rc = spliced_slab_trace(bp, prm)
    nrec = IT * B * 4
    # records (IT, B, 4) | ends (B, 3) | walk stats (B, 2)
    packed = torch.zeros(nrec + 5 * B, dtype=I32, device=bp.device)
    se, recs = spliced_ends_tb_walk(
        bp, prm, flags, spj, row, rc,
        ends=packed[nrec:nrec + 3 * B].view(B, 3),
        out=packed[:nrec].view(IT, B, 4),
        stats=packed[nrec + 3 * B:].view(B, 2))
    if recs.data_ptr() != packed.data_ptr():     # plain versions
        packed[:nrec] = recs.reshape(-1)
        packed[nrec:nrec + 3 * B] = se.reshape(-1)
    tail = packed[nrec:].cpu().numpy()
    se_h = tail[:3 * B].reshape(B, 3)
    rows = max(int(tail[3 * B:].reshape(B, 2)[:, 0].max()), 1)
    host = packed[:rows * B * 4].cpu().numpy()
    scores = se_h[:, 0].astype(np.int64)
    ends = [(int(se_h[b, 1]), int(se_h[b, 2])) for b in range(B)]
    return scores, ends, ops_from_records(host.reshape(rows, B, 4), B)
