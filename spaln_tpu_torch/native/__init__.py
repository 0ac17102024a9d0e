"""ctypes bindings for the native runtime (spaln_native.cpp).

Loads (building on first use if the toolchain is present) the shared
library with the parallel k-mer CSR builder, the FASTA encoder, the
protein path's init row and the splice-signal PSSM scan; callers fall
back to the numpy and Python paths when unavailable.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libspaln_native.so")
_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # make brings the library up to date with its source; the lock on
    # the Makefile keeps other processes from loading it half written
    with open(os.path.join(_DIR, "Makefile"), "rb") as mk:
        fcntl.flock(mk, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            pass
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
    if not hasattr(lib, "pssm_scan"):         # built from an older source
        return None
    lib.kmer_csr.restype = ctypes.c_int64
    lib.kmer_csr.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.fasta_encode.restype = ctypes.c_int64
    lib.fasta_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.tron_init_row.restype = None
    lib.tron_init_row.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.pssm_scan.restype = ctypes.c_int32
    lib.pssm_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p]
    _lib = lib
    return _lib


def kmer_csr_native(red: np.ndarray, k: int, blklen: int,
                    nthreads: int = 0):
    """(offsets, blocks) CSR of unique (k-mer, block) pairs, or None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    red = np.ascontiguousarray(red, dtype=np.int8)
    nwords = 4 ** k
    offsets = np.zeros(nwords + 1, dtype=np.int64)
    total = lib.kmer_csr(red.ctypes.data, len(red), k, blklen,
                         offsets.ctypes.data, None, 0, nthreads)
    blocks = np.zeros(max(int(total), 1), dtype=np.int32)
    lib.kmer_csr(red.ctypes.data, len(red), k, blklen,
                 offsets.ctypes.data, blocks.ctypes.data, 1, nthreads)
    return offsets, blocks[:total]


def fasta_encode_native(text: bytes, enc_tab: np.ndarray,
                        max_seqs: int = 1 << 20):
    """Parse FASTA bytes -> (codes, seq_offsets, names) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(text)
    codes = np.zeros(n, dtype=np.int8)
    seq_off = np.zeros(max_seqs, dtype=np.int64)
    nb = np.zeros(max_seqs, dtype=np.int64)
    ne = np.zeros(max_seqs, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    enc = np.ascontiguousarray(enc_tab, dtype=np.int8)
    if len(enc) < 256:
        enc = np.pad(enc, (0, 256 - len(enc)))
    nseq = lib.fasta_encode(text, n, codes.ctypes.data,
                            seq_off.ctypes.data, nb.ctypes.data,
                            ne.ctypes.data, max_seqs, enc.ctypes.data,
                            out_len.ctypes.data)
    nseq = int(nseq)
    w = int(out_len[0])
    names = [text[nb[i]:ne[i]].decode() for i in range(nseq)]
    return codes[:w], seq_off[:nseq], names


def tron_init_row_native(sigS: np.ndarray, sigE: np.ndarray, N: int,
                         a_exgl: bool, s_cut: int, gep: int, gap_w1: int,
                         gap_w2: int):
    """The tron init row (h, hd), int32 each over n = 0..N+1, in one
    compiled pass, or None if the native library is unavailable.  sigS
    reads 0 from ``s_cut`` on; no signal is copied unless it is not
    contiguous int32."""
    lib = get_lib()
    if lib is None:
        return None
    sigS = np.ascontiguousarray(sigS, dtype=np.int32)
    sigE = np.ascontiguousarray(sigE, dtype=np.int32)
    if N < 0 or len(sigS) < N or len(sigE) < N - 1:
        raise ValueError(f"tron signals of {len(sigS)} and {len(sigE)} "
                         f"positions for a window of {N}")
    h = np.empty(N + 2, dtype=np.int32)
    hd = np.empty(N + 2, dtype=np.int32)
    lib.tron_init_row(sigS.ctypes.data, sigE.ctypes.data, N,
                      min(s_cut, len(sigS)), int(bool(a_exgl)), int(gep),
                      int(gap_w1), int(gap_w2), h.ctypes.data,
                      hd.ctypes.data)
    return h, hd


def pssm_scan_native(mtx: np.ndarray, nalpha: int, morder: int,
                     offset: int, min_elem: float, tonic: float,
                     codes: np.ndarray, tab: np.ndarray):
    """Every position's window score of the (cols, rows) float32 PSSM
    ``mtx`` over ``codes`` reduced through ``tab``, float32, in one
    compiled pass (``score.pssm.scan_pssm``), or None if the native
    library is unavailable.  Raises IndexError where the numpy form
    would."""
    lib = get_lib()
    if lib is None:
        return None
    mtx = np.ascontiguousarray(mtx, dtype=np.float32)
    cols, rows = mtx.shape
    tab = np.ascontiguousarray(tab, dtype=np.int8)
    codes = np.asarray(codes)
    if codes.dtype != np.int8:
        # a code the table cannot index raises as numpy's gather does
        wide = codes.astype(np.int64)
        if wide.size and (wide.min() < -len(tab) or wide.max() >= len(tab)):
            raise IndexError(f"code outside the {len(tab)}-entry table")
        codes = wide.astype(np.int8)
    if codes.ndim != 1:
        raise ValueError(f"codes of shape {codes.shape}, not one sequence")
    codes = np.ascontiguousarray(codes)
    # numpy pads cols + 2 bases each side and reads a window that starts
    # before its padding from the other end
    if len(codes) and offset < min(morder, 2) - 3:
        raise IndexError(f"PSSM offset {offset} reads past the window")
    if len(codes) and offset > 2 * cols + 4:
        raise ValueError(f"PSSM offset {offset} past twice its {cols} "
                         "columns")
    out = np.empty(len(codes), dtype=np.float32)
    rc = lib.pssm_scan(codes.ctypes.data, len(codes), tab.ctypes.data,
                       len(tab), mtx.ctypes.data, cols, rows, nalpha,
                       morder, offset, min_elem, tonic, out.ctypes.data)
    if rc:
        raise IndexError("PSSM scan indexes outside its window or table")
    return out
