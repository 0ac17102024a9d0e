"""ctypes bindings for the native runtime (spaln_native.cpp).

Loads (building on first use if the toolchain is present) the shared
library with the parallel k-mer CSR builder, the FASTA encoder and the
protein path's init row; callers fall back to the numpy and Python paths
when unavailable.
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
    if not hasattr(lib, "tron_init_row"):     # built from an older source
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
