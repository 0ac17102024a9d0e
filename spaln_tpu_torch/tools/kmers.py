"""K-mer frequency counting over sequence sets (kmers.cc role).

Produces the background word-frequency tables (the .wdfq inputs of npssm
and exinpot, kmers.cc:1-347) as plain numpy arrays; the text form writes
``kmer count`` lines compatible with downstream tools.
"""
from __future__ import annotations

import numpy as np

from ..constants import NT_REDUCE4

_BASES = "ACGT"


def count_kmers(seqs: list[np.ndarray], k: int) -> np.ndarray:
    """(4^k,) int64 counts over all valid (unambiguous) k-mers."""
    out = np.zeros(4 ** k, dtype=np.int64)
    for codes in seqs:
        red = NT_REDUCE4[np.asarray(codes, dtype=np.int64)]
        L = len(red)
        if L < k:
            continue
        valid = red < 4
        w = np.zeros(L - k + 1, dtype=np.int64)
        ok = np.ones(L - k + 1, dtype=bool)
        for i in range(k):
            w = w * 4 + np.where(valid, red, 0)[i:L - k + 1 + i]
            ok &= valid[i:L - k + 1 + i]
        out += np.bincount(w[ok], minlength=4 ** k)
    return out


def kmer_string(code: int, k: int) -> str:
    s = []
    for _ in range(k):
        s.append(_BASES[code & 3])
        code >>= 2
    return "".join(reversed(s))


def write_wdfq(path: str, seqs: list[np.ndarray], kmax: int = 3) -> None:
    """Write mono- through kmax-mer counts as ``kmer count`` lines
    (the .wdfq background format read by npssm, npssm.cc:310-333)."""
    with open(path, "w") as fh:
        for k in range(1, kmax + 1):
            counts = count_kmers(seqs, k)
            for c, n in enumerate(counts):
                fh.write(f"{kmer_string(c, k)}\t{int(n)}\n")


def read_wdfq(path: str, kmax: int = 3) -> list[np.ndarray]:
    """Read back per-k count arrays [k=1..kmax]."""
    tabs = [np.zeros(4 ** k, dtype=np.int64) for k in range(1, kmax + 1)]
    code = {b: i for i, b in enumerate(_BASES)}
    with open(path) as fh:
        for line in fh:
            toks = line.split()
            if len(toks) != 2 or any(ch not in code for ch in toks[0]):
                continue
            k = len(toks[0])
            if 1 <= k <= kmax:
                w = 0
                for ch in toks[0]:
                    w = w * 4 + code[ch]
                tabs[k - 1][w] = int(toks[1])
    return tabs
