"""Sequence encode/decode/transform primitives (host-side, vectorized numpy).

Semantics match the reference sequence model (ogotoh/spaln src/seq.cc:30-120,
src/utilseq.cc:176-225): IUPAC-bitmask nucleotide codes, amino-acid codes,
complement/reverse-complement, 3-frame translation and the centered-codon
"tron" alphabet used for protein x genome spliced alignment.

These run on host during data loading; device kernels consume the resulting
int8 arrays.
"""
from __future__ import annotations

import numpy as np

from ..constants import (AA_DECODE, AA_ENCODE, AMB, AA_UNP, GAP, GENCODE,
                         NT_ELEMENT, NT_ENCODE, NT_REDUCE4, NUC_COMPLEMENT,
                         NUC_DECODE, SER, SER2, TRM, TRM2, TRON_DECODE, G,
                         LYS, ALA, GLY, LEU, N)

# most abundant aa per middle base, used when 1st codon base is ambiguous
# (utilseq.cc:176)
_MOST_ABUND = np.array([LYS, ALA, GLY, LEU], dtype=np.int8)


def encode_dna(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII -> nt codes (int8). Unknown letters become N."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return NT_ENCODE[raw]


def encode_protein(seq: bytes | str | np.ndarray) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return AA_ENCODE[raw]


def decode_dna(codes: np.ndarray) -> str:
    lut = np.frombuffer(NUC_DECODE.encode(), dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def decode_protein(codes: np.ndarray) -> str:
    lut = np.frombuffer(AA_DECODE.encode(), dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def decode_tron(codes: np.ndarray) -> str:
    lut = np.frombuffer(TRON_DECODE.encode(), dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def complement(codes: np.ndarray) -> np.ndarray:
    """Per-base complement of nt codes (seq.cc:74 complcod)."""
    return NUC_COMPLEMENT[np.asarray(codes, dtype=np.int64)]


def comrev(codes: np.ndarray) -> np.ndarray:
    """Reverse complement."""
    return complement(codes)[::-1].copy()


def _codon_index(b1: np.ndarray, b2: np.ndarray, b3: np.ndarray) -> np.ndarray:
    return (16 * b1.astype(np.int32) + 4 * b2.astype(np.int32)
            + b3.astype(np.int32))


def translate(codes: np.ndarray, frame: int = 0) -> np.ndarray:
    """Translate nt codes -> aa codes in the given frame (0/1/2).

    Matches toaa3 (utilseq.cc:191-202): gap in 2nd base -> UNP, ambiguous
    2nd base -> AMB, ambiguous 1st base -> most-abundant aa of 2nd base.
    """
    codes = np.asarray(codes)
    n = (len(codes) - frame) // 3
    if n <= 0:
        return np.zeros(0, dtype=np.int8)
    tri = codes[frame:frame + 3 * n].reshape(n, 3)
    return _tron_of(tri[:, 0], tri[:, 1], tri[:, 2], tron=False)


def _tron_of(c1: np.ndarray, c2: np.ndarray, c3: np.ndarray,
             tron: bool) -> np.ndarray:
    """Vectorized nuc2tron3/toaa3 (utilseq.cc:191-225)."""
    r1 = NT_REDUCE4[np.asarray(c1, dtype=np.int64)]
    r2 = NT_REDUCE4[np.asarray(c2, dtype=np.int64)]
    e3 = NT_ELEMENT[np.asarray(c3, dtype=np.int64)]
    idx = _codon_index(np.clip(r1, 0, 3), np.clip(r2, 0, 3), e3)
    aa = GENCODE[idx].copy()
    amb1 = r1 >= 4
    aa[amb1] = _MOST_ABUND[np.clip(r2, 0, 3)][amb1]
    aa[r2 >= 4] = AMB
    aa[np.asarray(c2) <= GAP] = AA_UNP
    if tron:
        mid_g = np.asarray(c2) == G
        aa[(aa == SER) & mid_g] = SER2
        aa[(aa == TRM) & mid_g] = TRM2
    return aa.astype(np.int8)


def nuc2tron(codes: np.ndarray) -> np.ndarray:
    """Genomic nt codes -> centered-codon tron codes, same length.

    tron[p] = translation of the codon (p-1, p, p+1), AGY-serine mapped to
    SER2 and TGA to TRM2 (nuc2tron3, utilseq.cc:204-225; placement per
    Seq::nuc2tron seq.cc:774-798).  Boundary positions (no full codon)
    become AMB.
    """
    codes = np.asarray(codes, dtype=np.int8)
    n = len(codes)
    out = np.full(n, AMB, dtype=np.int8)
    if n >= 3:
        out[1:n - 1] = _tron_of(codes[:-2], codes[1:-1], codes[2:], tron=True)
    return out
