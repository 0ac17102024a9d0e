"""Coding / exon / intron oligomer-potential builders (exinpot.cc role).

Potentials are log10(foreground k-mer frequency / background frequency)
(ExinPot::makeExinPot, utilseq.cc:1312-1331).  The coding potential is
phase-specific (3 columns, one per codon phase of the k-mer's last base)
plus an all-frame column, written in the CodePotTab text layout our
scoring loader reads (score/codepot.py CodePotTab.load); intron/exon
potentials are single-phase (IntronPotTab/ExonPotTab layout).
"""
from __future__ import annotations

import numpy as np

from ..constants import NT_REDUCE4
from .kmers import count_kmers


def _phase_kmer_counts(seqs: list[np.ndarray], k: int,
                       phase0: int = 0) -> np.ndarray:
    """(4^k, 3) counts by codon phase of the k-mer's END position,
    assuming each sequence starts in-frame at ``phase0``."""
    out = np.zeros((4 ** k, 3), dtype=np.int64)
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
        ends = np.arange(k - 1, L)
        ph = (ends + phase0) % 3
        for p in range(3):
            sel = ok & (ph == p)
            out[:, p] += np.bincount(w[sel], minlength=4 ** k)
    return out


def build_codepot(cds_seqs: list[np.ndarray],
                  bg_seqs: list[np.ndarray],
                  morder: int = 5) -> np.ndarray:
    """(4^(morder+1), 4) coding potential: 3 phase columns + all-frame
    (the CodePotTab content; phases follow calcScr_3's convention that
    column p scores a k-mer ending at codon position p)."""
    k = morder + 1
    fg = _phase_kmer_counts(cds_seqs, k).astype(np.float64) + 1.
    bg = count_kmers(bg_seqs, k).astype(np.float64) + 1.
    fgp = fg / fg.sum(axis=0, keepdims=True)
    fga = fg.sum(axis=1) / fg.sum()
    bgp = bg / bg.sum()
    pot = np.empty((4 ** k, 4), dtype=np.float64)
    pot[:, :3] = np.log10(fgp / bgp[:, None])
    pot[:, 3] = np.log10(fga / bgp)
    return pot


def build_exinpot(fg_seqs: list[np.ndarray],
                  bg_seqs: list[np.ndarray],
                  morder: int = 4) -> np.ndarray:
    """(4^(morder+1),) single-phase potential (IntronPotTab/ExonPotTab)."""
    k = morder + 1
    fg = count_kmers(fg_seqs, k).astype(np.float64) + 1.
    bg = count_kmers(bg_seqs, k).astype(np.float64) + 1.
    return np.log10((fg / fg.sum()) / (bg / bg.sum()))


def write_codepot(path: str, pot: np.ndarray) -> None:
    morder = int(np.log2(len(pot)) / 2) - 1
    with open(path, "w") as fh:
        fh.write(f"CodePotTab 4 {len(pot)} {morder} 1\n")
        for row in pot:
            fh.write("".join(f"{x:11.5f}\t" for x in row).rstrip() + "\n")


def write_exinpot(path: str, pot: np.ndarray, kind: str = "IntronPotTab",
                  nsupport: int = 0, lm: int = 6, rm: int = 16,
                  avlen: float = 0.) -> None:
    with open(path, "w") as fh:
        fh.write(f"{kind} 1 {len(pot)} {pot.min():.5f} {pot.mean():.5f} "
                 f"{pot.max():.5f} {nsupport} {lm} {rm} {avlen:8.2f}\n")
        for x in pot:
            fh.write(f"{x:11.5f}\n")
