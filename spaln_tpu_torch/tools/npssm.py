"""Splice / translation-signal PSSM builder (npssm.cc role).

From a set of aligned junction windows (sequences all anchored at the
same signal position), compute per-column m-th-order Markov log-odds
``log10((r + eps) / (1 + eps))`` against background k-mer frequencies
(npssm.cc:395-470), laid out in the PatMat row scheme our PSSM loader
reads (score/pssm.py): order-2 rows = 4 + 16 + 64 = 84 per column, where
the 0th/1st-order blocks are consumed only at the window start.
"""
from __future__ import annotations

import numpy as np

from ..constants import NT_REDUCE4
from ..score.pssm import PSSM


def _site_counts(wins: np.ndarray, morder: int):
    """Per-column mono/di/tri counts.  wins: (nseq, cols+morder) reduced
    codes (values >= 4 = ambiguous, excluded)."""
    nseq = wins.shape[0]
    cols = wins.shape[1] - morder
    mono = np.zeros((cols, 4))
    di = np.zeros((cols, 16))
    tri = np.zeros((cols, 64))
    v = wins < 4
    w = np.where(v, wins, 0)
    for c in range(cols):
        mono[c] = np.bincount(w[v[:, c], c], minlength=4)
        if morder >= 1 and c + 1 < wins.shape[1]:
            ok = v[:, c] & v[:, c + 1]
            di[c] = np.bincount(4 * w[ok, c] + w[ok, c + 1], minlength=16)
        if morder >= 2 and c + 2 < wins.shape[1]:
            ok = v[:, c] & v[:, c + 1] & v[:, c + 2]
            tri[c] = np.bincount(16 * w[ok, c] + 4 * w[ok, c + 1]
                                 + w[ok, c + 2], minlength=64)
    return mono, di, tri


def build_pssm(windows: list[np.ndarray], offset: int,
               bg_mono: np.ndarray, bg_di: np.ndarray | None = None,
               bg_tri: np.ndarray | None = None, morder: int = 2,
               eps: float = 0.01) -> PSSM:
    """PSSM from equal-length junction windows.

    offset: column index of the signal position (e.g. the first intron
    base for a donor Splice5 matrix).  Background tables come from
    tools.kmers.count_kmers over the genome.
    """
    wins = np.stack([NT_REDUCE4[np.asarray(w, dtype=np.int64)]
                     for w in windows])
    nseq = wins.shape[0]
    # the scan's order-m context at the last columns reads m bases past
    # the window (scan_pssm order-2 path), so training windows carry
    # ``morder`` extra trailing bases
    cols = wins.shape[1] - morder
    mono, di, tri = _site_counts(wins, morder)
    rc = bg_mono / max(bg_mono.sum(), 1)
    if bg_di is not None:
        rdi = (bg_di.reshape(4, 4) + 1.)
        rdi = rdi / rdi.sum(axis=1, keepdims=True)      # P(b1 | b0)
    if bg_tri is not None:
        rtri = (bg_tri.reshape(16, 4) + 1.)
        rtri = rtri / rtri.sum(axis=1, keepdims=True)   # P(b2 | b0 b1)

    nrows = {0: 4, 1: 20, 2: 84}[morder]
    mtx = np.zeros((cols, nrows))

    def lod(r):
        return np.log10((r + eps) / (1. + eps))

    for c in range(cols):
        tot = max(mono[c].sum(), 1.)
        p0 = mono[c] / tot
        mtx[c, :4] = lod(p0 / np.maximum(rc, 1e-9))
        if morder >= 1:
            dsum = np.maximum(mono[c][:, None], 1.)
            pd = (di[c].reshape(4, 4) + eps) / (dsum + 4 * eps)
            r1 = pd / (rdi if bg_di is not None
                       else np.full((4, 4), .25))
            mtx[c, 4:20] = lod(r1).ravel()
        if morder >= 2:
            dsum = np.maximum(di[c][:, None], 1.)
            pt = (tri[c].reshape(16, 4) + eps) / (dsum + 4 * eps)
            r2 = pt / (rtri if bg_tri is not None
                       else np.full((16, 4), .25))
            mtx[c, 20:84] = lod(r2).ravel()
    # per-position score range for the header / tonic threshold
    scores = scan_windows(mtx, wins, morder)
    return PSSM(mtx=mtx.astype(np.float32), offset=offset,
                tonic=float(max(scores.min(), -5.0)),
                mean=float(scores.mean()), min=float(scores.min()),
                max=float(scores.max()), nsupport=nseq, nalpha=4,
                morder=morder, min_elem=float(mtx.min()))


def scan_windows(mtx: np.ndarray, wins: np.ndarray,
                 morder: int) -> np.ndarray:
    """Self scores of the training windows under the PatMat scan rule."""
    nseq = wins.shape[0]
    cols = wins.shape[1] - morder
    out = np.zeros(nseq)
    v = wins < 4
    w = np.where(v, wins, 0)
    for c in range(cols):
        if morder == 0 or c == 0:
            out += np.where(v[:, c], mtx[c, w[:, c]], 0.)
        if morder >= 1 and (morder == 1 or c == 0):
            ok = v[:, c] & v[:, c + 1]
            out += np.where(ok, mtx[c, 4 + 4 * w[:, c] + w[:, c + 1]], 0.)
        if morder >= 2:
            ok = v[:, c] & v[:, c + 1] & v[:, c + 2]
            out += np.where(
                ok, mtx[c, 20 + 16 * w[:, c] + 4 * w[:, c + 1]
                        + w[:, c + 2]], 0.)
    return out


def write_pssm(path: str, p: PSSM) -> None:
    """PatMat text format (header per score/pssm.py load_pssm)."""
    with open(path, "w") as fh:
        # header = cols rows offset transpose skip min mean max nsupport
        # (the shipped Splice5 layout: "8 84 1 1 ..." = 8 window columns
        # of 84 context rows each, one line per window column)
        fh.write(f"{p.cols} {p.rows} {p.offset} 1 0 {p.min:.4f} "
                 f"{p.mean:.4f} {p.max:.4f} {p.nsupport}\n")
        for c in range(p.cols):
            fh.write(" ".join(f"{x:9.5f}" for x in p.mtx[c]) + "\n")
