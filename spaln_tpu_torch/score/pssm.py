"""Position-specific score matrices with m-th order Markov context.

Reproduces PatMat (utilseq.cc:737-1000): text format header
``rows cols offset transvers skip min mean max nsupport`` followed by
``skip`` ignored lines and rows*cols floats.  The scan over a sequence is a
gather + windowed sum over precomputed context codes — TPU-friendly (a
one-hot conv1d), but PSSM scans only run over candidate gene windows, so
they run on the host: one compiled pass of the native library
(``scan_pssm``), the numpy form (``scan_pssm_plain``) where it cannot be
loaded.

Context layout per window column m (order 2, rows = 4+16+64 = 84):
  ptn[m][k]        0th-order  (only added at m == 0)
  ptn[m][4+c]      1st-order  c = 4*b0+b1       (only added at m == 0)
  ptn[m][20+c]     2nd-order  c = 16*b0+4*b1+b2 (added every m)
Order 1 (rows = 4+16): per m adds ptn[m][4 + 4*b_m + b_{m+1}], plus
ptn[0][b_0] at m == 0.  Order 0: per m adds ptn[m][b_m].
"""
from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from ..constants import NT_REDUCE4, TRON_REDUCE4
from ..native import pssm_scan_native
from ..utils.metrics import metrics

MAXTONIC = 5.0                  # utilseq.h:38


@dataclass
class PSSM:
    mtx: np.ndarray             # (cols, rows) float32
    offset: int                 # window start = position - offset
    tonic: float                # clamped min, added once per position
    mean: float
    min: float
    max: float
    nsupport: int
    nalpha: int
    morder: int
    min_elem: float

    @property
    def cols(self) -> int:
        return self.mtx.shape[0]

    @property
    def rows(self) -> int:
        return self.mtx.shape[1]


def load_pssm(src) -> PSSM:
    """Parse one PatMat from an open text stream or path
    (PatMat::readPatMat utilseq.cc:737-776)."""
    close = False
    if isinstance(src, str):
        src = open(src)
        close = True
    try:
        line = src.readline()
        while line and not line.strip():
            line = src.readline()
        hdr = line.split()
        rows, cols, offset = int(hdr[0]), int(hdr[1]), int(hdr[2])
        t = int(hdr[3]) if len(hdr) > 3 else 0
        skip = int(hdr[4]) if len(hdr) > 4 else 0
        mmin = float(hdr[5]) if len(hdr) > 5 else 0.
        mean = float(hdr[6]) if len(hdr) > 6 else 0.
        mmax = float(hdr[7]) if len(hdr) > 7 else 0.
        nsup = int(hdr[8]) if len(hdr) > 8 else 0
        for _ in range(skip):
            src.readline()
        need = rows * cols
        vals: list[float] = []
        while len(vals) < need:
            line = src.readline()
            if not line:
                raise ValueError("PSSM data incomplete")
            vals.extend(float(x) for x in line.split())
        # consume remainder of last data line (already split fully)
        extra = vals[need:]
        assert not extra or all(isinstance(v, float) for v in extra)
        arr = np.asarray(vals[:need], dtype=np.float32)
        if t:
            rows, cols = cols, rows
        # stored row-major as ptn[m*rows + k] with m = window column
        mtx = arr.reshape(cols, rows)
        if rows % 23 == 0:
            nalpha = 23
        elif rows % 4 == 0:
            nalpha = 4
        else:
            nalpha = rows
        morder, d = 0, nalpha
        while d < rows:
            morder += 1
            d = d * (d + 1)
        tonic = mmin
        if -tonic > MAXTONIC:
            tonic = -MAXTONIC
        return PSSM(mtx=mtx, offset=offset, tonic=tonic, mean=mean, min=mmin,
                    max=mmax, nsupport=nsup, nalpha=nalpha, morder=morder,
                    min_elem=float(arr.min()))
    finally:
        if close:
            src.close()


def load_pssm_stack(path: str, n: int) -> list[PSSM]:
    """Read n concatenated PatMats from one file (the Intron53 layout)."""
    out = []
    with open(path) as fh:
        for _ in range(n):
            out.append(load_pssm(fh))
    return out


def _reduce(codes: np.ndarray, tron: bool) -> np.ndarray:
    tab = TRON_REDUCE4 if tron else NT_REDUCE4
    return tab[np.asarray(codes, dtype=np.int64)]


def scan_pssm(pssm: PSSM, codes: np.ndarray, tron: bool = False,
              zero_tonic: bool = False) -> np.ndarray:
    """``scan_pssm_plain``'s scores, bit for bit, from one compiled pass
    of the native library; ``scan_pssm_plain`` where the library cannot
    be loaded.  The counters ``pssm_scan_native`` and ``pssm_scan_plain``
    count the calls of each."""
    out = pssm_scan_native(pssm.mtx, pssm.nalpha, pssm.morder,
                           pssm.offset, pssm.min_elem,
                           0. if zero_tonic else pssm.tonic, codes,
                           TRON_REDUCE4 if tron else NT_REDUCE4)
    if out is not None:
        metrics.bump("pssm_scan_native")
        return out
    metrics.bump("pssm_scan_plain")
    return scan_pssm_plain(pssm, codes, tron, zero_tonic)


def scan_pssm_plain(pssm: PSSM, codes: np.ndarray, tron: bool = False,
                    zero_tonic: bool = False) -> np.ndarray:
    """Score every position of ``codes`` (PatMat::calcPatMat).

    Returns float32 array s.t. out[p] = window score of the window starting
    at p - offset.  Windows with any ambiguous/out-of-range base score 0
    from the first bad base on (order<=1) or cols*min_elem (order 2),
    matching utilseq.cc:914-1000.
    """
    red = _reduce(codes, tron).astype(np.int64)
    L = len(red)
    cols, nalpha = pssm.cols, pssm.nalpha
    tonic = 0. if zero_tonic else pssm.tonic
    bad = red >= nalpha
    # pad so windows can run off either end; padded positions are "bad"
    pad = cols + 2
    redp = np.concatenate([np.zeros(pad, np.int64), red,
                           np.zeros(pad, np.int64)])
    badp = np.concatenate([np.ones(pad, bool), bad, np.ones(pad, bool)])
    starts = np.arange(L) - pssm.offset + pad      # window starts, padded idx
    m_idx = np.arange(cols)
    win = starts[:, None] + m_idx[None, :]          # (L, cols) base positions
    b0 = redp[win]
    bb0 = badp[win]
    if pssm.morder == 0:
        contrib = pssm.mtx[m_idx[None, :], b0]
        good = ~bb0
        # reference zeroes contributions from the first bad char onward
        ok_prefix = np.cumprod(good, axis=1).astype(bool)
        return (contrib * ok_prefix).sum(axis=1).astype(np.float32) + tonic
    b1 = redp[win + 1]
    bb1 = badp[win + 1]
    if pssm.morder == 1:
        c1 = nalpha * b0 + b1 + nalpha
        contrib = pssm.mtx[m_idx[None, :], np.clip(c1, 0, pssm.rows - 1)]
        first = pssm.mtx[0, b0[:, 0]]
        anybad = bb0 | bb1
        ok_prefix = np.cumprod(~anybad, axis=1).astype(bool)
        out = (contrib * ok_prefix).sum(axis=1)
        # the m==0 marginal is added if the first base itself is good
        # (checked before the context base, utilseq.cc:933-937)
        out += np.where(~bb0[:, 0], first, 0.)
        return out.astype(np.float32) + tonic
    # order 2
    b2 = redp[win + 2]
    bb2 = badp[win + 2]
    c2 = 16 * b0 + 4 * b1 + b2 + 20
    contrib = pssm.mtx[m_idx[None, :], np.clip(c2, 0, pssm.rows - 1)]
    anybad = bb0 | bb1 | bb2
    # per reference order-2 path: if ANY bad char in window -> cols*min_elem
    window_bad = anybad.any(axis=1)
    total = contrib.sum(axis=1)
    total += pssm.mtx[0, np.clip(b0[:, 0], 0, 3)]            # 0th at m=0
    total += pssm.mtx[0, np.clip(4 * b0[:, 0] + b1[:, 0] + 4, 0,
                                 pssm.rows - 1)]             # 1st at m=0
    total = np.where(window_bad, cols * pssm.min_elem, total)
    return total.astype(np.float32) + tonic
