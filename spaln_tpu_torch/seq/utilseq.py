"""Query-sequence utilities: poly-A trimming, ORF finding, composition.

The roles of PolyA::rmpolyA (seq.cc:1402-1460, applied to every cDNA
query before mapping, spaln.cc:1154) and of utn's printorf/transorf
toolbox commands (utn.cc:1412-1461).
"""
from __future__ import annotations

import numpy as np

from .. import constants as K

DEF_POLYA_THR = 12          # def_polya_thr, seq.h:126


def rm_polya(codes: np.ndarray, thr: int = DEF_POLYA_THR,
             which: int = 3) -> tuple[int, int, int]:
    """Locate poly-A tail / poly-T head (+1 per A/T, -5 otherwise,
    trim where the running score peaks above ``thr``).

    Returns (lo, hi, strand_hint): use codes[lo:hi]; hint 1 = '+' gene
    (poly-A tail), 2 = '-' gene (poly-T head), 3 = undetermined.
    ``which``: 1 = tail only, 2 = head only, 3 = both.
    """
    n = len(codes)
    lo, hi = 0, n
    maxa = maxt = -1
    polya = polyt = 0
    if which != 2:
        scr = 0
        for i in range(n - 1, -1, -1):
            scr += 1 if codes[i] == K.A else -5
            if scr > polya:
                polya = scr
                if scr > thr:
                    maxa = i
            if scr < polya - thr:
                break
    if which != 1:
        scr = 0
        for i in range(n):
            scr += 1 if codes[i] == K.T else -5
            if scr > polyt:
                polyt = scr
                if scr > thr:
                    maxt = i
            if scr < polyt - thr:
                break
    if maxa >= 0 and maxt >= 0:
        if polya >= polyt:
            maxt = -1
        else:
            maxa = -1
    hint = 3
    if maxa >= 0:
        hi, hint = maxa, 1
    elif maxt >= 0:
        lo, hint = maxt + 1, 2
    return lo, hi, hint


def find_orfs(codes: np.ndarray, min_len: int = 30,
              both_strands: bool = True) -> list[tuple]:
    """Open reading frames >= min_len nt: (start, end, frame, strand)
    half-open nt coords on the forward strand (printorf role)."""
    from .codec import comrev, translate
    out = []
    n = len(codes)
    for strand, seq in ((1, np.asarray(codes)),
                        (-1, comrev(codes)) if both_strands else (None,
                                                                  None)):
        if seq is None:
            continue
        for frame in range(3):
            aa = translate(seq, frame)
            stop = np.isin(aa, (K.TRM, K.TRM2))
            start = 0
            for i in list(np.nonzero(stop)[0]) + [len(aa)]:
                length = 3 * (i - start)
                if length >= min_len:
                    b0 = frame + 3 * start
                    b1 = frame + 3 * i
                    if strand < 0:
                        b0, b1 = n - b1, n - b0
                    out.append((int(b0), int(b1), frame, strand))
                start = i + 1
    out.sort(key=lambda o: -(o[1] - o[0]))
    return out


def composition(codes: np.ndarray, is_aa: bool = False) -> dict:
    """Residue composition (utn 'c' command role)."""
    dec = K.AA_DECODE if is_aa else K.NUC_DECODE
    cnt = np.bincount(np.asarray(codes, dtype=np.int64),
                      minlength=len(dec))
    return {dec[i]: int(c) for i, c in enumerate(cnt[:len(dec)]) if c}
