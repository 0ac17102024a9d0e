"""Sequence divergence estimators (dvn/dvp/divseq roles, divseq.cc).

Given an aligned pair (or its match/mismatch counts), estimate
evolutionary distance: Jukes-Cantor and Kimura 2-parameter for
nucleotides, Poisson and Kimura (1983) for proteins.
"""
from __future__ import annotations

import math

import numpy as np

from .. import constants as K


def _aligned_pairs(a: np.ndarray, b: np.ndarray):
    n = min(len(a), len(b))
    a = np.asarray(a[:n], dtype=np.int64)
    b = np.asarray(b[:n], dtype=np.int64)
    return a, b


def p_distance(a: np.ndarray, b: np.ndarray, is_aa: bool = False) -> float:
    a, b = _aligned_pairs(a, b)
    lo = 3 if is_aa else 2
    hi = 23 if is_aa else 10
    ok = (a >= lo) & (a < hi) & (b >= lo) & (b < hi)
    if not ok.any():
        return 0.0
    return float((a[ok] != b[ok]).mean())


def jukes_cantor(a: np.ndarray, b: np.ndarray) -> float:
    """JC69 nt distance: -3/4 ln(1 - 4p/3)."""
    p = p_distance(a, b)
    x = 1. - 4. * p / 3.
    return math.inf if x <= 0 else -0.75 * math.log(x)


def kimura_2p(a: np.ndarray, b: np.ndarray) -> float:
    """K80 nt distance from transition (P) and transversion (Q) rates."""
    a, b = _aligned_pairs(a, b)
    ok = np.isin(a, (K.A, K.C, K.G, K.T)) & np.isin(b, (K.A, K.C, K.G,
                                                        K.T))
    if not ok.any():
        return 0.0
    aa, bb = a[ok], b[ok]
    purine = {K.A, K.G}
    isp_a = np.isin(aa, (K.A, K.G))
    isp_b = np.isin(bb, (K.A, K.G))
    diff = aa != bb
    transition = diff & (isp_a == isp_b)
    P = float(transition.mean())
    Q = float((diff & ~transition).mean())
    x = (1. - 2. * P - Q)
    y = (1. - 2. * Q)
    if x <= 0 or y <= 0:
        return math.inf
    return -0.5 * math.log(x) - 0.25 * math.log(y)


def poisson_aa(a: np.ndarray, b: np.ndarray) -> float:
    """Poisson-corrected protein distance: -ln(1 - p)."""
    p = p_distance(a, b, is_aa=True)
    return math.inf if p >= 1 else -math.log(1. - p)


def kimura_aa(a: np.ndarray, b: np.ndarray) -> float:
    """Kimura (1983) protein distance: -ln(1 - p - p^2/5)."""
    p = p_distance(a, b, is_aa=True)
    x = 1. - p - p * p / 5.
    return math.inf if x <= 0 else -math.log(x)


def random_seq(rng: np.random.Generator, n: int,
               comp: dict | None = None, is_aa: bool = False) -> np.ndarray:
    """Monte-Carlo random sequence with a given composition
    (montseq.cc role)."""
    if is_aa:
        codes = np.arange(3, 23)
    else:
        codes = np.array([K.A, K.C, K.G, K.T])
    if comp:
        dec = K.AA_DECODE if is_aa else K.NUC_DECODE
        p = np.array([comp.get(dec[c], 0.) for c in codes], dtype=float)
        p = p / p.sum() if p.sum() else None
    else:
        p = None
    return rng.choice(codes, size=n, p=p).astype(np.int8)
