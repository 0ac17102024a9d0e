"""Intron-length-dependent penalty.

Reproduces IntronPenalty (codepot.cc:127-233, codepot.h:223-257): the
penalty for an intron of length n is

    ipen(n) = fY * log10( sum_i a_i * Frechet(n; m_i, t_i, k_i) ) - IpBias

tabulated for llmt <= n < rlmt (the 80% quantile) with a log tail
IntFx + IntEp*ln(n - mu) beyond, where IpBias centers the expected total
intron score at -f*ip.  Parameters come from the species AlnParam ``-yI``
line (1-3 component Frechet mixture fitted by the fitild equivalent).

The table is exported as a dense int32 array that the DP kernels gather
from directly (DpParams.intron_table).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import AVRSIG53, Config

SHRT_MIN = -32768


@dataclass(frozen=True)
class IldParams:
    """A 1-3 component Frechet mixture (the -yI parameter set)."""
    a1: float
    m1: float
    t1: float
    k1: float
    m2: float = 0.
    t2: float = 0.
    k2: float = 0.
    a2: float = 0.
    m3: float = 0.
    t3: float = 0.
    k3: float = 0.


def frechet_pdf(n, mu: float, th: float, kk: float):
    """codepot.h:235-240 ProbDist."""
    n = np.asarray(n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        z = np.where(n > mu, th / np.maximum(n - mu, 1e-300), np.inf)
        zz = z ** kk
        out = np.where(n > mu, kk / th * z * zz * np.exp(-zz), 0.)
    return out


def frechet_quantile(p: float, mu: float, th: float, kk: float) -> float:
    return mu + th * (-np.log(p)) ** (-1. / kk)


class IntronPenalty:
    def __init__(self, cfg: Config, dvsp: int, f: float | None = None,
                 mean5: float | None = None, mean3: float | None = None,
                 rlmt_quant: float = 0.8):
        """f = Vab (scale x many_a x many_b); mean5/mean3 = species PSSM
        mean signals (pattern5/3 mmm.mean) when species tables are loaded.
        """
        it = cfg.intron
        a2m = cfg.aln2
        if f is None:
            f = float(cfg.aln.scale)
        fy = f * a2m.y
        fY = f * it.fact
        expsig = 0.
        if fy > 0:
            expsig = fy * (1. - a2m.sss) * AVRSIG53[0]
            fy_s = fy * a2m.sss
            if mean5 is not None and mean3 is not None:
                expsig += fy_s * (mean5 + mean3)
            else:
                expsig += fy_s * AVRSIG53[1]
        self.avr_sig = int(expsig)
        ip_bias = expsig + fY * it.mean + f * it.ip
        self.gap_wi = int(fY * it.mean - ip_bias)   # flat fallback penalty
        self.llmt = it.llmt
        self.f = f

        a1 = it.a1
        a2 = it.a2 if it.a2 else 1. - a1
        a3 = (1. - a1 - it.a2) if it.a2 else 0.

        def mixture(n):
            z = frechet_pdf(n, it.m1, it.t1, it.k1)
            if a2 > 0:
                z = a1 * z + a2 * frechet_pdf(n, it.m2, it.t2, it.k2)
                if a3:
                    z = z + a3 * frechet_pdf(n, it.m3, it.t3, it.k3)
            return z

        maxl = it.maxl or int(_tail_quantile(it, 0.99))
        self.maxl = maxl
        self.rlmt = int(_tail_quantile(it, rlmt_quant))
        ns = np.arange(it.llmt, maxl + 1)
        z = mixture(ns)
        with np.errstate(divide="ignore"):
            ipen = fY * np.log10(np.maximum(z, 1e-300)) - ip_bias
        # penalty table for llmt <= n < rlmt
        ntab = max(self.rlmt - it.llmt, 1)
        self.table = np.trunc(ipen[:ntab]).astype(np.int32)
        # mode (argmax of ipen) and optimum
        imax = int(np.argmax(ipen))
        self.mode = int(ns[imax])
        self.optip = int(ipen[imax])
        # minl: first length where intron beats an ordinary gap
        # (u/v may still be FQUERY here; fall back to the nt slot-0 values)
        u = cfg.aln.u if cfg.aln.u is not None else 3.
        v = cfg.aln.v if cfg.aln.v is not None else 8.
        gep = f * u
        gap0 = -(f * v + it.llmt * gep)
        gappen = gap0 - gep * (ns - it.llmt)
        better = ipen > gappen
        self.minl = int(ns[np.argmax(better)]) if better.any() else it.llmt
        # log tail: component with the largest pdf at rlmt
        comps = [(it.m1, it.t1, it.k1)]
        if a2 > 0:
            comps.append((it.m2, it.t2, it.k2))
        if a3:
            comps.append((it.m3, it.t3, it.k3))
        best = max(comps, key=lambda c: frechet_pdf(self.rlmt, *c))
        self.mu = int(best[0])
        kk = best[2]
        self.int_ep = float(-(kk + 1) * fY / np.log(10.))
        last = float(self.table[-1])
        self.int_fx = last - self.int_ep * np.log(max(self.rlmt - 1
                                                      - self.mu, 1))
        # equi-quantile coarse penalties (for -A2/-A3 style modes)
        nq = max(it.nquant, 1)
        cdf = np.cumsum(z)
        self.quant_len = np.zeros(nq + 1, dtype=np.int32)
        self.quant_pen = np.zeros(nq + 1, dtype=np.int32)
        fmt = np.cumsum(ipen * z)
        qfm, qi = 0., 0
        for i, n in enumerate(ns):
            if qi < nq and cdf[i] >= (qi + 1) / nq:
                self.quant_len[qi] = n
                self.quant_pen[qi] = int((fmt[i] - qfm) * nq)
                qfm = fmt[i]
                qi += 1
        self.quant_len[qi] = self.rlmt
        denom = cdf[-1] - 1. + 1. / nq
        if denom > 0:
            self.quant_pen[qi] = int((fmt[-1] - qfm) / denom)

    # -------------------------------------------------------------- queries
    def _tail(self, nmax: int) -> np.ndarray:
        """Log-tail values for rlmt <= n <= nmax, trunc(IntFx + IntEp *
        ln(n - mu)) in float32, evaluated on the host and cached.

        The float32 log is log_f32 below, then multiplied and added in
        float32.  This equals spaln_tpu's evaluation on the JAX CPU
        backend at every length below 1<<22, where a correctly rounded
        float32 log (and numpy's or torch's own) differs from XLA's by
        1 ulp at tens of thousands of arguments and flips the trunc at a
        few.  The table is the same whatever device the DP runs on (the
        reference evaluates the formula in double, codepot.h:242-247;
        this differs from it by at most 1 fixed-point unit on a few
        lengths)."""
        cached = getattr(self, "_tail_cache", None)
        if cached is None or len(cached) < nmax - self.rlmt + 1:
            top = max(nmax, 2 * self.rlmt + 1024, 1 << 20)
            ns = np.arange(self.rlmt, top + 1, dtype=np.int64)
            x = np.maximum((ns - self.mu).astype(np.float32),
                           np.float32(1.0))
            lg = log_f32(x)
            v = np.trunc(np.float32(self.int_fx)
                         + np.float32(self.int_ep) * lg)
            cached = v.astype(np.int64)
            self._tail_cache = cached
        return cached

    def penalty(self, n) -> np.ndarray:
        """Vectorized Penalty(n) (codepot.h:242-247)."""
        n = np.asarray(n, dtype=np.int64)
        nmax = int(n.max()) if n.size else self.rlmt
        if nmax >= self.rlmt:
            tc = self._tail(nmax)
            tail = tc[np.clip(n - self.rlmt, 0, len(tc) - 1)]
        else:
            tail = np.zeros_like(n)
        idx = np.clip(n - self.llmt, 0, len(self.table) - 1)
        out = np.where(n < self.rlmt, self.table[idx], tail)
        return np.where(n < self.llmt, SHRT_MIN, out).astype(np.int32)

    def penalty_plus(self, n) -> np.ndarray:
        """Penalty + expected signal — used in HSP chaining (wln.cc:692)."""
        n = np.asarray(n, dtype=np.int64)
        out = self.penalty(n).astype(np.int64) + self.avr_sig
        return np.where(n < self.llmt, SHRT_MIN, out).astype(np.int32)

    def device_table(self, max_len: int) -> np.ndarray:
        """Dense int32 penalty for every length 0..max_len-1, for gather
        inside DP kernels (lengths below llmt get SHRT_MIN)."""
        return self.penalty(np.arange(max_len))


_F32 = np.float32
# Cephes logf coefficients (as in XLA's CPU float32 log)
_LOG_P = tuple(_F32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _F32(-2.12194440e-4), _F32(0.693359375)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding: the product of two float32
    values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def log_f32(x: np.ndarray) -> np.ndarray:
    """Natural log of float32 x >= 1 with the float32 operation order of
    XLA's CPU backend: the Cephes polynomial with its multiply-adds
    fused, step for step.  Equal to jax.numpy.log on the CPU at every
    integer argument 1..1<<22 (tests/test_torch_host.py)."""
    x = np.asarray(x, dtype=_F32)
    m, e = np.frexp(x)                          # m in [0.5, 1)
    m = m.astype(_F32)
    e = e.astype(_F32)
    low = m < _F32(0.707106781186547524)
    z = (m - _F32(1)) + np.where(low, m, _F32(0))
    e = e - np.where(low, _F32(1), _F32(0))
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    y = _fma(_fma(p[0], z, p[1]), z, p[2])
    y1 = _fma(_fma(p[3], z, p[4]), z, p[5])
    y2 = _fma(_fma(p[6], z, p[7]), z, p[8])
    y = _fma(_fma(y, z3, y1), z3, y2)
    y = _fma(y, z3, _LOG_Q1 * e)
    z = z - z2 * _F32(0.5)
    return (z + y) + _LOG_Q2 * e


def _tail_quantile(it, p: float) -> float:
    """max_intron_len (codepot.cc:648-685): quantile of the rightmost
    mixture component."""
    if it.a2 > 0:
        mu, th, kk = it.m3, it.t3, it.k3
    elif it.a1 == 0:
        mu, th, kk = it.m1, it.t1, it.k1
    else:
        mu, th, kk = it.m2, it.t2, it.k2
    return frechet_quantile(p, mu, th, kk)
