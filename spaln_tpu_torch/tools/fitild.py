"""Intron-length-distribution fitting (fitild.cc / ildpdf.cc role).

Fits an observed intron-length sample to a 1-3 component Frechet mixture
by maximum likelihood (the reference uses GSL BFGS, ildpdf.h:45-120;
spaln_tpu uses optax Adam, spaln_tpu/tools/fitild.py:44-98; here
torch.autograd with torch.optim.Adam on ``device``: the same model in
float32, softmax weights, clipped location and shape, log scale).  Adam
and autodiff round differently in the two packages, so a fit agrees with
spaln_tpu's to a tolerance (README.md), not bit for bit.

The fitted parameters feed IntronPenalty's ``-yI`` line
(score/intron.py IldParams): components (a_i, m_i, t_i, k_i) with
Frechet(x; m, t, k) = (k/t) z^(-1-k) exp(-z^-k), z = (x - m)/t.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class IldFit:
    weights: list[float]          # a_i, sum = 1
    mus: list[float]              # location m_i
    thetas: list[float]           # scale t_i
    kappas: list[float]           # shape k_i
    nll: float                    # per-sample negative log likelihood
    n: int

    def yI_line(self) -> str:
        """AlnParam ``-yI`` parameter string: llmt mode then per-component
        a, k, m, t (table/Dictyost/AlnParam layout)."""
        toks = []
        for a, k, m, t in zip(self.weights, self.kappas, self.mus,
                              self.thetas):
            toks += [f"{a:.4f}", f"{k:.4f}", f"{m:.2f}", f"{t:.2f}"]
        return " ".join(toks)


def frechet_logpdf(x, mu, th, kk):
    z = torch.clamp((x - mu) / th, min=1e-9)
    return torch.log(kk / th) + (-1. - kk) * torch.log(z) - z ** (-kk)


def _unpack(p: dict, minl: float):
    w = torch.softmax(p["logit_w"], dim=0)
    mu = torch.clamp(p["mu_frac"], 0., 0.98) * minl
    th = torch.exp(p["log_th"])
    kk = torch.clamp(torch.exp(p["log_kk"]), 0.05, 20.)
    return w, mu, th, kk


def fit_ild(lengths: np.ndarray, n_modes: int = 2, steps: int = 3000,
            lr: float = 0.02, seed: int = 0,
            device: torch.device | str = "cuda") -> IldFit:
    """Maximum-likelihood Frechet mixture over intron lengths, on
    ``device`` (a CUDA device unless the caller asks for the CPU; asking
    for CUDA without one is an error).  The best parameters over the
    steps are kept on the device (no host sync a step); ``seed`` is
    accepted for spaln_tpu's signature (the fit is deterministic)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_ild on cuda: no CUDA device is available "
                           "(pass device='cpu' to fit on the CPU)")
    lengths = np.asarray(lengths, dtype=np.float64)
    x = torch.as_tensor(lengths.astype(np.float32), device=device)[:, None]
    n = len(lengths)
    qs = np.quantile(lengths, np.linspace(0.25, 0.75, n_modes))
    minl = float(lengths.min())

    def param(v):
        return torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True)

    p = {"logit_w": param(np.zeros(n_modes)),
         "mu_frac": param(np.full(n_modes, 0.5)),     # mu = mu_frac * minl
         "log_th": param(np.log(qs.astype(np.float32))),
         "log_kk": param(np.full(n_modes, np.log(1.5)))}

    def nll():
        w, mu, th, kk = _unpack(p, minl)
        lp = frechet_logpdf(x, mu[None, :], th[None, :], kk[None, :])
        lw = torch.log(w)[None, :]
        return -torch.mean(torch.logsumexp(lp + lw, dim=1))

    opt = torch.optim.Adam(list(p.values()), lr=lr)
    best = torch.tensor(np.inf, dtype=torch.float32, device=device)
    best_p = {k: v.detach().clone() for k, v in p.items()}
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        v = nll()
        v.backward()
        with torch.no_grad():
            better = torch.isfinite(v) & (v < best)
            best = torch.where(better, v, best)
            for k, t in p.items():
                best_p[k] = torch.where(better, t, best_p[k])
        opt.step()
    with torch.no_grad():
        wv, muv, thv, kkv = (t.cpu().numpy() for t in _unpack(best_p, minl))
    order = np.argsort(muv + thv)
    return IldFit(weights=[float(wv[i]) for i in order],
                  mus=[float(muv[i]) for i in order],
                  thetas=[float(thv[i]) for i in order],
                  kappas=[float(kkv[i]) for i in order],
                  nll=float(best), n=n)


def sample_frechet_mixture(rng: np.random.Generator, n: int,
                           weights, mus, thetas, kappas) -> np.ndarray:
    """Draw intron lengths from a Frechet mixture (testing aid)."""
    comp = rng.choice(len(weights), size=n, p=np.asarray(weights))
    u = rng.uniform(1e-9, 1 - 1e-9, size=n)
    mus = np.asarray(mus)[comp]
    th = np.asarray(thetas)[comp]
    kk = np.asarray(kappas)[comp]
    return mus + th * (-np.log(u)) ** (-1. / kk)


def ild_pdf(fit: IldFit, x: np.ndarray) -> np.ndarray:
    """Mixture density at lengths x (numpy; plotild/decompild support)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    for a, m, t, k in zip(fit.weights, fit.mus, fit.thetas, fit.kappas):
        z = np.maximum((x - m) / t, 1e-12)
        out += a * (k / t) * z ** (-1. - k) * np.exp(-z ** (-k))
    return out


def decompose_ild(fit: IldFit, x: np.ndarray) -> np.ndarray:
    """(n_modes, len(x)) per-component weighted densities (decompild)."""
    x = np.asarray(x, dtype=np.float64)
    rows = []
    for a, m, t, k in zip(fit.weights, fit.mus, fit.thetas, fit.kappas):
        z = np.maximum((x - m) / t, 1e-12)
        rows.append(a * (k / t) * z ** (-1. - k) * np.exp(-z ** (-k)))
    return np.stack(rows)


def compare_ilds(fa: IldFit, fb: IldFit, x_max: int = 20000) -> float:
    """Symmetrized KL divergence between two fitted ILDs over a length
    grid (compild role)."""
    x = np.arange(max(min(fa.mus + fb.mus), 1) + 1, x_max, dtype=float)
    pa = np.maximum(ild_pdf(fa, x), 1e-300)
    pb = np.maximum(ild_pdf(fb, x), 1e-300)
    pa /= pa.sum()
    pb /= pb.sum()
    return float(0.5 * (np.sum(pa * np.log(pa / pb))
                        + np.sum(pb * np.log(pb / pa))))


def plot_ild_text(fit: IldFit, lengths: np.ndarray | None = None,
                  width: int = 60, bins: int = 24,
                  x_max: int | None = None) -> list[str]:
    """ASCII density plot (plotild role): fitted curve (*) and, when a
    sample is given, observed histogram (#) over log-spaced bins."""
    if x_max is None:
        x_max = int(max(fit.thetas) * 10 + max(fit.mus) + 100)
    lo = max(min(fit.mus) + 1., 10.)
    edges = np.exp(np.linspace(np.log(lo), np.log(x_max), bins + 1))
    mids = np.sqrt(edges[:-1] * edges[1:])
    pdf = ild_pdf(fit, mids) * np.diff(edges)
    hist = None
    if lengths is not None and len(lengths):
        hist, _ = np.histogram(lengths, bins=edges)
        hist = hist / hist.sum()
    top = max(pdf.max(), hist.max() if hist is not None else 0., 1e-9)
    out = []
    for i, m in enumerate(mids):
        nstar = int(width * pdf[i] / top)
        line = f"{int(m):>7d} |" + "*" * nstar
        if hist is not None:
            nh = int(width * hist[i] / top)
            line += " " * max(nh - nstar, 0) + ("#" if nh else "")
        out.append(line)
    return out
