"""Probe op costs inside a one-CTA serial loop on an (8,128) int32 carry:
the H100 counterpart of scripts/pallas_probe.py.

    python -m spaln_tpu_torch.probes.pallas_probe [T] [--device cuda|cpu]
                                                  [--threads 128,...,1024]

The smoke kernel k0 (x*2+1, pallas_probe.py:69), then T steps of each
body of its make_kernel (pallas_probe.py:49) on a carry with a table:

  base            carry-only loop
  arith40         ~40 vector ops
  take1k_along    a lookup from an (8,1024) table along lanes
  take128_along   a lookup from an (8,128) table along lanes
  chain190        a compare/select chain over 190 constants
  analytic_log    the float32 log tail (1 log + mul + trunc)
  chain190x4      the chain for 4 candidates
  take1k_alongx4  the (8,1024) lookup for 4 candidates

Each body has a plain PyTorch version (a function of int32 tensors over
T steps) and a kernel in csrc/probes.cu (probe_pallas, probe_k0);
``run`` takes the plain version for CPU tensors and the kernel for CUDA
ones.  Prints ns a step by T-differencing at each thread count.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.dp_spliced_cuda import _check
from . import _cuda
from ._cuda import I32, Case

ENTRY = "probe_pallas"
SCRIPT = "scripts/pallas_probe.py:49"
T_DEFAULT = 4096
BODIES = ("base", "arith40", "take1k_along", "take128_along", "chain190",
          "analytic_log", "chain190x4", "take1k_alongx4")
WIDE = ("take1k_along", "take1k_alongx4")        # read the (8,1024) table
CONSTS = [(i * 64, -i * 3) for i in range(190)]
# int32 operations an element a step that the result needs, one per
# elementwise op of the body (a lookup is one) less the body's
# identities: arith40 5 an iteration (add, max, compare, subtract,
# select; y * 1 is y) less the add and max of i = 0; the take1k bodies
# no % 1024 after the clamp to [0, 1023]; the log tail 6 (convert, max,
# log, multiply, add, convert: the trunc before a truncating convert is
# none); the x4 bodies c + t once and + k for k = 1..3
OPS = {"base": 1, "arith40": 48, "take1k_along": 6, "take128_along": 5,
       "chain190": 383, "analytic_log": 9, "chain190x4": 1532,
       "take1k_alongx4": 24}
SHAPE = (8, 128)


def inputs(seed: int) -> dict:
    """The script's inputs, drawn as its main draws them from numpy's
    global generator after np.random.seed(seed)."""
    rs = np.random.RandomState(seed)
    return {"x": rs.randint(0, 1000, SHAPE, np.int32),
            "tab1k": rs.randint(-500, 0, (8, 1024), np.int32),
            "tab128": rs.randint(-500, 0, (8, 128), np.int32)}


# ---------------------------------------------------------- plain parts
def select_chain(idx: torch.Tensor, consts: list,
                 default: int = -9999) -> torch.Tensor:
    """``pen = where(idx >= b, v, pen)`` over (b, v) in ``consts`` from
    pen = default: with the b ascending, the v of the last b <= idx."""
    b = torch.tensor([c[0] for c in consts], dtype=I32, device=idx.device)
    v = torch.tensor([c[1] for c in consts], dtype=I32, device=idx.device)
    n = (idx.unsqueeze(-1) >= b).sum(-1)
    return torch.where(n > 0, v[(n - 1).clamp(min=0)],
                       torch.full_like(idx, default))


def log_tail(n: torch.Tensor) -> torch.Tensor:
    """trunc(-100 - 30.5 * log(max(n, 1))) in float32, as int32."""
    f = torch.clamp(n.to(torch.float32), min=1.0)
    return torch.trunc(-100.0 + -30.5 * torch.log(f)).to(I32)


def arith40(y: torch.Tensor) -> torch.Tensor:
    for i in range(10):
        y = torch.maximum(y + i, y * 1)
        y = torch.where(y > 100000, y - 100000, y)
    return y


def _take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 1, idx.long())


def _step(body: str, t: int, c: torch.Tensor, tab: torch.Tensor):
    if body == "base":
        return c + 1
    if body == "arith40":
        return arith40(c)
    if body == "take1k_along":
        idx = torch.clamp(c + t, 0, 1023)
        return c + _take(tab, idx % 1024) % 7
    if body == "take128_along":
        return c + _take(tab, (c + t) % 128) % 7
    if body == "chain190":
        return c + select_chain(c + t, CONSTS) % 7
    if body == "analytic_log":
        return c + log_tail(c + t) % 7
    if body == "chain190x4":
        k = torch.arange(4, dtype=I32, device=c.device).view(4, 1, 1)
        return c + (select_chain(c + t + k, CONSTS) % 7).sum(0, dtype=I32)
    acc = c                                      # take1k_alongx4
    for k in range(4):
        idx = torch.clamp(c + t + k, 0, 1023)
        acc = acc + _take(tab, idx % 1024) % 7
    return acc


def plain(body: str, x: torch.Tensor, tab: torch.Tensor,
          T: int) -> torch.Tensor:
    """The plain PyTorch version of ``body``: the carry after T steps."""
    c = x
    for t in range(T):
        c = _step(body, t, c, tab)
    return c


def k0_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2 + 1


# ------------------------------------------------------------- wrappers
def k0(x: torch.Tensor, threads: int = 128) -> torch.Tensor:
    """The smoke kernel: x*2+1 on an (8,128) int32 tile."""
    if x.device.type == "cpu":
        return k0_plain(x)
    _check("x", x, I32, SHAPE, x.device)
    out = torch.empty_like(x)
    _cuda.launch("probe_k0", "k0", x, out, x.numel(), threads)
    return out


def run(body: str, x: torch.Tensor, tab: torch.Tensor, T: int,
        threads: int = 128) -> torch.Tensor:
    """T steps of ``body`` on the carry x (8,128) with the table tab
    (8,1024) or (8,128), int32: the kernel for CUDA tensors (one CTA of
    ``threads``), the plain version for CPU ones."""
    if x.device.type == "cpu":
        return plain(body, x, tab, T)
    dev = x.device
    _check("x", x, I32, SHAPE, dev)
    _check("tab", tab, I32, (8, 1024 if body in WIDE else 128), dev)
    out = torch.empty_like(x)
    _cuda.launch(ENTRY, body, BODIES.index(body), x, tab, tab.shape[1], T,
                 threads, out)
    return out


def cases(device: torch.device, seed: int = 0) -> list:
    """k0 and the eight bodies on the script's inputs, on ``device``."""
    a = {k: torch.from_numpy(v).to(device) for k, v in inputs(seed).items()}
    x = a["x"]
    out = [Case("probe_k0", "k0", lambda T, th: k0(x, th),
                lambda T: k0_plain(x), 2 * x.numel(), 8 * x.numel(),
                stepped=False)]
    for body in BODIES:
        tab = a["tab1k" if body in WIDE else "tab128"]
        out.append(Case(
            ENTRY, body,
            lambda T, th, b=body, tb=tab: run(b, x, tb, T, th),
            lambda T, b=body, tb=tab: plain(b, x, tb, T),
            OPS[body] * x.numel(), 4 * (2 * x.numel() + tab.numel())))
    return out


def measure(T: int = T_DEFAULT, device: torch.device | str = "cuda",
            threads=_cuda.THREADS, reps: int = 1) -> dict:
    """The smoke kernel (raises unless x*2+1), then every body timed at T
    and 2T: body -> threads -> (ns a step, ms at T, ms at 2T)."""
    dev = torch.device(device)
    x = torch.from_numpy(inputs(0)["x"]).to(dev)
    if not torch.equal(k0(x), x * 2 + 1):
        raise AssertionError("k0: not x*2+1")
    return _cuda.sweep(cases(dev)[1:], T, dev, threads, reps)


def main(argv: list | None = None) -> int:
    p = _cuda.parser("python -m spaln_tpu_torch.probes.pallas_probe",
                     __doc__.splitlines()[0])
    p.add_argument("T", nargs="?", type=int, default=T_DEFAULT)
    args = p.parse_args(argv)
    dev, threads = _cuda.device_and_threads(args)
    res = measure(args.T, dev, threads)
    print("smoke OK")
    _cuda.report("pallas_probe", args.T, dev, res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
