"""Probe the costs of the slab step's operand-window patterns in a
one-CTA serial loop: the H100 counterpart of scripts/pallas_probe2.py.

    python -m spaln_tpu_torch.probes.pallas_probe2 [T0] [--device cuda|cpu]
                                                   [--threads 128,...,1024]

ns a step by T-differencing (T0 and 2*T0 steps) of each body of its
make_run (pallas_probe2.py:45) on an (8,128) int32 carry, with the
stacked sliding operands stk (128, 64, 128) (4 MiB) and the boundary
streams bstr (8,128):

  base        carry-only loop
  arith40     ~40 vector ops
  chain190x4  a 190-constant compare/select chain for 4 candidates
  headtail4   a 40-run head chain and the float32 log tail, 4 candidates
  dynroll8    8 operand rows of the sliding window from two stack tiles
  bext3       3 boundary-stream lane extracts
  mock_full   dynroll8 + bext3 + a recurrence mock + the head/tail
              penalty of 4 acceptor candidates: the whole-step mock

Each body has a plain PyTorch version and a kernel in csrc/probes.cu
(probe_pallas2); ``run`` takes the plain version for CPU tensors and the
kernel for CUDA ones.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.dp_spliced_cuda import _check
from . import _cuda
from ._cuda import I32, Case
from .pallas_probe import CONSTS, arith40, log_tail, select_chain

ENTRY = "probe_pallas2"
SCRIPT = "scripts/pallas_probe2.py:45"
T_DEFAULT = 32768
SOP, GRP, NBT = 8, 8, 128
BODIES = ("base", "arith40", "chain190x4", "headtail4", "dynroll8",
          "bext3", "mock_full")
HCONSTS = [(i * 3, -i * 5) for i in range(40)]
# int32 operations an element a step that the result needs, counted as
# in pallas_probe (a stack or stream read is one): headtail4 4 x (80 of
# the head chain, 6 of the log tail, the idx >= 120 compare and select,
# % 7, the add) and c + t once, + k thrice; bext3 one read of the
# stream's lane (the three sums are the same), then c + 3 v (multiply,
# add); mock_full: six stack reads and one stream read (isdon and sig5
# feed only the donor-insert mock, whose candidates the body never
# reads: dead code), the lane roll of h1 and h1 + 1 as one roll and an
# add (4 with the two lane-0 selects), the score 18, hv 1, fv 3, ev 4, mx
# 2, c + l and c - l 6, the 5-class select 2, accb + jv 1, isacc != 0 1,
# four acceptor candidates of 95 (the index 2, headtail 88, xc 2, the
# test 2, the select 1) and the final 5
OPS = {"base": 1, "arith40": 48, "chain190x4": 1532, "headtail4": 364,
       "dynroll8": 16, "bext3": 3, "mock_full": 434}
SHAPE = (GRP, 128)


def inputs(seed: int) -> dict:
    """The inputs of the script's ``marginal``, drawn as it draws them
    from numpy's global generator after np.random.seed(seed)."""
    rs = np.random.RandomState(seed)
    return {"stk": rs.randint(-100, 100, (NBT, SOP * GRP, 128), np.int32),
            "bstr": rs.randint(-100, 100, SHAPE, np.int32),
            "x": rs.randint(0, 100, SHAPE, np.int32)}


# ---------------------------------------------------------- plain parts
def headtail(idx: torch.Tensor) -> torch.Tensor:
    """The 40-run head chain below idx 120, the log tail from it on."""
    return torch.where(idx >= 120, log_tail(idx),
                       select_chain(idx, HCONSTS))


def dynroll_ops(t: int, stk: torch.Tensor) -> torch.Tensor:
    """The 8 operand tiles (SOP, GRP, 128) of the window at step t: two
    stack tiles side by side, rolled left by the window's offset."""
    base = (NBT * 128 - 400) - t % 8192
    q = min(max(base // 128, 0), NBT - 2)
    wide = torch.cat([stk[q], stk[q + 1]], dim=1)          # (64, 256)
    rolled = torch.roll(wide, -(base - q * 128), 1)
    return rolled[:, :128].reshape(SOP, GRP, 128)


def _mock(t: int, c: torch.Tensor, stk: torch.Tensor, bstr: torch.Tensor):
    code, _isdon, isacc, _sig5, accb, d5cls, j40, j41 = dynroll_ops(t, stk)
    lane0 = torch.arange(128, device=c.device) == 0
    f = bstr[:, t % 128:t % 128 + 1]              # the three lane-0 fills
    up = torch.where(lane0, f, torch.roll(c, 1, 1))
    dg = torch.where(lane0, f, torch.roll(c + 1, 1, 1))
    score = torch.zeros_like(c)
    for k in range(5):
        score = score + torch.where(code == k, c + k, 0)
    hv = dg + score
    fv = torch.maximum(up - 80, up * 1) - 30
    ev = torch.maximum(torch.where(lane0, f, c) - 80, hv) - 30
    mx = torch.maximum(torch.maximum(hv, fv), ev)
    jv = torch.where(d5cls == 0, j40, j41)
    for l in range(4):
        pen = headtail(mx - (c - l) + t)
        xc = (c + l) + pen + accb + jv
        mx = torch.where((isacc != 0) & (xc >= mx), xc, mx)
    # the script's donor-insert mock is dead code: its candidates are
    # never read
    return torch.where(mx > 10 ** 8, c, mx % 1000 + c % 3)


def _step(body: str, t: int, c: torch.Tensor, stk: torch.Tensor,
          bstr: torch.Tensor):
    if body == "base":
        return c + 1
    if body == "arith40":
        return arith40(c)
    if body in ("chain190x4", "headtail4"):
        k = torch.arange(4, dtype=I32, device=c.device).view(4, 1, 1)
        idx = c + t + k
        pen = (select_chain(idx, CONSTS) if body == "chain190x4"
               else headtail(idx))
        return c + (pen % 7).sum(0, dtype=I32)
    if body == "dynroll8":
        return c + dynroll_ops(t, stk).sum(0, dtype=I32)
    if body == "bext3":
        v = bstr[:, t % 128:t % 128 + 1]
        return c + v + v + v
    return _mock(t, c, stk, bstr)


def plain(body: str, x: torch.Tensor, stk: torch.Tensor, bstr: torch.Tensor,
          T: int) -> torch.Tensor:
    """The plain PyTorch version of ``body``: the carry after T steps."""
    c = x
    for t in range(T):
        c = _step(body, t, c, stk, bstr)
    return c


def run(body: str, x: torch.Tensor, stk: torch.Tensor, bstr: torch.Tensor,
        T: int, threads: int = 128) -> torch.Tensor:
    """T steps of ``body`` on the carry x (8,128) with stk (128,64,128)
    and bstr (8,128), int32: the kernel for CUDA tensors (one CTA of
    ``threads``), the plain version for CPU ones."""
    if x.device.type == "cpu":
        return plain(body, x, stk, bstr, T)
    dev = x.device
    _check("x", x, I32, SHAPE, dev)
    _check("stk", stk, I32, (NBT, SOP * GRP, 128), dev)
    _check("bstr", bstr, I32, SHAPE, dev)
    out = torch.empty_like(x)
    _cuda.launch(ENTRY, body, BODIES.index(body), x, stk, bstr, T, threads,
                 out)
    return out


def cases(device: torch.device, seed: int = 0) -> list:
    """The seven bodies on the script's inputs, on ``device``."""
    a = {k: torch.from_numpy(v).to(device) for k, v in inputs(seed).items()}
    x, stk, bstr = a["x"], a["stk"], a["bstr"]

    def nbytes(body):                # stk is read by the window bodies
        reads = stk.numel() if body in ("dynroll8", "mock_full") else 0
        return 4 * (2 * x.numel() + bstr.numel() + reads)
    return [Case(ENTRY, body,
                 lambda T, th, b=body: run(b, x, stk, bstr, T, th),
                 lambda T, b=body: plain(b, x, stk, bstr, T),
                 OPS[body] * x.numel(), nbytes(body))
            for body in BODIES]


def measure(T: int = T_DEFAULT, device: torch.device | str = "cuda",
            threads=_cuda.THREADS, reps: int = 1) -> dict:
    """Every body timed at T and 2T: body -> threads -> (ns a step, ms
    at T, ms at 2T)."""
    dev = torch.device(device)
    return _cuda.sweep(cases(dev), T, dev, threads, reps)


def main(argv: list | None = None) -> int:
    p = _cuda.parser("python -m spaln_tpu_torch.probes.pallas_probe2",
                     __doc__.splitlines()[0])
    p.add_argument("T0", nargs="?", type=int, default=T_DEFAULT)
    args = p.parse_args(argv)
    dev, threads = _cuda.device_and_threads(args)
    res = measure(args.T0, dev, threads)
    _cuda.report("pallas_probe2", args.T0, dev, res)
    for th, (ns, _, _) in res["mock_full"].items():
        if ns > 0:
            print(f"mock_full implies {1024 / ns:.2f} G cells/s at (8,128) "
                  f"a step, {th // 32} warps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
