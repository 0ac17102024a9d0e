"""Probe the per-step cost of the slab step's data-movement idioms in a
one-CTA serial loop: the H100 counterpart of scripts/probe_step_ops.py.

    python -m spaln_tpu_torch.probes.probe_step_ops [steps]
                                     [--device cuda|cpu]
                                     [--threads 128,...,1024]

Each variant (probe_step_ops.py:80, build) runs on a dependent (16,128)
int32 carry acc, masked to 10 bits a step, beside the tiles big
(112,256) and big2 (256,112):

  floor     carry-only loop
  rollbig   a roll of big by CHUNK-1 (the TPU moves 112 KB a step; an
            index offset here)
  roll64    a roll of big's (64,128) corner by 1, lane 0 from acc[0,0]
  dynroll   a roll of big's (64,256) corner by acc[0,0] & 127
  subread   a dynamic row read of big2 at (t + acc[0,0]) & 255
  subtrans  that row's first 16 entries down the carry's rows
  maskred   a masked cross-lane sum of big's rows at lane t & 255
  gather16  a lane gather of big's (16,128) corner at acc & 127
  sel112    big's lane 0 set to acc[0,0]

Each variant has a plain PyTorch version and a kernel in csrc/probes.cu
(probe_step_ops); ``run`` takes the plain version for CPU tensors and the
kernel for CUDA ones.  Those that read acc[0,0] broadcast it through
shared memory: one barrier a step.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.dp_spliced_cuda import _check
from . import _cuda
from ._cuda import I32, Case

ENTRY = "probe_step_ops"
SCRIPT = "scripts/probe_step_ops.py:80"
T_DEFAULT = 16384
GRP, L, CHUNK, SG3 = 16, 128, 256, 112
BODIES = ("floor", "rollbig", "roll64", "dynroll", "subread", "subtrans",
          "maskred", "gather16", "sel112")
# int32 operations an element a step: the read (or the step index), a
# lane-0 select where the variant has one, the add and the mask
OPS = {"floor": 2, "rollbig": 3, "roll64": 4, "dynroll": 3, "subread": 3,
       "subtrans": 3, "maskred": 3, "gather16": 4, "sel112": 4}
# the tile a variant reads: big's (16,256) corner, big2's first column
# or its (256,16) corner
READS = {"floor": 0, "subread": CHUNK, "subtrans": CHUNK * 16}
SHAPE = (GRP, L)


def inputs(seed: int = 0) -> dict:
    """The script's inputs, from numpy's default_rng(seed) as its main
    draws them."""
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(0, 1024, SHAPE).astype(np.int32),
            "big": rng.integers(0, 1024, (SG3, CHUNK)).astype(np.int32),
            "big2": rng.integers(0, 1024, (CHUNK, SG3)).astype(np.int32)}


def _step(v: str, t: int, acc: torch.Tensor, big: torch.Tensor,
          big2: torch.Tensor):
    a00 = acc[0, 0]
    if v == "floor":
        acc = acc + t
    elif v == "rollbig":
        big = torch.roll(big, CHUNK - 1, 1)
        acc = acc + big[:GRP, :L]
    elif v == "roll64":
        w = torch.roll(big[:64, :L], 1, 1)
        w = torch.where(torch.arange(L, device=acc.device) == 0, a00, w)
        acc = acc + w[:GRP]
    elif v == "dynroll":
        cols = (torch.arange(L, device=acc.device) + (a00 & 127)) % CHUNK
        acc = acc + big[:GRP][:, cols]
    elif v in ("subread", "subtrans"):
        row = big2[(t + a00) & 255]                  # (SG3,)
        acc = acc + (row[:1] if v == "subread" else row.reshape(SG3, 1)[:GRP])
    elif v == "maskred":
        acc = acc + big[:GRP, (t & 255):(t & 255) + 1]
    elif v == "gather16":
        acc = acc + torch.gather(big[:GRP, :L], 1, (acc & 127).long())
    else:                                            # sel112
        big = torch.where(torch.arange(CHUNK, device=acc.device) == 0, a00,
                          big)
        acc = acc + big[:GRP, :L]
    return acc & 1023, big


def plain(variant: str, x: torch.Tensor, big: torch.Tensor,
          big2: torch.Tensor, T: int) -> torch.Tensor:
    """The plain PyTorch version of ``variant``: the carry after T
    steps."""
    acc = x
    for t in range(T):
        acc, big = _step(variant, t, acc, big, big2)
    return acc


def run(variant: str, x: torch.Tensor, big: torch.Tensor,
        big2: torch.Tensor, T: int, threads: int = 128) -> torch.Tensor:
    """T steps of ``variant`` on the carry x (16,128) with big (112,256)
    and big2 (256,112), int32: the kernel for CUDA tensors (one CTA of
    ``threads``), the plain version for CPU ones."""
    if x.device.type == "cpu":
        return plain(variant, x, big, big2, T)
    dev = x.device
    _check("x", x, I32, SHAPE, dev)
    _check("big", big, I32, (SG3, CHUNK), dev)
    _check("big2", big2, I32, (CHUNK, SG3), dev)
    out = torch.empty_like(x)
    _cuda.launch(ENTRY, variant, BODIES.index(variant), x, big, big2, T,
                 threads, out)
    return out


def cases(device: torch.device, seed: int = 0) -> list:
    """The nine variants on the script's inputs, on ``device``."""
    a = {k: torch.from_numpy(v).to(device) for k, v in inputs(seed).items()}
    x, big, big2 = a["x"], a["big"], a["big2"]
    return [Case(ENTRY, v,
                 lambda T, th, v=v: run(v, x, big, big2, T, th),
                 lambda T, v=v: plain(v, x, big, big2, T),
                 OPS[v] * x.numel(),
                 4 * (2 * x.numel() + READS.get(v, GRP * CHUNK)))
            for v in BODIES]


def measure(T: int = T_DEFAULT, device: torch.device | str = "cuda",
            threads=_cuda.THREADS, reps: int = 1) -> dict:
    """Every variant timed at T and 2T: variant -> threads -> (ns a
    step, ms at T, ms at 2T)."""
    dev = torch.device(device)
    return _cuda.sweep(cases(dev), T, dev, threads, reps)


def main(argv: list | None = None) -> int:
    p = _cuda.parser("python -m spaln_tpu_torch.probes.probe_step_ops",
                     __doc__.splitlines()[0])
    p.add_argument("steps", nargs="?", type=int, default=T_DEFAULT)
    args = p.parse_args(argv)
    dev, threads = _cuda.device_and_threads(args)
    _cuda.report("probe_step_ops", args.steps, dev,
                 measure(args.steps, dev, threads))
    return 0


if __name__ == "__main__":
    sys.exit(main())
