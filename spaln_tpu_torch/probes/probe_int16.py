"""Probe whether int16 arithmetic runs at twice the int32 rate in a
one-CTA serial loop: the H100 counterpart of scripts/probe_int16.py.

    python -m spaln_tpu_torch.probes.probe_int16 [steps]
                                     [--device cuda|cpu]
                                     [--threads 128,...,1024]

Times a dependent chain of 64 add/select pairs a step (probe_int16.py:42,
build) on (rows, 128) tiles: int32 at 16 rows, int16 at 16 and 32 rows,
int32 at 32 rows.  The kernel (csrc/probes.cu, probe_int16) packs two
int16 a 32-bit word and runs them with the SIMD intrinsics: if int16 at
32 rows takes the time of int32 at 16, an int16 x 2 DP doubles the rate.
Each configuration has a plain PyTorch version; ``run`` takes it for CPU
tensors and the kernel for CUDA ones.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.dp_spliced_cuda import _check
from . import _cuda
from ._cuda import Case

ENTRY = "probe_int16"
SCRIPT = "scripts/probe_int16.py:42"
T_DEFAULT = 32768
GRP, L = 16, 128
OPS = 64                   # dependent add/select pairs a step
CONFIGS = (("i32", GRP), ("i16", GRP), ("i16", 2 * GRP), ("i32", 2 * GRP))
BODIES = tuple(f"{d}_r{r}" for d, r in CONFIGS)
DTYPE = {"i32": torch.int32, "i16": torch.int16}


def inputs(seed: int = 0) -> dict:
    """The script's tiles, one a configuration, from numpy's
    default_rng(seed) as its main draws them."""
    rng = np.random.default_rng(seed)
    return {f"{d}_r{r}": rng.integers(-1000, 1000, (r, L)).astype(
        np.int16 if d == "i16" else np.int32) for d, r in CONFIGS}


def plain(x: torch.Tensor, T: int) -> torch.Tensor:
    """The plain PyTorch version (x int32 or int16): after T steps of
    v = where(v + i + 1 > v, v + i + 1 - 3, v), i < 64, wrapping in the
    tile's type."""
    v = x
    for _ in range(T):
        for i in range(OPS):
            w = v + (i + 1)
            v = torch.where(w > v, w - 3, v)
    return v


def run(x: torch.Tensor, T: int, threads: int = 128) -> torch.Tensor:
    """T steps on the tile x ((16 or 32, 128), int32 or int16): the kernel
    for CUDA tensors (one CTA of ``threads``), the plain version for CPU
    ones."""
    if x.device.type == "cpu":
        return plain(x, T)
    d = "i16" if x.dtype == torch.int16 else "i32"
    body = f"{d}_r{x.shape[0]}"
    if body not in BODIES:
        raise ValueError(f"probe_int16: no configuration {body}")
    _check("x", x, DTYPE[d], (x.shape[0], L), x.device)
    out = torch.empty_like(x)
    _cuda.launch(ENTRY, body, BODIES.index(body), x, T, threads, out)
    return out


def cases(device: torch.device, seed: int = 0) -> list:
    """The four configurations on the script's inputs, on ``device``.
    Operations are counted in 32-bit lanes (an int16 pair is one), 3 a
    pair: v + k > v is v < MAX - k, a compare with a constant, beside
    the add v + k - 3 and the select."""
    out = []
    for body, x in inputs(seed).items():
        xt = torch.from_numpy(x).to(device)
        lanes = xt.numel() // (2 if x.dtype == np.int16 else 1)
        out.append(Case(ENTRY, body, lambda T, th, xt=xt: run(xt, T, th),
                        lambda T, xt=xt: plain(xt, T), 3 * OPS * lanes,
                        2 * x.nbytes))
    return out


def measure(T: int = T_DEFAULT, device: torch.device | str = "cuda",
            threads=_cuda.THREADS, reps: int = 1) -> dict:
    """Every configuration timed at T and 2T: body -> threads -> (ns a
    step, ms at T, ms at 2T)."""
    dev = torch.device(device)
    return _cuda.sweep(cases(dev), T, dev, threads, reps)


def main(argv: list | None = None) -> int:
    p = _cuda.parser("python -m spaln_tpu_torch.probes.probe_int16",
                     __doc__.splitlines()[0])
    p.add_argument("steps", nargs="?", type=int, default=T_DEFAULT)
    args = p.parse_args(argv)
    dev, threads = _cuda.device_and_threads(args)
    res = measure(args.steps, dev, threads)
    _cuda.report("probe_int16", args.steps, dev, res)
    for body, per in res.items():
        rows = int(body.split("_r")[1])
        for th, (ns, _, _) in per.items():
            if ns > 0:
                print(f"  {body:8s} {th // 32:2d} warps "
                      f"{rows * L * OPS / ns:8.1f} G element-ops/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
