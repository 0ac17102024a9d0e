"""Probe the fastest exact small-table lookup in a one-CTA serial loop:
the H100 counterpart of scripts/probe_gather.py.

    python -m spaln_tpu_torch.probes.probe_gather [variant ...] [STEPS]
                                     [--device cuda|cpu]
                                     [--threads 128,...,1024]

Per step, 4 candidates' lookups idx -> table[idx] of a 1,536-entry
table of 120 runs (the engine's acceptor close) on a (16,128) int32
carry (probe_gather.py:93, make_kernel):

  base      the loop with no lookup (floor)
  chain120  a 120-constant compare/select chain (the engine's scheme)
  dg12      the TPU's 12 lane gathers + row select: one __ldg here
  dg6       the same from the int16-packed table (half the bytes)

Each variant has a plain PyTorch version and a kernel in csrc/probes.cu
(probe_gather); ``run`` takes the plain version for CPU tensors and the
kernel for CUDA ones.  ``ref_result`` is the script's numpy reference
(probe_gather.py:103).  With no variant named, all four run.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.dp_spliced_cuda import _check
from . import _cuda
from ._cuda import I32, Case
from .pallas_probe import select_chain

ENTRY = "probe_gather"
SCRIPT = "scripts/probe_gather.py:93"
T_DEFAULT = 4096
GRP, L = 16, 128
NTAB = 1536
BODIES = ("base", "chain120", "dg12", "dg6")
# int32 operations an element a step that the result needs: the four
# indices (acc + t once, + 17c for c = 1..3, four mods: 8), the lookups
# (a chain's 240 compares and selects each; a gather 1; dg6's word
# index, gather, parity test, high-half shift, low-half two shifts and
# select 7), then 3 xors, an add and a mask
OPS = {"base": 13, "chain120": 973, "dg12": 17, "dg6": 41}
SHAPE = (GRP, L)


def inputs(seed: int = 0) -> dict:
    """The script's inputs: the run-length table, its 120-run key (run
    start, value), the carry, from numpy's default_rng(seed) as its main
    draws them, and the int16-packed table (two entries a word, the even
    one low)."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(-5000, 0, NTAB).astype(np.int32)
    nz = sorted(rng.choice(np.arange(1, NTAB), 119, replace=False))
    key = [(0, int(tbl[0]))] + [(int(b), int(tbl[b])) for b in nz]
    tbl_run = np.zeros(NTAB, np.int32)
    bounds = [b for b, _ in key] + [NTAB]
    for i, (b, v) in enumerate(key):
        tbl_run[b:bounds[i + 1]] = v
    x = rng.integers(0, NTAB, SHAPE).astype(np.int32)
    packed = ((tbl_run[0::2].astype(np.int64) & 0xffff)
              | ((tbl_run[1::2].astype(np.int64) & 0xffff) << 16))
    return {"tbl": tbl_run, "key": key, "x": x,
            "packed": packed.astype(np.uint32).view(np.int32)}


def ref_result(variant, key, tbl, steps, x):
    """The script's numpy reference of every variant (int64)."""
    tbl = np.asarray(tbl, np.int64)
    acc = x.astype(np.int64) & 1023
    for t in range(steps):
        accs = []
        for c in range(4):
            idx = (acc + c * 17 + t) % NTAB
            accs.append(idx if variant == "base" else tbl[idx])
        acc = (acc + (accs[0] ^ accs[1] ^ accs[2] ^ accs[3])) & 1023
    return acc


# the 120 runs of chain120, compiled into csrc/probes.cu as the script
# compiles its key into its kernel
KEY = tuple(inputs()["key"])


def _lookup(variant: str, idx: torch.Tensor, tbl: torch.Tensor,
            packed: torch.Tensor) -> torch.Tensor:
    if variant == "base":
        return idx
    if variant == "chain120":
        return select_chain(idx, KEY)
    if variant == "dg12":
        return tbl[idx.long()]
    w = packed[(idx >> 1).long()]                               # dg6
    return torch.where((idx & 1) == 1, w >> 16, (w << 16) >> 16)


def plain(variant: str, x: torch.Tensor, tbl: torch.Tensor,
          packed: torch.Tensor, T: int) -> torch.Tensor:
    """The plain PyTorch version of ``variant``: the carry after T
    steps (chain120 over KEY)."""
    acc = x & 1023
    for t in range(T):
        r = None
        for c in range(4):
            v = _lookup(variant, (acc + c * 17 + t) % NTAB, tbl, packed)
            r = v if r is None else r ^ v
        acc = (acc + r) & 1023
    return acc


def run(variant: str, x: torch.Tensor, tbl: torch.Tensor,
        packed: torch.Tensor, T: int, threads: int = 128) -> torch.Tensor:
    """T steps of ``variant`` on the carry x (16,128) with the table tbl
    (1536,) and its packed form (768,) (chain120 over KEY): the kernel
    for CUDA tensors (one CTA of ``threads``), the plain version for CPU
    ones."""
    if x.device.type == "cpu":
        return plain(variant, x, tbl, packed, T)
    dev = x.device
    _check("x", x, I32, SHAPE, dev)
    _check("tbl", tbl, I32, (NTAB,), dev)
    _check("packed", packed, I32, (NTAB // 2,), dev)
    out = torch.empty_like(x)
    _cuda.launch(ENTRY, variant, BODIES.index(variant), x, tbl, packed, T,
                 threads, out)
    return out


def cases(device: torch.device, seed: int = 0) -> list:
    """The four variants on the script's inputs, on ``device``."""
    a = inputs(seed)
    x, tbl, packed = (torch.from_numpy(a[k]).to(device)
                      for k in ("x", "tbl", "packed"))
    reads = {"base": 0, "chain120": 0, "dg12": tbl.numel(),
             "dg6": packed.numel()}
    return [Case(ENTRY, v,
                 lambda T, th, v=v: run(v, x, tbl, packed, T, th),
                 lambda T, v=v: plain(v, x, tbl, packed, T),
                 OPS[v] * x.numel(), 4 * (2 * x.numel() + reads[v]))
            for v in BODIES]


def measure(T: int = T_DEFAULT, device: torch.device | str = "cuda",
            threads=_cuda.THREADS, reps: int = 1, names=BODIES) -> dict:
    """The variants ``names`` timed at T and 2T: variant -> threads ->
    (ns a step, ms at T, ms at 2T)."""
    dev = torch.device(device)
    return _cuda.sweep([c for c in cases(dev) if c.body in names], T, dev,
                       threads, reps)


def main(argv: list | None = None) -> int:
    p = _cuda.parser("python -m spaln_tpu_torch.probes.probe_gather",
                     __doc__.splitlines()[0])
    p.add_argument("args", nargs="*",
                   help="variants (base chain120 dg12 dg6), then STEPS")
    args = p.parse_args(argv)
    dev, threads = _cuda.device_and_threads(args)
    names = [a for a in args.args if not a.isdigit()] or list(BODIES)
    steps = [int(a) for a in args.args if a.isdigit()] or [T_DEFAULT]
    if any(n not in BODIES for n in names):
        raise SystemExit(f"variants: {BODIES}")
    a = inputs()
    for c in cases(dev):             # correct= as the script checks it
        if c.body in names:
            want = ref_result(c.body, a["key"], a["tbl"],
                              min(steps[0], 64), a["x"])
            got = c.run(min(steps[0], 64), threads[0]).cpu().numpy()
            print(f"{c.body}: correct={bool((got == want).all())}")
    _cuda.report("probe_gather", steps[0], dev,
                 measure(steps[0], dev, threads, names=names))
    return 0


if __name__ == "__main__":
    sys.exit(main())
