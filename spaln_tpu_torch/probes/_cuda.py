"""Build, bind and time the probe kernels of csrc/probes.cu.

The library is built at first use by ops/dp_spliced_cuda.build_library
(nvcc into csrc/build/, a plain C interface bound with ctypes); a failed
build or launch raises.  ``launches`` counts the launches of each
(C entry, body) as "entry:body", so a run can show which kernels it went
through.  ``step_ns`` times a kernel with CUDA events by T-differencing,
(t(2T) - t(T)) / T, which cancels the launch (pallas_probe2.py's
``marginal``).

Each probe module describes its bodies as ``Case``s: the kernel's
wrapper and the plain version on the same inputs, and the work of a
step, so that its ``main``, ``chip_smoke.py`` and the tests drive them
alike.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import time
from typing import Callable

import torch

from ..ops.dp_spliced_cuda import CSRC, _launch, _ptr, build_library

SOURCE = CSRC / "probes.cu"
ENTRIES = ("probe_k0", "probe_pallas", "probe_pallas2", "probe_gather",
           "probe_step_ops", "probe_int16")
THREADS = (128, 256, 512, 1024)          # 4-32 warps, one CTA
I32 = torch.int32
launches: dict[str, int] = {}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    so, _, _ = build_library(SOURCE)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_k0.argtypes = [P, P, I, I, P]
    lib.probe_pallas.argtypes = [I, P, P, I, I, I, P, P]
    lib.probe_pallas2.argtypes = [I, P, P, P, I, I, P, P]
    lib.probe_gather.argtypes = [I, P, P, P, I, I, P, P]
    lib.probe_step_ops.argtypes = [I, P, P, P, I, I, P, P]
    lib.probe_int16.argtypes = [I, P, I, I, P, P]
    for name in ENTRIES:
        getattr(lib, name).restype = I
    lib.probe_error_string.argtypes = [I]
    lib.probe_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.probe_error_string
    return lib


def reset_counts() -> None:
    launches.clear()


def launch(entry: str, body: str, *args) -> None:
    """Call one C entry for ``body`` on the device of its first tensor
    argument (tensors are passed as pointers; dp_spliced_cuda._launch
    raises unless the device is a card and the entry returned
    cudaSuccess); count the launch."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    _launch(entry, device,
            *(_ptr(a) if isinstance(a, torch.Tensor) else a for a in args),
            loader=_library)
    key = f"{entry}:{body}"
    launches[key] = launches.get(key, 0) + 1


@dataclasses.dataclass
class Case:
    """One body of a probe on fixed inputs: ``run(T, threads)`` is the
    wrapper (the kernel for CUDA inputs, the plain version for CPU ones),
    ``plain(T)`` the plain version; a step does ``ops`` int32 operations
    over the tile (counted from the body) and the call moves ``nbytes``
    (inputs read once, the output written once).  A body with no step
    loop (k0) has ``stepped`` False: its ``ops`` are the call's."""
    entry: str
    body: str
    run: Callable[[int, int], torch.Tensor]
    plain: Callable[[int], torch.Tensor]
    ops: int
    nbytes: int
    stepped: bool = True


def elapsed_ms(fn: Callable[[], object], device: torch.device,
               reps: int = 1) -> float:
    """Median ms of ``reps`` calls of ``fn``: between two CUDA events on
    a card, on the host clock on the CPU."""
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def step_ns(run: Callable[[int], object], T: int, device: torch.device,
            reps: int = 1) -> tuple[float, float, float]:
    """(ns a step, ms at T, ms at 2T) of ``run(steps)``: a one-step
    warm-up call (it loads the kernel), then the median of ``reps`` calls
    at T and at 2T, differenced."""
    run(1)
    t1 = elapsed_ms(lambda: run(T), device, reps)
    t2 = elapsed_ms(lambda: run(2 * T), device, reps)
    return (t2 - t1) / T * 1e6, t1, t2


def sweep(cases: list, T: int, device: torch.device,
          threads=THREADS, reps: int = 1) -> dict:
    """Time every case at T and 2T at each thread count: body ->
    threads -> (ns a step, ms at T, ms at 2T).  (On the CPU the
    wrappers run the plain version, whatever the thread count.)"""
    return {c.body: {th: step_ns(lambda s, th=th: c.run(s, th), T, device,
                                 reps) for th in threads}
            for c in cases}


def report(name: str, T: int, device: torch.device, res: dict) -> None:
    """Print a sweep as the script does: ns a step (T-differenced) and
    t(T) per body and thread count, and the marginal over ``base``."""
    where = ("the kernels on " + torch.cuda.get_device_name(device)
             if device.type == "cuda" else "the plain versions on the CPU")
    print(f"{name}: T={T} steps, {where}; ns a step, (t(2T) - t(T)) / T:")
    base = res.get("base") or res.get("floor")
    for body, per in res.items():
        for th, (ns, t1, _) in per.items():
            warps = (f"{th // 32:2d} warps" if device.type == "cuda"
                     else "plain   ")
            marg = ("" if base is None or body in ("base", "floor")
                    else f"  (+{ns - base[th][0]:.1f} vs base)")
            print(f"  {body:16s} {warps} {ns:10.2f} ns/step   "
                  f"t(T)={t1:9.3f} ms{marg}")


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """The options every probe takes beside its script's own."""
    p = argparse.ArgumentParser(prog=prog, description=doc)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the kernels (an error without a card); "
                        "cpu: the plain versions")
    p.add_argument("--threads",
                   help="threads of the CTA, comma-separated, of 128, 256, "
                        "512, 1024 (default: all four on the card)")
    return p


def device_and_threads(args) -> tuple[torch.device, tuple]:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use "
                         "--device cpu to run the plain versions)")
    if args.threads is None:
        threads = THREADS if args.device == "cuda" else (128,)
    else:
        threads = tuple(int(x) for x in args.threads.split(","))
    if any(th not in THREADS for th in threads):
        raise SystemExit(f"--threads: each of {THREADS}")
    return torch.device(args.device), threads
