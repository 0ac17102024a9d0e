"""Runtime metrics / tracing (the aux subsystem the reference lacks,
SURVEY.md section 5: only TESTRAN stats and an index summary line exist
there; a production accelerator framework needs per-stage visibility).

Usage:
    from spaln_tpu_torch.utils.metrics import metrics, stage
    with stage("seed"):
        ...
    metrics.bump("queries")
    print(metrics.report())

`torch_profile(path)` wraps a block in the PyTorch profiler (CPU and CUDA
activities) and writes a Chrome trace for kernel-level inspection.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Metrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    timings: dict = field(default_factory=lambda: defaultdict(float))
    calls: dict = field(default_factory=lambda: defaultdict(int))
    # the shards of a batch split over devices bump from threads
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def bump(self, name: str, k: int = 1) -> None:
        with self.lock:
            self.counters[name] += k

    def add_time(self, name: str, dt: float) -> None:
        with self.lock:
            self.timings[name] += dt
            self.calls[name] += 1

    def reset(self) -> None:
        self.counters.clear()
        self.timings.clear()
        self.calls.clear()

    def report(self) -> str:
        """One JSON line: counters + per-stage seconds and call counts."""
        return json.dumps({
            "counters": dict(self.counters),
            "seconds": {k: round(v, 4) for k, v in self.timings.items()},
            "calls": dict(self.calls),
        }, sort_keys=True)


metrics = Metrics()


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics.add_time(name, time.perf_counter() - t0)


@contextlib.contextmanager
def torch_profile(trace_path: str):
    """Profile the block on the CPU and, when present, the CUDA device;
    writes a Chrome trace to ``trace_path``."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(trace_path)
