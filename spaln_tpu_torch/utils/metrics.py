"""Runtime metrics / tracing (the aux subsystem the reference lacks,
SURVEY.md section 5: only TESTRAN stats and an index summary line exist
there; a production accelerator framework needs per-stage visibility).

Usage:
    from spaln_tpu_torch.utils.metrics import metrics, stage
    with stage("seed"):
        ...
    metrics.bump("queries")
    print(metrics.report())

A span is opened in the function that does its work, so every caller
shares it; one opened inside an open span of its own name on the same
thread counts nothing (``carry_stages`` hands the open names to a worker
thread).  The spans of the align and map paths: ``seed`` (Wilip),
``prep`` (splice signals, band, batch packing and upload; ``init_row``,
each ``tron_init_row``, inside it), ``device_dp`` (launches, syncs,
copies back, the host end extraction between K7 and K8) and
``traceback`` (the gene structure, refinement, reclassification); the
map adds ``vote``, the search ``prefilter``, ``score_pass`` and
``local_pass``.

`torch_profile(path)` wraps a block in the PyTorch profiler (CPU and CUDA
activities) and writes a Chrome trace (the CLI's ``--profile PATH``);
while a profiler records, each span is a ``record_function`` range on
its timeline.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

from torch.autograd import profiler as _autograd_profiler


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
_open = threading.local()


def _open_names() -> set:
    """The names of the spans open on this thread."""
    try:
        return _open.names
    except AttributeError:
        _open.names = set()
        return _open.names


@contextlib.contextmanager
def stage(name: str):
    """Time the block: ``metrics.add_time(name, seconds)`` at its end.
    Inside an open span of the same name on this thread it times
    nothing; while a torch profiler records, the block is also a
    ``record_function(name)`` range."""
    names = _open_names()
    if name in names:
        yield
        return
    names.add(name)
    t0 = time.perf_counter()
    try:
        if _autograd_profiler._is_profiler_enabled:
            with _autograd_profiler.record_function(name):
                yield
        else:
            yield
    finally:
        names.discard(name)
        metrics.add_time(name, time.perf_counter() - t0)


def carry_stages(fn):
    """``fn`` to run on another thread inside the spans open on this
    one: a span of one of their names opened there counts nothing."""
    held = frozenset(_open_names())

    def run(*args, **kw):
        names = _open_names()
        new = held - names
        names |= new
        try:
            return fn(*args, **kw)
        finally:
            names -= new
    return run


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
