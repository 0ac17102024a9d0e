"""What a traced run (``--trace 1``) records, from the benchmark's own
files around the program's calls:

- the device's operations over the window, from ``torch.profiler``'s
  CUDA activity: each kernel and copy with its name and interval.  The
  port's kernels are every operation that is neither a copy nor one of
  PyTorch's own (``at::``, ``cub::``);
- the intervals of the program's ``stage`` timers: a timer reports only
  its duration, when ``metrics.add_time`` is called at its end, so the
  interval is [end - duration, end];
- the benchmark's own spans (each query's output, each query or chunk);
- the work each forward DP call needs, counted by ``benchmark.work`` from
  the problems the call is given: the port's public forward entries
  (``FORWARD``) are wrapped with their explicit arguments ``(bp, prm)``;
  the program's own launch counters (``launches`` of the two launch
  modules) say how many forward launches ran, so that forward launches
  with no work counted stop the run.
"""
from __future__ import annotations

import re
import sys
import time

from . import work

# the port's public forward entries: module -> {function: DP kind}, and
# the C entries their launches go through
FORWARD = {
    "spaln_tpu_torch.ops.dp_spliced_cuda": {
        "spliced_slab_trace": "cdna", "spliced_slab_links": "cdna",
        "spliced_slab_score": "cdna"},
    "spaln_tpu_torch.ops.dp_tron_cuda": {"tron_forward": "tron"},
}
FORWARD_LAUNCHES = re.compile(
    r"^(spliced_slab_(trace|links|score)|tron_forward)(_dagp)?$")
NOT_PORT = re.compile(r"at::|at_cuda_detail|cub::|c10::|[Mm]emcpy|[Mm]emset")


class TraceError(RuntimeError):
    """A traced run whose record would be wrong."""


def union_s(iv: list) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    tot, cur0, cur1 = 0.0, None, None
    for a, b in sorted(iv):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                tot += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        tot += cur1 - cur0
    return tot


def gaps(iv: list, t0: float, t1: float) -> list:
    """The (start, end) gaps of [t0, t1] that no interval covers."""
    out, at = [], t0
    for a, b in sorted(iv):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return [g for g in out if g[1] > g[0]]


def short(name: str) -> str:
    """A device operation's name without its return type, namespaces and
    parameters, its template arguments kept: ``slab_kernel<1, 0, 2>``,
    ``Memcpy HtoD``; at most 96 characters."""
    n = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        if ch == "(" and depth == 0:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return ("".join(out).strip() or name)[:96]


def summarise(dev: list, stages: list, work_calls: list,
              forward_launches: int, t0: float, t1: float) -> dict:
    """The record of a traced window from ``dev``, (name, host start,
    host end) of each device operation; ``stages``, (name, host start,
    host end); ``work_calls``, (entry, operations, bytes) of each forward
    DP call; and the forward C entries' launch count."""
    if forward_launches and not work_calls:
        raise TraceError(f"{forward_launches} forward DP launches and no "
                         f"work counted: the port's forward entries have "
                         f"moved or been renamed ({sorted(FORWARD)})")
    busy = union_s([(a, b) for _, a, b in dev])
    ops_s: dict = {}
    kernel_s = 0.0
    for name, a, b in dev:
        key = short(name)
        ops_s[key] = ops_s.get(key, 0.0) + (b - a)
        if not NOT_PORT.search(name):
            kernel_s += b - a
    by_stage: dict = {}
    for a, b in gaps([(a, b) for _, a, b in dev], t0, t1):
        lab = label(stages, (a + b) / 2)
        by_stage[lab] = by_stage.get(lab, 0.0) + (b - a)
    stage_s: dict = {}
    for name, a, b in stages:
        if a >= t0 - 1e-3 and b <= t1 + 1e-3:
            stage_s[name] = stage_s.get(name, 0.0) + (b - a)
    ops = sum(o for _, o, _ in work_calls)
    least = sum(work.least_seconds(o, nb) for _, o, nb in work_calls)
    return dict(
        window_s=t1 - t0, busy_s=busy, kernel_s=kernel_s, least_s=least,
        ops=ops, forward_calls=len(work_calls),
        forward_launches=forward_launches, stage_s=stage_s,
        device_events=len(dev),
        device_ops=sorted(ops_s.items(), key=lambda x: -x[1])[:10],
        idle_gaps=sorted(by_stage.items(), key=lambda x: -x[1])[:10])


def label(stages: list, t: float) -> str:
    """The innermost stage or span open on the host at time t."""
    best = None
    for name, a, b in stages:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "host, no stage"


class Tracer:
    """Installs the recorders for one window; ``summary()`` after it."""

    def __init__(self):
        import torch
        self.torch = torch
        self.stages: list = []        # (name, host start, host end)
        self.work: list = []          # (entry, ops, bytes)
        self.launch_mods: list = []
        self._undo: list = []
        self.prof = None

    # ------------------------------------------------------------ install
    def install(self) -> None:
        """After the program is loaded and warmed up: the stage timers
        and the forward entries, in every module of the program that
        holds them."""
        from spaln_tpu_torch.ops import dp_spliced_cuda, dp_tron_cuda
        from spaln_tpu_torch.utils.metrics import metrics
        orig_add = metrics.add_time

        def add_time(name, dt):
            t = time.perf_counter()
            self.stages.append((name, t - dt, t))
            orig_add(name, dt)
        metrics.add_time = add_time
        self._undo.append(lambda: delattr(metrics, "add_time"))
        for modname, fns in FORWARD.items():
            mod = sys.modules[modname]
            for fn, kind in fns.items():
                self._wrap_entry(getattr(mod, fn), fn, kind)
        self.launch_mods = [dp_spliced_cuda, dp_tron_cuda]

    def _wrap_entry(self, orig, fn: str, kind: str) -> None:
        def entry(bp, prm, *args, **kw):
            if bp.device.type == "cuda":
                alpha = bp.qprof.shape[-1] if kind == "cdna" else 0
                ops, nbytes = work.launch_work(
                    kind, bool(getattr(prm, "dagp", False)), bp.Ms, bp.Ns,
                    bp.lws, bp.W, alpha)
                if ops <= 0:
                    raise TraceError(f"{fn}: a forward call with no work "
                                     f"counted (Ms {bp.Ms[:4]}, W {bp.W})")
                self.work.append((fn, ops, nbytes))
            return orig(bp, prm, *args, **kw)
        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("spaln_tpu_torch")
                    and getattr(mod, fn, None) is orig):
                setattr(mod, fn, entry)
                self._undo.append(
                    lambda m=mod: setattr(m, fn, orig))

    def uninstall(self) -> None:
        for f in reversed(self._undo):
            f()
        self._undo.clear()

    def span(self, name: str, t0: float, t1: float) -> None:
        self.stages.append((name, t0, t1))

    # ------------------------------------------------------------- window
    def start(self) -> None:
        """The profiler on, then a marker operation whose device start is
        taken as the host time just before its launch: the offset of the
        profiler's clock."""
        torch = self.torch
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        self._mark = torch.empty(1, device="cuda").fill_(1.0)
        torch.cuda.synchronize()
        self.launches0 = self._forward_launches()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.launches = self._forward_launches() - self.launches0

    def _forward_launches(self) -> int:
        return sum(n for mod in self.launch_mods
                   for k, n in mod.launches.items()
                   if FORWARD_LAUNCHES.match(k))

    def _device_events(self) -> list:
        """(name, host start, host end) of each device operation the
        profiler recorded in the window, the marker left out."""
        raw = []
        for e in self.prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                tr = e.time_range
                if tr.end > tr.start:
                    raw.append((e.name, tr.start, tr.end))
        if not raw:
            raise TraceError("the profiler recorded no device operation")
        raw.sort(key=lambda x: x[1])
        mark_us = raw[0][1]
        return [(n, self.t_mark + (a - mark_us) / 1e6,
                 self.t_mark + (b - mark_us) / 1e6) for n, a, b in raw[1:]]

    def summary(self) -> dict:
        return summarise(self._device_events(), self.stages, self.work,
                         self.launches, self.t0, self.t1)
