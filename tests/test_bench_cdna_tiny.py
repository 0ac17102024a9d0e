"""The benchmark's ``align`` entry on a tiny copy of the cDNA deployment
(``benchmark/tests/tiny.py``), on the CPU with the plain versions of the
kernels, judged by ``spliced_truth`` at the limits of
``tetrapod_cdna.align_locus``.  Half of the tiny deployment's introns
are drawn over ``BIG_GAP``, so that a pass of the tiny cell runs the
long-intron path as the cell's does, and the window rule that sends the
cell's widest loci to the linear-space path is brought down to the tiny
loci.  A traced run (the benchmark's tracer without the card's profiler)
reports the cell's per-layer metrics of the cDNA path's own spans:
``udh``, ``long_join`` and ``refine``."""
from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness, trace
from benchmark.tests import tiny
from spaln_tpu_torch.align import driver

CELL = "tetrapod_cdna.align_locus"
NEW = ("align.udh_ms_per_query", "align.long_join_ms_per_query",
       "align.refine_ms_per_query")
LIMITS = json.loads((tiny.HERE / "limits" / f"{CELL}.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Plain versions of many small operations: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CpuTracer(trace.Tracer):
    """The benchmark's tracer with the card's profiler left out: the
    program's spans and forward entries recorded as on the card, no
    device operation."""

    def start(self) -> None:
        self.t_mark = time.perf_counter()
        self.launches0 = self._forward_launches()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self.launches = self._forward_launches() - self.launches0

    def _device_events(self) -> list:
        return []


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    base = tiny.tiny_base(tmp_path_factory.mktemp("bench"))
    cfg = tiny.tiny_config("cdna")
    cfg["name"] = "tiny_cdna_long"
    g = cfg["genes"]
    # two components of equal weight: introns of a few hundred bp, and
    # introns of 16.5-18 kb, over BIG_GAP
    g["intron_bp"] = dict(g["intron_bp"], min=100, max=18000,
                          ild=[0.5, 100, 100, 2.0, 16500, 500, 2.0])
    (base / "configs" / "tiny_cdna_long.json").write_text(json.dumps(cfg))
    return base


def _run(base, trace_on: bool, seed: int):
    cell = "tiny_cdna_long.tiny_align_locus"
    sp = tiny.spec([("tiny_cdna_long", "tiny_align_locus")])
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    # the cell's per-layer metrics, each for the tiny cell
    sp["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                       for m in bench["per_layer"]
                       if CELL in m.get("workloads", [CELL])]
    (base / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
    c = harness.resolve(sp, cell, base=base, cache=base / "cache")
    return harness.run_cell(c, seed, 0.5, trace_on, time.perf_counter(),
                            device="cpu")


def test_traced_run_is_correct_and_reads_the_cdna_spans(base, monkeypatch):
    monkeypatch.setattr(trace, "Tracer", CpuTracer)
    monkeypatch.setattr(driver, "WINDOW_PLANE_BYTES", 0)
    line, rec = _run(base, True, 2**31 + 20)
    assert line["correct"], line["checks"]
    assert line["checks"]["count_faults"]["value"] == 0
    assert rec["info"]["_counted_exons"] > 0
    for name in NEW:
        assert line["metrics"][name]["value"] > 0, name


def test_untraced_run_is_correct_and_reads_no_span(base):
    line, rec = _run(base, False, 20)
    assert line["correct"], line["checks"]
    assert line["checks"]["count_faults"]["value"] == 0
    assert not set(NEW) & set(line["metrics"])
    # the spans open untraced too: the plane path's windows, no UDH
    assert {"long_join", "refine"} <= set(rec["stages"])
    assert "udh" not in rec["stages"]
