"""The benchmark's readers of the program's spans in the ``align`` entry
(``benchmark/metrics/align.<span>_ms_per_query.py`` and
``align.unstaged_ms_per_query.py``) on hand-built run records: each
value as computed, and nothing for a ``map`` record, an untraced run, or
a program that opens none of the spans."""
import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parent.parent / "benchmark" / "metrics"
SPANS = ("seed", "prep", "init_row", "device_dp", "traceback", "udh",
         "long_join", "refine")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _record(entry="align", trace=True, stage_s=None):
    stage_s = (dict(seed=4.0, prep=10.0, init_row=6.0, device_dp=8.0,
                    traceback=2.0, udh=5.0, long_join=1.5, refine=0.5,
                    vote=3.0)
               if stage_s is None else stage_s)
    return dict(entry=entry, n=50, query_s=[0.5] * 50, output_s=0.25,
                trace=dict(stage_s=stage_s, kernel_s=7.0) if trace
                else None)


@pytest.mark.parametrize("span", SPANS)
def test_span_reader_value(span):
    rec = _record()
    got = _reader(f"align.{span}_ms_per_query")(rec)
    assert got == pytest.approx(1e3 * rec["trace"]["stage_s"][span] / 50)


def test_unstaged_reader_value():
    # 25 s of query walls less 0.25 s of output and 24 s of the top-level
    # spans (init_row and long_join inside prep, udh inside device_dp,
    # refine inside traceback, vote not on the align path)
    got = _reader("align.unstaged_ms_per_query")(_record())
    assert got == pytest.approx(1e3 * (25.0 - 0.25 - 24.0) / 50)


@pytest.mark.parametrize("name", [f"align.{s}_ms_per_query"
                                  for s in SPANS + ("unstaged",)])
@pytest.mark.parametrize("rec", [
    _record(entry="map"), _record(trace=False),
    _record(stage_s={"vote": 1.0})], ids=["map", "untraced", "no_spans"])
def test_reader_reports_nothing(name, rec):
    assert _reader(name)(rec) is None
