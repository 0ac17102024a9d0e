"""The harness on tiny configurations on the CPU, through its internal
functions (the plain versions of the kernels run in place of the card):
a run's last line, parts found by name, the faults the comparison has to
catch, and the refusal without a card."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import harness, system
from benchmark.tests import tiny

torch.set_num_threads(1)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.tiny_base(tmp_path_factory.mktemp("bench"))


def test_align_cell_runs_and_prints_the_contract_keys(base):
    sp = tiny.spec([("tiny_cdna", "tiny_align_locus")])
    line, rec = tiny.run(base, sp, "tiny_cdna.tiny_align_locus")
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"align_queries_per_s",
                                    "align_query_p95_s", "setup_s"}
    assert rec["info"]["_counted_exons"] > 0
    json.dumps(line)


def test_map_cell_runs_correct(base):
    sp = tiny.spec([("tiny_cdna", "tiny_map")])
    line, rec = tiny.run(base, sp, "tiny_cdna.tiny_map", seed=2**31 + 7)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 4
    assert set(line["metrics"]) == {"map_queries_per_s", "setup_s"}
    assert {"vote", "seed", "device_dp"} <= set(rec["stages"])


def test_added_config_traffic_and_metric_found_by_name(base):
    """A new configuration, traffic mix and metric reader, each a file of
    its own, run without an edit to any file that was there."""
    cfg = tiny.tiny_config("cdna")
    cfg.update(name="tiny_added")
    cfg["genome"]["genome_seed"] += 1
    (base / "configs" / "tiny_added.json").write_text(json.dumps(cfg))
    t = json.loads((base / "traffic" / "tiny_align_locus.json").read_text())
    t["flank_bp"] = [500, 600]
    (base / "traffic" / "tiny_near.json").write_text(json.dumps(t))
    (base / "metrics" / "answered_share.py").write_text(
        "def read(run):\n    return run['n'] and 100.0\n")
    sp = tiny.spec([("tiny_added", "tiny_near")])
    sp["end_to_end"].append(dict(name="answered_share", unit="%",
                                 better="higher", bound=0.01,
                                 source="host_clock"))
    line, _ = tiny.run(base, sp, "tiny_added.tiny_near", seed=3)
    assert line["correct"], line["checks"]
    assert line["metrics"]["answered_share"]["value"] == 100.0


def test_added_traffic_takes_program_options_as_files(base, monkeypatch):
    """A traffic that runs the program with other options (``-A 3 -y l3``:
    every multi-slab DP on the UDH path, double affine gaps) is a data
    file alone: its command-line words reach the aligner context through
    the CLI's own parser and option functions."""
    from spaln_tpu_torch.align.driver import AlignerContext
    made = []
    orig = AlignerContext.create.__func__

    def create(cls, *a, **kw):
        ctx = orig(cls, *a, **kw)
        made.append(ctx)
        return ctx
    monkeypatch.setattr(AlignerContext, "create", classmethod(create))
    t = json.loads((base / "traffic" / "tiny_align_locus.json").read_text())
    t["cli"] = ["-A", "3", "-y", "l3"]
    (base / "traffic" / "tiny_udh_l3.json").write_text(json.dumps(t))
    sp = tiny.spec([("tiny_cdna", "tiny_udh_l3")])
    line, rec = tiny.run(base, sp, "tiny_cdna.tiny_udh_l3", seed=6)
    assert line["correct"], line["checks"]
    assert rec["cli"][-4:] == ["-A", "3", "-y", "l3"]
    assert made and made[-1].force_udh and made[-1].prm.dagp


def _drop_every_other(orig):
    state = {"k": 0}

    def emit(self, gs_list, q_len):
        state["k"] += 1
        text = orig(self, gs_list, q_len)
        return "" if state["k"] % 2 else text
    return emit


def _alter_exon(orig):
    def emit(self, gs_list, q_len):
        text = orig(self, gs_list, q_len)
        # move the first -O4 row's genomic start by one base
        return re.sub(r"^(\S+\t\S+\t[+-]\t\d+\t\d+\t)(\d+)",
                      lambda m: m.group(1) + str(int(m.group(2)) + 1),
                      text, count=1, flags=re.M)
    return emit


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_broken_timed_path_is_not_correct(base, monkeypatch, fault):
    """The run with the timed path broken underneath: half of the answers
    left out, or an answer altered where it is produced."""
    if fault == "half_left_out":
        monkeypatch.setattr(system.System, "emit",
                            _drop_every_other(system.System.emit))
    else:
        monkeypatch.setattr(system.System, "emit",
                            _alter_exon(system.System.emit))
    sp = tiny.spec([("tiny_cdna", "tiny_align_locus")])
    line, _ = tiny.run(base, sp, "tiny_cdna.tiny_align_locus", seed=11,
                       seconds=1.0)
    assert not line["correct"], line["checks"]


def test_control_one_strand_is_not_correct(base):
    """The control: the program with one strand searched only breaks the
    configuration's 'both strands' guarantee."""
    sp = tiny.spec([("tiny_cdna", "tiny_align_locus")])
    line, _ = tiny.run(base, sp, "tiny_cdna.tiny_align_locus", seed=12,
                       seconds=8.0, control="strand")
    assert not line["correct"], line["checks"]
    assert line["checks"]["locus_miss_pct"]["value"] > 10


def test_protein_align_cell_runs_correct(base):
    """The tiny proteins (50-100 aa) have coding exons of ~20 residues,
    whose ends a local alignment may place off the plant: the exon
    limits here are the tiny cell's, not the benchmark's."""
    sp = tiny.spec([("tiny_protein", "tiny_align_locus")])
    limits = dict(tiny.LIMITS, exon_miss_pct=50, exon_extra_pct=50)
    line, rec = tiny.run(base, sp, "tiny_protein.tiny_align_locus", seed=4,
                         limits=limits)
    assert "count_faults" not in line["checks"]
    assert line["correct"], line["checks"]
    assert line["checks"]["locus_miss_pct"]["value"] == 0


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    p = subprocess.run([sys.executable, str(harness.ROOT / "benchmark" /
                                            "run.py"),
                        "--workload", spec["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_compare_needs_every_limit():
    ok, out = harness.compare({"a": 0, "_n": 3}, {"a": 0, "b": 1})
    assert not ok and out["b"]["value"] is None and "_n" not in out
    ok, out = harness.compare({"a": 0, "c": 5}, {"a": 0})
    assert not ok and out["c"]["limit"] == "missing"
    ok, out = harness.compare({"a": 0, "c": 5}, {"a": 0, "c": None})
    assert ok and out["c"]["limit"] is None
    ok, _ = harness.compare({"a": 0.5}, {"a": 1})
    assert ok
    ok, _ = harness.compare({"a": 2}, {"a": 1})
    assert not ok
