"""On the card (the repo's ``gpu`` marker; skipped without one): the
correctness control of each cell that has one comes out not correct at
the cell's own size on three seeds, and a checkout that holds only the
benchmark refuses.  Run from the root of a checkout on the machine with
the card:

    python3 -m pytest benchmark/tests/test_bench_card.py -m gpu -q
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# every cell's control is the program with one strand searched only
CONTROLLED = [w["name"] for w in SPEC["workloads"]]
CONTROL_SEEDS = (9001, 9002, 9003)
CONTROL_SECONDS = "10"

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _run(cwd: Path, cell: str, seed: int, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           cell, "--seed", str(seed), "--seconds",
                           CONTROL_SECONDS, "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=1500)


@pytest.mark.parametrize("cell", CONTROLLED)
def test_control_is_not_correct(card, cell):
    for seed in CONTROL_SEEDS:
        p = _run(ROOT, cell, seed, "--control", "strand")
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        print(cell, seed, json.dumps(line["checks"]))
        assert not line["correct"], line["checks"]


def test_bare_checkout_refuses(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    p = _run(tmp_path, SPEC["workloads"][0]["name"], 1)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
