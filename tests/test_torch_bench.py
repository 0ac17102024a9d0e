"""python -m spaln_tpu_torch.bench against bench.py's workload in spaln_tpu.

At a cut size (B=4, M=96, W=2,048: bench.py's problems, narrower, every
score positive) through --device cpu, the plain version: the one JSON
line and its keys, and the batch's scores equal to spaln_tpu's scan
engine (run_spliced_batch, score only) and collect_batch_results on the
batch bench.py builds with BENCH_B=4 BENCH_M=96 BENCH_W=2048: tolerance
0.  Also: no CUDA device, or a failed check, exits non-zero with no
line.
"""
import json

import numpy as np
import pytest
import torch

from spaln_tpu_torch import bench

B, M, W, L = 4, 96, 2048, 128
ARGS = ["--B", str(B), "--M", str(M), "--W", str(W), "--iters", "2",
        "--device", "cpu"]


def _reference_scores() -> np.ndarray:
    """bench.py's batch and scores at the cut size, in spaln_tpu."""
    from spaln_tpu.config import Config, resolve, CvsG
    from spaln_tpu.ops.params import DpParams
    from spaln_tpu.ops.dp_spliced_scan import (prepare_spliced_batch,
                                               run_spliced_batch,
                                               collect_batch_results)
    from spaln_tpu.score.intron import IntronPenalty
    from spaln_tpu.score.simmtx import Simmtx
    from spaln_tpu.score.splice import build_splice_signals
    from spaln_tpu.score.tables import TableDir, find_table_dir
    from spaln_tpu.seq.codec import encode_dna
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    tables = TableDir(find_table_dir())
    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))
    queries, genomes, sigs = [], [], []
    for _ in range(B):
        e = ["".join(rng.choice(bases, M // 3)) for _ in range(3)]
        i1 = "GTAAGT" + "".join(rng.choice(bases, 300)) + "TTTTTAG"
        i2 = "GTGAGT" + "".join(rng.choice(bases, 500)) + "TTTCTAG"
        queries.append(encode_dna("".join(e)))
        genomes.append(encode_dna(e[0] + i1 + e[1] + i2 + e[2]))
        sigs.append(build_splice_signals(genomes[-1], cfg, tables))
    lw = -(W // 2)
    bp = prepare_spliced_batch(queries, genomes, prm, sigs=sigs, lw=lw,
                               up=lw + W - 1, L=L)
    row, rc, _ = run_spliced_batch(bp, prm, score_only=True)
    scores, _, _ = collect_batch_results(bp, row, rc, None, True, prm=prm)
    return np.asarray(scores)


def test_bench_line_and_scores_on_the_cpu(capsys, monkeypatch):
    runs = []
    measure = bench.measure
    monkeypatch.setattr(bench, "measure",
                        lambda *a, **k: runs.append(measure(*a, **k))
                        or runs[-1])
    assert bench.main(ARGS) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "repeats",
                         "spread_gcups", "device"}
    assert (line["metric"], line["unit"], line["repeats"],
            line["device"]) == ("spliced_dp_gcups_per_chip", "GCUPS", 2,
                                "cpu")
    slow, fast = line["spread_gcups"]
    assert 0 < slow <= line["value"] <= fast
    res, = runs
    assert res["cells"] == B * 1 * L * W
    assert np.array_equal(res["scores"], _reference_scores())


def test_bench_without_a_card_or_with_a_failed_check(capsys, monkeypatch):
    if not torch.cuda.is_available():
        assert bench.main(["--device", "cuda"]) == 1
        assert capsys.readouterr().out == ""

    def mismatch(*a, **k):
        raise AssertionError("bench: the kernel's score of problem 0 ...")
    monkeypatch.setattr(bench, "measure", mismatch)
    assert bench.main(ARGS) == 1
    out = capsys.readouterr()
    assert out.out == "" and "score of problem 0" in out.err
