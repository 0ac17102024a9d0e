"""The program's spans (``utils.metrics.stage``) inside the align entries,
on the CPU with the plain versions of the kernels: ``align_protein`` and
``align_cdna`` each open ``seed``, ``prep``, ``device_dp`` and
``traceback`` where the work runs (the protein path ``init_row`` inside
``prep``, once a problem), the spans of one layer count once however
many callers open them, the batch entries keep their call counts, and a
profiler changes no answer; ``cli ... --profile PATH`` writes a Chrome
trace with the spans as ranges."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from spaln_tpu_torch import cli
from spaln_tpu_torch import constants as C
from spaln_tpu_torch.align.driver import AlignerContext, align_cdna
from spaln_tpu_torch.align.protein_driver import (ProteinAlignerContext,
                                                  align_protein,
                                                  execute_tron_jobs,
                                                  prepare_tron_job,
                                                  wilip_protein)
from spaln_tpu_torch.ops import dp_tron_cuda
from spaln_tpu_torch.score.tables import TableDir, find_table_dir
from spaln_tpu_torch.seq.codec import comrev, encode_dna, encode_protein
from spaln_tpu_torch.utils.metrics import carry_stages, metrics, stage

AMINO = "ARNDCQEGHILKMFPSTWYV"
_CODON = {}
for _i in range(64):
    _CODON.setdefault(int(C.GENCODE[_i]), "ACGT"[(_i >> 4) & 3]
                      + "ACGT"[(_i >> 2) & 3] + "ACGT"[_i & 3])
TOP = ("seed", "prep", "device_dp", "traceback")
LANES = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Plain versions of many small operations: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng, n):
    return "".join(rng.choice(list("ACGT"), n, p=[0.3, 0.2, 0.2, 0.3]))


@pytest.fixture(scope="module")
def loci():
    """A 60-aa protein gene with one intron and a two-exon cDNA gene,
    each with 300 nt of flank a side."""
    rng = np.random.default_rng(1801)
    p = "M" + "".join(rng.choice(list(AMINO), 59))
    nt = "".join(_CODON[int(c)] for c in encode_protein(p)) + "TAA"
    pg = (_mk(rng, 300) + nt[:70] + "GTAAGT" + _mk(rng, 120) + "TTTCAG"
          + nt[70:] + _mk(rng, 300))
    e1, e2 = _mk(rng, 90), _mk(rng, 80)
    cg = (_mk(rng, 300) + e1 + "GTAAGT" + _mk(rng, 207) + "TTTCTAG" + e2
          + _mk(rng, 300))
    return dict(protein=(p, pg), cdna=(e1 + e2, cg))


@pytest.fixture(scope="module")
def tables():
    return TableDir(find_table_dir())


@pytest.fixture(scope="module")
def pctx(tables):
    return ProteinAlignerContext.create(tables, "cpu")


@pytest.fixture(scope="module")
def dctx(tables):
    return AlignerContext.create(tables, "cpu")


@pytest.fixture
def spans(monkeypatch):
    """Each span's (name, start, end), recovered at ``metrics.add_time``
    as the benchmark's tracer recovers it; the metrics reset."""
    got = []
    orig = metrics.add_time

    def add_time(name, dt):
        t = time.perf_counter()
        got.append((name, t - dt, t))
        orig(name, dt)
    metrics.reset()
    monkeypatch.setattr(metrics, "add_time", add_time)
    yield got
    metrics.reset()


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, t0, time.perf_counter()


def _check_layers(got, t0, t1):
    """Every span inside the call; the top-level spans disjoint, their sum
    within the call's wall; no span under the benchmark's own names."""
    names = {n for n, _, _ in got}
    assert set(TOP) <= names
    assert not names & {"query", "output"}
    for _, a, b in got:
        assert t0 <= a <= b <= t1
    top = sorted((a, b) for n, a, b in got if n in TOP)
    for (_, b0), (a1, _) in zip(top, top[1:]):
        assert b0 <= a1
    assert sum(b - a for a, b in top) <= t1 - t0


def test_align_protein_opens_each_layer(loci, pctx, spans):
    p, g = loci["protein"]
    gs, t0, t1 = _timed(align_protein, encode_protein(p), encode_dna(g),
                        pctx, lanes=LANES)
    assert len(gs) == 1 and len(gs[0].exons) == 2
    _check_layers(spans, t0, t1)
    assert {k: metrics.calls[k] for k in TOP} == dict(
        seed=1, prep=2, device_dp=1, traceback=1)  # the job, the batch
    assert metrics.calls["init_row"] == 1          # one problem
    prep = [(a, b) for n, a, b in spans if n == "prep"]
    for n, a, b in spans:
        if n == "init_row":
            assert any(a0 <= a <= b <= b0 for a0, b0 in prep)


def test_align_cdna_opens_each_layer(loci, dctx, spans):
    q, g = loci["cdna"]
    gs, t0, t1 = _timed(align_cdna, encode_dna(q), encode_dna(g), dctx,
                        lanes=LANES)
    assert len(gs) == 1 and len(gs[0].exons) == 2
    _check_layers(spans, t0, t1)
    assert {k: metrics.calls[k] for k in TOP} == dict(
        seed=1, prep=2, device_dp=1, traceback=1)
    assert "init_row" not in metrics.calls


def test_stage_nested_in_its_own_name_counts_nothing(spans):
    with stage("x"):
        with stage("x"):
            time.sleep(0.01)
        with stage("y"):
            with stage("x"):
                pass
    assert metrics.calls["x"] == 1 and metrics.calls["y"] == 1
    assert [n for n, _, _ in spans] == ["y", "x"]
    assert metrics.timings["x"] >= metrics.timings["y"]


@pytest.mark.parametrize("carried", [False, True])
def test_stage_on_a_worker_thread(spans, carried):
    """A worker opening the caller's open span counts it again unless
    the work is handed over with carry_stages."""
    def work():
        with stage("x"):
            pass
    with stage("x"):
        fn = carry_stages(work) if carried else work
        th = threading.Thread(target=fn)
        th.start()
        th.join()
    assert metrics.calls["x"] == (1 if carried else 2)


def test_execute_tron_jobs_counts_each_layer_once_a_batch(loci, pctx, spans):
    p, g = loci["protein"]
    q, gc = encode_protein(p), encode_dna(g)
    jobs = []
    for st, gu in (("+", gc), ("-", comrev(gc))):
        ch = wilip_protein(q, gu, pctx.pmtx, ipen=pctx.ipen)
        jobs.append(prepare_tron_job(q, gu, pctx, ch[0] if ch else None,
                                     strand=st))
    metrics.reset()
    spans.clear()
    out = execute_tron_jobs(jobs, pctx, lanes=LANES)
    batches = metrics.counters["tron_buckets"]
    assert batches >= 1 and len(out) == 2
    assert {k: metrics.calls[k] for k in ("prep", "device_dp",
                                          "traceback")} == dict(
        prep=batches, device_dp=batches, traceback=batches)
    assert metrics.calls["init_row"] == 2
    assert "seed" not in metrics.calls


@pytest.fixture(scope="module")
def profiled(loci, tmp_path_factory):
    """``cli align`` of the protein onto its locus, plain and with
    --profile.  The profiled run replays the plain run's K7 and K8
    outputs: a CPU profile of their plain versions records every small
    operation of every step, hundreds of MB of trace."""
    d = tmp_path_factory.mktemp("stages")
    p, g = loci["protein"]
    (d / "g.fa").write_text(f">g\n{g}\n")
    (d / "q.fa").write_text(f">q\n{p}\n")
    base = ["align", str(d / "g.fa"), str(d / "q.fa"), "-O", "0,4",
            "--lanes", str(LANES), "--device", "cpu"]
    seen = {}

    def kept(name, fn):
        def run(*args):
            seen[name] = fn(*args)
            return seen[name]
        return run
    with pytest.MonkeyPatch.context() as mp:
        for name in ("tron_forward", "tron_walk"):
            mp.setattr(dp_tron_cuda, name,
                       kept(name, getattr(dp_tron_cuda, name)))
        assert cli.main(base + ["-o", str(d / "plain.txt")]) == 0
    with pytest.MonkeyPatch.context() as mp:
        for name in ("tron_forward", "tron_walk"):
            mp.setattr(dp_tron_cuda, name,
                       lambda *args, name=name: seen[name])
        assert cli.main(base + ["-o", str(d / "prof.txt"), "--profile",
                                str(d / "trace.json")]) == 0
    metrics.reset()
    return d


def test_profiler_leaves_the_text_unchanged(profiled):
    plain = (profiled / "plain.txt").read_bytes()
    assert b"\tgene\t" in plain
    assert (profiled / "prof.txt").read_bytes() == plain


def test_cli_profile_writes_the_spans_as_ranges(profiled):
    trace = json.loads((profiled / "trace.json").read_text())
    ranges = {e["name"] for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"seed", "prep", "init_row", "device_dp", "traceback"} <= ranges
    assert not ranges & {"query", "output"}
