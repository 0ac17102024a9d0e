"""A tiny copy of the benchmark's parts for CPU tests: configurations cut
to a few genes on 270 kb, traffic with short flanks and chunks, the
readers, entries and reference copied from the benchmark, all under a
temporary directory that the harness is pointed at."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from benchmark import harness

HERE = Path(harness.__file__).resolve().parent
LIMITS = {"locus_miss_pct": 10, "exon_miss_pct": 15, "exon_extra_pct": 15,
          "text_faults": 0, "count_faults": 0, "skipped": 0}


def tiny_config(kind: str = "cdna") -> dict:
    name = "tetrapod_cdna" if kind == "cdna" else "tetrapod_protein"
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(name=f"tiny_{kind}", genome_bp=270_000, n_genes=6)
    cfg["genome"]["chromosomes_bp"] = [150_000, 120_000]
    g = cfg["genes"]
    g["exons"] = dict(g["exons"], median=2.5, mean=2.6, min=2, max=3)
    g["intron_bp"] = dict(g["intron_bp"], min=100, max=300)
    g["spacing_bp"] = 5000
    if kind == "cdna":
        g["exon_bp"] = dict(g["exon_bp"], median=90, mean=92, min=60,
                            max=120)
        for k in ("utr5_bp", "utr3_bp"):
            g[k] = dict(g[k], median=20, mean=21, min=0, max=40)
    else:
        g["exon_bp"] = dict(g["exon_bp"], median=70, mean=72, min=60,
                            max=90)
    return cfg


def tiny_base(tmp: Path) -> Path:
    """A benchmark directory under ``tmp`` with the tiny parts."""
    base = tmp / "bench"
    for kind in ("entries", "metrics", "reference", "builders",
                 "generators"):
        shutil.copytree(HERE / kind, base / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "traffic", "limits"):
        (base / kind).mkdir(parents=True)
    for kind in ("cdna", "protein"):
        (base / "configs" / f"tiny_{kind}.json").write_text(
            json.dumps(tiny_config(kind)))
    for mix in ("align_locus", "map"):
        t = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
        t["stratum_genes"] = 1.5 if mix == "map" else 2
        if "flank_bp" in t:
            t["flank_bp"] = [300, 800]
        if "chunk" in t:
            t["chunk"] = 4
        (base / "traffic" / f"tiny_{mix}.json").write_text(json.dumps(t))
    return base


def spec(cells: list) -> dict:
    """A BENCHMARK.json naming ``cells`` (config, traffic) and the
    end-to-end metrics whose readers the benchmark has."""
    names = [f"{c}.{t}" for c, t in cells]
    e2e = [("map_queries_per_s", "queries/s"),
           ("align_queries_per_s", "queries/s"),
           ("align_query_p95_s", "s"), ("setup_s", "s")]
    return dict(
        workloads=[dict(name=n, config=c, traffic=t, chips=1)
                   for n, (c, t) in zip(names, cells)],
        end_to_end=[dict(name=n, unit=u) for n, u in e2e],
        per_layer=[])


def run(base: Path, sp: dict, cell: str, seed: int = 5, limits=None,
        seconds: float = 0.5, control=None):
    """One CPU run of ``cell``: (line, record)."""
    lim = dict(LIMITS if limits is None else limits)
    if "protein" in cell:
        lim.pop("count_faults", None)
    (base / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    c = harness.resolve(sp, cell, base=base, cache=base / "cache")
    return harness.run_cell(c, seed, seconds, False, time.perf_counter(),
                            device="cpu", control=control)
