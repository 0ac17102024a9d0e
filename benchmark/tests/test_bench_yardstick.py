"""The yardstick's own arithmetic: the work a launch needs, the trace's
interval sums, the spread, and the reference against the planted truth."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import deploy, repeat, trace, work
from benchmark.builders import planted_genome as pg
from benchmark.reference import spliced_truth as ref
from benchmark.tests import tiny


@pytest.mark.parametrize("M,N,lw,W", [(5, 9, -2, 6), (40, 30, -50, 200),
                                      (7, 100, 60, 20), (12, 12, -1, 3)])
def test_cdna_cells_count_the_band_inside_the_matrix(M, N, lw, W):
    want = sum(1 for m in range(1, M + 1) for n in range(1, N + 1)
               if lw + 1 <= n - m <= lw + W)
    assert work.cdna_cells(M, N, lw, W) == want


@pytest.mark.parametrize("M,N,lw,W", [(5, 20, -3, 8), (9, 40, 0, 12),
                                      (4, 100, 50, 30)])
def test_tron_cells_count_the_band_inside_the_matrix(M, N, lw, W):
    want = sum(1 for m in range(1, M + 1) for n in range(0, N + 1)
               if lw - 1 <= n - 3 * m <= lw + W - 2)
    assert work.tron_cells(M, N, lw, W) == want


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(16.7e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    ops, nbytes = work.launch_work("cdna", False, [10], [20], [-5], 30, 5)
    assert ops == 30 * work.cdna_cells(10, 20, -5, 30)
    assert nbytes == 4 * (10 * 5 + 22 * 21) + 16 * 10


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert trace.union_s(iv) == pytest.approx(3.0)
    assert trace.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                         (4.0, 5.0)]


def test_spread_is_the_quartile_distance_over_the_median():
    assert repeat.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def _answer(dep, g, lo, flip_strand=False, shift=0, bad_count=False,
            over_count=False):
    """The -O0,4 text a perfect aligner would print for gene g, in the
    coordinates of a locus starting at ``lo``."""
    strand = g["strand"]
    if flip_strand:
        strand = "+" if strand == "-" else "-"
    ex = [(s - lo, e - lo) for s, e in g["exons"]]
    ex[0] = (ex[0][0] + shift, ex[0][1])
    chrom = dep.names[g["chrom"]]
    lines = [f"{chrom}\tx\tgene\t{ex[0][0]}\t{ex[-1][1]}\t1.0\t{strand}\t."
             f"\tID=g;Name=q"]
    rows, q = [], g["product"]
    qlens = [e - s + 1 for s, e in ex]
    at = 0
    for i, ((s, e), n) in enumerate(zip(ex, qlens)):
        lines.append(f"{chrom}\tx\texon\t{s}\t{e}\t100.0\t{strand}\t.\tID=e")
        qs, qe = at + 1, at + n
        at += n
        gq = dep.region(g["chrom"], s - 1 + lo, e + lo)
        if strand == "-":
            qq = q[len(q) - qe:len(q) - qs + 1].encode()
        else:
            qq = q[qs - 1:qe].encode()
        mch, mmc = ref._recount(qq, gq, strand)
        if bad_count and i == 0:
            mch, mmc = mch - 1, mmc + 1
        if over_count and i == 0:
            mch += 1
        rows.append(f"q\t{chrom}\t{strand}\t{qs}\t{qe}\t{s}\t{e}\t99.0\t"
                    f"{mch}\t{mmc}\t0\t0\t0.0\t0.0")
    return "\n".join(lines + rows) + "\n"


@pytest.fixture(scope="module")
def dep(tmp_path_factory):
    cfg = tiny.tiny_config("cdna")
    p = tmp_path_factory.mktemp("cfg") / "c.json"
    import json
    p.write_text(json.dumps(cfg))
    return deploy.load(cfg, p, tmp_path_factory.mktemp("cache"))[0]


def _judge(dep, texts, genes, lo):
    records = [dict(query=dict(name="q", seq=g["product"], gene=g,
                               chrom=g["chrom"], lo=lo, hi=0), text=t)
               for t, g in zip(texts, genes)]
    return ref.judge(records, dep, dict(query=dict(kind="cdna")))


def test_reference_passes_the_planted_truth(dep):
    """Answers that say exactly the planted genes, on both strands, read
    nought on every number; the truth's introns open with a donor window
    and close with an acceptor window of the tables (G at the donor's
    first base, AG at the acceptor's end, in all but a few per mille)."""
    genes = dep.genes
    assert {g["strand"] for g in genes} == {"+", "-"}
    for g in genes:
        for (_, e), (s, _) in zip(g["exons"], g["exons"][1:]):
            intron = dep.region(g["chrom"], e, s - 1)
            if g["strand"] == "-":
                intron = intron.translate(ref._COMP)[::-1]
            assert 100 <= len(intron) <= 300
            assert intron[:1] == b"G" and intron[-2:] == b"AG"
    lo = 100
    got = _judge(dep, [_answer(dep, g, lo) for g in genes], genes, lo)
    assert got["locus_miss_pct"] == 0 and got["exon_miss_pct"] == 0
    assert got["exon_extra_pct"] == 0 and got["text_faults"] == 0
    assert got["count_faults"] == 0
    assert got["_counted_exons"] == sum(len(g["exons"]) for g in genes)


@pytest.mark.parametrize("fault,number", [
    (dict(flip_strand=True), "locus_miss_pct"),
    (dict(shift=1), "exon_miss_pct"),
    (dict(bad_count=True), "count_faults"),
    (dict(over_count=True), "count_faults")])
def test_reference_catches_wrong_answers(dep, fault, number):
    genes = dep.genes[:2]
    got = _judge(dep, [_answer(dep, g, 0, **fault) for g in genes], genes, 0)
    assert got[number] > 0


def test_reference_counts_a_missing_answer(dep):
    genes = dep.genes[:2]
    got = _judge(dep, [_answer(dep, genes[0], 0), ""], genes, 0)
    assert got["locus_miss_pct"] == 50.0



REPO = deploy.HERE.parent
CONFIGS = ("tetrapod_cdna", "tetrapod_protein")


def _cfg(name):
    import json
    return json.loads((deploy.HERE / "configs" / f"{name}.json").read_text())


def _table_rows(name: str, skip: int, n: int) -> list:
    lines = (REPO / "data_tables" / "Tetrapod" / name).read_text().split(
        "\n")[1:]
    data = [[float(x) for x in ln.split()] for ln in lines if ln.strip()]
    return [row[:4] for row in data[skip:skip + n]]


@pytest.mark.parametrize("name", CONFIGS)
def test_gene_model_is_copied_from_the_tables(name):
    """The splice-site windows are the Tetrapod tables' zero-order rows
    of their scoring windows, and the intron lengths the IldModel row of
    Homo sapiens, copied unchanged."""
    g = _cfg(name)["genes"]
    assert g["donor"]["log10_odds"] == _table_rows("Splice5", 47, 9)
    assert g["acceptor"]["log10_odds"] == _table_rows("Splice3", 29, 22)
    row = next(ln.split() for ln in (REPO / "data_tables" /
                                     "IldModel.txt").read_text().split("\n")
               if ln.startswith("homosapi"))
    assert [float(x) for x in row[7:14]] == g["intron_bp"]["ild"]
    assert (int(row[3]), int(row[5])) == (g["intron_bp"]["min"],
                                           g["intron_bp"]["max"])


def test_drawn_gene_parts_follow_the_model():
    """Intron lengths have the truncated mixture's median, log-normal
    parts their configured median and mean, and splice-site windows the
    table's base frequencies."""
    g = _cfg("tetrapod_cdna")["genes"]
    rng = np.random.default_rng(1)
    d = g["intron_bp"]
    x = np.array([pg.intron_length(rng, d) for _ in range(20000)])
    assert x.min() >= d["min"] and x.max() <= d["max"]
    a1, m1, t1, k1, m2, t2, k2 = d["ild"]

    def frechet(v, m, t, k):
        z = np.maximum(v - m, 1e-9) / t
        return np.where(v > m, np.exp(-z ** -k), 0.0)

    def cdf(v):
        return a1 * frechet(v, m1, t1, k1) + (1 - a1) * frechet(v, m2, t2,
                                                                 k2)
    lo, hi = cdf(d["min"]), cdf(d["max"])
    grid = np.arange(d["min"], 20000)
    median = grid[np.searchsorted((cdf(grid) - lo) / (hi - lo), 0.5)]
    assert abs(np.median(x) / median - 1) < 0.05
    ex = np.array([pg.lognormal(rng, g["exon_bp"]) for _ in range(20000)])
    assert abs(np.median(ex) / g["exon_bp"]["median"] - 1) < 0.03
    assert abs(ex.mean() / g["exon_bp"]["mean"] - 1) < 0.03
    probs = pg.site_probs(g["donor"])
    sites = [pg._site(rng, probs) for _ in range(4000)]
    freq = np.array([[sum(s[i] == b for s in sites) / len(sites)
                      for b in "ACGT"] for i in range(len(probs))])
    assert np.abs(freq - probs).max() < 0.03


def test_trace_summary_from_device_events():
    """The port's kernels are the device operations that are neither
    copies nor PyTorch's own; idle gaps are labelled by the innermost
    host span open; forward launches with no work counted stop a run."""
    dev = [("void slab_kernel<1, 0>(int*, int)", 1.0, 2.0),
           ("Memcpy DtoH (Device -> Pinned)", 2.0, 2.5),
           ("void at::native::vectorized_elementwise_kernel<4>(int)",
            4.0, 4.5)]
    stages = [("query", 0.0, 6.0), ("output", 5.0, 6.0)]
    got = trace.summarise(dev, stages, [("spliced_slab_trace", 16.7e9, 0)],
                          1, 0.0, 6.0)
    assert got["kernel_s"] == pytest.approx(1.0)
    assert got["busy_s"] == pytest.approx(2.0)
    assert got["least_s"] == pytest.approx(1e-3)
    assert dict(got["device_ops"])["slab_kernel<1, 0>"] == pytest.approx(1.0)
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"query": 2.5, "output": 1.5})
    with pytest.raises(trace.TraceError):
        trace.summarise(dev, stages, [], 3, 0.0, 6.0)
