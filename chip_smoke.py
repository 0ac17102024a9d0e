"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels of the map path from
spaln_tpu_torch/csrc/spliced_dp.cu, then:

1. kernels: one bucket at main-path shapes (B=8, L=128, W=1152, 2 slabs,
   planted introns) through each kernel and its plain PyTorch version on
   the card; outputs must be exactly equal (integer DP: tolerance 0);
2. map, small: `index` + `map -O0` and `-O4` of 4 planted genes through
   the CLI, once on the kernels and once with the DP forced through the
   plain versions on the card; the text must be byte-identical;
3. map, full size (the main path): a synthetic genome with the shape of
   Spaln's Dictyostelium seqdb sample (6 chromosomes, ~34 Mb, GC ~22%)
   with 200 planted genes on both strands, `index` then `map -T Dictyost
   -O0,4 --device cuda`; every bucket must run on the kernels and >= 95%
   of queries must be reported at their planted locus and strand.

Prints the card, per-kernel times, map throughput and stage seconds, a
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Exits
non-zero, with no result, on any failure or without a CUDA device.
Everything is made from fixed numpy seeds; scratch files go to
smoke_work/ (removed at the end), map text to smoke_out/.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "smoke_work"
OUT = ROOT / "smoke_out"
SEED = 20261016

REPLACES = {
    "spliced_slab_trace": "spaln_tpu/ops/dp_spliced_pallas.py:195",
    "spliced_last_ends": "spaln_tpu/ops/dp_spliced_pallas.py:1122",
    "spliced_tb_walk": "spaln_tpu/ops/dp_spliced_scan.py:1127",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def _seq(rng, n: int, gc: float) -> str:
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    return "".join(np.array(list("ACGT"))[rng.choice(4, n, p=p)])


def _intron(rng, n: int) -> str:
    return "GT" + _seq(rng, n - 4, 0.12) + "AG"


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _mutate(rng, s: str, rate: float) -> str:
    a = np.array(list(s))
    hit = np.flatnonzero(rng.random(len(a)) < rate)
    for i in hit:
        a[i] = "ACGT"[("ACGT".index(a[i]) + int(rng.integers(1, 4))) % 4]
    return "".join(a)


def _timed(fn, reps: int) -> float:
    """Milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


@contextlib.contextmanager
def plain_on_card(K):
    """Test hook: route run_bucket's three kernel calls to the plain
    PyTorch versions, on the same CUDA tensors."""
    saved = (K.spliced_slab_trace, K.spliced_last_ends, K.spliced_tb_walk)
    K.spliced_slab_trace = lambda bp, prm: K.slab_trace_plain(bp, prm)
    K.spliced_last_ends = (lambda bp, prm, row, rc, out=None:
                           K.last_ends_plain(bp, prm, row, rc))
    K.spliced_tb_walk = (lambda bp, fl, spj, ends, out=None:
                         K.tb_walk_plain(bp, fl, spj, ends))
    try:
        yield
    finally:
        (K.spliced_slab_trace, K.spliced_last_ends,
         K.spliced_tb_walk) = saved


# --------------------------------------------------------------- phase 1
def check_kernels(K, dp, ctx):
    """Each kernel against its plain version at main-path shapes."""
    from spaln_tpu_torch.score.splice import build_splice_signals
    from spaln_tpu_torch.seq.codec import encode_dna
    rng = np.random.default_rng(SEED)
    queries, genomes, sigs, lws = [], [], [], []
    for i in range(8):
        ex = [_seq(rng, int(rng.integers(60, 86)), 0.3)
              for _ in range(2 + i % 2)]
        g = _seq(rng, 100, 0.22)
        for j, e in enumerate(ex):
            g += e
            if j < len(ex) - 1:
                g += _intron(rng, int(rng.integers(70, 300)))
        g += _seq(rng, 120, 0.22)
        q = _mutate(rng, "".join(ex), 0.01)
        gc = encode_dna(g)
        queries.append(encode_dna(q))
        genomes.append(gc)
        sigs.append(build_splice_signals(gc, ctx.cfg, ctx.tables))
        lws.append(-150 - 7 * i)
    bp = dp.prepare_spliced_batch(queries, genomes, ctx.prm, sigs=sigs,
                                  lws=lws, W=1152, L=128, device="cuda")
    if (bp.S, bp.B, bp.L) != (2, 8, 128):
        raise AssertionError(f"kernel bucket geometry {bp.S, bp.B, bp.L}")
    prm = ctx.prm
    out = {}
    k1 = K.spliced_slab_trace(bp, prm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1 = K.slab_trace_plain(bp, prm)
    torch.cuda.synchronize()
    plain1 = (time.perf_counter() - t0) * 1e3
    err = max(_max_abs_err(a, b) for a, b in zip(k1, p1))
    if err:
        raise AssertionError(f"spliced_slab_trace differs from plain: {err}")
    if not (k1[1] > 0).any():
        raise AssertionError("no intron closed in the kernel bucket")
    out["spliced_slab_trace"] = dict(
        max_abs_err=err, plain_ms=plain1,
        ms=_timed(lambda: K.spliced_slab_trace(bp, prm), 5))
    flags, spj, row, rc = k1
    e_k = K.spliced_last_ends(bp, prm, row, rc)
    e_p = K.last_ends_plain(bp, prm, row, rc)
    err = _max_abs_err(e_k, e_p)
    if err:
        raise AssertionError(f"spliced_last_ends differs from plain: {err}")
    out["spliced_last_ends"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: K.spliced_last_ends(bp, prm, row, rc), 20),
        plain_ms=_timed(lambda: K.last_ends_plain(bp, prm, row, rc), 5))
    r_k = K.spliced_tb_walk(bp, flags, spj, e_k)
    r_p = K.tb_walk_plain(bp, flags, spj, e_k)
    err = _max_abs_err(r_k, r_p)
    if err:
        raise AssertionError(f"spliced_tb_walk differs from plain: {err}")
    ops = dp.ops_from_records(r_k.cpu().numpy(), bp.B)
    if not all(any(o[0] == "I" for o in x) for x in ops):
        raise AssertionError("a planted intron was not recovered")
    out["spliced_tb_walk"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: K.spliced_tb_walk(bp, flags, spj, e_k), 20),
        plain_ms=_timed(lambda: K.tb_walk_plain(bp, flags, spj, e_k), 2))
    cells = bp.B * bp.S * bp.L * bp.W
    for name, r in out.items():
        log(f"kernel {name}: exact (max_abs_err {r['max_abs_err']}); "
            f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms "
            f"(B=8 L=128 W=1152 S=2, {cells} band cells)")
    return out


# --------------------------------------------------------------- phase 2
def small_map(K, cli):
    """4 planted genes: kernels vs plain versions, byte for byte."""
    rng = np.random.default_rng(SEED + 1)
    contig = _seq(rng, 36000, 0.3)
    recs, pos = [], 3000
    for i in range(4):
        ex = [_seq(rng, int(rng.integers(90, 160)), 0.35)
              for _ in range(2 + i % 2)]
        g = ex[0]
        for e in ex[1:]:
            g += "GTAAGT" + _seq(rng, int(rng.integers(67, 387)), 0.2) \
                + "TTTCTAG" + e
        if i % 3 == 2:
            g = _revcomp(g)
        contig = contig[:pos] + g + contig[pos + len(g):]
        recs.append(f">q{i}\n{''.join(ex)}\n")
        pos += len(g) + 2500
    d = WORK / "small"
    d.mkdir(parents=True)
    (d / "g.fa").write_text(">c1\n" + contig + "\n")
    (d / "q.fa").write_text("".join(recs))
    cli.main(["index", str(d / "g.fa"), "-p", str(d / "g")])
    texts = {}
    for mode in ("kernels", "plain"):
        ctxm = plain_on_card(K) if mode == "plain" else contextlib.nullcontext()
        with ctxm:
            for fmt in ("0", "4"):
                o = OUT / f"small.{mode}.O{fmt}"
                cli.main(["map", str(d / "q.fa"), "-d", str(d / "g"), "-O",
                          fmt, "-o", str(o), "--device", "cuda"])
                texts[mode, fmt] = o.read_bytes()
    for fmt in ("0", "4"):
        if texts["kernels", fmt] != texts["plain", fmt]:
            raise AssertionError(f"small map -O{fmt}: kernels and plain "
                                 f"versions differ")
    n_genes = texts["kernels", "0"].count(b"\tgene\t")
    if n_genes != 4:
        raise AssertionError(f"small map reported {n_genes} of 4 genes")
    log(f"small map: -O0 and -O4 byte-identical, kernels vs plain on the "
        f"card ({len(texts['kernels', '0'])} + "
        f"{len(texts['kernels', '4'])} bytes)")


# --------------------------------------------------------------- phase 3
CHROMS = (4.9e6, 8.5e6, 6.4e6, 5.4e6, 5.1e6, 3.6e6)


def make_corpus(d: Path):
    """Synthetic dictdisc-scale deployment: 6 chromosomes (~34 Mb, GC
    ~22%), 200 genes planted on both strands (2-5 exons of 80-600 nt,
    GT..AG introns of 70-400 nt), cDNA queries from the exons with ~1%
    substitutions.  Returns the planted truth per query."""
    rng = np.random.default_rng(SEED + 2)
    lens = [int(x) for x in CHROMS]
    chroms = [np.array(list("ACGT"), dtype="S1")[
        rng.choice(4, n, p=[0.39, 0.11, 0.11, 0.39])] for n in lens]
    truth, queries, taken = [], [], [[] for _ in lens]
    p_chrom = np.asarray(lens, float) / sum(lens)
    while len(truth) < 200:
        c = int(rng.choice(len(lens), p=p_chrom))
        ex = [_seq(rng, int(rng.integers(80, 601)), 0.3)
              for _ in range(int(rng.integers(2, 6)))]
        parts, spans, at = [], [], 0
        for j, e in enumerate(ex):
            spans.append((at, at + len(e)))
            parts.append(e)
            at += len(e)
            if j < len(ex) - 1:
                intr = _intron(rng, int(rng.integers(70, 401)))
                parts.append(intr)
                at += len(intr)
        g = "".join(parts)
        pos = int(rng.integers(5000, lens[c] - len(g) - 5000))
        if any(pos < b + 5000 and a < pos + len(g) + 5000
               for a, b in taken[c]):
            continue
        taken[c].append((pos, pos + len(g)))
        strand = "+" if len(truth) % 2 == 0 else "-"
        if strand == "-":
            g = _revcomp(g)
            spans = [(len(g) - b, len(g) - a) for a, b in spans][::-1]
        chroms[c][pos:pos + len(g)] = np.array(list(g), dtype="S1")
        qn = f"q{len(truth):03d}"
        truth.append(dict(q=qn, chrom=f"chr{c + 1}", strand=strand,
                          span=(pos, pos + len(g)),
                          exons={(pos + a + 1, pos + b) for a, b in spans}))
        queries.append(f">{qn}\n{_mutate(rng, ''.join(ex), 0.01)}\n")
    with open(d / "genome.fa", "wb") as fh:
        for c, arr in enumerate(chroms):
            fh.write(f">chr{c + 1}\n".encode())
            body = arr.tobytes()
            for k in range(0, len(body), 80):
                fh.write(body[k:k + 80] + b"\n")
    (d / "cdna.fa").write_text("".join(queries))
    return truth


def full_map(K, cli, metrics):
    d = WORK / "full"
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    truth = make_corpus(d)
    log(f"full map: corpus built in {time.perf_counter() - t0:.1f} s "
        f"({sum(CHROMS) / 1e6:.1f} Mb, {len(truth)} planted genes)")
    t0 = time.perf_counter()
    cli.main(["index", str(d / "genome.fa"), "-p", str(d / "genome")])
    log(f"full map: index built in {time.perf_counter() - t0:.1f} s")
    metrics.reset()
    for k in K.KERNELS:
        K.launches[k] = 0
        K.plain_calls[k] = 0
    out = OUT / "full.O0_4"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["map", str(d / "cdna.fa"), "-d", str(d / "genome"),
              "-T", "Dictyost", "-O", "0,4", "-o", str(out),
              "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    buckets = metrics.counters.get("device_buckets", 0)
    if buckets < 1 or any(launches[k] != buckets for k in K.KERNELS):
        raise AssertionError(f"launches {launches} != buckets {buckets}")
    if any(K.plain_calls.values()):
        raise AssertionError(f"plain versions ran: {K.plain_calls}")
    # first reported gene per query (GFF3 gene lines), exon table rows
    best, exons = {}, {}
    for line in out.read_text().splitlines():
        f = line.split("\t")
        if len(f) == 9 and f[2] == "gene":
            q = f[8].split("Name=")[1]
            best.setdefault(q, (f[0], f[6], int(f[3]), int(f[4])))
        elif len(f) == 14:
            exons.setdefault(f[0], set()).add((int(f[5]), int(f[6])))
    hit = tp = n_true = n_rep = 0
    for t in truth:
        b = best.get(t["q"])
        if (b and b[0] == t["chrom"] and b[1] == t["strand"]
                and b[2] <= t["span"][1] and b[3] > t["span"][0]):
            hit += 1
        rep = exons.get(t["q"], set())
        tp += len(rep & t["exons"])
        n_true += len(t["exons"])
        n_rep += len(rep)
    frac = hit / len(truth)
    secs = {k: round(v, 3) for k, v in metrics.timings.items()}
    cells = metrics.counters.get("dp_cells", 0)
    dev = metrics.timings.get("device_dp", 0.0)
    log(f"full map: {len(truth)} queries in {wall:.2f} s = "
        f"{len(truth) / wall:.2f} queries/s; {buckets} buckets; "
        f"stage seconds {json.dumps(secs, sort_keys=True)}")
    log(f"full map: dp_cells {cells} (band cells), device_dp "
        f"{dev:.3f} s -> {cells / max(dev, 1e-9) / 1e9:.3f} GCUPS")
    log(f"full map: {hit}/{len(truth)} = {100 * frac:.1f}% at the planted "
        f"locus and strand; exon recall {tp / max(n_true, 1):.4f}, "
        f"precision {tp / max(n_rep, 1):.4f}")
    if frac < 0.95:
        raise AssertionError(f"only {100 * frac:.1f}% of queries at their "
                             f"planted locus and strand")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spaln_tpu_torch import cli
    from spaln_tpu_torch.align.driver import AlignerContext
    from spaln_tpu_torch.ops import dp_spliced as dp
    from spaln_tpu_torch.ops import dp_spliced_cuda as K
    from spaln_tpu_torch.score.tables import TableDir, find_table_dir
    from spaln_tpu_torch.utils.metrics import metrics

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    OUT.mkdir(parents=True, exist_ok=True)
    try:
        so, secs, ptxas = K.build_library()
        log(f"kernels built in {secs:.1f} s -> {so.relative_to(ROOT)}")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
        ctx = AlignerContext.create(
            TableDir(find_table_dir(), species="Dictyost"), "cuda")
        results = check_kernels(K, dp, ctx)
        small_map(K, cli)
        launches = full_map(K, cli, metrics)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    src = str((ROOT / "spaln_tpu_torch/csrc/spliced_dp.cu")
              .relative_to(ROOT))
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=REPLACES[k],
             launches=launches[k], max_abs_err=results[k]["max_abs_err"],
             ms=results[k]["ms"], plain_ms=results[k]["plain_ms"])
        for k in K.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
