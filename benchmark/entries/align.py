"""Entry ``align``: one query a call onto its locus, closed loop, one
caller, as ``spaln_tpu_torch.cli align`` runs a query against a genomic
segment: ``align_cdna`` or ``align_protein`` under the CLI's per-query
isolation (``guard_query``), the answer written through the CLI's sink.
(The CLI chunks a segment longer than ``-G``, 2 Mb by default; the
planted loci are shorter.)  Each query is timed from the call to the end
of its output."""
from __future__ import annotations

import time

SUBCOMMAND = ["align", "genomic.fa", "queries.fa"]


def prepare(dep, cfg: dict, traffic: dict) -> bool:
    """Nothing beyond the deployment: a locus needs no index."""
    return False


def setup(system) -> None:
    pass


def one(system, q) -> str:
    """One query onto its locus [q.lo, q.hi); returns its text."""
    from spaln_tpu_torch.seq.codec import encode_dna
    from spaln_tpu_torch.utils.errors import guard_query
    a, dep = system.args, system.dep
    seg = encode_dna(dep.region(q.chrom, q.lo, q.hi))
    codes = system.codes(q.seq)
    g_name = dep.names[q.chrom]
    if system.protein:
        from spaln_tpu_torch.align.protein_driver import align_protein as fn
    else:
        from spaln_tpu_torch.align.driver import align_cdna as fn
    gs_list = guard_query(fn, codes, seg, system.ctx, strand=a.strand,
                          q_name=q.name, g_name=g_name, lanes=a.lanes,
                          name=q.name, stage="align", fallback=[])
    return system.emit(gs_list, len(codes))


def warm(system, queries: list) -> None:
    for q in queries:
        one(system, q)


def drive(system, stream, seconds: float, tracer) -> dict:
    """Whole passes over the stream until the window has lasted
    ``seconds``; the window ends with the pass that crosses it."""
    answers, walls = [], []
    t0 = time.perf_counter()
    while True:
        for q in stream.next_pass():
            a = time.perf_counter()
            text = one(system, q)
            b = time.perf_counter()
            if tracer is not None:
                tracer.span("query", a, b)
            answers.append((q, text))
            walls.append(b - a)
        if b - t0 >= seconds:
            return dict(answers=answers, query_s=walls, t0=t0, t1=b)
