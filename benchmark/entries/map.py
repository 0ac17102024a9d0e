"""Entry ``map``: chunks of ``chunk`` queries over the whole genome,
closed loop, one caller, as ``spaln_tpu_torch.cli map`` runs them:
``GenomeMapper.map_queries`` or ``ProteinGenomeMapper.map_queries`` over
the program's own index (built by its ``index`` step into the
deployment's cache), the answers written through the CLI's sink.  Each
chunk is timed from the call to the end of its output."""
from __future__ import annotations

import time

SUBCOMMAND = ["map", "queries.fa", "-d", "genome"]


def _kind(cfg: dict) -> str:
    return "P" if cfg["query"]["kind"] == "protein" else "D"


def prepare(dep, cfg: dict, traffic: dict) -> bool:
    """The program's index of the deployment, made once by its ``index``
    step.  Returns whether it was made now."""
    from benchmark import deploy

    def make():
        from spaln_tpu_torch import cli
        cli.main(["index", dep.fasta, "-p", dep.prefix, "-K", _kind(cfg)])
    return deploy.ensure(dep, f"index.{_kind(cfg)}", make)



def setup(system) -> None:
    from spaln_tpu_torch.seq.genome import GenomeStore
    dep = system.dep
    store = GenomeStore.load(dep.prefix)
    if system.protein:
        from spaln_tpu_torch.align.mapper import ProteinGenomeMapper
        from spaln_tpu_torch.seed.blockindex import ProteinBlockIndex
        system.mapper = ProteinGenomeMapper(
            store, ProteinBlockIndex.load(dep.prefix), system.ctx)
    else:
        from spaln_tpu_torch.align.mapper import GenomeMapper
        from spaln_tpu_torch.seed.blockindex import BlockIndex
        system.mapper = GenomeMapper(store, BlockIndex.load(dep.prefix),
                                     system.ctx)


def chunk(system, qs: list) -> list:
    """A chunk of queries over the whole genome; returns their texts."""
    a = system.args
    kw = dict(q_names=[q.name for q in qs], lanes=a.lanes,
              max_out=a.max_out, max_batch=max(a.batch, 1))
    if not system.protein:
        kw["strand"] = a.strand
    res = system.mapper.map_queries([system.codes(q.seq) for q in qs], **kw)
    return [system.emit(gs_list, len(q.seq))
            for q, gs_list in zip(qs, res)]


def warm(system, queries: list) -> None:
    chunk(system, queries)


def drive(system, stream, seconds: float, tracer) -> dict:
    """Whole passes over the stream, in chunks, until the window has
    lasted ``seconds``; the window ends with the pass that crosses it."""
    n = system.traffic["chunk"]
    answers, walls = [], []
    t0 = time.perf_counter()
    while True:
        qs = stream.next_pass()
        for i in range(0, len(qs), n):
            a = time.perf_counter()
            texts = chunk(system, qs[i:i + n])
            b = time.perf_counter()
            if tracer is not None:
                tracer.span("chunk", a, b)
            answers.extend(zip(qs[i:i + n], texts))
            walls.append(b - a)
        if b - t0 >= seconds:
            return dict(answers=answers, query_s=walls, t0=t0, t1=b)
