"""Long genomic-segment annotation: chunking + seam stitching, cDNA
and protein queries.

The counterpart of spaln_tpu/align/segment.py (the reference's
g_segment chunks with HalfGene seam handling, ThQueue::putqueue
spaln.cc:1276-1296, mistress_func spaln.cc:1336-1361): chunks overlap by
max(chunk / 10, 64 kb); every query is aligned against every chunk with
align_cdna, copies clipped at an interior seam are dropped (the
neighbouring chunk holds the whole gene thanks to the overlap), and
duplicates from overlapping chunks dedup to the best-scoring copy.
Protein queries go through align_protein at half the lanes (at least
32), as in the reference.
"""
from __future__ import annotations

import numpy as np

from ..utils.errors import guard_query
from ..utils.metrics import metrics
from .driver import AlignerContext, align_cdna
from .protein_driver import ProteinAlignerContext, align_protein
from .gene import GeneStructure

G_SEGMENT = 2_000_000


def _chunks(n: int, size: int, overlap: int):
    out = []
    lo = 0
    while lo < n:
        hi = min(lo + size, n)
        out.append((lo, hi))
        if hi >= n:
            break
        lo = hi - overlap
    return out


def annotate_segment(genome: np.ndarray, queries: list,
                     ctx: AlignerContext | None = None,
                     pctx: ProteinAlignerContext | None = None,
                     q_names: list | None = None,
                     molc_is_aa: list | None = None,
                     g_name: str = "", lanes: int = 128,
                     chunk: int = G_SEGMENT,
                     overlap: int | None = None,
                     strand: str = "auto",
                     min_coverage: float = 0.3) -> list[GeneStructure]:
    """Annotate one genomic segment against a query set; returns all
    gene structures in segment coordinates, seam-stitched and deduped."""
    n = len(genome)
    q_names = q_names or [""] * len(queries)
    molc_is_aa = molc_is_aa or [False] * len(queries)
    if overlap is None:
        overlap = max(chunk // 10, 65536) if n > chunk else 0
    if n > chunk and overlap >= chunk:
        raise ValueError(f"chunks of {chunk} with an overlap of {overlap} "
                         f"never advance")
    results: list[GeneStructure] = []
    spans = _chunks(n, chunk, overlap) if n > chunk else [(0, n)]
    for lo, hi in spans:
        metrics.bump("segment_chunks")
        win = np.asarray(genome[lo:hi])
        edge_l = lo > 0
        edge_r = hi < n
        for qi, q in enumerate(queries):
            if molc_is_aa[qi]:
                if pctx is None:
                    continue
                gss = guard_query(align_protein, q, win, pctx,
                                  strand=strand, q_name=q_names[qi],
                                  g_name=g_name,
                                  lanes=max(lanes // 2, 32),
                                  name=q_names[qi], stage="segment",
                                  fallback=[])
            else:
                if ctx is None:
                    continue
                gss = guard_query(align_cdna, q, win, ctx, strand=strand,
                                  q_name=q_names[qi], g_name=g_name,
                                  lanes=lanes, name=q_names[qi],
                                  stage="segment", fallback=[])
            for gs in gss:
                if gs.coverage(len(q)) < min_coverage:
                    continue
                g0, g1 = gs.g_span
                # seam check (HalfGene role): a gene clipped at an
                # interior chunk edge is re-found in the neighboring
                # chunk thanks to the overlap; drop the clipped copy
                near = max(len(q) * (3 if molc_is_aa[qi] else 1), 64)
                if ((edge_l and g0 < near
                     and gs.coverage(len(q)) < 0.999)
                        or (edge_r and len(win) - g1 < near
                            and gs.coverage(len(q)) < 0.999)):
                    metrics.bump("seam_dropped")
                    continue
                for e in gs.exons:
                    e.g_start += lo
                    e.g_end += lo
                for i in gs.introns:
                    i.g_start += lo
                    i.g_end += lo
                results.append(gs)
    return _dedup(results)


def _dedup(records: list[GeneStructure]) -> list[GeneStructure]:
    """Keep the best-scoring copy of each (query, locus) produced by
    overlapping chunks (>=50% genomic overlap = same locus)."""
    records = sorted(records, key=lambda g: -g.score)
    kept: list[GeneStructure] = []
    for g in records:
        g0, g1 = g.g_span
        dup = False
        for k in kept:
            if k.q_name != g.q_name or k.strand != g.strand:
                continue
            k0, k1 = k.g_span
            ov = min(g1, k1) - max(g0, k0)
            if ov > 0 and 2 * ov > min(g1 - g0, k1 - k0):
                dup = True
                break
        if not dup:
            kept.append(g)
    kept.sort(key=lambda g: (g.g_span[0], g.g_span[1]))
    return kept
