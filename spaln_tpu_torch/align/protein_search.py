"""Protein vs protein-DB (semi-)global search: the spaln -a mode.

The counterpart of spaln_tpu/align/protein_search.py (the role of
Aln2b1's seeded driver + CalcServer fan-out, fwd2b1.cc:1405,
calcserv.h): score one query against many DB entries and align the
best hits.  Every candidate batch is one launch of the score-only slab
kernel (K5, spliced_slab_score) and the end extraction (K2e); each top
hit then takes the plane path (run_bucket: K1, then K2e and K3 in one
launch).  Both run
on ``device``: the CUDA kernels on a CUDA device, their plain versions
on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config, resolve, PvsP
from ..ops.dp_spliced import forward_spliced_batch, prepare_spliced_batch
from ..ops.dp_spliced_cuda import run_bucket
from ..ops.params import DpParams, DpFlags
from ..score.simmtx import Simmtx
from ..utils.errors import DeviceDPError
from ..utils.metrics import metrics, stage
from .gene import GeneStructure, build_gene_structure


@dataclass
class ProteinHit:
    name: str
    score: int
    q_span: tuple
    s_span: tuple
    identity: float
    structure: GeneStructure | None = None


def _device_dp(what: str, where, fn, *args, **kw):
    """Run one DP call; any failure of it (upload, kernel, plain
    version) is raised as DeviceDPError, which per-query isolation passes
    on."""
    try:
        return fn(*args, **kw)
    except Exception as exc:
        raise DeviceDPError(f"{what} on {where}: {type(exc).__name__}: "
                            f"{exc}") from exc


def search_protein_db(query: np.ndarray, db: list, ctx_tables=None,
                      matrix: str | None = None, table_dir: str = "",
                      max_hits: int = 10, align_top: int = 1,
                      lanes: int = 64, batch: int = 64,
                      cfg: Config | None = None,
                      prefilter: bool | None = None,
                      db_index=None,
                      device: torch.device | str = "cuda"
                      ) -> list[ProteinHit]:
    """Rank DB entries by semi-global alignment score; align the best.

    db: list of (name, codes) tuples.  For large DBs a k-mer prefilter
    (SrchBlk::finds role, blksrc.cc:3271+) selects candidate entries so
    the DP runs on a calibrated subset; pass prefilter=False to force
    full DP on every entry, or a prebuilt ProteinDbIndex via db_index.
    The DP runs on ``device``: the CUDA kernels by default, their plain
    versions for "cpu".
    """
    cfg = resolve(cfg or Config(), PvsP)
    if matrix:
        from ..score.simmtx import text_matrix
        sm = Simmtx(text_matrix(matrix), u=4., v=10.)
    else:
        sm = Simmtx.protein(table_dir, slot=0)
    prm = DpParams.build(cfg, sm, PvsP)
    flags = DpFlags()                      # semi-global
    if prefilter is None:
        prefilter = len(db) > 256
    cand_ids = np.arange(len(db))
    if prefilter and len(db):
        from ..seed.dbindex import ProteinDbIndex
        with stage("prefilter"):
            if db_index is None:
                db_index = ProteinDbIndex.build(db)
            cand_ids = db_index.candidates(query,
                                           max_cand=max(4 * max_hits, 64),
                                           min_hits=max_hits)
    scores = np.full(len(db), -(1 << 60), dtype=np.int64)
    for b0 in range(0, len(cand_ids), batch):
        ids = cand_ids[b0:b0 + batch]
        with stage("score_pass"):
            s, _, _ = _device_dp(
                f"score pass of {len(ids)} DB entries", device,
                forward_spliced_batch, [query] * len(ids),
                [db[i][1] for i in ids], prm, flags=flags, L=lanes,
                score_only=True, device=device)
        scores[ids] = s
        metrics.bump("search_score_batches")
    order = np.argsort(scores)[::-1][:max_hits]
    order = order[scores[order] > -(1 << 60)]
    hits: list[ProteinHit] = []
    for rank, i in enumerate(order):
        name, codes = db[i]
        hit = ProteinHit(name=name, score=int(scores[i]),
                         q_span=(0, len(query)), s_span=(0, len(codes)),
                         identity=0.0)
        if rank < align_top:
            with stage("traceback"):
                s, _, ops_all = _device_dp(
                    f"traceback of hit {name!r}", device,
                    lambda: run_bucket(prepare_spliced_batch(
                        [query], [codes], prm, flags=flags, L=lanes,
                        device=device), prm))
                gsr = build_gene_structure(ops_all[0], query, codes,
                                           int(s[0]), q_name="query",
                                           g_name=name, aa_pair=True)
            metrics.bump("search_traced_hits")
            if gsr is not None:
                hit.structure = gsr
                hit.identity = gsr.identity
                hit.q_span = gsr.q_span
                hit.s_span = gsr.g_span
        hits.append(hit)
    return hits


def search_protein_local(*args, **kwargs) -> list[ProteinHit]:
    """SWG multi-local search (spaln_tpu's search_protein_local): needs
    the local mode of the slab kernel."""
    raise NotImplementedError(
        "local protein search is not ported yet: ROADMAP.md Queue 1, "
        "item 9 (local mode, K6)")
