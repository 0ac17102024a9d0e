"""Protein vs protein-DB (semi-)global search: the spaln -a mode.

The counterpart of spaln_tpu/align/protein_search.py (the role of
Aln2b1's seeded driver + CalcServer fan-out, fwd2b1.cc:1405,
calcserv.h): score one query against many DB entries and align the
best hits.  Every candidate batch is one launch of the score-only slab
kernel (K5, spliced_slab_score) and the end extraction (K2e); each top
hit then takes the plane path (run_bucket: K1, then K2e and K3 in one
launch).  The local search (search_protein_local) runs K1 in its local
mode with the emission (K6) a batch, and walks the colonies it finds on
the host.  All run on ``device``: the CUDA kernels on a CUDA device,
their plain versions on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config, resolve, PvsP
from ..ops.dp_spliced import (PLANE_BYTES_BUDGET, SliceTrace,
                              collect_local_ends, forward_spliced_batch,
                              pick_colonies, plane_bytes_per_cell,
                              prepare_spliced_batch, traceback_spliced_scan)
from ..ops.dp_spliced_cuda import run_bucket, spliced_slab_trace
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


def _plane_parts(query: np.ndarray, chunk: list, lanes: int, prm,
                 plane_budget: int) -> list:
    """The batch ``chunk`` cut, in DB order, into runs of entries whose
    planes fit ``plane_budget`` in one launch (the band of a batch spans
    its longest entry, so a long entry widens every problem's planes).
    A problem's result does not depend on its batch-mates: its band
    covers its whole matrix in any batch (lw = -M, up >= N)."""
    S = -(-len(query) // lanes)
    per_cell = plane_bytes_per_cell(prm)
    parts, cur, nmax = [], [], 0
    for e in chunk:
        n2 = max(nmax, len(e[1]))
        T = n2 + len(query) + 1 + 2 * (lanes - 1)
        if cur and (len(cur) + 1) * S * T * lanes * per_cell > plane_budget:
            parts.append(cur)
            cur, n2 = [], len(e[1])
        cur.append(e)
        nmax = n2
    if cur:
        parts.append(cur)
    return parts


def search_protein_local(query: np.ndarray, db: list,
                         matrix: str | None = None, table_dir: str = "",
                         max_out: int = 4, vthr: int | None = None,
                         lanes: int = 64, batch: int = 64,
                         cfg: Config | None = None,
                         device: torch.device | str = "cuda",
                         plane_budget: int = PLANE_BYTES_BUDGET
                         ) -> list[ProteinHit]:
    """SWG multi-local search (search_protein_local, spaln_tpu/align/
    protein_search.py:103-160; fwdswgB_ng + Colonies, fwd2b1.cc:734):
    every local-alignment island scoring >= vthr is reported, up to
    max_out per DB entry, best first (ties in DB order).  Each batch of
    ``batch`` entries is one launch of K1 in its local mode with the
    step emission (K6; split by problems where its planes would pass
    ``plane_budget``); the colony ends come from the emission on the
    host, and only the planes of problems that have one are copied back
    and walked there (pick_colonies)."""
    cfg = resolve(cfg or Config(), PvsP)
    if matrix:
        from ..score.simmtx import text_matrix
        sm = Simmtx(text_matrix(matrix), u=4., v=10.)
    else:
        sm = Simmtx.protein(table_dir, slot=0)
    prm = DpParams.build(cfg, sm, PvsP)
    if vthr is None:
        vthr = int(cfg.aln.thr * cfg.aln.scale)   # pwd->Vthr
    flags = DpFlags(local=True)
    hits: list[ProteinHit] = []
    for b0 in range(0, len(db), batch):
        for part in _plane_parts(query, db[b0:b0 + batch], lanes, prm,
                                 plane_budget):
            with stage("local_pass"):
                bp, fl, spj, lv, li = _device_dp(
                    f"local pass of {len(part)} DB entries", device,
                    _local_pass, query, part, prm, flags, lanes, device)
                ends = collect_local_ends(bp, list(zip(lv, li)), vthr)
            metrics.bump("local_search_batches")
            with stage("traceback"):
                for i, cands in enumerate(ends):
                    if cands:
                        hits.extend(_colonies(query, part[i], cands,
                                              bp.lws[i], bp,
                                              fl[:, :, i], spj[:, :, :, i],
                                              prm, max_out, vthr))
    hits.sort(key=lambda h: -h.score)
    return hits


def _local_pass(query, part, prm, flags, lanes, device):
    """K1 in local mode with the emission over one part: (bp, flags (S,
    T, B, L) and spj planes on the device, the emission (S, T, B) as
    numpy)."""
    bp = prepare_spliced_batch([query] * len(part), [c for _, c in part],
                               prm, flags=flags, L=lanes, device=device)
    fl, spj, _, _, lv, li = spliced_slab_trace(bp, prm, emit_local=True)
    return bp, fl, spj, lv.cpu().numpy(), li.cpu().numpy()


def _colonies(query, entry, cands, lw: int, bp, fl, spj, prm,
              max_out: int, vthr: int) -> list:
    """The hits of one DB entry (band placement ``lw``): its planes
    copied to the host, the colonies picked from its ends and walked
    there."""
    name, codes = entry
    fl, spj = fl.cpu().numpy(), spj.cpu().numpy()   # (S, T, L), (S, NS, ..)
    tr = SliceTrace(flags=list(fl),
                    spj=[np.moveaxis(x, 0, -1) for x in spj],
                    L=bp.L, lw=lw, W=bp.W)

    def _trace(m, n):
        ops = traceback_spliced_scan(tr, m, n)
        if not ops:
            return None
        return (ops[0][1], ops[0][2], ops)

    out = []
    for val, m, n, (m0, n0, ops) in pick_colonies(
            cands, _trace, max_out=max_out, gep=prm.gep, vthr=vthr):
        gsr = build_gene_structure(ops, query, codes, val, q_name="query",
                                   g_name=name, aa_pair=True)
        if gsr is None:
            continue
        out.append(ProteinHit(name=name, score=val, q_span=gsr.q_span,
                              s_span=gsr.g_span, identity=gsr.identity,
                              structure=gsr))
        metrics.bump("local_search_hits")
    return out
