"""Genome mapper: block-index candidate location + seeded alignment of
cDNA queries.

The role of the spaln -Q7 pipeline (spaln_job -> quick4 -> blkaln,
spaln.cc:846-1154): locate candidate gene ranges with the block index,
align the query to each with the batched driver on the context's
device, keep the best loci.  The counterpart of the cDNA half of
spaln_tpu/align/mapper.py; protein queries are not ported yet
(ROADMAP.md Queue 1, item 8).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..seed.blockindex import BlockIndex
from ..seed.wilip import wilip
from ..seq.codec import comrev
from ..seq.utilseq import rm_polya
from ..seq.genome import GenomeStore
from .driver import AlignerContext, execute_jobs, prepare_job
from .gene import GeneStructure


@dataclass
class GenomeMapper:
    store: GenomeStore
    index: BlockIndex
    ctx: AlignerContext

    def map_query(self, query: np.ndarray, q_name: str = "",
                  strand: str = "auto", ncand: int = 10,
                  max_out: int = 1, min_coverage: float = 0.3,
                  lanes: int = 128,
                  trim_polya: bool = True) -> list[GeneStructure]:
        """Map one query onto the whole genome; returns best loci.

        Thin wrapper over the batched pipeline (map_queries) so the two
        entry points cannot drift."""
        return self.map_queries([query], q_names=[q_name], strand=strand,
                                ncand=ncand, max_out=max_out,
                                min_coverage=min_coverage, lanes=lanes,
                                trim_polya=trim_polya)[0]


def _map_queries_batched(self, queries: list, q_names: list | None = None,
                         strand: str = "auto", ncand: int = 10,
                         max_out: int = 1, min_coverage: float = 0.3,
                         lanes: int = 128, max_batch: int = 32,
                         trim_polya: bool = True,
                         triage: dict | None = None
                         ) -> list[list[GeneStructure]]:
    """Map many queries in bucketed device batches — the data-parallel
    replacement of the reference's master-worker ThQueue
    (spaln.cc:1220-1468).  Per round: locate candidates + seed on host,
    run all DP problems as batched device launches, widen windows
    that clipped a gene (ExtBlock) and re-queue for the next round."""
    from ..utils.metrics import metrics, stage
    q_names = q_names or [""] * len(queries)
    maxgene = self.index.maxgene
    total = self.store.total_len
    metrics.bump("queries", len(queries))
    # poly-A trimming (PolyA::rmpolyA, spaln.cc:1161).  The hint encodes
    # the QUERY's sense (ori bitmask: polyA tail = sense transcript,
    # polyT head = antisense), NOT the genome strand — a sense cDNA maps
    # to either strand (spaln.cc:1140-1145 only restricts which query
    # orientation is tried).  Antisense queries are flipped to sense
    # orientation here and reported in flipped coordinates (the
    # reference comrevs the Seq and reports with a sense flag).
    queries = list(queries)
    q_offs = [0] * len(queries)
    strands = [strand] * len(queries)
    if trim_polya:
        for qi, q in enumerate(queries):
            lo, hi, hint = rm_polya(q)
            if hi - lo >= 30:
                queries[qi], q_offs[qi] = q[lo:hi], lo
                if hint == 2:
                    queries[qi], q_offs[qi] = comrev(queries[qi]), 0

    def _mark(qi, stage_name, detail=""):
        if triage is not None:
            triage.setdefault(qi, []).append((stage_name, detail))
    # a failing query is skipped with a warning, never aborts the batch
    # (spaln.cc:1104-1107 semantics)
    from ..utils.errors import report_skip
    from ..seed.wilip import WindowTable

    # window word tables are reused across strands (the query flips
    # instead of the 26kb window), widen rounds, and queries voting
    # into the same locus (Wlp keeps its lookup table per target,
    # wln.cc:253-350)
    wt_cache: dict[tuple, WindowTable] = {}
    rc_cache: dict[int, np.ndarray] = {}

    def _wtab(g0, g1):
        wt = wt_cache.get((g0, g1))
        if wt is None:
            if len(wt_cache) > 256:
                wt_cache.clear()
            wt = WindowTable(self.store.window(g0, g1))
            wt_cache[(g0, g1)] = wt
        return wt

    def _rc_q(qi):
        rq = rc_cache.get(qi)
        if rq is None:
            rq = comrev(queries[qi])
            rc_cache[qi] = rq
        return rq

    def _verify_candidate(qi, g0, g1, hint=None):
        """FindHsp-equivalent in-candidate verification
        (blksrc.cc:2346-2545): run Wilip inside the vote window, widen
        the window (ExtBlock role) while the best chain leaves a query
        end uncovered at a window edge, and return the verified
        (g0, g1, strand, chain) — or None when no chain survives.  DP
        is only spent on verified candidates.

        hint: the strand whose block votes produced this window — that
        strand is chained first and the other only as a fallback
        (findblock's 4-tally scan is already per-orientation,
        blksrc.cc:2971-3087), halving host chaining work."""
        q = queries[qi]
        order = ("+", "-")
        if hint == "-":
            order = ("-", "+")
        order = [st for st in order
                 if strands[qi] == "auto" or strands[qi] == st]
        for _widen in range(3):
            wt = _wtab(g0, g1)
            window = wt.g
            cands = []
            with stage("seed"):
                for st in order:
                    # same-species verification stays on the fine seed:
                    # the deeper (k=4) levels exist for cross-species
                    # sensitivity and explode on the ~2/3 of candidate
                    # windows that are spurious (profiled: the level
                    # ladder on junk windows was most of the seed stage)
                    ch = wilip(_rc_q(qi) if st == "-" else q,
                               wtab=wt, mirror=(st == "-"),
                               ipen=self.ctx.ipen,
                               prm=self.ctx.prm,
                               spaced=self.ctx.cfg.alg.crs > 0,
                               max_level=(None if self.ctx.cfg.alg.crs
                                          else 1))
                    if ch:
                        cands.append((ch[0].score, st, ch[0]))
            if not cands:
                return None
            cands.sort(key=lambda c: -c[0])
            score, st, chain = cands[0]
            # ambiguous orientation: when the other strand chains almost
            # as well, BOTH run DP and the better alignment wins (the
            # reference aligns both orientations and keeps the best,
            # geneorient/q_mns; 3/500 gate mismatches were strand flips
            # at loci where only the better-chained strand was aligned)
            alt = None
            if len(cands) > 1 and cands[1][0] * 10 >= 9 * score:
                alt = (cands[1][1], cands[1][0], cands[1][2])
            # chain coords are in window space; on '-' in rc-window
            # space, so a left-edge overhang is a genome-right overhang
            wlen = len(window)
            q0, q1 = chain.q_span
            c0, c1 = chain.g_span
            if st == "-":
                c0, c1 = wlen - c1, wlen - c0
                q0, q1 = len(q) - q1, len(q) - q0
            edge = max(len(q), 64)
            grow_l = (maxgene // 2
                      if (q0 > 15 and c0 < edge and g0 > 0) else 0)
            grow_r = (maxgene // 2
                      if (len(q) - q1 > 15 and wlen - c1 < edge
                          and g1 < total) else 0)
            if not (grow_l or grow_r):
                return g0, g1, st, score, chain, alt
            g0 = max(g0 - grow_l, 0)
            g1 = min(g1 + grow_r, total)
        return g0, g1, st, score, chain, alt

    # phase A: block voting -> raw candidate windows per query
    raw: list[list[tuple[int, int]]] = [[] for _ in queries]
    for qi, q in enumerate(queries):
        try:
            with stage("vote"):
                cands = [(g0, g1, sc, "+") for g0, g1, sc
                         in self.index.candidate_ranges(q, ncand)]
            if strands[qi] in ("auto", "-"):
                cands += [(g0, g1, sc, "-") for g0, g1, sc
                          in self.index.candidate_ranges(comrev(q),
                                                         ncand)]
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:
            report_skip(q_names[qi], exc, "vote")
            _mark(qi, "vote-error", repr(exc))
            continue
        if not cands:
            _mark(qi, "no-candidate")
            continue
        cands.sort(key=lambda c: -c[2])
        picked = []
        for g0, g1, score, hint in cands:
            if any(not (g1 <= p0 or g0 >= p1) for p0, p1, _ in picked):
                continue
            picked.append((g0, g1, hint))
            if len(picked) >= max_out * 3:
                break
        raw[qi] = picked

    # phase B: FindHsp verification — chain every window, widen until
    # covered, then dedup overlapping loci by chain score and apply the
    # rising crit-score floor (critjscr, blksrc.cc:2532-2534) so DP is
    # only paid for plausible loci
    work = []
    for qi, picked in enumerate(raw):
        verified = []
        for g0, g1, hint in picked:
            try:
                v = _verify_candidate(qi, g0, g1, hint=hint)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as exc:
                report_skip(q_names[qi], exc, "seed")
                _mark(qi, "seed-error", repr(exc))
                continue
            if v is None:
                _mark(qi, "no-chain", f"({g0},{g1})")
                continue
            verified.append(v)
        if not verified:
            continue
        verified.sort(key=lambda v: -v[3])
        best = verified[0][3]
        kept: list = []
        for g0, g1, st, score, chain, alt in verified:
            if any(not (g1 <= k0 or g0 >= k1) for k0, k1, *_ in kept):
                continue                      # locus dedup by chain score
            if kept and score * 2 < best:
                _mark(qi, "chain-floor", f"{score}<{best}/2")
                continue
            kept.append((g0, g1, st, score, chain, alt))
            if len(kept) >= max_out * 2:
                break
        for g0, g1, st, score, chain, alt in kept:
            work.append([qi, g0, g1, 0, st, chain])
            if alt is not None:
                work.append([qi, g0, g1, 0, alt[0], alt[2]])

    results: list[list[GeneStructure]] = [[] for _ in queries]
    for _round in range(3):
        if not work:
            break
        jobs, meta = [], []
        for qi, g0, g1, retry, st, chain in work:
            try:
                q = queries[qi]
                window = self.store.window(g0, g1)
                ci, _ = self.store.locate(g0)
                # minus genes align in transcript orientation — original
                # query vs reverse-complemented window — so the splice
                # model applies exactly (see align_cdna)
                g_use = comrev(window) if st == "-" else window
                job = prepare_job(q, g_use, self.ctx, chain,
                                  q_name=q_names[qi],
                                  g_name=self.store.names[ci], strand=st)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as exc:
                report_skip(q_names[qi], exc, "seed")
                _mark(qi, "seed-error", repr(exc))
                continue
            if job is None:
                _mark(qi, "no-job", f"({g0},{g1})")
                continue
            jobs.append(job)
            meta.append((qi, g0, g1, retry, ci, len(window)))
        if not jobs:
            break
        out = execute_jobs(jobs, self.ctx, lanes=lanes,
                           max_batch=max_batch)
        work = []
        for gs, (qi, g0, g1, retry, ci, wlen) in zip(out, meta):
            if isinstance(gs, BaseException):
                report_skip(q_names[qi], gs, "align")
                _mark(qi, "align-error", repr(gs))
                continue
            if gs is None:
                _mark(qi, "align-none", f"({g0},{g1})")
                continue
            q = queries[qi]
            qlo = min(e.q_start for e in gs.exons)
            qhi = max(e.q_end for e in gs.exons)
            glo = min(e.g_start for e in gs.exons)
            ghi = max(e.g_end for e in gs.exons)
            edge = max(len(q), 64)
            grow_l = (maxgene // 2 if (qlo > 8 and glo < edge and g0 > 0)
                      else 0)
            grow_r = (maxgene // 2
                      if (len(q) - qhi > 8 and wlen - ghi < edge
                          and g1 < total) else 0)
            if (grow_l or grow_r) and retry < 2:
                # window clipped the gene: widen and re-verify (the
                # chain must be recomputed for the new window)
                try:
                    v = _verify_candidate(qi, max(g0 - grow_l, 0),
                                          min(g1 + grow_r, total),
                                          hint=st)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as exc:
                    report_skip(q_names[qi], exc, "seed")
                    _mark(qi, "seed-error", repr(exc))
                    v = None
                if v is not None:
                    n0, n1, st2, _, ch2, _alt2 = v
                    work.append([qi, n0, n1, retry + 1, st2, ch2])
                    continue
            if gs.coverage(len(q)) < min_coverage:
                _mark(qi, "coverage-filtered",
                      f"{gs.coverage(len(q)):.2f}")
                continue
            off = g0 - int(self.store.offsets[ci])
            for e in gs.exons:
                e.g_start += off
                e.g_end += off
                e.q_start += q_offs[qi]
                e.q_end += q_offs[qi]
            for i in gs.introns:
                i.g_start += off
                i.g_end += off
            results[qi].append(gs)
    for qi in range(len(queries)):
        results[qi].sort(key=lambda g: (-g.score, g.g_name,
                                        g.exons[0].g_start))
        results[qi] = results[qi][:max_out]
    return results


GenomeMapper.map_queries = _map_queries_batched
