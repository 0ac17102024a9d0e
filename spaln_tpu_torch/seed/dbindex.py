"""Protein-DB k-mer prefilter for the -a search mode.

The reference's `spaln -a` builds a block index over the formatted aa DB
(.bka) and SrchBlk::finds (blksrc.cc:3271+) votes query k-mers into
per-entry tallies via Bhit2, so the expensive DP runs only on entries
that share significant seed content with the query.  Here the index is
a host-side CSR (word -> entry ids) over the reduced 20-letter alphabet
with -log2-frequency word scores; a query is one vectorized gather +
bincount, and the calibrated Randbs-style threshold (blksrc.h:388-390,
sqrt model for aa DBs) keeps only plausible entries for the batched
wavefront launch.

Carried over from spaln_tpu/seed/dbindex.py (pure numpy) with the same
API, so one test can drive both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..constants import AA_REDUCE20

NALPHA = 20


def _aa_words(codes: np.ndarray, k: int) -> np.ndarray:
    red = AA_REDUCE20[np.asarray(codes, dtype=np.int64)]
    valid = (red >= 0) & (red < NALPHA)
    L = len(red)
    if L < k:
        return np.zeros(0, np.int64)
    w = np.zeros(L - k + 1, dtype=np.int64)
    ok = np.ones(L - k + 1, dtype=bool)
    for i in range(k):
        w = w * NALPHA + np.clip(red[i:L - k + 1 + i], 0, NALPHA - 1)
        ok &= valid[i:L - k + 1 + i]
    return w[ok]


@dataclass
class ProteinDbIndex:
    """k-mer -> DB-entry CSR index (the .bka role for -a search)."""
    k: int
    offsets: np.ndarray          # (20^k + 1,) CSR offsets
    entries: np.ndarray          # entry ids, word-major
    wscr: np.ndarray             # (20^k,) int16 word scores
    n_entries: int

    @classmethod
    def build(cls, db: list, k: int | None = None,
              max_word_frac: float = 0.02) -> "ProteinDbIndex":
        """db: list of (name, codes).  k auto-sized as the reference's
        aa rule 0.30*ln(dbsize) capped [3, 5] (blksrc.cc:678-737)."""
        total = sum(len(c) for _, c in db)
        if k is None:
            k = int(np.clip(0.30 * math.log(max(total, 2)), 3, 5))
        nw = NALPHA ** k
        # pass 1: count (word, entry) pairs after per-entry dedup
        pairs = []
        for ei, (_, codes) in enumerate(db):
            w = np.unique(_aa_words(codes, k))
            pairs.append((w, np.full(len(w), ei, dtype=np.int64)))
        words = np.concatenate([p[0] for p in pairs]) if pairs else \
            np.zeros(0, np.int64)
        ents = np.concatenate([p[1] for p in pairs]) if pairs else \
            np.zeros(0, np.int64)
        order = np.argsort(words, kind="stable")
        words, ents = words[order], ents[order]
        counts = np.bincount(words, minlength=nw)
        offsets = np.zeros(nw + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        # word scores: -log2 of occurrence frequency, repetitive words 0
        freq = np.maximum(counts / max(len(words), 1), 1e-12)
        wscr = np.minimum(-np.log2(freq) * 4, 120).astype(np.int16)
        wscr[counts > max_word_frac * max(len(db), 1) * 50] = 0
        wscr[counts == 0] = 0
        return cls(k=k, offsets=offsets, entries=ents, wscr=wscr,
                   n_entries=len(db))

    # Randbs sqrt model for aa DBs (RbsFactSqr=0.606, RbsBase=3,
    # blksrc.cc:62-68, 2047-2069)
    RBS_FACT = 0.606
    RBS_BASE = 3.0

    @property
    def avr_wscr(self) -> float:
        pos = self.wscr[self.wscr > 0]
        return float(pos.mean()) if len(pos) else 1.0

    def candidates(self, query: np.ndarray, max_cand: int = 200,
                   min_hits: int = 10) -> np.ndarray:
        """Entry ids worth aligning, best vote first.

        Entries must clear randbs(sqrt(nwords)); if fewer than min_hits
        do, the top min_hits by vote are kept anyway (TestOutput force
        semantics) so recall never drops below the no-index behavior
        for the reported hits.
        """
        w = np.unique(_aa_words(query, self.k))
        if not len(w):
            return np.arange(min(self.n_entries, max_cand))
        lo, hi = self.offsets[w], self.offsets[w + 1]
        cnt = hi - lo
        has = cnt > 0
        if not has.any():
            return np.arange(min(self.n_entries, max_cand))
        idx = np.concatenate([np.arange(l, h)
                              for l, h in zip(lo[has], hi[has])])
        ent = self.entries[idx]
        ws = np.repeat(self.wscr[w[has]].astype(np.int64), cnt[has])
        votes = np.bincount(ent, weights=ws, minlength=self.n_entries)
        thr = (self.RBS_FACT * math.sqrt(len(w))
               + self.RBS_BASE) * self.avr_wscr
        good = np.nonzero(votes >= thr)[0]
        if len(good) < min_hits:
            order = np.argsort(votes)[::-1]
            good = order[:min(min_hits, self.n_entries)]
            good = good[votes[good] > 0] if (votes[good] > 0).any() \
                else good
        good = good[np.argsort(votes[good])[::-1]]
        return good[:max_cand]
