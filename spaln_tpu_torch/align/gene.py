"""Traceback ops -> gene structure (exon/intron records).

The role of skl_rngS_ng + Eijnc/EISCR (fwd2s1.cc:446-700, gsinfo.h:262-283):
walk the alignment path, emit per-exon statistics (match/mismatch/gap/unpaired
counts, junction-neighborhood quality windows), intron records with donor/
acceptor signals, and CIGAR/VULGAR strings.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..score.splice import SpliceSignals


@dataclass
class Exon:
    q_start: int          # 0-based inclusive, query
    q_end: int            # exclusive
    g_start: int          # 0-based inclusive, genome (window coords)
    g_end: int            # exclusive
    mch: int = 0
    mmc: int = 0
    gap: int = 0          # gap opens
    unp: int = 0          # unpaired residues
    sig5: int = 0         # donor signal at the exon's 3' end (next intron)
    sig3: int = 0         # acceptor signal at the exon's 5' start
    bmmc: int = 0         # mismatches within jneibr of intron boundaries
    bunp: int = 0         # unpaired within jneibr of intron boundaries

    @property
    def identity(self) -> float:
        aln = self.mch + self.mmc
        return self.mch / aln if aln else 0.0

    @property
    def q_len(self) -> int:
        return self.q_end - self.q_start

    @property
    def g_len(self) -> int:
        return self.g_end - self.g_start


@dataclass
class Intron:
    g_start: int          # first intron base (donor), 0-based
    g_end: int            # first exon base after (acceptor boundary)
    q_pos: int            # query position of the junction
    sig5: int = 0
    sig3: int = 0
    canonical: bool = True

    @property
    def length(self) -> int:
        return self.g_end - self.g_start


@dataclass
class AlnView:
    """Immutable sequence-level snapshot taken at build time, in the
    aligned orientation and window-local coordinates — lets the
    sequence-bearing output forms (alignment text, cDNA/translation
    recovery) render after the caller shifts/flips genomic coords."""
    q: np.ndarray                     # query codes as aligned
    g: np.ndarray                     # genomic window codes as aligned
    exons: list[tuple]                # (q0, q1, g0, g1) local coords
    introns: list[tuple]              # (g5, g3) local coords
    q_is_aa: bool = False
    g_is_aa: bool = False             # protein x protein (AvsA)
    ops: list | None = None           # raw traceback op stream


@dataclass
class GeneStructure:
    score: int
    exons: list[Exon]
    introns: list[Intron]
    q_name: str = ""
    g_name: str = ""
    strand: str = "+"
    scale: int = 10
    view: AlnView | None = None

    @property
    def q_span(self) -> tuple[int, int]:
        return (self.exons[0].q_start, self.exons[-1].q_end)

    @property
    def g_span(self) -> tuple[int, int]:
        return (self.exons[0].g_start, self.exons[-1].g_end)

    @property
    def n_matches(self) -> int:
        return sum(e.mch for e in self.exons)

    @property
    def identity(self) -> float:
        aln = sum(e.mch + e.mmc for e in self.exons)
        return self.n_matches / aln if aln else 0.0

    @property
    def coverage_of(self) -> float:
        return 0.0

    def coverage(self, q_len: int) -> float:
        return sum(e.q_len for e in self.exons) / q_len if q_len else 0.0

    def cigar(self) -> str:
        """Spliced CIGAR (M/I/D/N ops, SAM semantics: I = query insertion,
        D = genome deletion, N = intron)."""
        out = []

        def emit(op, k):
            if k:
                out.append(f"{k}{op}")
        prev_e = None
        for i, e in enumerate(self.exons):
            if prev_e is not None:
                emit('N', e.g_start - prev_e.g_end)
                if e.q_start > prev_e.q_end:
                    emit('I', e.q_start - prev_e.q_end)
            emit('M', min(e.q_len, e.g_len))
            d = e.g_len - e.q_len
            if d > 0:
                emit('D', d)
            elif d < 0:
                emit('I', -d)
            prev_e = e
        return "".join(out)

    def vulgar(self) -> str:
        """Exonerate-style VULGAR-ish op string (M / G / 5 I 3)."""
        toks = []
        prev_e = None
        for e in self.exons:
            if prev_e is not None:
                ilen = e.g_start - prev_e.g_end
                toks += ["5", "0", "2", "I", "0", str(ilen - 4),
                         "3", "0", "2"]
            toks += ["M", str(e.q_len), str(e.g_len)]
            prev_e = e
        return " ".join(toks)


def trim_terminal_microexons(exons: list[Exon], introns: list[Intron],
                             min_q: int, max_loose: int = 0) -> None:
    """Drop unreliable terminal micro-exons (in place).

    The reference accepts micro end exons only as exact Boyer-Moore
    matches with valid splice sites (micro_exon, fwd2s1.cc:2163-2273);
    free-end DP can instead pick up spurious signal-boosted fragments.
    A terminal exon shorter than ``min_q`` query units (or imperfect and
    shorter than ``max_loose``) is removed together with its intron.
    """
    def bad(e: Exon) -> bool:
        if e.q_len < min_q:
            return True
        return e.q_len < max_loose and (e.mmc + e.unp) > 0

    while len(exons) > 1 and bad(exons[0]):
        exons.pop(0)
        introns.pop(0)
    while len(exons) > 1 and bad(exons[-1]):
        exons.pop()
        introns.pop()


def reclassify_introns(ops: list, sig: SpliceSignals, prm) -> list:
    """Intron-vs-gap re-decision at reporting (skl_rngS_ng,
    fwd2s1.cc:497-534): each horizontal run the DP spliced is re-judged
    as  iscr + GapPenalty(insert - intlen)  vs  GapPenalty(insert);
    when the ordinary-gap path wins the intron is demoted to genome
    insertions, merging the flanking exons.

    iscr = sig5[n5] + IntronPenalty(len) + sig53(n5, n3) — the same
    junction composition the DP's acceptor close applied
    (spjscr, codepot.cc:74-77)."""
    n_ops = len(ops)
    out = list(ops)
    i = 0
    while i < n_ops:
        if out[i][0] not in ('E', 'I'):
            i += 1
            continue
        j = i
        insert = 0
        intr = []
        while j < n_ops and out[j][0] in ('E', 'I'):
            if out[j][0] == 'E':
                insert += 1                   # cDNA E ops are 1 nt each
            else:
                intr.append(j)
                insert += out[j][3] - out[j][2]
            j += 1
        interior = (i > 0 and j < n_ops)
        if interior and len(intr) == 1:
            _, m, n5, n3 = out[intr[0]]
            intlen = n3 - n5
            iscr = (int(sig.sig5[n5])
                    + int(prm.intron_table(intlen + 2)[intlen])
                    + int(sig.sig53_ie53(n5, n3)))
            x = prm.gap_penalty(insert)
            xi = iscr + prm.gap_penalty(insert - intlen)
            if xi < x:
                out[intr[0]:intr[0] + 1] = [('E', m, n)
                                            for n in range(n5 + 1, n3 + 1)]
                n_ops = len(out)
                j = i
                continue                      # re-scan the merged run
        i = j
    return out


def build_gene_structure(ops: list, a: np.ndarray, b: np.ndarray,
                         score: int, sig: SpliceSignals | None = None,
                         q_name: str = "", g_name: str = "",
                         strand: str = "+",
                         aa_pair: bool = False,
                         prm=None) -> GeneStructure | None:
    """Convert a traceback op stream (from traceback_spliced_*) into exon /
    intron records with per-exon stats.

    Op coords are 1-based DP cells; exon genome coords come out 0-based
    half-open.
    """
    if not ops:
        return None
    if sig is not None and prm is not None:
        ops = reclassify_introns(ops, sig, prm)
    exons: list[Exon] = []
    introns: list[Intron] = []
    cur: Exon | None = None
    last_gap_state = None
    last_d = None                 # (m, n) of the newest match op
    pend_gap = pend_unp = 0       # gap ops awaiting a bracketing match
    for op in ops:
        kind = op[0]
        if kind == 'D':
            _, m, n = op
            last_d = (m, n)
            if cur is None:
                cur = Exon(q_start=m - 1, q_end=m, g_start=n - 1, g_end=n)
            else:
                cur.q_end, cur.g_end = m, n
            if a[m - 1] == b[n - 1]:
                cur.mch += 1
            else:
                cur.mmc += 1
            # flush gap ops bracketed by matches (terminal runs drop)
            cur.gap += pend_gap
            cur.unp += pend_unp
            pend_gap = pend_unp = 0
            last_gap_state = None
        elif kind == 'E':
            _, m, n = op
            if cur is not None:
                cur.g_end = n
                pend_unp += 1
                if last_gap_state != 'E':
                    pend_gap += 1
                last_gap_state = 'E'
        elif kind == 'F':
            _, m, n = op
            if cur is not None:
                cur.q_end = m
                pend_unp += 1
                if last_gap_state != 'F':
                    pend_gap += 1
                last_gap_state = 'F'
        elif kind == 'I':
            _, m, n5, n3 = op
            pend_gap = pend_unp = 0
            if cur is not None:
                s5 = int(sig.sig5[n5]) if sig is not None else 0
                s3 = int(sig.sig3[n3]) if sig is not None and n3 < len(
                    sig.sig3) else 0
                cur.sig5 = s5
                exons.append(cur)
                dinc5 = int(sig.dinc5[n5]) if sig is not None else 11
                dinc3 = int(sig.dinc3[n3]) if sig is not None else 2
                introns.append(Intron(g_start=n5, g_end=n3, q_pos=m,
                                      sig5=s5, sig3=s3,
                                      canonical=(dinc5 == 11 and dinc3 == 2)))
                cur = None
                last_gap_state = None
    if cur is not None:
        # crop a trailing free-end gap run (not part of the exon)
        if last_d is not None and last_d[0] >= cur.q_start + 1:
            cur.q_end = min(cur.q_end, last_d[0])
            cur.g_end = min(cur.g_end, last_d[1])
            exons.append(cur)
    if not exons:
        return None
    trim_terminal_microexons(exons, introns, min_q=12, max_loose=20)
    # attach acceptor signals to downstream exons
    for i, intr in enumerate(introns):
        if i + 1 < len(exons):
            exons[i + 1].sig3 = intr.sig3
    # junction-neighborhood quality windows (Eijnc, gsinfo.h:262-283;
    # window = alprm2.jneibr = 10 query residues around each junction):
    # per exon, mismatches/unpaired within the window on each
    # intron-adjacent side feed the sortgrcd -m/-u filters (Bmmc/Bunp)
    JNB = 10
    if introns:
        wins = []                 # (lo, hi] query windows -> exon index
        for i, intr in enumerate(introns):
            qp = exons[i].q_end
            wins.append((qp - JNB, qp, i))          # upstream side
            wins.append((qp, qp + JNB, i + 1))      # downstream side
        for op in ops:
            kind = op[0]
            if kind == 'I':
                continue
            m = op[1]
            bad = (kind in ('E', 'F')
                   or (kind == 'D' and a[m - 1] != b[op[2] - 1]))
            if not bad:
                continue
            for lo, hi, ei in wins:
                if lo < m <= hi and ei < len(exons):
                    if kind == 'D':
                        exons[ei].bmmc += 1
                    else:
                        exons[ei].bunp += 1
    view = AlnView(q=np.asarray(a), g=np.asarray(b),
                   exons=[(e.q_start, e.q_end, e.g_start, e.g_end)
                          for e in exons],
                   introns=[(i.g_start, i.g_end) for i in introns],
                   q_is_aa=aa_pair, g_is_aa=aa_pair, ops=ops)
    return GeneStructure(score=score, exons=exons, introns=introns,
                         q_name=q_name, g_name=g_name, strand=strand,
                         view=view)
