"""Coding-potential and translated-genome (tron) signal arrays.

The protein x genome engine consumes, per genomic position, everything
Exinon::intron53_p builds (codepot.cc:529-618):
  sigE  per-codon coding potential (5th-order Markov CodePotTab,
        ExinPot::calcScr_3 utilseq.cc:1423-1461) with premature-stop folds
  sigS  translation-initiation signal (TransInit PSSM)
  sigT  termination signal (TransTerm PSSM)
  sig5/sig3/phs5/phs3 as in the nt case
plus the 256-entry junction-codon tron tables (spj_tron_tab role,
codepot.h:130-186) used to re-score phase +-1 splices.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..constants import (GENCODE, NT_REDUCE4, SER, SER2, TRM, TRM2, G, AMB)
from .pssm import load_pssm, scan_pssm
from .splice import (SpliceSignals, Sig53Tables, build_splice_signals,
                     _c_short)
from .tables import TableDir


@dataclass
class CodePotTab:
    """5th-order Markov phase-specific coding potentials (CodePotTab)."""
    data: np.ndarray          # (ndata, 3) float32
    ndata: int
    morder: int

    @classmethod
    def load(cls, tables: TableDir) -> "CodePotTab | None":
        p = tables.path("CodePotTab")
        if p is None:
            return None
        with open(p) as fh:
            hdr = fh.readline().split()
            ndata = int(hdr[2])
            vals = []
            for line in fh:
                toks = line.split()
                if not toks:
                    continue
                if toks and not _isnum(toks[0]):
                    toks = toks[1:]
                vals.extend(float(x) for x in toks[:3])
        data = np.asarray(vals, dtype=np.float32).reshape(ndata, 3)
        morder = int(np.log2(ndata) / 2) - 1
        return cls(data=data, ndata=ndata, morder=morder)

    def scan(self, codes: np.ndarray,
             classes: np.ndarray | None = None) -> np.ndarray:
        """Per-position coding potential (calcScr_3): at position p,
        t2(p+2) + t0(p+3) + t1(p+4) where tk(x) = pot[w6(x), k] and w6(x)
        is the (morder+1)-mer ending at x (0 when any base ambiguous).

        classes: pre-reduced 2-bit word stream (4 = invalid) replacing
        the nucleotide reduction — the reference scans a TRON-converted
        target through tnredctab (calcScr_3 redctab pick,
        utilseq.cc:1425), so the protein path's words are reduced-tron
        classes, not bases."""
        red = (np.asarray(classes, dtype=np.int64) if classes is not None
               else NT_REDUCE4[np.asarray(codes, dtype=np.int64)])
        L = len(red)
        kk = self.morder + 1
        valid = red < 4
        redc = np.where(valid, red, 0).astype(np.int64)
        # rolling windows: w6 ending at x uses bases x-kk+1..x
        if L < kk:
            return np.zeros(L, dtype=np.float32)
        wv = np.zeros(L - kk + 1, dtype=np.int64)
        okv = np.ones(L - kk + 1, dtype=bool)
        for i in range(kk):
            wv = wv * 4 + redc[i:L - kk + 1 + i]
            okv &= valid[i:L - kk + 1 + i]
        t = np.zeros((L, 3), dtype=np.float32)
        pos = np.arange(kk - 1, L)
        t[pos[okv]] = self.data[wv[okv] % self.ndata]
        out = np.zeros(L, dtype=np.float32)
        # out[p] = t[p+3,2] + t[p+4,0] + t[p+5,1] — calibrated against
        # an instrumented reference binary (element-exact on a 3 kb
        # window; the earlier p+2/p+3/p+4 mapping was one position off,
        # which parked the stop-word penalties NEXT to in-frame stops
        # where the fold rules never cancel them)
        out[:L - 3] += t[3:, 2]
        out[:L - 4] += t[4:, 0]
        out[:L - 5] += t[5:, 1]
        return out


def _isnum(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def spj_tron_tables() -> tuple[np.ndarray, np.ndarray]:
    """256-entry junction-codon translations (spj_tron_tab role).

    Index w = 16*exon5_dinc + exon3_dinc where exon5_dinc = (b[n5-2],
    b[n5-1]) (the donor-side exon tail = dinc3[n5]) and exon3_dinc =
    (b[n3], b[n3+1]) (acceptor-side exon head = dinc5[n3]).  Entry k:
      tron1[w] = tron(c1 c2 c3)  -- phase +1 junction codon
      tron2[w] = tron(c2 c3 c4)  -- phase -1 junction codon
    with AGY-serine/TGA adjustments (nuc2tron3 semantics)."""
    tron1 = np.zeros(256, dtype=np.int8)
    tron2 = np.zeros(256, dtype=np.int8)

    def tr(c1, c2, c3):
        aa = GENCODE[16 * c1 + 4 * c2 + c3]
        if aa == SER and c2 == 2:     # middle G -> AGY serine
            aa = SER2
        if aa == TRM and c2 == 2:
            aa = TRM2
        return aa

    for w in range(256):
        c1 = (w >> 6) & 3
        c2 = (w >> 4) & 3
        c3 = (w >> 2) & 3
        c4 = w & 3
        tron1[w] = tr(c1, c2, c3)
        tron2[w] = tr(c2, c3, c4)
    return tron1, tron2


@dataclass
class TronSignals(SpliceSignals):
    """SpliceSignals + protein-path extras."""
    sigE: np.ndarray = None       # int32 coding potential per position
    sigS: np.ndarray = None       # translation start
    sigT: np.ndarray = None       # termination
    btron: np.ndarray = None      # tron codes of the window
    spj_tron1: np.ndarray = None
    spj_tron2: np.ndarray = None


def build_tron_signals(codes: np.ndarray, cfg: Config, tables: TableDir,
                       fact: float | None = None) -> TronSignals:
    """Exinon::intron53_p for a genomic window given as nt codes."""
    from ..seq.codec import nuc2tron
    a2 = cfg.aln2
    scale = cfg.aln.scale
    if fact is None:
        fact = float(scale)
    base = build_splice_signals(codes, cfg, tables)
    L = len(codes)
    btron = nuc2tron(codes)

    fE = (a2.z or 0.) * fact
    fT = a2.bti * fact
    fO = -a2.o * fact
    sigE = np.zeros(L, dtype=np.float64)
    cpt = CodePotTab.load(tables)
    if cpt is not None and fE > 0:
        # the reference scans the TRON-converted target: the coding-
        # potential words are tnredctab[tron] classes, not bases
        # (calcScr_3 redctab pick, utilseq.cc:1425; codepot.cc:544)
        from ..constants import TRON_REDUCE4
        cls = TRON_REDUCE4[np.clip(btron.astype(np.int64), 0,
                                   len(TRON_REDUCE4) - 1)]
        sigE = fE * cpt.scan(codes, classes=cls).astype(np.float64)
    # premature stops fold into sigE (codepot.cc:577-580)
    is_stop = (btron == TRM) | (btron == TRM2)
    sigE = np.where(is_stop, sigE + fO, sigE)
    next_stop = np.zeros(L, dtype=bool)
    next_stop[:L - 3] = is_stop[3:]
    sigE = np.where(~is_stop & next_stop, 0., sigE)

    sigS = np.zeros(L, dtype=np.int32)
    sigT = np.zeros(L, dtype=np.int32)
    if a2.bti > 0:
        fi, ft = tables.path("TransInit"), tables.path("TransTerm")
        if fi:
            ps = load_pssm(fi)
            sigS = _c_short(fT * scan_pssm(ps, codes))
        if ft:
            pt = load_pssm(ft)
            sigT = _c_short(fT * scan_pssm(pt, codes))
    # branch-point bonus (Exinon::intron53_p, codepot.cc:588-597): a
    # Branch-PSSM hit above tonicB carries fB*signal forward, added to
    # sig3 of positions strictly after it while the distance from the
    # hit stays <= bp_maxb3d; a newer hit replaces an older one
    sig3 = base.sig3
    bpf = getattr(a2, "bp_factor", 0.)
    if bpf and bpf > 0:
        fbp = tables.path("Branch")
        if fbp:
            pb = load_pssm(fbp)
            brs = scan_pssm(pb, codes).astype(np.float64)
            fB = bpf * fact
            strong = brs > pb.tonic
            pos = np.arange(L)
            marked = np.where(strong, pos, -1)
            last = np.maximum.accumulate(marked)
            prev = np.full(L, -1, dtype=np.int64)
            prev[1:] = last[:-1]                 # latest hit strictly before
            ok = (prev >= 0) & ((pos - 1 - prev)
                                <= getattr(a2, "bp_maxb3d", 100))
            bonus = np.where(ok, fB * brs[np.clip(prev, 0, L - 1)], 0.)
            sig3 = (sig3.astype(np.int64)
                    + _c_short(bonus).astype(np.int64)).astype(sig3.dtype)
    t1, t2 = spj_tron_tables()
    return TronSignals(sig5=base.sig5, sig3=sig3, cano5=base.cano5,
                       cano3=base.cano3, phs5=base.phs5, phs3=base.phs3,
                       dinc5=base.dinc5, dinc3=base.dinc3, tabs=base.tabs,
                       acc_joint=base.acc_joint,
                       sigE=_c_short(sigE), sigS=sigS, sigT=sigT,
                       btron=btron, spj_tron1=t1, spj_tron2=t2)


@dataclass
class ExinPot:
    """Single-phase oligomer potential (IntronPotTab / ExonPotTab):
    pot[w] = log10(p_fg(w)/p_bg(w)) for (morder+1)-mers; intpot() sums
    the interior of an intron with immune margins (ExinPot::intpot,
    utilseq.h:90-167; itn_lm/itn_rm utilseq.h:31-32)."""
    data: np.ndarray              # (4^(morder+1),) float32
    morder: int
    lm: int = 6
    rm: int = 16

    @classmethod
    def load(cls, tables: TableDir, fname: str = "IntronPotTab"
             ) -> "ExinPot | None":
        return cls.load_path(tables.path(fname))

    @classmethod
    def load_path(cls, p: str | None) -> "ExinPot | None":
        if not p:
            return None
        with open(p) as fh:
            hdr = fh.readline().split()
            ndata = int(hdr[2])
            lm = int(hdr[7]) if len(hdr) > 7 else 6
            rm = int(hdr[8]) if len(hdr) > 8 else 16
            vals = []
            for line in fh:
                toks = line.split()
                if toks and _isnum(toks[0]):
                    vals.append(float(toks[0]))
        data = np.asarray(vals[:ndata], dtype=np.float32)
        morder = int(round(np.log2(max(len(data), 4)) / 2)) - 1
        return cls(data=data, morder=morder, lm=lm, rm=rm)

    def scan(self, codes: np.ndarray) -> np.ndarray:
        """Per-position potential of the k-mer ending at each position."""
        red = NT_REDUCE4[np.asarray(codes, dtype=np.int64)]
        L = len(red)
        kk = self.morder + 1
        out = np.zeros(L, dtype=np.float32)
        if L < kk:
            return out
        valid = red < 4
        redc = np.where(valid, red, 0).astype(np.int64)
        wv = np.zeros(L - kk + 1, dtype=np.int64)
        okv = np.ones(L - kk + 1, dtype=bool)
        for i in range(kk):
            wv = wv * 4 + redc[i:L - kk + 1 + i]
            okv &= valid[i:L - kk + 1 + i]
        pos = np.arange(kk - 1, L)
        out[pos[okv]] = self.data[wv[okv] % len(self.data)]
        return out

    def intpot(self, scan: np.ndarray, b5: int, b3: int) -> float:
        """Sum of potentials over the intron interior [b5+lm, b3-rm)."""
        lo, hi = b5 + self.lm, b3 - self.rm
        if hi <= lo:
            return 0.0
        return float(scan[lo:hi].sum())
