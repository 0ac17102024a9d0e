"""Per-base splice-signal arrays over a genomic window.

Reproduces Exinon (codepot.cc:357-560): for every position n of a genomic
segment, donor/acceptor eligibility and signal strengths that the spliced DP
consults in O(1):

  dinc5[n] = dinucleotide (b[n], b[n+1])   -- intron's first two bases if a
             donor cuts at n (intron occupies [n5, n3) in 0-based coords)
  dinc3[n] = dinucleotide (b[n-2], b[n-1]) -- intron's last two bases if an
             acceptor resumes the exon at n
  cano5/cano3: canonicity level (GT>GC>AT donors, AG>AC acceptors, with
             -ya relaxations; codepot.cc:437-477)
  sig5[n] = fS*sss*PSSM5(n) + tab5[dinc5[n]]      (x10 fixed point)
  sig3[n] = fS*sss*PSSM3(n) + tab3[dinc3[n]]
  phs5/phs3: splice phase markers for the tron engine (0 site, +-1
             phase-shifted neighbors, 2 overlap like GTGT)

Composite junction score (codepot.cc:401-435):
  sig53(n5, n3) = sig3[n3] - tab3[dinc3[n3]] + tab53[16*dinc5[n5]+dinc3[n3]]

The arrays ship to device as the DP kernels' per-position signal operands;
the 16x16 joint table is pre-expanded per acceptor position into
``acc_joint[n, dinc5]`` so the kernel's acceptor close is a 16-way select.
"""
from __future__ import annotations

import typing
from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..constants import NT_REDUCE4, TRON_REDUCE4
from .pssm import PSSM, load_pssm_stack, scan_pssm, load_pssm
from .tables import TableDir

# dinucleotide codes 4*b0+b1 with A,C,G,T = 0..3
AA_, AC_, AG_, AT_ = 0, 1, 2, 3
CG_, CT_, GA_, GC_, GG_, GT_ = 6, 7, 8, 9, 10, 11
TG_, TT_ = 14, 15

_JLEVEL_AC = (0, 2, 3, 1)      # codepot.cc:439 jlevelac[algmode.any]
_JLEVEL_GT = (0, 0, 3, 1)      # jlevelgt


def _c_short(x: np.ndarray) -> np.ndarray:
    """(STYPE) cast: truncation toward zero."""
    return np.trunc(x).astype(np.int32)


import functools


@functools.lru_cache(maxsize=16)
def _cached_pssm(path: str):
    return load_pssm(path)


@functools.lru_cache(maxsize=8)
def _cached_exinpot(path: str):
    from .codepot import ExinPot
    return ExinPot.load_path(path) if path else None


@dataclass
class Sig53Tables:
    """Scaled dinucleotide signal tables from table/Intron53
    (Sig53 ctor, codepot.cc:283-327)."""
    tab5: np.ndarray      # (16,)  donor dinucleotide log-odds
    tab3: np.ndarray      # (16,)  acceptor
    tab53: np.ndarray     # (256,) joint donor x acceptor
    tab35: np.ndarray     # (256,) joint acceptor..donor (IE35 order)

    _cache: typing.ClassVar[dict] = {}

    @classmethod
    def load(cls, tables: TableDir, fs: float) -> "Sig53Tables":
        path = tables.path("Intron53")
        key = (path, fs)
        hit = cls._cache.get(key)          # per-window rebuilds re-read
        if hit is not None:                # the same table file otherwise
            return hit
        mats = load_pssm_stack(path, 4)
        t5 = _c_short(fs * mats[0].mtx.ravel()[:16])
        t3 = _c_short(fs * mats[1].mtx.ravel()[:16])
        t53 = _c_short(fs * mats[2].mtx.ravel()[:256])
        t35 = _c_short(fs * mats[3].mtx.ravel()[:256])
        out = cls(t5, t3, t53, t35)
        cls._cache[key] = out
        return out


@dataclass
class SpliceSignals:
    sig5: np.ndarray          # int32 (L,)
    sig3: np.ndarray
    cano5: np.ndarray         # uint8 canonicity level (0 = not a donor)
    cano3: np.ndarray
    phs5: np.ndarray          # int8 phase marker (-2 = not a site)
    phs3: np.ndarray
    dinc5: np.ndarray         # uint8 dinucleotide codes
    dinc3: np.ndarray
    tabs: Sig53Tables
    acc_joint: np.ndarray     # int32 (L, 16): tab53[16*d5 + dinc3[n]]

    def sig53_ie53(self, n5, n3):
        """Composite donor->acceptor junction signal (vectorized)."""
        n5 = np.asarray(n5, dtype=np.int64)
        n3 = np.asarray(n3, dtype=np.int64)
        return (self.sig3[n3]
                - self.tabs.tab3[self.dinc3[n3]]
                + self.tabs.tab53[16 * self.dinc5[n5].astype(np.int64)
                                  + self.dinc3[n3]])

    @property
    def is_donor(self) -> np.ndarray:
        return self.cano5 > 0

    @property
    def is_accpt(self) -> np.ndarray:
        return self.cano3 > 0


def build_splice_signals(codes: np.ndarray, cfg: Config, tables: TableDir,
                         tron: bool = False, both_ori: bool = False,
                         fact: float | None = None) -> SpliceSignals:
    """Exinon construction for a genomic window (intron53_c + intron53_n)."""
    a2 = cfg.aln2
    scale = cfg.aln.scale
    if fact is None:
        fact = float(scale)
    fS = a2.y * fact
    fs_univ = fS * (1. - a2.sss)          # universal dinucleotide part
    fs_spec = fS * a2.sss                 # species PSSM part

    red = (TRON_REDUCE4 if tron else NT_REDUCE4)[
        np.asarray(codes, dtype=np.int64)].astype(np.int64)
    red = np.where(red >= 4, 1, red)       # ambiguous -> 'C' (codepot.cc:448)
    L = len(red)

    # dinc5[n] = (b[n], b[n+1]); dinc3[n] = (b[n-2], b[n-1]); C-padded
    b_prev = np.concatenate([[1], red[:-1]])
    b_next = np.concatenate([red[1:], [1]])
    b_prev2 = np.concatenate([[1, 1], red[:-2]])
    dinc5 = (4 * red + b_next).astype(np.uint8)
    dinc3 = (4 * b_prev2 + b_prev).astype(np.uint8)

    any_lvl = cfg.alg.any
    jac, jgt = _JLEVEL_AC[any_lvl], _JLEVEL_GT[any_lvl]
    base = 1 if any_lvl == 3 else 0
    cano5_map = np.full(16, base, dtype=np.uint8)
    cano3_map = np.full(16, base, dtype=np.uint8)
    cano3_map[AA_] = jac
    cano3_map[AC_] = 2
    cano3_map[AG_] = 3
    cano5_map[AT_] = 2
    cano3_map[AT_] = jac
    cano3_map[CG_] = jgt
    cano5_map[CT_] = jgt
    cano5_map[GA_] = jgt
    cano5_map[GC_] = 3
    cano5_map[GG_] = jgt
    cano3_map[GG_] = jgt
    cano5_map[GT_] = 3
    cano3_map[TG_] = jgt
    cano5_map[TT_] = jgt
    if both_ori:
        cano5_map[AC_] = max(cano5_map[AC_], 1)
        cano3_map[CT_] = max(cano3_map[CT_], 1)
        cano3_map[GT_] = max(cano3_map[GT_], 1)
    cano5 = cano5_map[dinc5]
    cano3 = cano3_map[dinc3]

    tabs = Sig53Tables.load(tables, fs_univ)

    # species PSSM component
    p5 = p3 = None
    if a2.y > 0:
        f5, f3 = tables.path("Splice5"), tables.path("Splice3")
        if f5:
            p5 = _cached_pssm(f5)
        if f3:
            p3 = _cached_pssm(f3)
    pssm5 = (fs_spec * scan_pssm(p5, codes, tron=tron, zero_tonic=True)
             if p5 else np.zeros(L))
    pssm3 = (fs_spec * scan_pssm(p3, codes, tron=tron, zero_tonic=True)
             if p3 else np.zeros(L))
    sig5 = _c_short(pssm5) + tabs.tab5[dinc5]
    sig3 = _c_short(pssm3) + tabs.tab3[dinc3]

    # phase markers (intron53_n, codepot.cc:497-523)
    phs5 = np.full(L, -2, dtype=np.int8)
    phs3 = np.full(L, -2, dtype=np.int8)
    th5 = int(fS * (p5.tonic if p5 else 0.))
    th3 = int(fS * (p3.tonic if p3 else 0.))
    elig5 = (cano5 > 0) | ((any_lvl == 2) & (sig5 > th5))
    elig3 = (cano3 > 0) | ((any_lvl == 2) & (sig3 > th3))
    phs5[elig5] = 0
    phs3[elig3] = 0
    strong5 = cano5 > 1
    strong3 = cano3 > 1
    # wkb[1].phs5 = 1; wkb[-1].phs5 = (was 1 ? 2 : -1)
    for phs, strong in ((phs5, strong5), (phs3, strong3)):
        nxt = np.roll(strong, 1)           # position p has strong at p-1
        prv = np.roll(strong, -1)          # position p has strong at p+1
        nxt[0] = prv[-1] = False
        phs[nxt & (phs == -2)] = 1
        overlap = prv & (phs == 1)
        phs[prv & ~overlap & (phs != 0)] = -1
        phs[overlap] = 2
        # sites that are both a 0-phase site and neighbor of a strong one
        # keep phase 0 (reference writes only into phs == -2 slots for +1)

    # -yZ intron oligomer potential (sig53's intnpot term, codepot.cc:
    # 401-435 with ExinPot::intpot = sigI[b3-rm] - sigI[b5+lm],
    # utilseq.cc:1463-1470).  The cumulative-difference form splits by
    # endpoint, so it folds into the per-base signals: the donor side
    # carries -C[n5+lm], the acceptor side +C[n3-rm] — every junction
    # consumer (kernels, oracle, closed-form joins) then applies the
    # exact reference term with no per-pair gather.  Known deviation:
    # introns shorter than lm+rm (22 nt) score the (tiny) negative-span
    # difference instead of the reference's hard 0.
    if a2.Z and a2.Z > 0 and not tron:
        ipt = _cached_exinpot(tables.path("IntronPotTab") or "")
        if ipt is not None:
            fI = a2.Z * fact
            cum = np.zeros(L + 1, dtype=np.float64)
            np.cumsum(ipt.scan(codes).astype(np.float64), out=cum[1:])
            C = _c_short(fI * cum)
            sig5 = sig5 - C[np.clip(np.arange(L) + ipt.lm, 0, L)]
            sig3 = sig3 + C[np.clip(np.arange(L) - ipt.rm, 0, L)]

    acc_joint = tabs.tab53.reshape(16, 16)[:, dinc3].T.copy()   # (L, 16)
    return SpliceSignals(sig5=sig5.astype(np.int32),
                         sig3=sig3.astype(np.int32),
                         cano5=cano5, cano3=cano3, phs5=phs5, phs3=phs3,
                         dinc5=dinc5, dinc3=dinc3, tabs=tabs,
                         acc_joint=acc_joint.astype(np.int32))
