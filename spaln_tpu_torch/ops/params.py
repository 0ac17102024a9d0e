"""Parameter bundle consumed by the DP engines.

The role of PwdB (aln.h:235-308, ctor aln2.cc:99-137): everything a DP
kernel needs, pre-resolved to x10 fixed-point int32 — substitution table,
affine gap costs, splice-signal arrays, intron-penalty table.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import Config, resolve, CvsG
from ..score.intron import IntronPenalty
from ..score.simmtx import Simmtx
from ..score.splice import SpliceSignals

NEVSEL = -(2**31 // 16 * 7)      # cmn.h:79 (int build)

@dataclass
class DpFlags:
    """End-gap openness (INEX exgl/exgr semantics, seq.h:148-172).

    a_exgl/a_exgr: free genome prefix/suffix (query ends not anchored to
    genome start/end); b_exgl/b_exgr: free query prefix/suffix.  Default
    algmode.lcl = 15 -> all four free (semi-global gene search)."""
    a_exgl: bool = True
    a_exgr: bool = True
    b_exgl: bool = True
    b_exgr: bool = True
    local: bool = False          # SWG local (lcl & 16)


@dataclass
class DpParams:
    """Device-ready scoring operands for one alignment family."""
    qprof_mtx: np.ndarray        # (alpha_a, alpha_b) int32 substitution
    gop: int                     # BasicGOP (negative)
    gep: int                     # BasicGEP (negative)
    lgop: int = 0                # LongGOP
    lgep: int = 0                # LongGEP
    dagp: bool = False           # double affine (Noll == 3)
    intron_llmt: int = 20
    ipen: IntronPenalty | None = None
    scale: int = 10
    codonk1: int = 1 << 30       # long-gap switch (aln2.cc:114)

    @classmethod
    def build(cls, cfg: Config, simmtx: Simmtx, dvsp: int = CvsG,
              ipen: IntronPenalty | None = None,
              many_a: int = 1, many_b: int = 1) -> "DpParams":
        cfg = resolve(cfg, dvsp)
        vab = cfg.aln.scale * many_a * many_b
        u = cfg.aln.u if cfg.aln.u is not None else simmtx.u
        v = cfg.aln.v if cfg.aln.v is not None else simmtx.v
        gop = -int(v * vab)
        gep = -int(u * vab)
        lgep = -int(cfg.aln.u1 * vab)
        diffu = lgep - gep
        lgop = gop - diffu * cfg.aln.k1
        return cls(qprof_mtx=simmtx.mtx, gop=gop, gep=gep,
                   lgop=lgop, lgep=lgep, dagp=cfg.aln.ls >= 3,
                   intron_llmt=cfg.intron.llmt, ipen=ipen,
                   scale=cfg.aln.scale,
                   codonk1=(int(cfg.aln.k1) if cfg.aln.ls >= 3
                            else 1 << 30))

    def gap_penalty(self, k: int) -> int:
        """PwdB::GapPenalty (aln.h:276-279): affine, long-gap regime
        past codonk1 when double affine is configured."""
        if k <= 0:
            return 0
        if k > self.codonk1:
            return self.lgop + k * self.lgep
        return self.gop + k * self.gep

    def intron_table(self, max_len: int) -> np.ndarray:
        """Dense intron penalty for lengths 0..max_len-1 (int32) —
        EXACT per length (IntronPenalty.penalty, the reference's
        codepot.cc:127-233 table + log tail).  The DP kernels evaluate
        the identical values as a compare/select chain over the table's
        constant-value runs (_pack_ipen): the smooth penalty has only
        ~200 distinct int values over a 13k-length range, so the exact
        chain costs the same as any quantized one, and oracle == kernel
        == reference formula for every length."""
        if self.ipen is None:
            return np.full(max_len, NEVSEL // 2, dtype=np.int32)
        tab = self.ipen.penalty(np.arange(max_len)).astype(np.int64)
        return np.where(tab <= -32768, NEVSEL // 2, tab).astype(np.int32)
