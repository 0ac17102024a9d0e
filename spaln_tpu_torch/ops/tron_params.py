"""Parameters and direction codes of the protein x translated-genome
spliced DP (the tron DP of ops/dp_tron: K7 and K8).

States: 0 = H (diag, consumes 1 aa x 3 nt), 1 = E (genome insertion,
rotating 3-frame queue), 2 = F (aa deletion), with 1/2-nt frameshift
moves into both gap states (GapE1/E2 extend, GapW1/W2 open); with double
affine (-yl3, prm.dagp) also 3 = E2 (HORL) / 4 = F2 (VERL) long-gap
states under LongGOP/GEP (fwd2h1.cc:413-448).  The counterpart of
TronDpParams and the direction codes of spaln_tpu/ops/dp_tron_ref.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# dir codes (aln.h:30-36)
DEAD, RSRV, DIAG, NEWD, VERT, SLA1, SLA2, VERL = 0, 1, 2, 3, 4, 5, 6, 7
HORI, HOR1, HOR2, HORL = 8, 9, 10, 11
SPIN = 16


@dataclass
class TronDpParams:
    """Protein-path gap costs (PwdB ctor, aln2.cc:99-127)."""
    qprof_mtx: np.ndarray          # tron matrix (26, 26) int32
    gop: int                       # BasicGOP
    gep: int                       # BasicGEP
    extra_gop: int                 # -x * Vab (frameshift)
    intron_minl: int = 20
    scale: int = 10
    # double affine (Noll == 3, -yl3): long-gap costs per codon step;
    # LongGEP = -u1*Vab, LongGOP = BasicGOP - (LongGEP - BasicGEP)*k1
    dagp: bool = False
    lgop: int = 0                  # LongGOP
    lgep: int = 0                  # LongGEP
    codonk1: int = 1 << 30         # long-gap switch (aln2.cc:114)
    vthr: int = 350                # Vthr = alprm.thr * Vab (aln2.cc:105)

    @property
    def gap_e1(self) -> int:
        return self.gep + self.extra_gop

    @property
    def gap_e2(self) -> int:
        return self.gap_e1 + self.gep

    @property
    def gap_w1(self) -> int:
        return self.gap_e1 + self.gop

    @property
    def gap_w2(self) -> int:
        return self.gap_e2 + self.gop

    @property
    def gap_w3(self) -> int:
        return self.gop + self.gep

    @property
    def gap_w3l(self) -> int:
        return self.lgop + self.lgep

    @classmethod
    def build(cls, cfg, tron_mtx: np.ndarray, u: float = 2., v: float = 9.):
        vab = cfg.aln.scale
        gop, gep = -int(v * vab), -int(u * vab)
        lgep = -int(cfg.aln.u1 * vab)
        lgop = gop - (lgep - gep) * int(cfg.aln.k1)
        return cls(qprof_mtx=tron_mtx, gop=gop, gep=gep,
                   extra_gop=-int(cfg.aln2.x * vab),
                   intron_minl=cfg.intron.minl, scale=cfg.aln.scale,
                   dagp=cfg.aln.ls >= 3, lgop=lgop, lgep=lgep,
                   codonk1=(3 * int(cfg.aln.k1) if cfg.aln.ls >= 3
                            else 1 << 30),
                   vthr=int(cfg.aln.thr * vab))

    def gap_penalty3(self, i: int) -> int:
        """PwdB::GapPenalty3 (aln2.cc:41-52): affine gap cost over i nt
        with frameshift end costs and the long-gap regime past codonk1."""
        if i <= 0:
            return 0
        x = (self.gap_e1, self.gap_e2)[i % 3 - 1] if i % 3 else 0
        if i > self.codonk1:
            return x + self.lgop + (i // 3) * self.lgep
        return x + self.gop + (i // 3) * self.gep
