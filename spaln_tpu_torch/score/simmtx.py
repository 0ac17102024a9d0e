"""Substitution matrices.

Reproduces the reference's scoring matrices as dense int32 numpy arrays in
x10 fixed-point units (the reference's integer build, spaln.cc:1492):

- DNA 17x17 from the IUPAC-bitmask ``level`` formula (simmtx.cc:31,145-168)
- protein 25x25 from the PAM-series mutation-data file ``table/mdm_mtx``
  (simmtx.cc:284-336) or a BLAST-format text matrix (blosum62, vtml...)
- tron 26x26 extension for protein x translated-genome (simmtx.cc Hmtx)

Matrices are small; they live as host numpy and are shipped to device once
per run as gather tables for the DP kernels.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np

from ..constants import (ALA, AMB, AA_NIL, AA_UNP, ASIMD, CYS, GAP, NIL,
                         NSIMD, NTS, SEC, SER, SER2, TRM, TRM2, TRP, TSIMD,
                         AA_DECODE)

SCALE = 10                      # fixed-point score scale (spaln.cc:1492)
PAMSTEP, MAXPAM = 10, 300       # mdm.h:26-27
AAS = 24
AASCMB = AAS * (AAS + 1) // 2
PAMLEVELS = MAXPAM // PAMSTEP


@dataclass(frozen=True)
class DefPrm:
    """Per-matrix-slot gap defaults (simmtx.cc:58-61 defNprm/defPprm)."""
    u: float      # gap extension
    v: float      # gap opening
    n: float      # nt mismatch (DNA only)
    b: float      # matrix bias
    p: int        # nt match ladder top / protein PAM level


# slot 0 = final alignment, slot 1 = cross-species (-yp), slot 2 = HSP search
DEF_NPRM = (DefPrm(3., 8., -6., 0., 1),
            DefPrm(2., 6., -4., 0., 1),
            DefPrm(2., 4., -2., 0., 1))
DEF_PPRM = (DefPrm(4., 10., 0., 0., 100),
            DefPrm(2., 9., 0., 0., 150),
            DefPrm(2., 9., 0., 0., 250))
# runtime PAM overrides: slot0=100 intra, slot1=150 cross, slot2=50 HSP
# (spaln.cc:49-51, setdefparam)


def _countbit(x: int) -> int:
    return bin(x).count("1")


def _level(i: int, j: int) -> int:
    """simmtx.cc:31 — integer-division similarity level of two IUPAC masks."""
    ci, cj, cij = _countbit(i), _countbit(j), _countbit(i & j)
    return 4 - (9 * cij) // ci // cj // 2


def dna_matrix(mismatch: float = -6., match_top: float = 2., u: float = 3.,
               scale: int = SCALE) -> np.ndarray:
    """17x17 DNA matrix (Simmtx::Nmtx, simmtx.cc:145-168).

    smn ladder {match_top, 1, 0, -1, mismatch} indexed by IUPAC overlap
    level; gap column = -scale*u; NIL rows zero.
    """
    smn = [match_top, 1., 0., -1., mismatch]
    mtx = np.zeros((NSIMD, NSIMD), dtype=np.int32)
    ntsunp = -int(scale * u)
    for i in range(1, NTS):
        ii = i + GAP
        for j in range(1, i + 1):
            jj = j + GAP
            v = int(scale * smn[_level(i, j)])
            mtx[ii, jj] = mtx[jj, ii] = v
        mtx[GAP, ii] = mtx[ii, GAP] = ntsunp
    return mtx


def mdm_matrix(pam: int, table_dir: str, u: float = 4., b: float = 0.,
               o: float = 30., scale: int = SCALE) -> np.ndarray:
    """25x25 protein matrix at a PAM level from table/mdm_mtx
    (Simmtx::Pmtx, simmtx.cc:284-336).  Values in the file are already in
    x10 units; int conversion adds +0.5 (truncation toward zero on the
    positives, matching the reference's ``(VTYPE)(buf+0.5)``)."""
    lev = (pam + PAMSTEP - 1) // PAMSTEP
    raw = np.fromfile(os.path.join(table_dir, "mdm_mtx"), dtype=np.float64)
    buf = raw[lev * AASCMB:(lev + 1) * AASCMB].copy()
    fscl = scale / 10.
    buf = buf + 10. * b
    buf *= fscl
    vals = np.trunc(buf + 0.5).astype(np.int32)
    mtx = np.zeros((ASIMD + 1, ASIMD + 1), dtype=np.int32)
    k = 0
    for i in range(AAS):
        ii = i + 1
        for j in range(i + 1):
            jj = j + 1
            mtx[ii, jj] = mtx[jj, ii] = vals[k]
            k += 1
    unp = -int(scale * u)
    for i in range(AMB, ASIMD + 1):
        mtx[i, AA_UNP] = mtx[AA_UNP, i] = unp
        mtx[i, SEC] = mtx[SEC, i] = mtx[i, CYS]
    mtx[AA_UNP, AA_UNP] = 0
    mtx[AA_NIL, :] = mtx[:, AA_NIL] = 0
    return mtx[:ASIMD + 1, :ASIMD + 1]


def text_matrix(path: str, u: float = 4., b: float = 0.,
                scale: int = SCALE) -> np.ndarray:
    """Parse a BLAST-format protein matrix (blosum62/vtml...) into 25x25
    int32 (Simmtx::Pmtx(fname), simmtx.cc:338-430)."""
    from ..constants import AA_ENCODE
    file_scale = 1.
    header: list[int] = []
    rows: list[tuple[int, list[float]]] = []
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if not s:
                continue
            if s.startswith("#"):
                if "=" in s:
                    key, _, val = s[1:].partition("=")
                    if key.strip() == "scale":
                        try:
                            file_scale = float(val) or 1.
                        except ValueError:
                            pass
                continue
            toks = s.split()
            if not header and all(len(t) == 1 and not _is_num(t)
                                  for t in toks):
                for t in toks:
                    header.append(GAP if t in "*-"
                                  else int(AA_ENCODE[ord(t)]))
                continue
            if header:
                first = toks[0]
                if _is_num(first):
                    k = header[len(rows)]
                    nums = toks
                else:
                    k = GAP if first in "*-" else int(AA_ENCODE[ord(first)])
                    nums = toks[1:]
                rows.append((k, [float(x) for x in nums]))
    mtx = np.zeros((ASIMD + 1, ASIMD + 1), dtype=np.int32)
    for k, nums in rows:
        for j, x in enumerate(nums[:len(header)]):
            mtx[k, header[j]] = int((x / file_scale + b) * scale)
    unp = -int(scale * u)
    for i in range(AMB, ASIMD + 1):
        mtx[i, AA_UNP] = mtx[AA_UNP, i] = unp
    mtx[AA_UNP, AA_UNP] = 0
    mtx[AA_NIL, :] = mtx[:, AA_NIL] = 0
    return mtx


def _is_num(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def tron_matrix(pmtx: np.ndarray, u: float = 4., o: float = 30.,
                scale: int = SCALE, txt: bool = False) -> np.ndarray:
    """26x26 protein-vs-tron matrix from a 25x25 protein matrix
    (Simmtx::Hmtx).  SER2 column copies SER; SEC/TRM2 and TRM columns carry
    the premature-stop penalty -scale*o; TxT additionally scores stop-stop
    as ALA-ALA."""
    mtx = np.zeros((TSIMD, TSIMD), dtype=np.int32)
    unp = -int(scale * u)
    trm_aas = -int(scale * o)
    trm_trm = int(scale * pmtx[ALA, ALA])
    mtx[:SER2, :SER2] = pmtx[:SER2, :SER2]
    for i in range(TSIMD):
        mtx[i, SER2] = mtx[SER2, i] = mtx[SER, i]
    for i in range(AMB, TSIMD):
        mtx[AA_UNP, i] = mtx[i, AA_UNP] = unp
        mtx[SEC, i] = mtx[i, SEC] = trm_aas
        mtx[TRM, i] = mtx[i, TRM] = trm_aas
    mtx[AA_UNP, AA_UNP] = 0
    mtx[SEC, SEC] = mtx[CYS, CYS]
    if txt:
        mtx[TRM, TRM] = mtx[TRM, TRM2] = mtx[TRM2, TRM] = \
            mtx[TRM2, TRM2] = trm_trm
    mtx[AA_NIL, :] = mtx[:, AA_NIL] = 0
    return mtx


@dataclass
class Simmtx:
    """A similarity matrix bundle: dense table + the gap params that came
    with it (the role of class Simmtx + DefPrm, simmtx.h:38-86)."""
    mtx: np.ndarray
    u: float                    # gap extension (unscaled)
    v: float                    # gap opening (unscaled)
    scale: int = SCALE

    @property
    def gap_ext(self) -> int:
        return -int(self.scale * self.u)

    @property
    def gap_open(self) -> int:
        return -int(self.scale * self.v)

    @classmethod
    def dna(cls, slot: int = 0, scale: int = SCALE,
            match: float | None = None,
            mismatch: float | None = None) -> "Simmtx":
        """match/mismatch override the smn ladder ends (-ym/-yn)."""
        p = DEF_NPRM[slot]
        return cls(dna_matrix(mismatch if mismatch is not None else p.n,
                              match if match is not None else 2.,
                              p.u, scale), p.u, p.v, scale)

    @classmethod
    def protein(cls, table_dir: str, pam: int | None = None, slot: int = 0,
                scale: int = SCALE) -> "Simmtx":
        p = DEF_PPRM[slot]
        pam_runtime = {0: 100, 1: 150, 2: 50}
        pp = pam if pam is not None else pam_runtime.get(slot, p.p)
        return cls(mdm_matrix(pp, table_dir, p.u, p.b, scale=scale),
                   p.u, p.v, scale)

    def tron(self, o: float = 30.) -> "Simmtx":
        return Simmtx(tron_matrix(self.mtx, self.u, o, self.scale),
                      self.u, self.v, self.scale)
