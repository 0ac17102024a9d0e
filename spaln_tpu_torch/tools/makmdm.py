"""Mutation-data-matrix (PAM series) generator — the makmdm equivalent.

Implements Dayhoff's procedure (Dayhoff, Schwartz & Orcutt 1978, Atlas of
Protein Sequence and Structure 5(3):345-352) from the published accepted-
point-mutation counts and relative mutabilities: build the PAM1 transition
matrix, take matrix powers, convert to log-odds against the stationary
composition, normalize each level to SD=25, and write the packed
``mdm_mtx`` / ``mdm_cmp`` binaries consumed by the scoring layer
(makmdm.cc:266-1061 behavior; file layout putfmtx makmdm.cc:241-250).

Levels: PAM 0..300 step 10 (31 tables), each a lower-triangular 24x24
block (rows = UNP, AMB, ALA..VAL, ASX, GLX), followed by the per-level
normalization factors and traces.
"""
from __future__ import annotations

import os

import numpy as np

PAMSTEP = 10
MAXPAM = 300
AAS = 24
AASCMB = AAS * (AAS + 1) // 2
STDSD = 25.0
GAP_WT = -60.0

# Dayhoff 1978 relative mutabilities (year 0) and the 1991 JTT-style
# update (year 1), ALA..VAL alphabetical one-letter order
# (A R N D C Q E G H I L K M F P S T W Y V).
_RMT = np.array([
    [100., 83., 104., 86., 44., 84., 77., 50., 91., 103., 54.,
     72., 93., 51., 58., 117., 107., 25., 50., 98.],
    [100., 65., 134., 106., 20., 93., 102., 49., 66., 96., 40.,
     56., 94., 41., 56., 120., 97., 18., 41., 74.],
])

# Accepted point mutation counts (x10), strictly-lower-triangular rows.
_RAW = [
    [247,
     216, 116,
     386, 48, 1433,
     106, 125, 32, 13,
     208, 750, 159, 130, 9,
     600, 119, 180, 2914, 8, 1027,
     1183, 614, 291, 577, 98, 84, 610,
     46, 446, 466, 144, 40, 635, 41, 41,
     173, 76, 130, 37, 19, 20, 43, 25, 26,
     257, 205, 63, 34, 36, 314, 65, 56, 134, 1324,
     200, 2348, 758, 102, 7, 858, 754, 142, 85, 75, 94,
     100, 61, 39, 27, 23, 52, 30, 27, 21, 704, 974, 103,
     51, 16, 15, 8, 66, 9, 13, 18, 50, 196, 1093, 7, 49,
     901, 217, 31, 39, 15, 395, 71, 93, 157, 31, 578, 77, 23, 36,
     2413, 413, 1738, 244, 353, 182, 156, 1131, 138, 172, 436, 228, 54,
     309, 1138,
     2440, 230, 693, 151, 66, 149, 142, 164, 76, 930, 172, 398, 343, 39,
     412, 2258,
     11, 109, 2, 5, 38, 12, 12, 69, 5, 12, 82, 9, 8, 37, 6, 36, 8,
     41, 46, 114, 89, 164, 40, 15, 15, 514, 61, 84, 20, 17, 850, 22, 164,
     45, 41,
     1766, 69, 55, 127, 99, 58, 226, 276, 22, 3938, 1261, 58, 559, 189,
     84, 219, 526, 27, 42],
    [30,
     109, 17,
     154, 0, 532,
     33, 10, 0, 0,
     93, 120, 50, 76, 0,
     266, 0, 94, 831, 0, 422,
     579, 10, 156, 162, 10, 30, 112,
     21, 103, 226, 43, 10, 243, 23, 10,
     66, 30, 36, 13, 17, 8, 35, 0, 3,
     95, 17, 37, 0, 0, 75, 15, 17, 40, 253,
     57, 477, 322, 85, 0, 147, 104, 60, 23, 43, 39,
     29, 17, 0, 0, 0, 20, 7, 7, 0, 57, 207, 90,
     20, 7, 7, 0, 0, 0, 0, 17, 20, 90, 167, 0, 17,
     345, 67, 27, 10, 10, 93, 40, 49, 50, 7, 43, 43, 4, 7,
     772, 137, 432, 98, 117, 47, 86, 450, 26, 20, 32, 168, 20, 40, 269,
     590, 20, 169, 57, 10, 37, 31, 50, 14, 129, 52, 200, 28, 10, 73, 696,
     0, 27, 3, 0, 0, 0, 0, 0, 3, 0, 13, 0, 0, 10, 0, 17, 0,
     20, 3, 36, 0, 30, 0, 10, 0, 40, 13, 23, 10, 0, 260, 0, 22, 23, 6,
     365, 20, 13, 17, 33, 27, 37, 97, 30, 661, 303, 17, 77, 10, 50, 43,
     186, 0, 17],
]

# row layout of the 24-wide tables: UNP, AMB, 20 aa, ASX, GLX
R_UNP, R_AMB, R_AA0, R_ASX, R_GLX = 0, 1, 2, 22, 23
# positions of N/D/Q/E within the alphabetical 20-aa order
I_ARG, I_ASN, I_ASP, I_GLN, I_GLU = 1, 2, 3, 5, 6


def pam1(year: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """PAM1 transition matrix + stationary composition
    (makmdm.cc:266-359)."""
    count = np.zeros((20, 20))
    k = 0
    raw = _RAW[year]
    for i in range(20):
        for j in range(i):
            count[i, j] = count[j, i] = raw[k]
            k += 1
    rmt = _RMT[year]
    a = np.zeros((20, 20))
    delta = 0.01
    colsum = count.sum(axis=0)
    for j in range(20):
        s = colsum[j] if colsum[j] else 1.0
        a[:, j] = delta * rmt[j] * count[:, j] / s
        a[j, j] = -delta * rmt[j]
    # stationary composition via cofactor determinants (makmdm.cc:336-347)
    comp = np.empty(20)
    for i in range(20):
        b = a.copy()
        b[i, :] = 0.0
        b[i, i] = 1.0
        comp[i] = np.linalg.det(b)
    dt = comp.sum()
    s = comp @ np.diag(a)
    fact = -0.01 * dt / s
    comp = comp / dt
    a = a * fact + np.eye(20)
    return a, comp


def _matstat(c24: np.ndarray, comp: np.ndarray) -> tuple[float, float]:
    s = c24[R_AA0:R_AA0 + 20, R_AA0:R_AA0 + 20]
    s = np.tril(s) + np.tril(s, -1).T         # symmetric from lower tri
    av = comp @ s @ comp
    sd = comp @ (s * s) @ comp
    return av, float(np.sqrt(sd - av * av))


def _makes(c24: np.ndarray) -> None:
    """Extend to 24x24: AMB=0, UNP=gap weight, ASX/GLX averages
    (makmdm.cc:212-234)."""
    s = c24[R_AA0:R_AA0 + 20, R_AA0:R_AA0 + 20]
    sym = np.tril(s) + np.tril(s, -1).T
    c24[R_AA0:R_AA0 + 20, R_AA0:R_AA0 + 20] = sym
    c24[R_AMB, :] = c24[:, R_AMB] = 0.0
    c24[R_UNP, :] = c24[:, R_UNP] = GAP_WT
    asx = (c24[R_AA0 + I_ASN, :] + c24[R_AA0 + I_ASP, :]) / 2.
    c24[R_ASX, :] = c24[:, R_ASX] = asx
    glx = (c24[R_AA0 + I_GLN, :] + c24[R_AA0 + I_GLU, :]) / 2.
    c24[R_GLX, :] = c24[:, R_GLX] = glx
    # diagonals resolve self-referentially in the reference's sequential
    # loop (makmdm.cc:226-231): ASX/ASX averages the already-averaged
    # column entries
    c24[R_ASX, R_ASX] = (c24[R_AA0 + I_ASN, R_ASX]
                         + c24[R_AA0 + I_ASP, R_ASX]) / 2.
    c24[R_GLX, R_GLX] = (c24[R_AA0 + I_GLN, R_GLX]
                         + c24[R_AA0 + I_GLU, R_GLX]) / 2.
    c24[R_UNP, R_UNP] = 0.0
    c24[R_AMB, R_AMB] = 1.0


def build_mdm(year: int = 0):
    """All PAM levels: returns (triangles (nlev, AASCMB), nrmf, trace,
    comp)."""
    a, comp = pam1(year)
    a10 = np.linalg.matrix_power(a, PAMSTEP)
    b = np.eye(20)
    nlev = MAXPAM // PAMSTEP + 1
    tris = np.zeros((nlev, AASCMB))
    nrmf = np.zeros(nlev)
    trace = np.zeros(nlev)
    il, jl = np.tril_indices(AAS)
    for lev in range(nlev):
        c24 = np.zeros((AAS, AAS))
        aa = c24[R_AA0:R_AA0 + 20, R_AA0:R_AA0 + 20]
        if lev == 0:
            np.fill_diagonal(aa, 1.0)
        else:
            with np.errstate(divide="ignore"):
                lo = np.log(np.maximum(b, 1e-300) / comp[:, None])
            # only the lower triangle is defined before makes()
            aa[:, :] = np.tril(lo)
        av, sd = _matstat(c24, comp)
        nrmf[lev] = STDSD / sd
        aa *= nrmf[lev]
        trace[lev] = np.trace(aa) / 20
        _makes(c24)
        tris[lev] = c24[il, jl]
        b = b @ a10
    return tris, nrmf, trace, comp


def write_mdm(dest_dir: str, year: int = 0) -> None:
    tris, nrmf, trace, comp = build_mdm(year)
    with open(os.path.join(dest_dir, "mdm_cmp"), "wb") as fh:
        comp.astype(np.float64).tofile(fh)
    with open(os.path.join(dest_dir, "mdm_mtx"), "wb") as fh:
        tris.astype(np.float64).tofile(fh)
        nrmf.astype(np.float64).tofile(fh)
        trace.astype(np.float64).tofile(fh)


if __name__ == "__main__":
    import sys
    write_mdm(sys.argv[1] if len(sys.argv) > 1 else ".")
