"""Alphabet encodings shared across the framework.

Residue integer codes follow the reference encoding (ogotoh/spaln
src/cmn.h:113-118, src/seq.cc:30-77) so that the bundled parameter tables
(PSSMs, substitution matrices, reduced alphabets) keep their meaning.

Nucleotide codes are IUPAC bitmask + 1: ``code - 1`` is a 4-bit mask over
(A=1, C=2, G=4, T=8); code 0 is the pad/terminator sentinel and code 1 a gap.
Amino-acid codes: 0=NIL(pad), 1=UNP(gap), 2=AMB(X), 3..22 = the 20 residues,
23=ASX, 24=SEC/TRM2, 25=TRM(stop).
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- nucleotides
NIL = 0          # pad / end-of-sequence sentinel ("___" in the reference)
GAP = 1          # gap code ("_")
A, C, M, G, R, S, V, T = 2, 3, 4, 5, 6, 7, 8, 9
U = 9
W, Y, H, K, D, B, N = 10, 11, 12, 13, 14, 15, 16
NTS = 16         # number of nt symbols incl. gap
NSIMD = 17       # nt alphabet size incl. pad

NUC_DECODE = "--ACMGRSVTWYHKDBN"          # seq.cc:56

# letter (A..Z) -> nt code (seq.cc:45 nccode)
_NCCODE = [A, B, C, D, N, N, G, H, N, N, K, N, M, N, N, N, N, R, S, T, U, V,
           W, N, Y, N]
# reference maps unknown letters to Z(=17, out of range) -> we clamp to N.

# complement per nt code (seq.cc:74 complcod)
NUC_COMPLEMENT = np.array(
    [NIL, GAP, T, G, K, C, Y, S, B, A, W, R, D, M, H, V, N], dtype=np.int8)

# nt code -> 0..3 (A,C,G,T) for unambiguous bases; ambiguity -> arbitrary
# member base (seq.cc:33 ncelements)
NT_ELEMENT = np.array(
    [0, 0, 0, 1, 2, 2, 0, 2, 0, 3, 3, 3, 1, 1, 2, 3, 0], dtype=np.int8)

# nt code -> reduced 4-letter alphabet with N=4 sentinel for seeds
# (A,C,G,T -> 0..3; anything ambiguous -> 4)
NT_REDUCE4 = np.full(NSIMD, 4, dtype=np.int8)
NT_REDUCE4[A], NT_REDUCE4[C], NT_REDUCE4[G], NT_REDUCE4[T] = 0, 1, 2, 3

# tron code -> 2-bit class (tnredctab, seq.cc:41-42): the word stream
# the reference feeds CodePot/ExinPot scans for TRON-converted targets
TRON_REDUCE4 = np.array(
    [4, 4, 4, 1, 2, 0, 0, 2, 0, 0, 2, 0, 3, 3, 0, 3, 3, 1, 1, 1, 2, 0,
     3, 2, 2, 0], dtype=np.int8)

def _build_nt_encode() -> np.ndarray:
    enc = np.full(256, N, dtype=np.int8)   # unknown -> N
    enc[0] = NIL
    for ch in "-.~":
        enc[ord(ch)] = GAP
    for i, code in enumerate(_NCCODE):
        enc[ord('A') + i] = code
        enc[ord('a') + i] = code
    return enc

NT_ENCODE = _build_nt_encode()             # byte -> nt code

# --------------------------------------------------------------- amino acids
AA_NIL, AA_UNP, AMB = 0, 1, 2
(ALA, ARG, ASN, ASP, CYS, GLN, GLU, GLY, HIS, ILE, LEU, LYS, MET, PHE, PRO,
 SER, THR, TRP, TYR, VAL) = range(3, 23)
ASX = 23
SER2 = 23        # tron alphabet reuses 23 for AGY-serine (cmn.h:117)
SEC = TRM2 = 24
TRM = 25
ASIMD = 24       # aa alphabet size for profile arrays
TSIMD = 26       # tron alphabet size (adds TRM2/TRM)

AA_DECODE = "--XARNDCQEGHILKMFPSTWYVBUO"   # seq.cc:58 (B=ASX, U=SEC, O=TRM)

# letter (A..Z) -> aa code (seq.cc:47 aacode); J/O -> out-of-alphabet -> AMB
_AACODE = [ALA, ASX, CYS, ASP, GLU, PHE, GLY, HIS, ILE, AMB, LYS, LEU, MET,
           ASN, AMB, PRO, GLN, ARG, SER, THR, SEC, VAL, TRP, AMB, TYR, AMB]
# reference: J->ZZZ, Z->GLX(24); we fold both to AMB / SEC slot semantics.

def _build_aa_encode() -> np.ndarray:
    enc = np.full(256, AMB, dtype=np.int8)
    enc[0] = AA_NIL
    for ch in "-.~":
        enc[ord(ch)] = AA_UNP
    enc[ord('*')] = TRM
    for i, code in enumerate(_AACODE):
        enc[ord('A') + i] = code
        enc[ord('a') + i] = code
    return enc

AA_ENCODE = _build_aa_encode()

# aa code -> reduced 0..19 index for seed words (seq.cc:38 aaredctab:
# ALA..VAL -> 0..19, AMB/ASX/etc -> sentinels >= 20)
AA_REDUCE20 = np.array(
    [21, 21, 20, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
     17, 18, 19, 2, 5, 20], dtype=np.int8)

# ------------------------------------------------------------- genetic code
# Standard (EukUniv) genetic code, codon index = 16*b1 + 4*b2 + b3 with
# A=0,C=1,G=2,T=3 (utilseq.cc:38-43).  TGA encodes TRM2 (=SEC slot) to let
# selenocysteine read-through score separately from TAA/TAG.
GENCODE = np.array([
    LYS, ASN, LYS, ASN, THR, THR, THR, THR, ARG, SER, ARG, SER, ILE, ILE, MET, ILE,
    GLN, HIS, GLN, HIS, PRO, PRO, PRO, PRO, ARG, ARG, ARG, ARG, LEU, LEU, LEU, LEU,
    GLU, ASP, GLU, ASP, ALA, ALA, ALA, ALA, GLY, GLY, GLY, GLY, VAL, VAL, VAL, VAL,
    TRM, TYR, TRM, TYR, SER, SER, SER, SER, TRM2, CYS, TRP, CYS, LEU, PHE, LEU, PHE,
], dtype=np.int8)

# tron decode alphabet (seq.cc:59 acodon: J = SER2, U = TRM2, O = TRM)
TRON_DECODE = "--XARNDCQEGHILKMFPSTWYVJUO"

# tron code -> nucleotide-class 0..3 used by 6-frame reduced seeds
# (seq.cc:41 tnredctab maps each tron/aa code to a representative base class;
# index 4 = ambiguous sentinel)
TRON_REDUCE4 = np.array(
    [4, 4, 4, 1, 2, 0, 0, 2, 0, 0, 2, 0, 3, 3, 0, 3, 3, 1, 1, 1, 2, 0, 3, 2,
     2, 0], dtype=np.int8)

# ------------------------------------------------------------------ molecules
UNKNOWN, PROTEIN, DNA, RNA, TRON_MOL, GENOME_MOL = 0, 1, 2, 3, 4, 5


def is_nuc_molc(molc: int) -> bool:
    return molc in (DNA, RNA, GENOME_MOL)
