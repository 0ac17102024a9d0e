"""Reduced amino-acid alphabets and codon->reduced tables (ReducWord,
bitpat.cc:25-90).

DefConvPat strings partition the 20 letters (plus J = the SER2 serine
class and U/X ambiguity) into Nalpha groups, '|'-separated.  The 6- and
14-letter alphabets drive the protein block index and HSP seed words
(wlprms aaprm/trprm, wln.cc:105-116); g2r/g2r_c map codon indices
directly to reduced classes for 6-frame genome scanning without an
intermediate tron decode (bitpat.cc:76-88).
"""
from __future__ import annotations

import numpy as np

from ..constants import GENCODE, SER2
from ..seq.codec import encode_protein

# bitpat.cc:27-45, indexed by Nalpha (6..20)
DEF_CONV_PAT = {
    6: "ASJT|CP|DEHKNQR|FWY|G|ILMV|X|U",              # SEB6
    7: "ASJT|CP|DHN|EKQR|FWY|G|ILMV|X|U",
    8: "ASJT|C|DHN|EKQR|FWY|G|ILMV|P|X|U",
    9: "ASJT|C|DEN|H|KQR|FWY|G|ILMV|P|X|U",
    10: "ASJT|C|DEN|FY|G|H|ILMV|KQR|P|W|X|U",
    11: "A|C|DEN|FY|G|H|ILMV|KQR|P|SJT|W|X|U",
    12: "A|C|DN|EQ|FY|G|H|ILMV|KR|P|SJT|W|X|U",
    13: "A|C|DN|EQ|FY|G|H|IV|KR|LM|P|SJT|W|X|U",
    14: "A|C|D|EQ|FY|G|H|IV|KR|LM|N|P|SJT|W|X|U",
    15: "A|C|D|E|FY|G|H|ILMV|KR|N|P|Q|SJ|T|W|X|U",
    16: "A|C|DE|Q|F|Y|G|H|IV|KR|L|M|N|P|SJT|W|X|U",
    17: "A|C|DE|Q|F|Y|G|H|IV|K|R|L|M|N|P|SJT|W|X|U",
    18: "A|C|DE|Q|F|Y|G|H|IV|K|R|L|M|N|P|SJ|T|W|X|U",
    19: "A|C|DE|Q|F|Y|G|H|I|V|K|R|L|M|N|P|SJ|T|W|X|U",
    20: "A|R|N|D|C|Q|E|G|H|I|L|K|M|F|P|SJ|T|W|Y|V|X|U",
}
DAYH6 = "C|SJTPANDEQBZ|HRK|MILV|FYW|X|U"


def reduc_table(nalpha: int = 20, pattern: str | None = None
                ) -> tuple[np.ndarray, int]:
    """(table over aa codes -> class id or -1, n_classes).  The trailing
    U/X groups collapse into one out-of-alphabet class (ReducWord ctor:
    Nalpha is decremented so ambiguity maps past the last real class)."""
    pat = pattern or DEF_CONV_PAT[nalpha]
    groups = pat.split("|")
    tab = np.full(64, -1, dtype=np.int8)
    n_real = 0
    for ci, grp in enumerate(groups):
        for ch in grp:
            if ch in ("X", "U"):
                continue                      # ambiguity: stays -1
            if ch == "J":                     # tron SER2 serine class
                tab[SER2] = ci
                n_real = max(n_real, ci + 1)
                continue
            try:
                code = int(encode_protein(ch)[0])
            except Exception:
                continue
            tab[code] = ci
            n_real = max(n_real, ci + 1)
    return tab, n_real


def g2r_tables(nalpha: int = 20, pattern: str | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Codon index (16*b0 + 4*b1 + b2) -> reduced class, forward and
    reverse-complement frames (g2r/g2r_c, bitpat.cc:76-88).  Stops and
    ambiguity map to -1."""
    tab, _ = reduc_table(nalpha, pattern)
    g2r = np.full(64, -1, dtype=np.int8)
    g2rc = np.full(64, -1, dtype=np.int8)
    for g in range(64):
        aa = int(GENCODE[g])
        g2r[g] = tab[aa] if 0 <= aa < 64 else -1
        f, s, t = (g >> 4) & 3, (g >> 2) & 3, g & 3
        c = 63 - (f + 4 * s + 16 * t)
        aac = int(GENCODE[c])
        g2rc[g] = tab[aac] if 0 <= aac < 64 else -1
    return g2r, g2rc
