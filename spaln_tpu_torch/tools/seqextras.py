"""Sequence-utility equivalents of the reference's small aux binaries.

- montseq (src/montseq.cc): Monte-Carlo random nt/aa sequences with a
  given residue composition, plus mutate (substitute / insert / delete)
  for score-distribution studies.
- resite (src/resite.cc, table/renzyme): restriction-enzyme cleavage
  site scan over IUPAC-degenerate patterns; all sites or unique-cutters.
- extcds (src/extcds.cc): extract CDS regions from GenBank flat files,
  honoring join()/complement() location syntax.
- rdn (src/rdn.cc): pick members from a multiple sequence alignment
  (every k-th, a random subset, or by explicit index list).

Pure-host utilities (no device work); the heavy compute paths live in
spaln_tpu_torch.ops / spaln_tpu_torch.align.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

DNA_ALPHABET = "ACGT"
AA_ALPHABET = "ARNDCQEGHILKMFPSTWYV"

# IUPAC degenerate nucleotide codes -> regex character classes
IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "[AG]", "Y": "[CT]", "M": "[AC]", "K": "[GT]",
    "S": "[CG]", "W": "[AT]", "B": "[CGT]", "D": "[AGT]",
    "H": "[ACT]", "V": "[ACG]", "N": "[ACGT]",
}

_COMP = str.maketrans("ACGTRYMKBDHVacgtrymkbdhv",
                      "TGCAYRKMVHDBtgcayrkmvhdb")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


# ---------------------------------------------------------------- montseq

def montseq(n: int, length: int, composition=None, protein: bool = False,
            seed: int | None = None) -> list[str]:
    """Generate n random sequences of the given length whose residues
    are drawn i.i.d. from ``composition`` (uniform if None) — the
    Monte-Carlo generator of montseq.cc."""
    alpha = AA_ALPHABET if protein else DNA_ALPHABET
    rng = np.random.default_rng(seed)
    if composition is None:
        p = np.full(len(alpha), 1.0 / len(alpha))
    else:
        p = np.asarray(composition, dtype=float)
        p = p / p.sum()
    letters = np.array(list(alpha))
    return ["".join(rng.choice(letters, size=length, p=p))
            for _ in range(n)]


def mutate_seq(seq: str, sub: float = 0.0, ins: float = 0.0,
               del_: float = 0.0, protein: bool = False,
               seed: int | None = None) -> str:
    """Apply point substitutions / insertions / deletions at the given
    per-position rates (montseq.cc mutate mode; also utn 'mutate')."""
    alpha = AA_ALPHABET if protein else DNA_ALPHABET
    rng = np.random.default_rng(seed)
    out = []
    for c in seq:
        r = rng.random()
        if r < del_:
            continue
        if r < del_ + ins:
            out.append(alpha[rng.integers(len(alpha))])
        if rng.random() < sub:
            repl = alpha[rng.integers(len(alpha))]
            while repl == c and len(alpha) > 1:
                repl = alpha[rng.integers(len(alpha))]
            c = repl
        out.append(c)
    return "".join(out)


# ---------------------------------------------------------------- resite

@dataclass
class Enzyme:
    name: str
    pattern: str           # IUPAC
    cut: int               # cleavage offset within the pattern


@dataclass
class CutSite:
    enzyme: str
    pos: int               # 0-based position of the cleavage point
    strand: str            # '+' or '-'


def read_renzyme(path: str) -> list[Enzyme]:
    """Parse the table/renzyme format: name, IUPAC pattern, cut offset."""
    out = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3 or parts[0].startswith("#"):
                continue
            try:
                out.append(Enzyme(parts[0], parts[1].upper(),
                                  int(parts[2])))
            except ValueError:
                continue
    return out


def _iupac_regex(pattern: str) -> str:
    return "".join(IUPAC.get(c, c) for c in pattern.upper())


def resite(seq: str, enzymes: list[Enzyme],
           unique_only: bool = False) -> list[CutSite]:
    """Find restriction cleavage sites (resite.cc): every match of each
    enzyme's degenerate pattern on either strand; ``unique_only`` keeps
    enzymes that cut exactly once (UNIQENZ set)."""
    seq = seq.upper()
    sites: list[CutSite] = []
    per_enzyme: dict[str, list[CutSite]] = {}
    for enz in enzymes:
        rx = re.compile(_iupac_regex(enz.pattern))
        found = []
        for m in rx.finditer(seq):
            found.append(CutSite(enz.name, m.start() + enz.cut, "+"))
        if revcomp(enz.pattern) != enz.pattern:   # non-palindromic
            rxr = re.compile(_iupac_regex(revcomp(enz.pattern)))
            plen = len(enz.pattern)
            for m in rxr.finditer(seq):
                found.append(CutSite(enz.name,
                                     m.start() + (plen - enz.cut), "-"))
        per_enzyme[enz.name] = found
    for name, found in per_enzyme.items():
        if unique_only and len(found) != 1:
            continue
        sites.extend(found)
    sites.sort(key=lambda s: (s.pos, s.enzyme))
    return sites


# ---------------------------------------------------------------- extcds

_LOC_RE = re.compile(r"(\d+)\.\.[<>]?(\d+)|(\d+)")


def _parse_location(loc: str):
    """Parse a GenBank feature location into (ranges, minus_strand).
    Supports join(), order(), complement(), partial markers <,>."""
    loc = loc.replace(" ", "")
    minus = False
    # strip nested complement(...)/join(...)/order(...)
    changed = True
    while changed:
        changed = False
        for kw in ("complement(", "join(", "order("):
            if loc.startswith(kw) and loc.endswith(")"):
                if kw == "complement(":
                    minus = not minus
                loc = loc[len(kw):-1]
                changed = True
    ranges = []
    for part in loc.split(","):
        m = _LOC_RE.search(part)
        if not m:
            continue
        if m.group(3) is not None:
            a = b = int(m.group(3))
        else:
            a, b = int(m.group(1)), int(m.group(2))
        ranges.append((a - 1, b))          # to 0-based half-open
    return ranges, minus


@dataclass
class CdsRecord:
    entry: str
    product: str
    seq: str               # spliced CDS, 5'->3'
    ranges: list
    minus: bool


def extcds(path: str) -> list[CdsRecord]:
    """Extract every CDS from a GenBank flat file (extcds.cc): splices
    join() segments and reverse-complements complement() features.

    Feature grammar: a feature key starts at column 5; its location may
    continue on indented lines until the first '/qualifier' line.  Only
    the /product qualifier is retained."""
    out: list[CdsRecord] = []

    def flush(entry, feats, seq_chunks):
        seq = "".join(seq_chunks).upper()
        for loc, prod in feats:
            ranges, minus = _parse_location(loc)
            if not ranges:
                continue
            s = "".join(seq[a:b] for a, b in ranges)
            if minus:
                s = revcomp(s)
            out.append(CdsRecord(entry, prod, s, ranges, minus))

    entry, feats, seq_chunks = "", [], []
    in_seq = False
    cds = None                 # [location, product] of the open CDS
    loc_open = False           # still appending location lines
    for line in open(path):
        if line.startswith("LOCUS"):
            if entry:
                flush(entry, feats, seq_chunks)
            parts = line.split()
            entry = parts[1] if len(parts) > 1 else ""
            feats, seq_chunks = [], []
            in_seq = False
            cds, loc_open = None, False
            continue
        if line.startswith("ORIGIN"):
            in_seq = True
            continue
        if line.startswith("//"):
            in_seq = False
            continue
        if in_seq:
            seq_chunks.append("".join(c for c in line if c.isalpha()))
            continue
        st = line.strip()
        is_qual = st.startswith("/")
        is_key = len(line) > 5 and line[:5] == "     " and \
            len(line) > 5 and line[5] not in " \t"
        if is_key:                      # new feature begins
            if cds:
                feats.append(tuple(cds))
            if st.split()[0] == "CDS":
                cds = [st[3:].strip(), ""]
                loc_open = True
            else:
                cds, loc_open = None, False
        elif cds is not None and line.startswith(" " * 10):
            if is_qual:
                loc_open = False
                if st.startswith("/product="):
                    cds[1] = st.split("=", 1)[1].strip('"')
            elif loc_open:
                cds[0] += st            # location continuation
    if cds:
        feats.append(tuple(cds))
    if entry:
        flush(entry, feats, seq_chunks)
    return out


# ---------------------------------------------------------------- rdn

def pick_members(names: list[str], every: int | None = None,
                 count: int | None = None,
                 indices: list[int] | None = None,
                 seed: int | None = None) -> list[int]:
    """Pick member indices from an MSA (rdn.cc): every k-th member, a
    random subset of ``count``, or an explicit index list."""
    n = len(names)
    if indices is not None:
        return [i for i in indices if 0 <= i < n]
    if every:
        return list(range(0, n, every))
    if count:
        rng = np.random.default_rng(seed)
        return sorted(rng.choice(n, size=min(count, n),
                                 replace=False).tolist())
    return list(range(n))
