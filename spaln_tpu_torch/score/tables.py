"""Species parameter-table directory access.

Replaces the reference's Ftable path resolution + gnm2tab species lookup
(iolib.cc:319-446): a table directory holds substitution matrices, splice
PSSMs (Splice5/Splice3), Intron53 dinucleotide tables, coding potentials and
per-clade AlnParam files.  Lookup order: explicit path -> $ALN_TAB ->
default.  ``-T species`` selects a clade subdirectory via gnm2tab.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_TABLE_DIRS = (
    os.environ.get("ALN_TAB", ""),
    os.path.join(_PKG_ROOT, "data_tables"),   # vendored parameter data
)


def find_table_dir(explicit: str | None = None) -> str:
    for cand in ((explicit,) if explicit else ()) + DEFAULT_TABLE_DIRS:
        if cand and os.path.isdir(cand):
            return cand
    raise FileNotFoundError("no parameter table directory found; "
                            "set $ALN_TAB")


@dataclass
class TableDir:
    """A resolved parameter directory, optionally specialized by species."""
    root: str
    species: str | None = None
    _sub: str | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.species:
            self._sub = self._lookup_species(self.species)

    def _lookup_species(self, sp: str) -> str | None:
        """gnm2tab: 8-char species code -> clade subdir (col 2)."""
        g2t = os.path.join(self.root, "gnm2tab")
        if os.path.isfile(g2t):
            with open(g2t) as fh:
                for line in fh:
                    if line.startswith("#"):
                        continue
                    toks = line.split()
                    if len(toks) >= 2 and toks[0] == sp[:8]:
                        return toks[1]
        # species may itself name a subdirectory
        if os.path.isdir(os.path.join(self.root, sp)):
            return sp
        return None

    def path(self, fname: str) -> str | None:
        """Resolve a table file: species subdir first, then root."""
        if self._sub:
            p = os.path.join(self.root, self._sub, fname)
            if os.path.isfile(p):
                return p
        p = os.path.join(self.root, fname)
        return p if os.path.isfile(p) else None

    def open(self, fname: str):
        p = self.path(fname)
        if p is None:
            raise FileNotFoundError(f"{fname} not in {self.root}"
                                    f" (species={self.species})")
        return open(p)

    def alnparam_args(self) -> list[str]:
        """Read the species AlnParam file as extra CLI-style args
        (readargs, spaln.cc:518-553)."""
        p = self.path("AlnParam")
        if p is None:
            return []
        import shlex
        args: list[str] = []
        with open(p) as fh:
            for line in fh:
                line = line.split(";")[0].split("#")[0].strip()
                if line:
                    # quote-aware: -yI"15 131 ..." stays one token
                    args.extend(shlex.split(line))
        return args
