"""FASTA(.gz) reading/writing and streaming query supply.

Replaces the reference's Seq readers + SeqServer streaming input
(seq.h:1158-1197): queries are streamed from (possibly gzipped) FASTA files
and encoded to int8 code arrays for the device pipeline.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from ..constants import DNA, PROTEIN, UNKNOWN
from .codec import encode_dna, encode_protein


@dataclass
class SeqRecord:
    name: str
    codes: np.ndarray            # int8 residue codes
    molc: int                    # DNA or PROTEIN
    descr: str = ""
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.codes)


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


_AA_ONLY = set("EFILPQZefilpqz")   # letters that cannot occur in IUPAC DNA


def infer_molc(seq: str) -> int:
    """Guess molecule type from residue composition (Seq::infermolc logic:
    dominant ACGTN -> DNA, else protein)."""
    if any(c in _AA_ONLY for c in seq[:1000]):
        return PROTEIN
    body = [c for c in seq[:1000].upper() if c.isalpha()]
    if not body:
        return UNKNOWN
    acgtn = sum(1 for c in body if c in "ACGTNU")
    return DNA if acgtn / len(body) > 0.75 else PROTEIN


def iter_fasta(path: str, molc: int = UNKNOWN) -> Iterator[SeqRecord]:
    """Stream records from a FASTA(.gz) file.

    The reference's extended records are honored: ";B pfqnum lstnum"
    followed by ";b pos num ..." continuation lines carries the query's
    known exon-exon junction positions (SigII, gsinfo.h:77-103); they
    land in record.meta["sig_pos"] as [(pos, num), ...] and feed the
    -yJ conserved-intron-position bonus (Cip_score)."""
    name, descr, chunks = None, "", []
    sig_pos: list = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield _make_record(name, descr, "".join(chunks), molc,
                                       sig_pos)
                head = line[1:].split(None, 1)
                name = head[0] if head else ""
                descr = head[1] if len(head) > 1 else ""
                chunks = []
                sig_pos = []
            elif line.startswith(";b"):
                toks = line[2:].split()
                for p, c in zip(toks[::2], toks[1::2]):
                    try:
                        sig_pos.append((int(p), int(c)))
                    except ValueError:
                        break
            elif line.startswith((";", "#")):
                continue
            else:
                chunks.append(line)
        if name is not None:
            yield _make_record(name, descr, "".join(chunks), molc, sig_pos)


def _make_record(name: str, descr: str, seq: str, molc: int,
                 sig_pos: list | None = None) -> SeqRecord:
    m = molc if molc != UNKNOWN else infer_molc(seq)
    codes = encode_protein(seq) if m == PROTEIN else encode_dna(seq)
    rec = SeqRecord(name=name, codes=codes, molc=m, descr=descr)
    if sig_pos:
        rec.meta["sig_pos"] = sig_pos
    return rec


def read_fasta(path: str, molc: int = UNKNOWN) -> list[SeqRecord]:
    return list(iter_fasta(path, molc))


def write_fasta(path: str, records: list[tuple[str, str]], width: int = 60):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")


def iter_genbank(path: str, molc: int = UNKNOWN) -> Iterator[SeqRecord]:
    """Stream GenBank flat-file records (Seq::get_gbseq role,
    seq.cc GenBank reader): LOCUS..ORIGIN..// sections."""
    name, descr, chunks, in_seq = None, "", [], False
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith("LOCUS"):
                toks = line.split()
                name = toks[1] if len(toks) > 1 else ""
                chunks, in_seq = [], False
            elif line.startswith("DEFINITION"):
                descr = line[10:].strip()
            elif line.startswith("ORIGIN"):
                in_seq = True
            elif line.startswith("//"):
                if name is not None:
                    yield _make_record(name, descr, "".join(chunks), molc)
                name, descr, chunks, in_seq = None, "", [], False
            elif in_seq:
                chunks.append("".join(c for c in line if c.isalpha()))


def iter_embl(path: str, molc: int = UNKNOWN) -> Iterator[SeqRecord]:
    """Stream EMBL flat-file records (ID..SQ..// sections)."""
    name, descr, chunks, in_seq = None, "", [], False
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith("ID"):
                toks = line[2:].replace(";", " ").split()
                name = toks[0] if toks else ""
                chunks, in_seq = [], False
            elif line.startswith("DE"):
                descr = (descr + " " + line[2:].strip()).strip()
            elif line.startswith("SQ"):
                in_seq = True
            elif line.startswith("//"):
                if name is not None:
                    yield _make_record(name, descr, "".join(chunks), molc)
                name, descr, chunks, in_seq = None, "", [], False
            elif in_seq:
                chunks.append("".join(c for c in line if c.isalpha()))


def iter_msf(path: str, molc: int = UNKNOWN) -> Iterator[SeqRecord]:
    """GCG MSF multiple-alignment reader (dbs.cc:178 MSF entry): header
    up to the '//' separator (member names from 'Name:' lines), then
    interleaved blocks of 'name  chunk chunk ...'.  Gap characters
    ('.', '~', '-') are stripped: SeqRecord holds encoded residues (the
    reference likewise ungaps MSF members on read for alignment use)."""
    names: list[str] = []
    seqs: dict[str, list[str]] = {}
    in_body = False
    with _open_text(path) as fh:
        for line in fh:
            if not in_body:
                ls = line.strip()
                if ls.startswith("Name:"):
                    nm = ls.split()[1]
                    if nm not in seqs:
                        names.append(nm)
                        seqs[nm] = []
                elif ls.startswith("//"):
                    in_body = True
                continue
            parts = line.split()
            if len(parts) >= 2 and parts[0] in seqs:
                seqs[parts[0]].append("".join(parts[1:]))
    for nm in names:
        s = "".join(seqs[nm])
        s = s.replace(".", "").replace("~", "").replace("-", "")
        yield _make_record(nm, "", s, molc)


def iter_seqfile(path: str, molc: int = UNKNOWN) -> Iterator[SeqRecord]:
    """Format-sniffing reader: FASTA / GenBank / EMBL / MSF (.gz
    transparent), the Seq reader dispatch role (seq.cc fasta readers +
    dbs.cc whichdb)."""
    with _open_text(path) as fh:
        first = ""
        for line in fh:
            if line.strip():
                first = line
                break
    fs = first.strip()
    if fs.startswith("LOCUS"):
        yield from iter_genbank(path, molc)
    elif "MSF:" in fs or fs.startswith(("PileUp", "!!NA_MULTIPLE",
                                        "!!AA_MULTIPLE")):
        yield from iter_msf(path, molc)
    elif fs.startswith("ID") and not fs.startswith("ID\t>"):
        yield from iter_embl(path, molc)
    else:
        yield from iter_fasta(path, molc)


def parse_seq_arg(arg: str):
    """spaln-style sequence argument: 'path [from to]' 1-based inclusive
    subrange (README.md:243 'chr1.fa 10001 40000' syntax).

    Returns (path, from0, to) with python half-open 0-based coords, or
    (path, None, None)."""
    toks = arg.split()
    if len(toks) == 3:
        try:
            return toks[0], int(toks[1]) - 1, int(toks[2])
        except ValueError:
            pass
    return arg, None, None
