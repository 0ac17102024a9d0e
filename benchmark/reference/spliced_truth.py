"""The plain reference of a spliced-alignment cell: each answer judged by
what it says, against the planted truth and the input sequences.

For each query of the window the program's ``-O0,4`` text is parsed and
held against the gene the query was drawn from:

- ``locus_miss_pct``: answers whose first gene line is not on the planted
  chromosome and strand, overlapping the planted span (no answer counts);
- ``exon_miss_pct``: planted exons not reported with both ends exact;
- ``exon_extra_pct``: reported exons that are not planted ones;
- ``count_faults`` (cDNA): exons whose reported matches and mismatches
  differ from a recount of the query against the genome at the reported
  coordinates, over the exons reported without gaps (on the minus strand
  the text numbers the query from its 3' end and the genome forward);
- ``text_faults``: answers whose GFF exon rows and ``-O4`` rows disagree,
  or whose gene line does not span its exons.

A key that starts with ``_`` is for the record, not a number compared:
``_counted_exons``, the exons the recount covered; ``_faults``, the first
answers at fault, each with its query's name, what is wrong and its text.

Plain Python and numpy: nothing of the program is imported.
"""
from __future__ import annotations

_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def parse(text: str) -> dict:
    """(gene lines, GFF exon rows, -O4 exon rows) of one answer's text."""
    genes, gff, tab = [], [], []
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) == 9 and f[2] == "gene":
            genes.append((f[0], int(f[3]), int(f[4]), f[6]))
        elif len(f) == 9 and f[2] == "exon":
            gff.append((int(f[3]), int(f[4])))
        elif len(f) == 14:
            tab.append(dict(chrom=f[1], strand=f[2], qs=int(f[3]),
                            qe=int(f[4]), gs=int(f[5]), ge=int(f[6]),
                            mch=int(f[8]), mmc=int(f[9]), gap=int(f[10]),
                            unp=int(f[11])))
    return dict(genes=genes, gff=gff, tab=tab)


def _recount(query: bytes, genome: bytes, strand: str) -> tuple[int, int]:
    """(matches, mismatches) of an ungapped exon: the query letters
    against the genome's, reverse-complemented on the minus strand."""
    g = genome.translate(_COMP)[::-1] if strand == "-" else genome
    mmc = sum(a != b for a, b in zip(query, g))
    return len(query) - mmc, mmc


def judge(records: list, dep, cfg: dict) -> dict:
    """The numbers compared, over ``records``: one a query of the window,
    ``{"query": the query as the generator made it (its ``seq``, its
    planted ``gene``, its ``chrom`` and the origin ``lo`` of its text's
    coordinates), "text": the program's text}``.  ``dep`` gives the
    chromosomes' ``names`` and ``region(chrom, a, b)``, the genome's
    letters [a, b) of a chromosome; ``cfg`` the configuration (its
    ``query`` ``kind``)."""
    protein = cfg["query"]["kind"] == "protein"
    region = dep.region
    miss = n_true = n_rep = tp = counted = count_bad = text_bad = 0
    faults = []

    def fault(a, what):
        if len(faults) < 5:
            faults.append(dict(name=a.get("name"), lo=a["lo"], what=what,
                               text=a["text"]))
    for rec in records:
        a = dict(rec["query"], text=rec["text"])
        g, lo = a["gene"], a["lo"]
        p = parse(a["text"])
        first = p["genes"][0] if p["genes"] else None
        if not (first and first[0] == dep.names[g["chrom"]]
                and first[3] == g["strand"]
                and first[1] + lo <= g["span"][1]
                and first[2] + lo > g["span"][0]):
            miss += 1
            fault(a, "locus")
        truth = {(s, e) for s, e in g["exons"]}
        rep = {(r["gs"] + lo, r["ge"] + lo) for r in p["tab"]}
        tp += len(truth & rep)
        n_true += len(truth)
        n_rep += len(rep)
        if (sorted(p["gff"]) != sorted((r["gs"], r["ge"]) for r in p["tab"])
                or (p["tab"] and first and (
                    first[1] != min(r["gs"] for r in p["tab"])
                    or first[2] != max(r["ge"] for r in p["tab"])))
                or (p["tab"] and not p["genes"])):
            text_bad += 1
            fault(a, "text")
        if protein:
            continue
        q = a["seq"].encode()
        chrom = g["chrom"]
        for r in p["tab"]:
            qn, gn = r["qe"] - r["qs"] + 1, r["ge"] - r["gs"] + 1
            if r["gap"] or r["unp"] or qn != gn or qn <= 0:
                continue
            counted += 1
            # a minus-strand answer numbers the query from its 3' end
            qs, qe = ((len(q) - r["qe"] + 1, len(q) - r["qs"] + 1)
                      if r["strand"] == "-" else (r["qs"], r["qe"]))
            got = _recount(q[qs - 1:qe],
                           region(chrom, r["gs"] - 1 + lo, r["ge"] + lo),
                           r["strand"])
            if got != (r["mch"], r["mmc"]):
                count_bad += 1
                fault(a, f"count: exon {r}, recount {got}")
    n = max(len(records), 1)
    out = dict(locus_miss_pct=100.0 * miss / n,
               exon_miss_pct=100.0 * (1 - tp / max(n_true, 1)),
               exon_extra_pct=100.0 * (1 - tp / max(n_rep, 1)),
               text_faults=text_bad, _faults=faults)
    if not protein:
        out["count_faults"] = count_bad
        out["_counted_exons"] = counted
    return out
