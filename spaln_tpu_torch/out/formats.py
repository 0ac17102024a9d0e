"""Alignment output writers.

The role of sqpr.cc:130-1331: render GeneStructure records as GFF3 gene
models, exon/intron tables, SAM, CIGAR — the spaln -O output family.
Genome coordinates are converted to 1-based contig space by the caller
supplying ``g_off`` (window offset) and contig name.
"""
from __future__ import annotations

from ..align.gene import GeneStructure

_GFF_SRC = "spaln_tpu"


def gff3_lines(gs: GeneStructure, g_off: int = 0, q_len: int = 0,
               gene_id: int = 1) -> list[str]:
    """GFF3 gene/mRNA/exon records (Gff3Form semantics)."""
    g0, g1 = gs.g_span
    gid = f"gene{gene_id:05d}"
    mid = f"mRNA{gene_id:05d}"
    sc = gs.score / gs.scale
    lines = [
        "\t".join([gs.g_name, _GFF_SRC, "gene", str(g_off + g0 + 1),
                   str(g_off + g1), f"{sc:.1f}", gs.strand, ".",
                   f"ID={gid};Name={gs.q_name}"]),
        "\t".join([gs.g_name, _GFF_SRC, "mRNA", str(g_off + g0 + 1),
                   str(g_off + g1), f"{sc:.1f}", gs.strand, ".",
                   f"ID={mid};Parent={gid};Name={gs.q_name}"]),
    ]
    for i, e in enumerate(gs.exons, 1):
        attrs = (f"ID={mid}.e{i};Parent={mid};Target={gs.q_name} "
                 f"{e.q_start + 1} {e.q_end}")
        lines.append("\t".join(
            [gs.g_name, _GFF_SRC, "exon", str(g_off + e.g_start + 1),
             str(g_off + e.g_end), f"{e.identity * 100:.1f}", gs.strand,
             ".", attrs]))
    return lines


def exon_table_lines(gs: GeneStructure, g_off: int = 0,
                     q_len: int = 0) -> list[str]:
    """Per-exon stats table (ExonForm, -O4 style)."""
    lines = []
    for e in gs.exons:
        lines.append("\t".join(map(str, [
            gs.q_name, gs.g_name, gs.strand,
            e.q_start + 1, e.q_end,
            g_off + e.g_start + 1, g_off + e.g_end,
            f"{e.identity * 100:.2f}",
            e.mch, e.mmc, e.gap, e.unp,
            e.sig3 / gs.scale, e.sig5 / gs.scale,
        ])))
    return lines


def intron_lines(gs: GeneStructure, g_off: int = 0) -> list[str]:
    """Intron records (IntronForm, -O6 style)."""
    lines = []
    for i in gs.introns:
        lines.append("\t".join(map(str, [
            gs.q_name, gs.g_name, gs.strand,
            g_off + i.g_start + 1, g_off + i.g_end, i.length,
            i.q_pos, f"{i.sig5 / gs.scale:.1f}", f"{i.sig3 / gs.scale:.1f}",
            "canonical" if i.canonical else "noncanonical",
        ])))
    return lines


def sam_line(gs: GeneStructure, g_off: int = 0, q_len: int = 0,
             seq: str = "*") -> str:
    """Minimal SAM alignment line (SamForm, -O15/-O3 style)."""
    flag = 0 if gs.strand == "+" else 16
    g0, _ = gs.g_span
    mapq = min(60, max(1, int(gs.score / gs.scale / 10)))
    return "\t".join(map(str, [
        gs.q_name, flag, gs.g_name, g_off + g0 + 1, mapq,
        gs.cigar(), "*", 0, 0, seq, "*",
        f"AS:i:{int(gs.score / gs.scale)}",
        f"NM:i:{sum(e.mmc + e.unp for e in gs.exons)}",
    ]))


def _gap_attr(gs: GeneStructure, e) -> str:
    """Per-exon pairwise-alignment Gap= op string (Gff3PWA,
    sqpr.cc:599-632): M/I/D runs, with R/F frameshift remainders on the
    protein path.  M counts are query units (aa for protein)."""
    v = gs.view
    if v is None or not v.ops:
        return ""
    toks: list[str] = []
    run_sym = None
    run_len = 0

    def flush():
        nonlocal run_sym, run_len
        if run_sym is not None and run_len:
            toks.append(f"{run_sym}{run_len}")
        run_sym, run_len = None, 0

    def push(sym, k=1):
        nonlocal run_sym, run_len
        if sym != run_sym:
            flush()
            run_sym = sym
        run_len += k

    # exon bounds in the view's (local) coordinates; '-' results were
    # flipped to forward order after the view snapshot, so the view
    # index runs backwards there
    ix = gs.exons.index(e)
    if gs.strand == "-":
        ix = len(gs.exons) - 1 - ix
    if ix >= len(v.exons):
        return ""
    lg0, lg1 = v.exons[ix][2], v.exons[ix][3]
    aa = v.q_is_aa
    for op in v.ops:
        kind = op[0]
        if kind == 'I':
            continue
        n = op[2]
        if not (lg0 < n <= lg1):
            continue
        if aa:
            if kind == 'D':
                push('M')
            elif kind == 'F':
                s = op[3]
                flush()
                toks.append("I1" if s == 0 else f"R{s}")
            else:                        # 'E': genome-only w nt
                w = op[3]
                flush()
                toks.append(f"D{w // 3}" if w % 3 == 0 else f"F{w}")
        else:
            push({'D': 'M', 'E': 'D', 'F': 'I'}[kind])
    flush()
    return ";Gap=" + " ".join(toks) if toks else ""


def gff3_match_lines(gs: GeneStructure, g_off: int = 0, q_len: int = 0,
                     gene_id: int = 1) -> list[str]:
    """GFF3 match/match_part records with pairwise-alignment Gap
    attributes (Gff3PWA, -O2; sqpr.cc:558-640)."""
    g0, g1 = gs.g_span
    mid = f"match{gene_id:05d}"
    sc = gs.score / gs.scale
    kind = ("nucleotide_to_protein_match" if (gs.view and gs.view.q_is_aa)
            else "cDNA_match")
    lines = ["\t".join([gs.g_name, _GFF_SRC, kind, str(g_off + g0 + 1),
                        str(g_off + g1), f"{sc:.1f}", gs.strand, ".",
                        f"ID={mid};Name={gs.q_name}"])]
    for e in gs.exons:
        attrs = (f"ID={mid};Target={gs.q_name} {e.q_start + 1} "
                 f"{e.q_end}" + _gap_attr(gs, e))
        lines.append("\t".join(
            [gs.g_name, _GFF_SRC, "match_part",
             str(g_off + e.g_start + 1), str(g_off + e.g_end),
             f"{e.identity * 100:.1f}", gs.strand, ".", attrs]))
    return lines


def bed_line(gs: GeneStructure, g_off: int = 0) -> str:
    """BED12 gene line (BedForm, -O3)."""
    g0, g1 = gs.g_span
    starts = [e.g_start - g0 for e in gs.exons]
    sizes = [e.g_len for e in gs.exons]
    score = min(1000, max(0, int(gs.score / gs.scale)))
    return "\t".join(map(str, [
        gs.g_name, g_off + g0, g_off + g1, gs.q_name, score, gs.strand,
        g_off + g0, g_off + g1, "0",
        len(gs.exons),
        ",".join(map(str, sizes)) + ",",
        ",".join(map(str, starts)) + ",",
    ]))


def cdna_fasta(gs: GeneStructure, width: int = 60) -> list[str]:
    """Recovered spliced transcript sequence (-O6 cDNA form)."""
    from ..seq.codec import decode_dna
    v = gs.view
    if v is None:
        return []
    seq = "".join(decode_dna(v.g[g0:g1]) for _, _, g0, g1 in v.exons)
    head = (f">{gs.q_name} {gs.g_name} {gs.strand} "
            f"{gs.g_span[0] + 1} {gs.g_span[1]}")
    return [head] + [seq[i:i + width] for i in range(0, len(seq), width)]


def translated_fasta(gs: GeneStructure, width: int = 60) -> list[str]:
    """Translated gene product (-O7): translation of the recovered
    transcript in the frame implied by the alignment."""
    from ..seq.codec import decode_protein, translate
    import numpy as np
    v = gs.view
    if v is None:
        return []
    spliced = np.concatenate([v.g[g0:g1] for _, _, g0, g1 in v.exons])
    if v.q_is_aa:
        # alignment consumed whole codons from the first exon start
        aa = translate(spliced, 0)
    else:
        aa = translate(spliced, 0)
    head = (f">{gs.q_name} {gs.g_name} {gs.strand} translated")
    s = decode_protein(aa)
    return [head] + [s[i:i + width] for i in range(0, len(s), width)]


def _dec(codes, is_aa):
    from ..seq.codec import decode_dna, decode_protein
    return decode_protein(codes) if is_aa else decode_dna(codes)


def alignment_lines(gs: GeneStructure, width: int = 60) -> list[str]:
    """Pretty pairwise alignment (print2 role, -O1), rendered from the
    exact traceback op stream.

    cDNA: query vs genome nt with a match line; introns elided to a
    length marker.  Protein: query aa over the translation of each
    aligned genome codon; frameshift slips render as '!'.
    """
    v = gs.view
    if v is None or not v.ops:
        return []
    is_aa = v.q_is_aa
    from ..seq.codec import translate
    qrow: list[str] = []
    grow: list[str] = []

    def qc(m):
        return _dec(v.q[m - 1:m], is_aa)

    for op in v.ops:
        kind = op[0]
        if kind == 'D':
            m, n = op[1], op[2]
            qrow.append(qc(m))
            if is_aa and not v.g_is_aa:
                grow.append(_dec(translate(v.g[n - 3:n], 0), True))
            else:
                grow.append(_dec(v.g[n - 1:n], v.g_is_aa))
        elif kind == 'E':
            if is_aa and not v.g_is_aa:
                _, m, n, w = op
                qrow.append("-" * ((w + 2) // 3 or 1))
                grow.append(_dec(translate(v.g[n - w:n], 0), True)
                            if w == 3 else "!" * ((w + 2) // 3 or 1))
            else:
                _, m, n = op
                qrow.append("-")
                grow.append(_dec(v.g[n - 1:n], v.g_is_aa))
        elif kind == 'F':
            if is_aa and not v.g_is_aa:
                _, m, n, s = op
                qrow.append(qc(m))
                grow.append("-" if s == 0 else "!")
            else:
                _, m, n = op
                qrow.append(qc(m))
                grow.append("-")
        elif kind == 'I':
            if is_aa and not v.g_is_aa:
                _, m, n5, n3, phs = op
                ilen = n3 - n5
            else:
                _, m, n5, n3 = op
                ilen = n3 - n5
            marker = f"...{ilen}nt..."
            qrow.append(marker)
            grow.append(marker)
    qs = "".join(qrow)
    gt = "".join(grow)
    match = "".join("|" if a == b and a not in "-.! " else " "
                    for a, b in zip(qs, gt))
    out = [f"{gs.q_name} x {gs.g_name} {gs.strand}  score "
           f"{gs.score / gs.scale:.1f}"]
    for i in range(0, len(qs), width):
        out.append(f"Q {qs[i:i + width]}")
        out.append(f"  {match[i:i + width]}")
        out.append(f"G {gt[i:i + width]}")
        out.append("")
    return out


def sugar_line(gs: GeneStructure) -> str:
    """Exonerate SUGAR line (-O2 AvsA form)."""
    q0, q1 = gs.q_span
    s0, s1 = gs.g_span
    return (f"sugar: {gs.q_name} {q0} {q1} + {gs.g_name} {s0} {s1} "
            f"{gs.strand} {int(gs.score / gs.scale)}")


def psl_line(gs: GeneStructure, q_len: int = 0, t_len: int = 0) -> str:
    """UCSC PSL 21-column line (-O3 AvsA / PslForm)."""
    mch = gs.n_matches
    mmc = sum(e.mmc for e in gs.exons)
    qgap = sum(max(b.q_start - a.q_end, 0)
               for a, b in zip(gs.exons, gs.exons[1:]))
    tgap = sum(max(b.g_start - a.g_end, 0)
               for a, b in zip(gs.exons, gs.exons[1:]))
    q0, q1 = gs.q_span
    t0, t1 = gs.g_span
    sizes = ",".join(str(min(e.q_len, e.g_len)) for e in gs.exons) + ","
    qst = ",".join(str(e.q_start) for e in gs.exons) + ","
    tst = ",".join(str(e.g_start) for e in gs.exons) + ","
    return "\t".join(map(str, [
        mch, mmc, 0, 0, len(gs.exons) - 1, qgap, len(gs.exons) - 1, tgap,
        gs.strand, gs.q_name, q_len or q1, q0, q1,
        gs.g_name, t_len or t1, t0, t1, len(gs.exons), sizes, qst, tst]))


def hit_stat_line(hit) -> str:
    """AvsA -O0 statistics line: query subject score span identity."""
    return "\t".join(map(str, [
        hit.name, int(hit.score / 10), hit.q_span[0] + 1, hit.q_span[1],
        hit.s_span[0] + 1, hit.s_span[1], f"{hit.identity * 100:.1f}"]))


# ------------------------------------------------- repalninf stat forms
# The reference's alignment-info report family (Gsinfo::repalninf0-6,
# sqpr.cc:130-330), used by -O modes on non-gene alignments.  Segments
# come from the traceback op stream (the SKL-vertex equivalent).

def _xyl_segments(gs: GeneStructure) -> list[tuple[int, int, int]]:
    """Maximal diagonal runs as (q_start_1based, g_start_1based, len)."""
    segs = []
    ops = gs.view.ops if gs.view is not None else []
    run = None
    for op in ops:
        if op[0] == 'D':
            m, n = op[1], op[2]
            if run is not None and m == run[0] + run[2] \
                    and n == run[1] + run[2]:
                run = (run[0], run[1], run[2] + 1)
            else:
                if run is not None:
                    segs.append(run)
                run = (m, n, 1)
        else:
            if run is not None:
                segs.append(run)
            run = None
    if run is not None:
        segs.append(run)
    return segs


def stat_line(gs: GeneStructure, q_name: str = "", scale: int = 10
              ) -> str:
    """repalninf0: one statistics line (score, spans, strands, names)."""
    mch = sum(e.mch for e in gs.exons)
    mmc = sum(e.mmc for e in gs.exons)
    gap = sum(e.gap for e in gs.exons)
    unp = sum(e.unp for e in gs.exons)
    q0, q1 = gs.q_span
    g0, g1 = gs.g_span
    return (f"{mch}\t{mmc}\t{gap}\t{unp}\t{gs.score / scale:6.1f}\t"
            f"{q0 + 1} {q1} +\t{g0 + 1} {g1} {gs.strand}\t"
            f"{q_name or gs.q_name}\t{gs.g_name}")


def skl_lines(gs: GeneStructure, scale: int = 10) -> list[str]:
    """repalninf1: 2-line classic SKL format (vertex list)."""
    segs = _xyl_segments(gs)
    verts: list[tuple[int, int]] = []
    for q0, g0, ln in segs:
        for pt in ((q0, g0), (q0 + ln - 1, g0 + ln - 1)):
            if not verts or verts[-1] != pt:
                verts.append(pt)
    head = (f"{gs.q_name} {gs.g_name}  {len(verts)}  "
            f"{gs.score / scale:.2f}")
    return [head, " ".join(f"{m} {n}" for m, n in verts)]


def xyl_line(gs: GeneStructure, scale: int = 10) -> str:
    """repalninf4: 1-line compact XYL (x, y, len)*n."""
    q0, q1 = gs.q_span
    g0, g1 = gs.g_span
    body = " ".join(f" {m} {n} {ln}".strip()
                    for m, n, ln in _xyl_segments(gs))
    return (f"XYL: {gs.q_name} {q0 + 1} {q1} + {gs.g_name} {g0 + 1} "
            f"{g1} {gs.strand} {gs.score / scale:.1f} : {body}")


def xyl2_lines(gs: GeneStructure, scale: int = 10) -> list[str]:
    """repalninf6: 2-line XYL with identity/stat header."""
    mch = sum(e.mch for e in gs.exons)
    mmc = sum(e.mmc for e in gs.exons)
    gap = sum(e.gap for e in gs.exons)
    unp = sum(e.unp for e in gs.exons)
    q0, q1 = gs.q_span
    g0, g1 = gs.g_span
    denom = max(mch + mmc + gap, 1)
    segs = _xyl_segments(gs)
    head = (f"XYL2: {gs.q_name} {q0 + 1} {q1} + {gs.g_name} {g0 + 1} "
            f"{g1} {gs.strand} {gs.score / scale:7.1f} "
            f"{100. * mch / denom:6.2f} {mch} {mmc} {gap} {unp} "
            f"{len(segs)}")
    return [head,
            " ".join(f"{m} {n} {ln}" for m, n, ln in segs)]


def boundary_line(gs: GeneStructure) -> str:
    """repalninf5: 1-line exon-boundary list (genome coordinates)."""
    pts = []
    for e in gs.exons:
        pts.extend((e.g_start + 1, e.g_end))
    return f"{gs.g_name} " + " ".join(map(str, pts))
