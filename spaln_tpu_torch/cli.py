"""Command-line interface of the port.

  python -m spaln_tpu_torch.cli index <genome.fa>            build the
        genome store + block index for nucleotide queries (-K D)
  python -m spaln_tpu_torch.cli map <cdna.fa> -d <genome>    map cDNA
        queries onto the indexed genome (spaln -Q7), the DP on --device

Same options and output as spaln_tpu.cli for this path, plus --device
{cuda,cpu} (default cuda; asking for cuda without a GPU is an error).
Output formats -O#[,#2,..]: 0 GFF3 gene, 1 alignment text, 2 GFF3
match, 3 BED12, 4 exon table, 5 intron table, 6 recovered cDNA,
7 translated protein, 10 SAM, 12 binary shard (.grd.npz), 15 unique
introns.  What is not ported yet raises NotImplementedError naming the
ROADMAP.md item that will port it.
"""
from __future__ import annotations

import argparse
import sys

import torch

from .align.driver import AlignerContext
from .constants import DNA, PROTEIN
from .out.formats import (alignment_lines, bed_line, cdna_fasta,
                          exon_table_lines, gff3_lines, gff3_match_lines,
                          intron_lines, sam_line, translated_fasta)
from .score.tables import TableDir, find_table_dir
from .seq.fasta import iter_seqfile
from .seq.genome import GenomeStore

UNPORTED = {
    "align": "ROADMAP.md Queue 1, item 7 (the align subcommand with its "
             "long-intron split and linear-space fallback)",
    "search": "ROADMAP.md Queue 1, item 9 (protein-DB search)",
    "sortgrcd": "ROADMAP.md Queue 1, item 10 (remaining subcommands)",
    "pair": "ROADMAP.md Queue 1, item 9 (protein-DB search)",
    "ild": "ROADMAP.md Queue 1, item 10 (tools)",
    "seq": "ROADMAP.md Queue 1, item 10 (tools)",
}


def _lcl_local(args) -> bool:
    """-L value -> SW-local flag (spaln.cc:361-379: S/16 = local)."""
    v = getattr(args, "lcl", None)
    if v is None:
        return False
    if v.isdigit():
        return bool(int(v) & 16)
    return v.upper().startswith("S")


class OutputSink:
    """Multi-format writer (AlnOutModes role, aln.h:312-333): one pass
    over results feeds every requested -O form; -O12 shards collect in
    memory and flush as one .grd.npz per run."""

    def __init__(self, fmts: list[int], out, grd_path: str = "run"):
        self.fmts = fmts
        self.out = out
        self.gene_id = 1
        self.grd_path = grd_path
        self.bin_records = []
        self.q_lens = {}
        if 0 in fmts or 2 in fmts:
            out.write("##gff-version 3\n")

    def emit(self, gs_list, q_len: int) -> None:
        w = self.out.write
        for gs in gs_list:
            for fmt in self.fmts:
                if fmt == 0:
                    w("\n".join(gff3_lines(gs, q_len=q_len,
                                           gene_id=self.gene_id)) + "\n")
                elif fmt == 1:
                    w("\n".join(alignment_lines(gs)) + "\n")
                elif fmt == 2:
                    w("\n".join(gff3_match_lines(
                        gs, q_len=q_len, gene_id=self.gene_id)) + "\n")
                elif fmt == 3:
                    w(bed_line(gs) + "\n")
                elif fmt == 4:
                    w("\n".join(exon_table_lines(gs, q_len=q_len)) + "\n")
                elif fmt == 5:
                    lines = intron_lines(gs)
                    if lines:
                        w("\n".join(lines) + "\n")
                elif fmt == 6:
                    w("\n".join(cdna_fasta(gs)) + "\n")
                elif fmt == 7:
                    w("\n".join(translated_fasta(gs)) + "\n")
                elif fmt == 10:
                    w(sam_line(gs, q_len=q_len) + "\n")
                elif fmt in (12, 15):
                    pass                   # collected below
                else:
                    raise SystemExit(f"unsupported output format -O{fmt}")
            if 12 in self.fmts or 15 in self.fmts:
                self.bin_records.append(gs)
                self.q_lens[gs.q_name] = q_len
            self.gene_id += 1

    def close(self) -> None:
        if 12 in self.fmts and self.bin_records:
            from .out.sortgrcd import write_grd
            write_grd(self.grd_path + ".grd.npz", self.bin_records,
                      self.q_lens)
            print(f"binary shard -> {self.grd_path}.grd.npz",
                  file=sys.stderr)
        if 15 in self.fmts:
            from .out.sortgrcd import unique_introns
            for row in unique_introns(self.bin_records):
                self.out.write("\t".join(map(str, row)) + "\n")


def _parse_fmts(s) -> list[int]:
    return [int(x) for x in str(s).split(",")]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(use --device cpu to run the plain versions)")
    return torch.device(name)


def cmd_index(args) -> int:
    from .seed.blockindex import BlockIndex
    if set(args.kind.upper()) - {"D"}:
        raise NotImplementedError(
            "the protein index (-K P) is not ported yet: ROADMAP.md "
            "Queue 1, item 8 (protein path)")
    store = GenomeStore.from_fasta(args.genome, molc=DNA)
    prefix = args.prefix or args.genome.rsplit(".", 1)[0]
    store.save(prefix)
    BlockIndex.build(store).save(prefix)
    print(f"indexed {store.n_contigs} contigs, {store.total_len} "
          f"bases -> {prefix}.bkn.npz", file=sys.stderr)
    return 0


def cmd_map(args) -> int:
    from .seed.blockindex import BlockIndex
    from .align.mapper import GenomeMapper
    if _lcl_local(args):
        raise NotImplementedError(
            "local alignment (-L S) is not ported yet: ROADMAP.md Queue 1, "
            "item 9 (local mode, K6)")
    for flag, letter in (("u_pen", "u"), ("v_pen", "v"), ("w_band", "w")):
        v = getattr(args, flag, None)
        if v is not None:
            args.y_args.append(f"{letter}{v}")
    if any(a.startswith("J") for a in args.y_args):
        raise NotImplementedError(
            "the -yJ conserved intron-position bonus is not ported yet: "
            "ROADMAP.md Queue 1, item 9 (cip mode, K6)")
    device = _device(args.device)
    store = GenomeStore.load(args.genome_db)
    tables = TableDir(find_table_dir(args.table_dir), species=args.species)
    out = open(args.output, "w") if args.output else sys.stdout
    fmts = _parse_fmts(args.fmt)
    if 10 in fmts:
        # SAM @SQ headers (put_genome_entries, spaln.cc:1209-1218)
        for name, ln in zip(store.names, store.lengths):
            out.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
    sink = OutputSink(fmts, out,
                      grd_path=(args.output or "run").rsplit(".", 1)[0])
    mapper = None
    batch: list = []
    bs = max(args.batch, 1)

    def flush():
        nonlocal mapper
        if not batch:
            return
        if mapper is None:
            mapper = GenomeMapper(
                store, BlockIndex.load(args.genome_db),
                AlignerContext.create(
                    tables, device,
                    y_args=["-y" + a for a in args.y_args]))
        # queries carrying SigII junction records (;B/;b) would get the
        # conserved-intron-position bonus SpbFact*num at those rows
        if mapper.ctx.cfg.aln2.spb > 0 and any("sig_pos" in r.meta
                                                for r in batch):
            raise NotImplementedError(
                "queries with junction records (the -yJ conserved intron-"
                "position bonus) are not ported yet: ROADMAP.md Queue 1, "
                "item 9 (cip mode, K6)")
        res = mapper.map_queries([r.codes for r in batch],
                                 q_names=[r.name for r in batch],
                                 strand=args.strand, lanes=args.lanes,
                                 max_out=args.max_out, max_batch=bs)
        for rec, gs_list in zip(batch, res):
            sink.emit(gs_list, len(rec.codes))
        batch.clear()

    for rec in iter_seqfile(args.queries):
        if rec.molc == PROTEIN:
            raise NotImplementedError(
                f"protein query {rec.name!r}: protein mapping is not "
                f"ported yet: ROADMAP.md Queue 1, item 8 (protein path)")
        batch.append(rec)
        if len(batch) >= 4 * bs:
            flush()
    flush()
    sink.close()
    if args.output:
        out.close()
    return 0


def _unported(args) -> int:
    raise NotImplementedError(
        f"the {args.cmd} subcommand is not ported yet: {UNPORTED[args.cmd]}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spaln_tpu_torch",
        description="spliced aligner, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("index", help="format genome + build block index")
    sp.add_argument("genome")
    sp.add_argument("-p", dest="prefix", default=None)
    sp.add_argument("-K", dest="kind", default="D",
                    help="index kind: D = nt queries (.bkn)")
    sp.set_defaults(func=cmd_index)

    sp = sub.add_parser("map", help="map cDNA queries onto an indexed "
                                    "genome")
    sp.add_argument("queries")
    sp.add_argument("-d", dest="genome_db", required=True)
    sp.add_argument("-M", dest="max_out", type=int, default=1,
                    help="report up to M loci per query (paralogs)")
    sp.add_argument("--batch", type=int, default=32,
                    help="queries per device launch")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the DP runs: cuda = the CUDA kernels "
                         "(default), cpu = their plain PyTorch versions")
    sp.add_argument("-O", dest="fmt", default="0",
                    help="output format(s), comma-separated: 0 gff3 "
                         "gene, 1 alignment, 2 gff3 match, 3 bed, "
                         "4 exon, 5 intron, 6 cDNA, 7 translated, "
                         "10 sam, 12 binary, 15 unique introns")
    sp.add_argument("-T", dest="species", default=None,
                    help="species/clade parameter set")
    sp.add_argument("-S", dest="strand", default="auto",
                    choices=["auto", "+", "-"])
    sp.add_argument("-t", dest="table_dir", default=None)
    sp.add_argument("-o", dest="output", default=None)
    sp.add_argument("--lanes", type=int, default=128)
    sp.add_argument("--metrics", action="store_true",
                    help="print per-stage counters/timings to stderr")
    sp.add_argument("-y", dest="y_args", action="append", default=[],
                    help="alignment parameter (readalprm letters), "
                         "e.g. -y w150")
    sp.add_argument("-L", dest="lcl", default=None,
                    help="end-gap mode (spaln -L); default 15 "
                         "(semi-global)")
    sp.add_argument("-Q", dest="qlevel", type=int, default=7,
                    help="algorithm level (spaln -Q); map always uses "
                         "the block index")
    sp.add_argument("-u", dest="u_pen", default=None,
                    help="gap-extension penalty (alprm.u)")
    sp.add_argument("-v", dest="v_pen", default=None,
                    help="gap-open penalty (alprm.v)")
    sp.add_argument("-w", dest="w_band", default=None,
                    help="band width sh (alprm.sh)")
    sp.add_argument("-p", dest="p_flags", action="append", default=[],
                    help="output subflags; q (quiet) accepted for "
                         "reference command-line compatibility")
    sp.set_defaults(func=cmd_map)

    for name in UNPORTED:
        sp = sub.add_parser(name, help=f"not ported yet ({UNPORTED[name]})")
        sp.add_argument("rest", nargs=argparse.REMAINDER)
        sp.set_defaults(func=_unported)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = args.func(args)
    if getattr(args, "metrics", False):
        from .utils.metrics import metrics
        print(metrics.report(), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
