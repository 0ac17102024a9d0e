"""The system under test: the port set up as its CLI sets it up.

The program's options are command-line words, as a user gives them:
the configuration's ``cli`` list, then the traffic's, then a control's.
They are parsed by the CLI's own parser for the entry's subcommand, and
the aligner contexts are made from them by the CLI's own option
functions, so an option the CLI takes (``-A 3``, ``-y l3``, ``-L S``,
``-V``, ``-S +``) needs no change here.  Output goes through the CLI's
``OutputSink``.  What an entry calls (``align_cdna``, ``map_queries``,
...) lives in the entry's own file, ``benchmark/entries/<entry>.py``.
Of the benchmark, this module, the entries and ``benchmark.trace`` import
the program, each only when a run needs it.
"""
from __future__ import annotations

import io
import time


class System:
    """The port set up for one configuration, traffic and entry."""

    def __init__(self, cfg: dict, traffic: dict, dep, device,
                 subcommand: list, extra: tuple = ()):
        from spaln_tpu_torch import cli
        from spaln_tpu_torch.score.tables import TableDir, find_table_dir
        from spaln_tpu_torch.utils.metrics import metrics
        self.metrics = metrics
        self.cfg, self.traffic, self.dep = cfg, traffic, dep
        self.protein = cfg["query"]["kind"] == "protein"
        self.device = device
        self.words = [*cfg["cli"], *traffic.get("cli", []), *extra]
        self.args = cli.build_parser().parse_args([*subcommand,
                                                   *self.words])
        cli._join_gap_flags(self.args)
        self.tables = TableDir(find_table_dir(self.args.table_dir),
                               species=self.args.species)
        if self.protein:
            from spaln_tpu_torch.align.protein_driver import (
                ProteinAlignerContext)
            self.ctx = ProteinAlignerContext.create(
                self.tables, device, **cli._protein_options(self.args))
        else:
            from spaln_tpu_torch.align.driver import AlignerContext
            self.ctx = AlignerContext.create(self.tables, device,
                                             **cli._dna_options(self.args))
        self.buf = io.StringIO()
        self.sink = cli.OutputSink(cli._parse_fmts(self.args.fmt), self.buf)
        self.output_s = 0.0
        self.tracer = None

    def codes(self, text: str):
        from spaln_tpu_torch.seq.codec import encode_dna, encode_protein
        return (encode_protein if self.protein else encode_dna)(text)

    def emit(self, gs_list, q_len: int) -> str:
        """The answer's text through the CLI's sink, timed."""
        t0 = time.perf_counter()
        at = self.buf.tell()
        self.sink.emit(gs_list, q_len)
        t1 = time.perf_counter()
        self.output_s += t1 - t0
        if self.tracer is not None:
            self.tracer.span("output", t0, t1)
        return self.buf.getvalue()[at:]

    def skipped(self) -> int:
        return int(self.metrics.counters.get("skipped_queries", 0))
