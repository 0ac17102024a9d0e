"""Generator ``planted``: the queries a run sends, drawn from the run's
seed over the deployment's planted gene pool, with the parameters of the
traffic file (``benchmark/traffic/<mix>.json``).

The pool, sorted by genomic length, is cut into strata of about
``stratum_genes`` genes of near-equal size, and a pass sends one gene
from each stratum: every pass holds the pool's size mix (the longest
stratum included), so that seeds differ little in the work they send.  Each stratum is visited in an order
drawn from the seed, without repeats until its genes are spent, so a
run's passes hold different genes and the seeds cover the whole pool.
Each query carries fresh mutations and, for a locus (``flank_bp``),
fresh flanks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.builders import planted_genome as pg


@dataclass
class Query:
    name: str
    gene: dict                    # the planted gene it was drawn from
    seq: str                      # cDNA or protein letters
    chrom: int
    lo: int = 0                   # the locus handed to align: [lo, hi)
    hi: int = 0


def strata(genes: list, n: int) -> list:
    """The pool's gene indices sorted by genomic length, cut into ``n``
    strata of near-equal counts."""
    by_len = sorted(range(len(genes)),
                    key=lambda i: genes[i]["span"][1] - genes[i]["span"][0])
    return [list(s) for s in np.array_split(by_len, n)]


def n_strata(genes: list, traffic: dict) -> int:
    return max(1, round(len(genes) / traffic["stratum_genes"]))


def make_query(rng, dep, cfg: dict, traffic: dict, gi: int,
               name: str) -> Query:
    g = dep.genes[gi]
    q = cfg["query"]
    if q["kind"] == "protein":
        text = pg.mutate_protein(
            rng, g["product"], float(rng.uniform(*q["substitution_rate"])),
            int(rng.integers(q["indels"][0], q["indels"][1] + 1)))
    else:
        text = pg.mutate(rng, g["product"], q["substitution_rate"])
    lo = hi = 0
    if "flank_bp" in traffic:
        f0, f1 = traffic["flank_bp"]
        n = len(dep.chroms[g["chrom"]])
        lo = max(0, g["span"][0] - int(rng.integers(f0, f1 + 1)))
        hi = min(n, g["span"][1] + int(rng.integers(f0, f1 + 1)))
    return Query(name, g, text, g["chrom"], lo, hi)


class QueryStream:
    """The run's passes, endless."""

    def __init__(self, dep, cfg: dict, traffic: dict, seed: int):
        self.dep, self.cfg, self.traffic = dep, cfg, traffic
        self.rng = np.random.default_rng([seed % 2**63, 1])
        self.strata = strata(dep.genes, n_strata(dep.genes, traffic))
        self.orders = [self.rng.permutation(len(s)) for s in self.strata]
        self.k = self.passes = 0

    def next_pass(self) -> list:
        pick = [s[o[self.passes % len(s)]]
                for s, o in zip(self.strata, self.orders)]
        self.passes += 1
        out = []
        for j in self.rng.permutation(len(pick)):
            gi = pick[j]
            self.k += 1
            out.append(make_query(self.rng, self.dep, self.cfg, self.traffic,
                                  gi, f"{self.dep.genes[gi]['name']}_"
                                      f"{self.k}"))
        return out


def warmup_queries(dep, cfg: dict, traffic: dict, seed: int,
                   n: int = 8) -> list:
    """``n`` queries from strata evenly spaced by size, the middle gene of
    each and the pool's longest gene last, the same genes for every seed:
    set-up sends them before the window so that every kind of size the
    window sends has run once, and set-up does the same work each run."""
    rng = np.random.default_rng([seed % 2**63, 2])
    st = strata(dep.genes, n_strata(dep.genes, traffic))
    at = np.round(np.linspace(0, len(st) - 1, min(n, len(st)))).astype(int)
    pick = [st[i][len(st[i]) // 2] for i in at[:-1]] + [st[-1][-1]]
    return [make_query(rng, dep, cfg, traffic, gi, f"warm{k}")
            for k, gi in enumerate(pick)]
