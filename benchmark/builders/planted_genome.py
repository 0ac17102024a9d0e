"""Builder ``planted_genome``: a synthetic assembly with a planted gene
pool, made from the configuration's ``genome_seed``.

Genes follow the configuration's gene model, each part from a stated
source: exon counts and exon and UTR lengths log-normal with a published
median and mean, intron lengths drawn from a Frechet mixture of an
intron-length table (``intron_bp``), and the bases around each splice site
drawn from the positional base distributions of a splice-site table
(``donor``, ``acceptor``: log10 odds against ``background``).  Exon and
intron interiors are i.i.d. at their GC.  A cDNA gene's product is its
transcript (UTRs included); a protein gene's coding exons are cut from a
back-translated protein, and its product is that protein.

Frozen copies of ``chip_smoke.py``'s generators (``_gene_parts``,
``_plant``, ``_mutate``, the phase 8 protein corpus), reworked to this
model.  Nothing here imports the program: the cache holds raw FASTA and
numpy arrays, and a map entry hands the FASTA to the program's own
``index`` step.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

AMINO = "ARNDCQEGHILKMFPSTWYV"
AA_FREQ = np.array([7.805, 5.129, 4.487, 5.364, 1.925, 4.264, 6.295, 7.377,
                    2.199, 5.142, 9.019, 5.744, 2.243, 3.856, 5.203, 7.120,
                    5.841, 1.330, 3.216, 6.441])
AA_FREQ = AA_FREQ / AA_FREQ.sum()
# the standard genetic code, codons in TCAG order of each position
_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
CODONS: dict = {}
for _i, _aa in enumerate(_CODE):
    _c = "TCAG"[_i // 16] + "TCAG"[(_i // 4) % 4] + "TCAG"[_i % 4]
    CODONS.setdefault(_aa, []).append(_c)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_LUT = np.frombuffer(b"ACGT", np.uint8)


def seq(rng, n: int, gc: float) -> str:
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    return _LUT[rng.choice(4, n, p=p)].tobytes().decode()


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def mutate(rng, s: str, rate: float) -> str:
    """Substitutions at ``rate``, each to one of the three other bases."""
    a = np.frombuffer(s.encode(), np.uint8).copy()
    hit = np.flatnonzero(rng.random(len(a)) < rate)
    idx = np.searchsorted(_LUT, a[hit])
    a[hit] = _LUT[(idx + rng.integers(1, 4, len(hit))) % 4]
    return a.tobytes().decode()


def protein(rng, n: int) -> str:
    return "".join(np.array(list(AMINO))[rng.choice(20, n, p=AA_FREQ)])


def mutate_protein(rng, s: str, rate: float, n_indels: int) -> str:
    """Substitutions at ``rate`` (background residues) and ``n_indels``
    insertions or deletions of 1-10 residues at random places."""
    a = np.array(list(s))
    hit = rng.random(len(a)) < rate
    a[hit] = np.array(list(AMINO))[rng.choice(20, int(hit.sum()),
                                              p=AA_FREQ)]
    out = "".join(a)
    for _ in range(n_indels):
        k = int(rng.integers(1, 11))
        p = int(rng.integers(0, len(out)))
        if rng.random() < 0.5:
            out = out[:p] + out[p + k:]
        else:
            out = out[:p] + protein(rng, k) + out[p:]
    return out


def lognormal(rng, d: dict) -> int:
    """A length or count log-normal with median ``d["median"]`` and mean
    ``d["mean"]``, rounded and clipped to [``min``, ``max``]."""
    sigma = np.sqrt(2 * np.log(d["mean"] / d["median"]))
    x = np.exp(rng.normal(np.log(d["median"]), sigma))
    return int(np.clip(np.round(x), d["min"], d["max"]))


def intron_length(rng, d: dict) -> int:
    """An intron length from the Frechet mixture ``d["ild"]`` = (a1, mu1,
    theta1, kappa1, mu2, theta2, kappa2) (weights a1 and 1 - a1), drawn
    again until it lies in the table's observed range [``min``,
    ``max``]."""
    a1, m1, t1, k1, m2, t2, k2 = d["ild"]
    while True:
        mu, th, kk = (m1, t1, k1) if rng.random() < a1 else (m2, t2, k2)
        x = mu + th * (-np.log(rng.uniform(1e-12, 1.0))) ** (-1.0 / kk)
        if d["min"] <= x <= d["max"]:
            return int(round(x))


def site_probs(site: dict) -> np.ndarray:
    """(positions, 4) base probabilities of a splice-site window: the
    table's zero-order log10 odds over its background, each row
    normalised."""
    p = (np.asarray(site["background"]) *
         10.0 ** np.asarray(site["log10_odds"]))
    return p / p.sum(axis=1, keepdims=True)


def _site(rng, probs: np.ndarray) -> str:
    return "".join("ACGT"[rng.choice(4, p=row)] for row in probs)


def _spliced(rng, g: dict, exons: list, exonic: bool = True) -> tuple:
    """The exons joined by introns of the model, each splice site's window
    drawn from its table; with ``exonic`` the donor's first ``exon_bp``
    positions and the acceptor's last ``exon_bp`` overwrite the ends of
    the exons beside them, without it only the intronic positions are
    drawn (coding exons keep their codons): (genomic string, exon spans
    in it, the exons as placed)."""
    don, acc = site_probs(g["donor"]), site_probs(g["acceptor"])
    dx, ax = g["donor"]["exon_bp"], g["acceptor"]["exon_bp"]
    exons = list(exons)
    introns = []
    for j in range(len(exons) - 1):
        d, a = _site(rng, don), _site(rng, acc)
        if exonic:
            exons[j] = exons[j][:len(exons[j]) - dx] + d[:dx]
            exons[j + 1] = a[len(a) - ax:] + exons[j + 1][ax:]
        n = intron_length(rng, g["intron_bp"])
        head, tail = d[dx:], a[:len(a) - ax]
        introns.append(head + seq(rng, max(n - len(head) - len(tail), 0),
                                  g["intron_gc"]) + tail)
    parts, spans, at = [], [], 0
    for j, e in enumerate(exons):
        spans.append((at, at + len(e)))
        parts.append(e)
        at += len(e)
        if j < len(introns):
            parts.append(introns[j])
            at += len(introns[j])
    return "".join(parts), spans, exons


def _cdna_gene(rng, g: dict):
    """A transcript of the model's exon count and exon lengths, with UTRs
    on its first and last exons: (genomic string, exon spans, the
    transcript)."""
    n_ex = lognormal(rng, g["exons"])
    lens = [lognormal(rng, g["exon_bp"]) for _ in range(n_ex)]
    lens[0] += lognormal(rng, g["utr5_bp"])
    lens[-1] += lognormal(rng, g["utr3_bp"])
    ex = [seq(rng, n, g["exon_gc"]) for n in lens]
    genomic, spans, ex = _spliced(rng, g, ex)
    return genomic, spans, "".join(ex)


def _protein_gene(rng, g: dict):
    """Coding exons of the model's count and lengths (the last cut to
    whole codons), filled by a protein back-translated with random
    synonymous codons and a stop codon (in the last exon, as Spaln reports
    it), joined by introns whose splice-site windows are drawn in their
    intronic positions only: (genomic string, coding exon spans, the
    protein), or None where the protein would be shorter than
    ``aa_min``."""
    n_ex = lognormal(rng, g["exons"])
    lens = [lognormal(rng, g["exon_bp"]) for _ in range(n_ex)]
    total = sum(lens) - sum(lens) % 3
    n_aa = total // 3 - 1
    if n_aa < g["aa_min"]:
        return None
    lens[-1] -= sum(lens) - total
    if lens[-1] < 6:
        return None
    prot = "M" + protein(rng, n_aa - 1)
    cds = "".join(CODONS[a][int(rng.integers(len(CODONS[a])))]
                  for a in prot) + "TAA"
    cuts = np.cumsum([0] + lens)
    ex = [cds[cuts[j]:cuts[j + 1]] for j in range(n_ex)]
    genomic, spans, _ = _spliced(rng, g, ex, exonic=False)
    return genomic, spans, prot


def generate(cfg: dict) -> tuple[list[np.ndarray], list[dict]]:
    """(chromosomes as ASCII uint8 arrays, gene pool) of a configuration:
    chromosomes of the configured lengths and GC, genes planted on
    alternating strands at least ``spacing_bp`` apart.  Each gene records
    its chromosome, strand, span (0-based, half-open), exons (1-based
    inclusive forward coordinates) and its transcript or protein."""
    gcfg, pool = cfg["genome"], cfg["genes"]
    rng = np.random.default_rng(gcfg["genome_seed"])
    lens = [int(x) for x in gcfg["chromosomes_bp"]]
    if sum(lens) != cfg["genome_bp"]:
        raise ValueError(f"{cfg['name']}: chromosomes of {sum(lens)} bp, "
                         f"genome_bp {cfg['genome_bp']}")
    gc = gcfg["gc"]
    chroms = [_LUT[rng.choice(4, n, p=[(1 - gc) / 2, gc / 2, gc / 2,
                                       (1 - gc) / 2])] for n in lens]
    genes, taken = [], [[] for _ in lens]
    p_chrom = np.asarray(lens, float) / sum(lens)
    sp = pool["spacing_bp"]
    make = _protein_gene if cfg["query"]["kind"] == "protein" else _cdna_gene
    while len(genes) < cfg["n_genes"]:
        got = make(rng, pool)
        if got is None:
            continue
        g, spans, product = got
        c = int(rng.choice(len(lens), p=p_chrom))
        if lens[c] - len(g) - sp <= sp:
            continue
        pos = int(rng.integers(sp, lens[c] - len(g) - sp))
        if any(pos < b + sp and a < pos + len(g) + sp for a, b in taken[c]):
            continue
        taken[c].append((pos, pos + len(g)))
        strand = "+" if len(genes) % 2 == 0 else "-"
        if strand == "-":
            g = revcomp(g)
            spans = [(len(g) - b, len(g) - a) for a, b in spans][::-1]
        chroms[c][pos:pos + len(g)] = np.frombuffer(g.encode(), np.uint8)
        genes.append(dict(name=f"g{len(genes):04d}", chrom=c, strand=strand,
                          span=[pos, pos + len(g)],
                          exons=sorted([pos + a + 1, pos + b]
                                       for a, b in spans),
                          product=product))
    return chroms, genes


@dataclass
class Deployment:
    """A built deployment in its cache directory."""
    root: Path
    names: list
    chroms: list                  # ASCII uint8 arrays (memory-mapped)
    genes: list

    @property
    def prefix(self) -> str:
        """The program's genome database prefix (``index -p``)."""
        return str(self.root / "genome")

    @property
    def fasta(self) -> str:
        return str(self.root / "genome.fa")

    def region(self, chrom: int, lo: int, hi: int) -> bytes:
        return self.chroms[chrom][lo:hi].tobytes()


def _write_fasta(path: Path, names, arrays) -> None:
    with open(path, "wb") as fh:
        for name, arr in zip(names, arrays):
            fh.write(f">{name}\n".encode())
            body = arr.tobytes()
            for k in range(0, len(body), 80):
                fh.write(body[k:k + 80] + b"\n")


def build(cfg: dict, root: Path) -> None:
    """Writes the chromosomes, the gene pool and the FASTA into ``root``."""
    chroms, genes = generate(cfg)
    names = [f"chr{c + 1}" for c in range(len(chroms))]
    np.save(root / "genome.u8.npy", np.concatenate(chroms))
    (root / "genes.json").write_text(json.dumps(
        dict(names=names, lengths=[len(c) for c in chroms], genes=genes)))
    _write_fasta(root / "genome.fa", names, chroms)


def open_built(cfg: dict, root: Path) -> Deployment:
    meta = json.loads((root / "genes.json").read_text())
    flat = np.load(root / "genome.u8.npy")
    offs = np.concatenate([[0], np.cumsum(meta["lengths"])])
    chroms = [flat[offs[i]:offs[i + 1]] for i in range(len(meta["names"]))]
    return Deployment(root, meta["names"], chroms, meta["genes"])
