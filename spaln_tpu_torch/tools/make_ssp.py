"""Species-specific parameter generation (make_eij.pl / make_ssp.pl role).

From a genome plus a set of confirmed introns (e.g. from mapping a
transcript set with the mapper and collecting unique introns), derive the
full species parameter set (makessp.md:44-75):

  Splice5 / Splice3     donor / acceptor PSSMs        (npssm role)
  AlnParam -yI line     Frechet-mixture intron-length model (fitild role)
  IntronPotTab          intron oligomer potential     (exinpot role)
  CodePotTab            coding potential from CDS set (optional)

All written into a table directory loadable via TableDir(species=...).
The intron-length fit runs on ``device`` (fit_ild); the rest is numpy.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..seq.genome import GenomeStore
from .exinpot import build_codepot, build_exinpot, write_codepot, \
    write_exinpot
from .fitild import fit_ild
from .kmers import count_kmers
from .npssm import build_pssm, write_pssm

# window geometry of the default Splice5/Splice3 tables
# (table/Dictyost/Splice5: cols=8 offset=1; Splice3: cols up to 33)
DON_LEFT, DON_RIGHT = 1, 7        # exon 1 nt | intron 7 nt
ACC_LEFT, ACC_RIGHT = 23, 2       # intron 23 nt | exon 2 nt


def collect_junction_windows(store: GenomeStore,
                             introns: list[tuple],
                             morder: int = 2):
    """Per-intron donor/acceptor windows from forward-strand coords.

    introns: (chrom, strand, g_start, g_end) tuples (unique_introns rows).
    """
    from ..seq.codec import comrev
    dons, accs = [], []
    for row in introns:
        chrom, strand, g0, g1 = row[:4]
        ci = store.names.index(chrom)
        base = int(store.offsets[ci])
        lo = base + g0 - (DON_LEFT + ACC_LEFT + 4)
        hi = base + g1 + (DON_LEFT + ACC_LEFT + 4)
        if lo < 0 or hi > len(store.codes):
            continue
        seg = np.asarray(store.codes[lo:hi])
        d0 = base + g0 - lo
        a0 = base + g1 - lo
        if strand == "-":
            seg = comrev(seg)
            d0, a0 = len(seg) - a0, len(seg) - d0
        dw = seg[d0 - DON_LEFT:d0 + DON_RIGHT + morder]
        aw = seg[a0 - ACC_LEFT:a0 + ACC_RIGHT + morder]
        if len(dw) == DON_LEFT + DON_RIGHT + morder:
            dons.append(dw)
        if len(aw) == ACC_LEFT + ACC_RIGHT + morder:
            accs.append(aw)
    return dons, accs


def collect_intron_seqs(store: GenomeStore, introns: list[tuple],
                        max_n: int = 20000) -> list[np.ndarray]:
    from ..seq.codec import comrev
    out = []
    for row in introns[:max_n]:
        chrom, strand, g0, g1 = row[:4]
        ci = store.names.index(chrom)
        base = int(store.offsets[ci])
        seg = np.asarray(store.codes[base + g0:base + g1])
        if strand == "-":
            seg = comrev(seg)
        out.append(seg)
    return out


def make_ssp(dest_dir: str, store: GenomeStore, introns: list[tuple],
             cds_seqs: list[np.ndarray] | None = None,
             n_modes: int = 2, morder: int = 2,
             fit_steps: int = 3000,
             device: torch.device | str = "cuda") -> dict:
    """Generate the species parameter files; returns a summary dict.
    The AlnParam -yI line comes from fit_ild on ``device``."""
    os.makedirs(dest_dir, exist_ok=True)
    genome = [np.asarray(store.codes)]
    bg1 = count_kmers(genome, 1)
    bg2 = count_kmers(genome, 2)
    bg3 = count_kmers(genome, 3)

    dons, accs = collect_junction_windows(store, introns, morder)
    p5 = build_pssm(dons, DON_LEFT, bg1, bg2, bg3, morder=morder)
    p3 = build_pssm(accs, ACC_LEFT, bg1, bg2, bg3, morder=morder)
    write_pssm(os.path.join(dest_dir, "Splice5"), p5)
    write_pssm(os.path.join(dest_dir, "Splice3"), p3)

    lens = np.asarray([r[3] - r[2] for r in introns], dtype=np.float64)
    fit = fit_ild(lens, n_modes=n_modes, steps=fit_steps, device=device)
    with open(os.path.join(dest_dir, "AlnParam"), "w") as fh:
        fh.write(f"-yI\"{fit.yI_line()}\"\n")

    iseqs = collect_intron_seqs(store, introns)
    ipot = build_exinpot(iseqs, genome, morder=4)
    write_exinpot(os.path.join(dest_dir, "IntronPotTab"), ipot,
                  nsupport=len(iseqs),
                  avlen=float(lens.mean()) if len(lens) else 0.)

    if cds_seqs:
        cpot = build_codepot(cds_seqs, genome, morder=5)
        write_codepot(os.path.join(dest_dir, "CodePotTab"), cpot)
    return {"n_donor": len(dons), "n_accept": len(accs),
            "ild": fit, "files": sorted(os.listdir(dest_dir))}
