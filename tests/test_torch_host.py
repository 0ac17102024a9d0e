"""Host state of the port against spaln_tpu: the intron-length penalty
(its float32 log tail over all 1<<20 cached lengths), DpParams carried
over by params_from_reference, and splice signals.  Integer results,
tolerance 0."""
import dataclasses

import numpy as np
import pytest

from spaln_tpu.align.driver import AlignerContext as RefContext
from spaln_tpu.config import Config, resolve, CvsG
from spaln_tpu.ops.params import DpParams
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.score.tables import TableDir
from spaln_tpu.seq.codec import encode_dna
from spaln_tpu_torch.align.driver import AlignerContext as PortContext
from spaln_tpu_torch.config import Config as PConfig, resolve as presolve
from spaln_tpu_torch.ops.convert import params_from_reference
from spaln_tpu_torch.score.intron import IntronPenalty as PIntronPenalty
from spaln_tpu_torch.score.splice import \
    build_splice_signals as port_signals
from spaln_tpu_torch.score.tables import TableDir as PTableDir

SPECIES = [None, "Dictyost", "Human"]


def _ref_ctx(table_dir, species):
    return RefContext.create(TableDir(table_dir.root, species=species))


def _port_ctx(table_dir, species):
    return PortContext.create(PTableDir(table_dir.root, species=species),
                              "cpu")


@pytest.mark.parametrize("species", SPECIES)
def test_intron_tail_identical_over_all_lengths(table_dir, species):
    ref = _ref_ctx(table_dir, species).ipen
    port = _port_ctx(table_dir, species).ipen
    t_ref = ref._tail(ref.rlmt)
    t_port = port._tail(port.rlmt)
    assert len(t_ref) == len(t_port)
    assert ref.rlmt + len(t_ref) > 1 << 20
    np.testing.assert_array_equal(t_port, t_ref)


@pytest.mark.parametrize("species", SPECIES)
def test_intron_table_and_params_identical(table_dir, species):
    ref = _ref_ctx(table_dir, species)
    port = _port_ctx(table_dir, species)
    n = 200_000
    np.testing.assert_array_equal(port.prm.intron_table(n),
                                  ref.prm.intron_table(n))
    for f in dataclasses.fields(ref.prm):
        if f.name != "ipen":
            assert np.array_equal(getattr(port.prm, f.name),
                                  getattr(ref.prm, f.name)), f.name


def test_params_from_reference(table_dir):
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    pp = params_from_reference(prm)
    assert type(pp).__module__.startswith("spaln_tpu_torch.")
    assert type(pp.ipen).__module__.startswith("spaln_tpu_torch.")
    for f in dataclasses.fields(prm):
        if f.name != "ipen":
            assert np.array_equal(getattr(pp, f.name),
                                  getattr(prm, f.name)), f.name
    lens = np.arange(0, 1 << 20)
    np.testing.assert_array_equal(pp.ipen.penalty(lens),
                                  prm.ipen.penalty(lens))
    # the port's own build from its own config agrees too
    pcfg = presolve(PConfig(), CvsG)
    own = PIntronPenalty(pcfg, CvsG)
    np.testing.assert_array_equal(own.penalty(lens), prm.ipen.penalty(lens))


@pytest.mark.parametrize("species", [None, "Dictyost"])
def test_splice_signals_identical(table_dir, species):
    rng = np.random.default_rng(5)
    g = "".join(rng.choice(np.array(list("ACGT")), 6000))
    g = g[:1000] + "GTAAGTATTTTTCTTTTTAG" + g[1020:]
    gc = encode_dna(g)
    ref = build_splice_signals(gc, resolve(Config(), CvsG),
                               TableDir(table_dir.root, species=species))
    port = port_signals(gc, presolve(PConfig(), CvsG),
                        PTableDir(table_dir.root, species=species))
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "tabs":
            for g_ in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(a, g_.name),
                                              getattr(b, g_.name))
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert ref.is_donor.sum() > 0 and ref.is_accpt.sum() > 0
