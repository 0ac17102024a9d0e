"""The port's tron path (K7 and K8's plain versions, the batch layer and
the end extraction) against spaln_tpu's tron wavefront scan on the CPU:
scores, end cells and op streams must be identical (int32 DP, fixed
tie-breaks: tolerance 0).

Each batch holds several planted protein genes with different band
placements (per-problem lw, one common W) and more rows than lanes, so
slabs hand their last row to the next: introns at phase 0 and at both
split-codon phases, 1- and 2-nt frameshifts; Smith-Waterman local mode
with and without anchors (Local bounds); double-affine gaps with a long
deletion and a long insertion.  spaln_tpu runs each batch once
(prepare_tron_batch, run_tron_batch, collect_tron_results and the host
walk traceback_tron_scan, as on its CPU backend); the port runs the
same batch carried over (convert.tron_batch_from_reference) and from
its own host preparation.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from spaln_tpu import constants as K
from spaln_tpu.config import Config, resolve, PvsG
from spaln_tpu.ops.dp_tron_ref import TronDpParams as RefTronDpParams
from spaln_tpu.ops.dp_tron_scan import (collect_tron_results,
                                        forward_tron_scan,
                                        prepare_tron_batch as ref_prepare,
                                        run_tron_batch as ref_run,
                                        traceback_tron_scan)
from spaln_tpu.ops.params import DpFlags as RefFlags
from spaln_tpu.score.codepot import build_tron_signals as ref_signals
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.tables import TableDir, find_table_dir
from spaln_tpu.seq.codec import encode_dna

from spaln_tpu_torch.align.protein_driver import ProteinAlignerContext
from spaln_tpu_torch.ops import dp_tron as TD
from spaln_tpu_torch.ops import dp_tron_cuda as TK
from spaln_tpu_torch.ops.convert import (tron_batch_from_reference,
                                         tron_params_from_reference)
from spaln_tpu_torch.ops.params import DpFlags
from spaln_tpu_torch.score.codepot import build_tron_signals
from spaln_tpu_torch.score.tables import TableDir as PortTableDir

_CODON = {}
for _i in range(64):
    _CODON.setdefault(int(K.GENCODE[_i]), "ACGT"[(_i >> 4) & 3]
                      + "ACGT"[(_i >> 2) & 3] + "ACGT"[_i & 3])
AA_CODES = list(range(3, 23))
L = 32                                   # 3 slabs for most queries
NONE = (1 << 30, -(1 << 30))             # no Local bounds


def _bt(aa):
    return "".join(_CODON[int(x)] for x in aa)


def _mk(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _intron(rng, n, head="GTAAGT", tail="TTTCTAG"):
    return head + _mk(rng, n) + tail


def _case(name, rng):
    """(query codes, genome string, Local bounds or None)."""
    if name == "intron0":
        a1, a2 = rng.choice(AA_CODES, 35), rng.choice(AA_CODES, 42)
        g = _mk(rng, 30) + _bt(a1) + _intron(rng, 200) + _bt(a2) \
            + _mk(rng, 25)
        return np.concatenate([a1, a2]), g, None
    if name in ("split1", "split2"):
        k = int(name[-1])
        a1, a2 = rng.choice(AA_CODES, 30), rng.choice(AA_CODES, 45)
        mid = _CODON[int(K.LEU)]
        g = (_mk(rng, 20) + _bt(a1) + mid[:k]
             + _intron(rng, 150, "GTGAGT", "TTTACAG") + mid[k:] + _bt(a2))
        return np.concatenate([a1, [K.LEU], a2]), g, None
    if name in ("fs1", "fs2"):
        aa = rng.choice(AA_CODES, 70)
        g = _bt(aa)
        d = int(name[-1])
        return aa, _mk(rng, 15) + g[:90] + g[90 + d:] + _mk(rng, 10), None
    if name == "local_anchored":
        a1, a2 = rng.choice(AA_CODES, 35), rng.choice(AA_CODES, 42)
        g = _mk(rng, 60) + _bt(a1) + _intron(rng, 180) + _bt(a2) \
            + _mk(rng, 45)
        return np.concatenate([a1, a2]), g, (90, 420)
    if name == "local_junk":
        core, junk = rng.choice(AA_CODES, 60), rng.choice(AA_CODES, 20)
        return np.concatenate([core, junk]), _bt(core) + _mk(rng, 40), None
    if name == "local_divergent":
        a1, a2 = rng.choice(AA_CODES, 40), rng.choice(AA_CODES, 35)
        e1 = list(_bt(a1))
        for i in range(2, len(e1), 9):
            e1[i] = rng.choice(list("ACGT"))
        g = _mk(rng, 40) + "".join(e1) + _intron(rng, 120, "GTAAGT",
                                                  "TTTTTAG") + _bt(a2)
        return np.concatenate([a1, a2]), g, (50, 300)
    if name == "dagp_deletion":
        aa = rng.choice(AA_CODES, 70)
        g = _bt(aa)
        return aa, g[:90] + g[150:], None              # 20 codons gone
    if name == "dagp_insertion":
        aa = rng.choice(AA_CODES, 70)
        g = _bt(aa)
        return aa, g[:120] + "".join(rng.choice(list("AC"), 60)) + g[120:], \
            None
    raise KeyError(name)


BATCHES = {
    "global": (("intron0", "split1", "split2", "fs1", "fs2"), False, False),
    "local": (("local_anchored", "local_junk", "local_divergent"), True,
              False),
    "dagp": (("dagp_deletion", "dagp_insertion", "intron0"), False, True),
}
CASES = [(b, i) for b, (names, _, _) in BATCHES.items()
         for i in range(len(names))]


@pytest.fixture(scope="module")
def env():
    tables = TableDir(find_table_dir())
    cfg = resolve(Config(), PvsG)
    prm = RefTronDpParams.build(
        cfg, Simmtx.protein(tables.root, slot=0).tron().mtx)
    lgep = -int(0.6 * cfg.aln.scale)
    prm_d = dataclasses.replace(prm, dagp=True, lgep=lgep,
                                lgop=prm.gop - (lgep - prm.gep) * 7)
    ipen = IntronPenalty(cfg, PvsG).penalty(np.arange(20000))
    return cfg, tables, prm, prm_d, ipen


@pytest.fixture(scope="module")
def runs(env):
    """Each batch through spaln_tpu once and through the port twice (the
    reference's batch carried over, and the port's own preparation from
    its own signals)."""
    cfg, tables, prm, prm_d, ipen = env
    ptables = PortTableDir(tables.root)
    out = {}
    for bname, (names, local, dagp) in BATCHES.items():
        rng = np.random.default_rng(20261017 + len(bname))
        cases = [_case(n, rng) for n in names]
        qs = [np.asarray(c[0]).astype(np.int8) for c in cases]
        gs = [encode_dna(c[1]) for c in cases]
        lbs = [c[2] or NONE for c in cases]
        # per-problem band placements: each its full band, shifted apart
        lws = [-3 * len(q) - 6 * i for i, q in enumerate(qs)]
        W = max(len(g) - lw for g, lw in zip(gs, lws)) + 2
        p = prm_d if dagp else prm
        sigs = [ref_signals(g, cfg, tables) for g in gs]
        bp = ref_prepare(qs, gs, sigs, p, ipen, lws=lws, W=W,
                         flags=RefFlags(local=local), L=L, loc_bounds=lbs)
        row, rc, traces = ref_run(bp, p)
        res = collect_tron_results(bp, row, rc, traces, False)
        ref = [(s, m, n, traceback_tron_scan(tr, m, n))
               for s, m, n, tr in res]
        pp = tron_params_from_reference(p)
        port = TD.run_tron_batch(tron_batch_from_reference(bp, p), pp)
        psigs = [build_tron_signals(g, cfg, ptables) for g in gs]
        own = TD.run_tron_batch(TD.prepare_tron_batch(
            qs, gs, psigs, pp, ipen, lws=lws, W=W, L=L,
            flags=DpFlags(local=local), loc_bounds=lbs), pp)
        out[bname] = dict(ref=ref, port=port, own=own, S=bp.n_slabs,
                          names=names)
    return out


@pytest.mark.parametrize("batch,i", CASES)
def test_tron_batch_equals_reference(runs, batch, i):
    r = runs[batch]
    assert r["port"][i] == r["ref"][i]
    assert r["own"][i] == r["ref"][i]


@pytest.mark.parametrize("batch,i", CASES)
def test_tron_case_exercises_its_path(runs, batch, i):
    """Each planted feature is on the walked path."""
    name = runs[batch]["names"][i]
    ops = runs[batch]["ref"][i][3]
    introns = [o for o in ops if o[0] == 'I']
    if name == "intron0":
        assert [o[4] for o in introns] == [0]
    elif name in ("split1", "split2"):
        assert len(introns) == 1 and introns[0][4] != 0
    elif name in ("fs1", "fs2"):
        assert any(o[0] in "EF" and o[3] in (1, 2) for o in ops)
    elif name == "local_junk":
        assert max(o[1] for o in ops if o[0] == 'D') <= 62
    elif name == "dagp_deletion":
        assert sum(o[0] == 'F' for o in ops) == 20
    elif name == "dagp_insertion":
        assert sum(o[0] == 'E' and o[3] == 3 for o in ops) == 20
    else:
        assert introns


def test_tron_batches_span_several_slabs(runs):
    assert all(r["S"] >= 2 for r in runs.values())


def test_single_problem_equals_forward_tron_scan(env):
    """forward_tron (one problem, its own band) = forward_tron_scan +
    traceback_tron_scan, with anchors in Local mode."""
    cfg, tables, prm, _, ipen = env
    rng = np.random.default_rng(5)
    q, g, lb = _case("local_anchored", rng)
    q = np.asarray(q).astype(np.int8)
    gc = encode_dna(g)
    s, m, n, tr = forward_tron_scan(q, gc, ref_signals(gc, cfg, tables),
                                    prm, ipen, L=L,
                                    flags=RefFlags(local=True),
                                    loc_bounds=lb)
    want = (s, m, n, traceback_tron_scan(tr, m, n))
    got = TD.forward_tron(q, gc, build_tron_signals(
        gc, cfg, PortTableDir(tables.root)), tron_params_from_reference(prm),
        ipen, L=L, flags=DpFlags(local=True), loc_bounds=lb,
        device="cpu")
    assert got == want


def test_tron_wrappers_run_plain_on_cpu_and_count(env):
    """CPU tensors take the plain versions (counted as plain calls, no
    launch); the kernel entry refuses CPU tensors; L < 3 is refused."""
    cfg, tables, prm, _, ipen = env
    pp = tron_params_from_reference(prm)
    rng = np.random.default_rng(9)
    q, g, _ = _case("fs1", rng)
    gc = encode_dna(g)
    sig = build_tron_signals(gc, cfg, PortTableDir(tables.root))
    bp = TD.prepare_tron_batch([np.asarray(q, np.int8)], [gc], [sig], pp,
                               ipen, L=16)
    before = dict(TK.plain_calls), dict(TK.launches)
    TD.run_tron_batch(bp, pp)
    assert TK.plain_calls["tron_forward"] == before[0]["tron_forward"] + 1
    assert TK.plain_calls["tron_walk"] == before[0]["tron_walk"] + 1
    assert TK.launches == before[1]
    with pytest.raises(ValueError, match="CUDA tensors"):
        TK._launch("tron_walk", bp.device)
    with pytest.raises(ValueError, match="L >= 3"):
        TD.prepare_tron_batch([np.asarray(q, np.int8)], [gc], [sig], pp,
                              ipen, L=2)


def test_protein_path_runs_on_the_card_unless_asked(env):
    """forward_tron's device defaults to the card and a
    ProteinAlignerContext always names its device: no caller gets the
    plain versions on the host without asking.  Without a card the
    default raises."""
    assert inspect.signature(TD.forward_tron).parameters[
        "device"].default == "cuda"
    fields = {f.name: f for f in dataclasses.fields(ProteinAlignerContext)}
    assert fields["device"].default is dataclasses.MISSING
    assert inspect.signature(ProteinAlignerContext.create).parameters[
        "device"].default is inspect.Parameter.empty
    if torch.cuda.is_available():
        return
    cfg, tables, prm, _, ipen = env
    q, g, _ = _case("fs1", np.random.default_rng(9))
    gc = encode_dna(g)
    with pytest.raises((RuntimeError, AssertionError)):
        TD.forward_tron(np.asarray(q, np.int8), gc, build_tron_signals(
            gc, cfg, PortTableDir(tables.root)),
            tron_params_from_reference(prm), ipen, L=16)
