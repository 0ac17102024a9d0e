"""Carry state across from spaln_tpu: its DpParams and BatchProblem, and
its TronDpParams and TronBatchProblem, become the port's, so a test can
drive both packages from one problem.

The objects are taken duck-typed; nothing here imports spaln_tpu.  Only
tests call this module.
"""
from __future__ import annotations

import numpy as np
import torch

from .dp_spliced import (BatchProblem, N_GOPS, G_RES, G_ISDON, G_ISACC,
                         G_SIG5, G_ACCB, G_DINC5, walk_bound)
from .dp_tron import TronBatchProblem, prepare_tron_batch
from .tron_params import TronDpParams
from .params import DpFlags, DpParams
from ..score.intron import IntronPenalty


def params_from_reference(prm) -> DpParams:
    """A spaln_tpu DpParams as the port's.  The intron model is copied
    field by field, except the cached log tail, which the port evaluates
    itself (score/intron.py _tail)."""
    ipen = None
    if prm.ipen is not None:
        ipen = IntronPenalty.__new__(IntronPenalty)
        for k, v in vars(prm.ipen).items():
            if k != "_tail_cache":
                setattr(ipen, k, v.copy() if isinstance(v, np.ndarray)
                        else v)
    return DpParams(qprof_mtx=np.array(prm.qprof_mtx), gop=prm.gop,
                    gep=prm.gep, lgop=prm.lgop, lgep=prm.lgep,
                    dagp=prm.dagp, intron_llmt=prm.intron_llmt, ipen=ipen,
                    scale=prm.scale, codonk1=prm.codonk1)


def batch_from_reference(bp, device: torch.device | str = "cpu"
                         ) -> BatchProblem:
    """A spaln_tpu BatchProblem as the port's, on ``device``, at the
    reference's geometry (its slab count, Mpad and padded Nmax).

    Reads the host mirrors of the uploaded operands (ops_host,
    qprof_host) and undoes their layout: genome arrays reversed and
    right-aligned at pad2 + Nmax - N + delta, donor dinucleotides as
    class ids with a per-class joint acceptor table (the port keeps the
    class id in place of the dinucleotide code and the class table in
    the first columns of its joint table: the same values at every
    close).  The penalty table is expanded from its constant runs
    (ipen_key).  The row-0 boundary that bnd_h0_host/bnd_f0_host hold
    is not read: it is a function of the DpFlags and the gap costs, and
    the slab kernel derives it from them."""
    B, Nmax = bp.B, bp.Nmax
    Np = Nmax + 1
    oh = bp.ops_host
    gops = np.zeros((B, N_GOPS, Np), np.int32)
    joint = np.zeros((B, Np, 16), np.int32)
    rows = ((G_ISDON, "rb_isdon"), (G_ISACC, "rb_isacc"),
            (G_SIG5, "rb_sig5"), (G_ACCB, "rb_accb"),
            (G_DINC5, "rb_d5cls"))
    for i in range(B):
        N = bp.Ns[i]
        o = bp.pad2 + Nmax - N + bp.deltas[i]
        gops[i, G_RES, 1:N + 1] = oh["rb_code"][i, o:o + N][::-1]
        for r, k in rows:
            gops[i, r, :N] = oh[k][i, o:o + N][::-1]
        j4 = oh["rb_joint4"][i, o:o + N][::-1]
        joint[i, :N, :j4.shape[1]] = j4
    ipen = np.empty(Np, np.int32)
    for base, val in bp.ipen_key:
        if base <= Nmax:
            ipen[base:] = val

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    S, L, W = bp.n_slabs, bp.L, bp.W
    return BatchProblem(
        qprof=up(np.asarray(bp.qprof_host, np.int32)), gops=up(gops),
        joint=up(joint), ipen=up(ipen),
        Ms_t=up(np.asarray(bp.Ms, np.int32)),
        Ns_t=up(np.asarray(bp.Ns, np.int32)),
        lws_t=up(np.asarray(bp.lws, np.int32)),
        Ms=list(bp.Ms), Ns=list(bp.Ns), lws=list(bp.lws), B=B, L=L, W=W,
        T=bp.T, S=S, Mpad=bp.Mpad, Nmax=Nmax, IT=walk_bound(S, L, W),
        flags=DpFlags(**vars(bp.flags)),
        cip=(None if bp.cip_all is None
             else up(np.asarray(bp.cip_all, np.int32))))


def tron_params_from_reference(prm) -> TronDpParams:
    """A spaln_tpu TronDpParams as the port's (the same fields)."""
    return TronDpParams(qprof_mtx=np.array(prm.qprof_mtx), gop=prm.gop,
                        gep=prm.gep, extra_gop=prm.extra_gop,
                        intron_minl=prm.intron_minl, scale=prm.scale,
                        dagp=prm.dagp, lgop=prm.lgop, lgep=prm.lgep,
                        codonk1=prm.codonk1, vthr=prm.vthr)


def tron_batch_from_reference(bp, prm, device: torch.device | str = "cpu"
                              ) -> TronBatchProblem:
    """A spaln_tpu TronBatchProblem as the port's, on ``device``, at the
    port's geometry (ceil(max M / L) slabs, no padded M or N: the
    reference's padding changes no output).

    The queries are read back from the reference's query profiles (the
    first tron-matrix row equal to each profile row: rows that are equal
    score alike), the genome operands and the init row come from its
    host signals (sigs), the penalty table from its intron-penalty
    operand and the Local bounds from loc_lo_j/loc_hi_j."""
    mtx = np.asarray(prm.qprof_mtx, np.int32)
    qprof = np.asarray(bp.qprof_all, np.int32)
    queries = []
    for b, M in enumerate(bp.Ms):
        hit = (qprof[b, :M, None, :] == mtx[None]).all(-1)    # (M, A)
        if not hit.any(-1).all():
            raise ValueError("a query profile row is no tron-matrix row")
        queries.append(hit.argmax(-1).astype(np.int8))
    lo = np.asarray(bp.loc_lo_j).tolist()
    hi = np.asarray(bp.loc_hi_j).tolist()
    # prepare_tron_batch reads only the lengths of the genome windows:
    # the operands come from the signals
    return prepare_tron_batch(
        queries, [np.empty(N, np.int8) for N in bp.Ns], list(bp.sigs),
        tron_params_from_reference(prm), np.asarray(bp.ops["ipen"]),
        lws=list(bp.lws), W=bp.W, flags=DpFlags(**vars(bp.flags)),
        L=bp.L, loc_bounds=list(zip(lo, hi)), device=device)
