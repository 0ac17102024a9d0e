"""The tile schedule of the two traceback walks, K3 (spliced_tb_walk and
its strip mode) and K8 (tron_walk), on the CPU: the models
dp_spliced_cuda.tb_walk_tiles and dp_tron_cuda.tron_walk_tiles give the
tiles each walk's warp stages in shared memory, bands of up to 32 cells
along a run of moves: (i - k, t - 2k) for K3 in state 0, (i, t - k) in
its horizontal states and (i - k, t - k) in its vertical ones, (i - k, t
- 6k) for K8.  On walks of the plain versions (planted-intron buckets at
3 and 5 states, their strips, and tron batches at 3 and 5 states,
Smith-Waterman local and not, with split-codon introns), every cell a
step reads must lie in the tile in force at that step, no tile may leave
its slab, its lanes or the planes' rows, and the loads may number at
most ceil(reads / 32) + breaks + turns: a break is a step to a cell that
is neither the last one nor its successor along a band's direction in
the same slab (an intron close, a slab crossing, for K8 a gap move), a
turn a move along another direction than the move before it (than the
diagonal, after the start or a break).  The cells read come from the
records (K3 writes one a step) or from a scalar walk written here (K8
records moves only).  The kernels' own counts are held against the
models on the card (chip_smoke.py phases 1 and 8,
tests/test_torch_cuda.py).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spaln_tpu_torch.config import Config, resolve, CvsG
from spaln_tpu_torch.ops import dp_spliced as dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.ops import dp_tron as TD
from spaln_tpu_torch.ops import dp_tron_cuda as TK
from spaln_tpu_torch.ops.params import DpFlags, DpParams
from spaln_tpu_torch.ops.tron_params import (DEAD, HOR1, HOR2, SLA1,
                                             SLA2)
from spaln_tpu_torch.score.intron import IntronPenalty
from spaln_tpu_torch.score.simmtx import Simmtx
from spaln_tpu_torch.score.tables import TableDir, find_table_dir
from test_torch_cuda import (GEOMS, _dagp, _problems, _tron_problems,
                             _tron_setup)

CSRC = Path(K.__file__).resolve().parent.parent / "csrc"


K3_DIRS = ((1, 2), (0, 1), (1, 1))     # (lanes, rows) back a move
K8_DIRS = ((1, 6),)


def test_model_shapes_are_the_kernels():
    """The models' band shapes are the kernels' constexpr ones."""
    def const(src, name):
        text = (CSRC / src).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const("spliced_dp.cu", "TB_CELLS") == K.TB_BAND_CELLS
    assert const("spliced_dp.cu", "TB_STEP_T") == K.TB_BAND_STEP
    assert const("tron_dp.cu", "TW_CELLS") == TK.TRON_BAND_CELLS
    assert const("tron_dp.cu", "TW_STEP_T") == TK.TRON_BAND_STEP


def _check_schedule(reads, tiles, L, S, T, cells, dirs):
    """reads: the (s, i, t) of every step that reads a cell, in order;
    tiles: the model's (step, (s, i, t, di, dt, n)), the band of cells
    (i - di k, t - dt k), k < n.  Returns (loads, breaks)."""
    assert [k for k, _ in tiles] == sorted({k for k, _ in tiles})
    assert not reads or (tiles and tiles[0][0] == 0)
    cur, nxt = None, 0
    for k, (s, i, t) in enumerate(reads):
        while nxt < len(tiles) and tiles[nxt][0] == k:
            cur = tiles[nxt][1]
            nxt += 1
        bs, bi, bt, di, dt, n = cur
        j = bi - i if di else bt - t
        assert (s == bs and 0 <= j < n and i == bi - di * j
                and t == bt - dt * j), (k, cur)
    assert nxt == len(tiles)
    for _, (s, i, t, di, dt, n) in tiles:
        assert 0 <= s < S and 0 <= i < L and 0 <= t < T
        assert (di, dt) in dirs and 1 <= n <= cells
        assert i - di * (n - 1) >= 0 and t - dt * (n - 1) >= 0
    breaks = turns = 0
    # the direction of the last move (after the start or a break: of the
    # band a cell staged in state 0 gets, the diagonal)
    last = dirs[0]
    for a, b in zip(reads, reads[1:]):
        if a == b:
            continue
        d = next((d for d in dirs
                  if b == (a[0], a[1] - d[0], a[2] - d[1])), None)
        breaks += d is None
        turns += d is not None and d != last
        last = dirs[0] if d is None else d
    assert len(tiles) <= math.ceil(len(reads) / cells) + breaks + turns
    return len(tiles), breaks


# ------------------------------------------------------------------- K3
@pytest.fixture(scope="module")
def k3_runs():
    """The plain K1, K2e and K3 on each card-test bucket, single and
    double affine."""
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    tables = TableDir(find_table_dir())
    out = {}
    for dagp in (False, True):
        p = _dagp(prm) if dagp else prm
        for g, (B, M, ilen, L, lws) in enumerate(GEOMS):
            qs, gs, ss = _problems(cfg, tables, B, M, ilen, seed=B + L)
            band = dict(lws=lws, W=256) if lws else {}
            bp = dp.prepare_spliced_batch(qs, gs, p, sigs=ss, L=L,
                                          device="cpu", **band)
            fl, spj, row, rc = K.slab_trace_plain(bp, p)
            se = K.last_ends_plain(bp, p, row, rc)
            out[dagp, g] = bp, fl, spj, se
    return out


K3_CASES = [(dagp, g) for dagp in (False, True) for g in range(len(GEOMS))]


def _k3_reads(recs, lw, L, S, T, s0=0):
    """Each walk's cells read: the cell of every record in the planes."""
    out = []
    for w in range(recs.shape[1]):
        reads = []
        for kind, m, n, _ in recs[:, w].tolist():
            if m == 0:
                break
            s, i = (m - 1) // L - s0, (m - 1) % L
            t = n - m - int(lw[w]) - 1 + 2 * i
            if 0 <= t < T and 0 <= s < S:
                reads.append((s, i, t))
        out.append(reads)
    return out


def _k3_schedule(recs, fl, lw, s0=0, st0=None, col=None):
    S, T, _, L = fl.shape
    tiles = K.tb_walk_tiles(recs, fl, lw, s0, st0, col)
    reads = _k3_reads(recs, lw, L, S, T, s0)
    closes = (recs[:, :, 0] == 4).sum(0).tolist()
    loads = []
    for r, x, c in zip(reads, tiles, closes):
        n, breaks = _check_schedule(r, x, L, S, T, K.TB_BAND_CELLS, K3_DIRS)
        # a break is an intron close or a slab crossing
        assert breaks <= c + sum(a[0] != b[0] for a, b in zip(r, r[1:]))
        loads.append(n)
    stats = K.walk_stats(recs, fl, lw, s0, st0, col)
    assert stats[:, 1].tolist() == loads
    assert stats[:, 0].tolist() == (recs[:, :, 1] != 0).sum(0).tolist()
    return reads, loads


@pytest.mark.parametrize("dagp,g", K3_CASES)
def test_k3_walk_schedule(k3_runs, dagp, g):
    bp, fl, spj, se = k3_runs[dagp, g]
    assert spj.shape[1] == (5 if dagp else 3)
    stats = torch.zeros((bp.B, 2), dtype=torch.int32)
    recs = K.spliced_tb_walk(bp, fl, spj, se, stats=stats)
    assert torch.equal(recs, K.tb_walk_plain(bp, fl, spj, se))
    reads, loads = _k3_schedule(recs, fl, bp.lws_t)
    assert stats[:, 1].tolist() == loads
    assert (recs[:, :, 0] == 4).any()          # the planted introns
    assert all(reads) and min(loads) >= 1


@pytest.mark.parametrize("dagp,g", K3_CASES)
def test_k3_strip_schedule(k3_runs, dagp, g):
    """Every (slab, problem) strip from its slab's top row in a state by
    turns, over the planes of slabs s0.. (s0 = 0 and 1)."""
    bp, fl, spj, se = k3_runs[dagp, g]
    L = bp.L
    states = (0, 1, 2, 3, 4) if dagp else (0, 1, 2)
    starts = torch.tensor(
        [[min((s + 1) * L, bp.Ms[b]), min((s + 1) * L, bp.Ms[b])
          + bp.lws[b] + bp.W // 2, states[(b + s) % len(states)], s * L, b]
         for b in range(bp.B) for s in range(bp.S)], dtype=torch.int32)
    IT = dp.strip_walk_bound(L, bp.W)
    for s0 in (0, 1):
        sel = starts[starts[:, 3] >= s0 * L]
        f, p = fl[s0:].contiguous(), spj[s0:].contiguous()
        stats = torch.zeros((sel.shape[0], 2), dtype=torch.int32)
        recs = K.spliced_tb_strips(f, p, sel, bp.lws_t, s0, IT, stats=stats)
        col = sel[:, 4].long()
        _, loads = _k3_schedule(recs, f, bp.lws_t[col], s0, sel[:, 2], col)
        assert stats[:, 1].tolist() == loads
        assert (recs[:, :, 0] != 0).any()


# ------------------------------------------------------------------- K8
def _tron_reads(bp, planes, ends):
    """Each problem's cells read and its records, from a scalar walk of
    the planes (_tron_tb_walker's step, as K8 takes it)."""
    fl, spj, php = (x.numpy().astype(np.int64) for x in planes)
    B, S, T, nn, L = fl.shape
    lw = bp.meta[:, 2].numpy()
    out = []
    for b in range(B):
        m, n = (int(x) for x in ends[b])
        st, reads, recs = 0, [], []
        for _ in range(bp.IT):
            if m < 1 or n < 1:
                break
            s = (m - 1) // L
            i = m - 1 - s * L
            t = n - 3 * (s * L + 1) - int(lw[b]) + 1 + 3 * i
            if not (0 <= t < T and s < S):
                break
            reads.append((s, i, t))
            jnc, phs = (int(x[b, s, t, min(st, nn - 1), i])
                        for x in (spj, php))
            if st == 0:
                flh = int(fl[b, s, t, 0, i])
                win = flh >> 5 & 7
                if flh == 255 or (not win and not jnc
                                  and (flh & 15) == DEAD):
                    break
                if win:
                    st = win
                elif jnc > 0:
                    recs.append((5 if phs == 1 else 4, m, n, jnc - 1, phs))
                    if phs == 1:
                        m, n = m - 1, jnc - 3
                    else:
                        n = jnc - 1 if phs == 0 else jnc - 2
                else:
                    recs.append((1, m, n, 0, 0))
                    m, n = m - 1, n - 3
            elif jnc > 0:
                recs.append((4, m, n, jnc - 1, phs))
                n = jnc - 1 + phs
            else:
                fg = int(fl[b, s, t, st, i])
                base = fg & 15
                if st in (1, 3):
                    a1 = 2 if base == HOR2 else 1 if base == HOR1 else 3
                    recs.append((2, m, n, a1, 0))
                    n -= a1
                else:
                    a1 = 2 if base == SLA2 else 1 if base == SLA1 else 0
                    recs.append((3, m, n, a1, 0))
                    m, n = m - 1, n - a1
                if fg & 0x80:
                    st = 0
        out.append((reads, recs))
    return out


@pytest.mark.parametrize("dagp,local", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_k8_walk_schedule(dagp, local):
    """Three planted protein genes (introns at phases 0, 1 and 2: two
    split codons; a frameshift, a 45-nt insertion), two slabs of 64
    lanes."""
    cfg, prm, ipen = _tron_setup(dagp)
    qs, gs, ss, lws, W, lbs = _tron_problems(cfg, 3, seed=11)
    bp = TD.prepare_tron_batch(qs, gs, ss, prm, ipen, lws=lws, W=W, L=64,
                               flags=DpFlags(local=local), loc_bounds=lbs,
                               device="cpu")
    planes, row, rc, loc = TK.tron_forward_plain(bp, prm)
    ends = TD.collect_tron_ends(bp, row.numpy(), rc.numpy(), loc.numpy())
    et = torch.tensor([[e[1], e[2]] for e in ends], dtype=torch.int32)
    stats = torch.zeros((bp.B, 2), dtype=torch.int32)
    recs, counts = TK.tron_walk(bp, planes, et, stats=stats)
    model = TK.tron_walk_tiles(bp, planes[0], et, recs, counts)
    kinds, crossed = set(), 0
    for b, (reads, want) in enumerate(_tron_reads(bp, planes, et)):
        n = int(counts[b])
        assert recs[b, :n].tolist() == [list(r) for r in want]
        steps, tiles = model[b]
        assert steps == len(reads)        # a hand-over reads its cell again
        loads, breaks = _check_schedule(reads, tiles, bp.L, bp.S, bp.T,
                                        TK.TRON_BAND_CELLS, K8_DIRS)
        # a break is an intron close, a slab crossing or a gap move
        assert breaks <= sum(r[0] != 1 for r in want) + sum(
            a[0] != c[0] for a, c in zip(reads, reads[1:]))
        assert stats[b].tolist() == [steps, loads]
        kinds |= {r[0] for r in want}
        crossed += any(a[0] != c[0] for a, c in zip(reads, reads[1:]))
    assert 5 in kinds and crossed                # a split codon, a slab
