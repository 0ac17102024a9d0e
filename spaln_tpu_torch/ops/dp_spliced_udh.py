"""Multi-intermediate unidirectional Hirschberg (UDH) traceback: the
linear-space path of the banded spliced DP.

The counterpart of spaln_tpu/ops/dp_spliced_udh.py (the reference's
lspS_ng multi-intermediate path, fwd2s1.cc:1801-1897).  The slab
boundaries (every L-th query row) are the intermediate rows:

1. links pass (K4, spliced_slab_links, or its double-affine mode under
   prm.dagp): every value carries the packed link (column * 8 + state)
   of the cell where its path crossed the previous slab boundary; each
   slab emits four link streams of T ints (five under dagp: the
   boundary F2's) and a snapshot of its entry boundary rows (layout in
   ops/dp_spliced.py).  No planes: O(S * T) int32 per problem.  K2e
   takes the ends from its row / right column as on the plane path.
   For dagp the reference runs its scan engine's links mode here
   (spaln_tpu/ops/dp_spliced_udh.py:66-78); the port has one engine.
2. backwalk (backwalk): from each end cell's link, one batched gather per
   slab boundary over the device link streams gives every problem's
   crossing at each boundary row its path spans; one small tensor is
   copied to the host.
3. retrace (_retrace): the slab run of each path, from the first slab it
   enters to its end slab, is re-run with planes (K1 in retrace mode,
   from K4's snapshot of the run's first slab, so bit-identical to the
   links pass), sub-batches of runs in one launch each within the plane
   budget (retrace_launches), and every (slab, problem) strip of a
   launch is walked in one launch (K3 in strip mode), each from the
   crossing above down to the one below; one copy brings every strip's
   records back, and the strips, stitched, are the op stream of the
   full-plane walk.

The local mode and the -yJ bonus (K6) run in the links pass only: the
reference's retrace re-runs its slabs without them, each slab from its
own snapshot (spaln_tpu/ops/dp_spliced_udh.py:159-163), so its op
streams can differ from its plane path's there, and the port's equal its
own (ROADMAP.md Queue 3).  The port retraces every (problem, slab) pair
of such a bucket in one launch within the plane budget (pair_launches,
spliced_slab_retrace_pairs: a CTA a pair), and walks their strips in
one launch, each in its own slab's planes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dp_spliced import (BatchProblem, LK_BND_F, LK_BND_F2, LK_BND_H, LK_RC,
                         LK_ROW, PLANE_BYTES_BUDGET, ops_from_records,
                         plane_bytes_per_cell, strip_walk_bound,
                         unpack_link)
from .dp_spliced_cuda import (spliced_last_ends, spliced_slab_links,
                              spliced_slab_retrace,
                              spliced_slab_retrace_pairs, spliced_tb_strips)
from .params import DpParams
from ..utils.metrics import metrics, stage

I32 = torch.int32


@stage("device_dp")
def run_spliced_batch_udh(bp: BatchProblem, prm: DpParams,
                          plane_budget: int = PLANE_BYTES_BUDGET):
    """Full UDH pipeline over a prepared batch on its device.

    Returns (scores (B,) int64, ends (B, 2) int64, ops_list): the same
    op streams as the full-plane walk (run_bucket), with at most
    ``plane_budget`` bytes of planes live at a time."""
    _, snaps, se, cr = links_pass(bp, prm)
    ops_list = _retrace(bp, prm, snaps, cr, se, plane_budget)
    return se[:, 0].astype(np.int64), se[:, 1:].astype(np.int64), ops_list


def links_pass(bp: BatchProblem, prm: DpParams):
    """K4, K2e and the backwalk.  Returns (links, snaps) on the device
    and, on the host, the ends (B, 3) = (score, m, n) and the crossings
    (B, S, 2) of backwalk."""
    links, snaps, row, rc = spliced_slab_links(bp, prm)
    se = spliced_last_ends(bp, prm, row, rc)
    cr = backwalk(bp, links, se)
    B = bp.B
    host = torch.cat([se.reshape(-1), cr.reshape(-1)]).cpu().numpy()
    se_h = host[:3 * B].reshape(B, 3)
    cr_h = host[3 * B:].reshape(B, bp.S, 2)
    if cr_h[:, 0, 1].any():
        bad = np.flatnonzero(cr_h[:, 0, 1]).tolist()
        raise RuntimeError(f"UDH backwalk of problems {bad}: a crossing "
                           f"link points outside its slab's streams")
    return links, snaps, se_h, cr_h


def end_link_t(bp: BatchProblem, ends: torch.Tensor):
    """_end_link_t (spaln_tpu dp_spliced_udh.py:88) for every problem:
    (slab, stream, step t, ok) of the end cell's link emission; ok is
    False where the end is not a computed DP cell (stale band-edge or
    column-0 corner candidates), which traces to an empty op stream."""
    L = bp.L
    bm, bn = ends[:, 1].long(), ends[:, 2].long()
    sf = torch.div(bm - 1, L, rounding_mode="floor").clamp(min=0)
    lane = bm - (sf * L + 1)
    t = (bn - bm) - bp.lws_t.long() - 1 + 2 * lane
    stream = torch.where(bm == bp.Ms_t.long(), LK_ROW, LK_RC)
    ok = ((t >= 0) & (t < bp.T) & (lane >= 0) & (lane < L)
          & (t - 2 * lane >= 0) & (t - 2 * lane < bp.W))
    return sf, stream, t, ok


def backwalk(bp: BatchProblem, links: torch.Tensor,
             ends: torch.Tensor) -> torch.Tensor:
    """_backwalk (spaln_tpu dp_spliced_udh.py:114) as S batched gathers
    over the device link streams.  Returns (B, S, 2) int32: [b, s] =
    (column, state) where problem b's path crosses boundary row s*L, for
    1 <= s <= its end slab (0, 0 where the path rides column 0 below);
    [b, 0] = (has crossings, bad link)."""
    B, L, S, T = bp.B, bp.L, bp.S, bp.T
    dev = links.device
    nlk = links.shape[1]
    flat = links.reshape(-1)
    barr = torch.arange(B, device=dev)

    def at(s, k, t):
        return flat[((s * nlk + k) * B + barr) * T + t.clamp(0, T - 1)]

    sf, stream, t, ok = end_link_t(bp, ends)
    valid = (ends[:, 1] >= 1) & (ends[:, 2] >= 1)
    has = valid & (ok | (sf == 0))
    cur = at(sf.clamp(0, S - 1), stream, t).long()
    lw = bp.lws_t.long()
    cr = torch.zeros((B, S, 2), dtype=I32, device=dev)
    alive = has & (sf > 0)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    for s in range(S - 1, 0, -1):
        here = alive & (sf >= s)
        col, st = unpack_link(cur)
        cr[:, s, 0] = torch.where(here, col, 0).to(I32)
        cr[:, s, 1] = torch.where(here, st, 0).to(I32)
        # the crossing cell sits on slab s-1's last row; its own link is
        # in slab s-1's boundary stream for its state (H, F, or F2 with
        # double-affine gaps)
        cont = here & (col != 0) & (s > 1)
        tb = col - ((s - 1) * L + 1 + lw + 2 - L)
        vert = (st == 2) | ((st == 4) & (nlk > LK_BND_F2))
        bad |= cont & ((tb < 0) | (tb >= T) | ((st != 0) & ~vert))
        k = torch.where(st == 2, LK_BND_F,
                        torch.where(st == 4, LK_BND_F2, LK_BND_H))
        nxt = at(s - 1, k.clamp(max=nlk - 1), tb)
        cur = torch.where(cont, nxt.long(), cur)
        alive = alive & ~(here & ~cont)
    cr[:, 0, 0] = has.to(I32)
    cr[:, 0, 1] = bad.to(I32)
    return cr


def retrace_launches(runs: list, max_ps: int) -> list:
    """The retrace's launches over ``runs`` [(problem, first slab, end
    slab)], each launch (s0, nslab, problems) holding at most ``max_ps``
    problem-slabs of planes: problems in order of their runs, grouped
    while the group's size times its slab span fits, and a span that does
    not fit cut into consecutive pieces, each from K4's snapshot of its
    own first slab (a run split mid-way, outputs unchanged)."""
    groups: list = []
    for r in sorted(runs, key=lambda r: (r[1], r[2])):
        g = groups[-1] if groups else None
        if g is not None and (len(g) + 1) * (max(r[2], *(x[2] for x in g))
                                             - g[0][1] + 1) <= max_ps:
            g.append(r)
        else:
            groups.append([r])
    out = []
    for g in groups:
        lo, hi = g[0][1], max(x[2] for x in g)
        step = max(1, max_ps // len(g))
        for a in range(lo, hi + 1, step):
            b = min(a + step, hi + 1)
            out.append((a, b - a, [x[0] for x in g if x[1] < b and x[2] >= a]))
    return out


def pair_launches(runs: list, max_ps: int) -> list:
    """The retrace's launches over ``runs`` [(problem, first slab, end
    slab)] where every slab runs from its own snapshot: each launch a
    list of (problem, slab) pairs, every pair of every run once, in the
    runs' order, at most ``max_ps`` a launch (the plane budget's
    problem-slabs), so as few launches as the budget allows."""
    pairs = [(i, s) for i, a, b in runs for s in range(a, b + 1)]
    return [pairs[c:c + max_ps] for c in range(0, len(pairs), max_ps)]


def _retrace(bp: BatchProblem, prm: DpParams, snaps: torch.Tensor,
             cr: np.ndarray, se: np.ndarray, plane_budget: int) -> list:
    """_retrace (spaln_tpu dp_spliced_udh.py:151): re-run each path's
    slab run with planes in launches of whole runs within
    ``plane_budget`` (retrace_launches), or after a local or -yJ links
    pass each of its slabs alone, every (problem, slab) pair of a
    sub-batch in one launch (pair_launches); walk every strip of a
    launch in one launch on the device, copy every strip back at once and
    stitch the strips."""
    B, L, W, T = bp.B, bp.L, bp.W, bp.T
    dev = bp.device
    # the reference's retrace builds its slab runner with neither local
    # nor cip (spaln_tpu/ops/dp_spliced_udh.py:159-163), whatever the
    # links pass ran, and re-runs each slab from its own snapshot: the
    # port does the same (ROADMAP.md Queue 3, "the UDH retrace drops
    # local and cip").  A run retraced from its first slab's snapshot
    # computes the later slabs' entry rows without them, so there every
    # slab is retraced alone, a CTA a (problem, slab) pair.
    alone = bp.flags.local or bp.cip is not None
    bp = dataclasses.replace(
        bp, flags=dataclasses.replace(bp.flags, local=False), cip=None)
    IT = strip_walk_bound(L, W)
    max_ps = max(1, plane_budget // (T * L * plane_bytes_per_cell(prm)))
    runs = []
    for i in range(B):
        if not cr[i, 0, 0]:
            continue
        sf = (int(se[i, 1]) - 1) // L
        # slab s < sf holds a strip where the path crosses boundary row
        # (s+1)*L off column 0; below the first crossing on column 0 the
        # path rides column 0 (backwalk), so the strips form one run
        s0 = sf
        while s0 > 0 and cr[i, s0, 0] != 0:
            s0 -= 1
        runs.append((i, s0, sf))
    first = {i: s0 for i, s0, _ in runs}

    def start(i, s, j):
        # a path leaves slab s+1 upward by a vertical move, so the strip
        # starts here in the crossing's state: 0 (H), 2 (F) or 4 (F2)
        # (dp_spliced_scan.py:1240-1243)
        bm, bn = int(se[i, 1]), int(se[i, 2])
        if s == (bm - 1) // L:
            return bm, bn, 0, s * L, j
        return ((s + 1) * L, int(cr[i, s + 1, 0]), int(cr[i, s + 1, 1]),
                s * L, j)

    pending = []
    if alone:
        launches = pair_launches(runs, max_ps)
        if len(launches) > 1:     # past one a bucket: the budget's splits
            metrics.bump("udh_retrace_splits", len(launches) - 1)
        for pairs in launches:
            ids = torch.tensor(pairs, dtype=I32, device=dev).T.contiguous()
            sel, slabs = ids[0], ids[1]
            snap = snaps[slabs.long(), :, sel.long()].transpose(0, 1)
            fl, spj = spliced_slab_retrace_pairs(bp, prm, slabs,
                                                 snap.contiguous(), sel)
            metrics.bump("udh_retrace_cells", len(pairs) * L * W)
            starts = [start(i, s, j) for j, (i, s) in enumerate(pairs)]
            recs = spliced_tb_strips(
                fl, spj, torch.tensor(starts, dtype=I32, device=dev),
                bp.lws_t.index_select(0, sel.long()), slabs, IT)
            del fl, spj
            pending.append((recs, (recs[:, :, 1] != 0).sum(0).max(), pairs))
    else:
        for a, nslab, members in retrace_launches(runs, max_ps):
            sel = torch.tensor(members, dtype=I32, device=dev)
            idx = sel.long()
            snap = snaps[a].index_select(1, idx).contiguous()
            fl, spj = spliced_slab_retrace(bp, prm, a, nslab, snap, sel)
            metrics.bump("udh_retrace_cells", len(members) * nslab * L * W)
            starts, keys = [], []
            for j, i in enumerate(members):
                sf = (int(se[i, 1]) - 1) // L
                for s in range(max(a, first[i]), min(a + nslab, sf + 1)):
                    starts.append(start(i, s, j))
                    keys.append((i, s))
            recs = spliced_tb_strips(
                fl, spj, torch.tensor(starts, dtype=I32, device=dev),
                bp.lws_t.index_select(0, idx), a, IT)
            del fl, spj
            pending.append((recs, (recs[:, :, 1] != 0).sum(0).max(), keys))
    strips: list[dict[int, list]] = [dict() for _ in range(B)]
    if pending:
        # walks are short next to the bound: copy back their steps only
        n_steps = torch.stack([n for _, n, _ in pending]).tolist()
        host = torch.cat([r[:n].reshape(-1) for (r, _, _), n in
                          zip(pending, n_steps)]).cpu().numpy()
        at = 0
        for (recs, _, keys), n in zip(pending, n_steps):
            size = n * len(keys) * 4
            part = host[at:at + size].reshape(n, len(keys), 4)
            at += size
            for (i, s), ops in zip(keys, ops_from_records(part, len(keys))):
                strips[i][s] = ops
    out = []
    for i in range(B):
        allops: list = []
        for s in sorted(strips[i]):
            allops.extend(strips[i][s])
        out.append(allops)
    return out
