"""The yardstick of the kernels: the work a DP launch needs, counted from
the true lengths of its problems, and the card's peaks.

A launch's work is that of its problems' dynamic programming, whatever
implements it: each problem's band cells (its query rows times the genome
columns of its band, inside the matrix) at a fixed number of int32
operations a cell, and its inputs read once.  Only the first forward pass
over a batch counts it (``FORWARD``); the UDH retrace, the end extraction
and the traceback walks re-read or follow that work and count none, so a
share of the roofline falls when an implementation adds passes.  The
operations a cell are those of ``PERF.md``'s kernel table (frozen here):
30 a cDNA band cell (55 double affine), 70 a tron cell (95); the branches
at acceptor and donor sites are left out, so the share is a lower bound.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and int32 lanes
# (132 SMs x 64 lanes x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12

OPS_CELL = {("cdna", False): 30, ("cdna", True): 55,
            ("tron", False): 70, ("tron", True): 95}
# the C entry of the first forward pass over a batch -> its DP kind
FORWARD = {"spliced_slab_trace": "cdna", "spliced_slab_trace_dagp": "cdna",
           "spliced_slab_links": "cdna", "spliced_slab_links_dagp": "cdna",
           "spliced_slab_score": "cdna", "tron_forward": "tron",
           "tron_forward_dagp": "tron"}


def cdna_cells(M: int, N: int, lw: int, W: int) -> int:
    """Cells (m, n), 1 <= m <= M, 1 <= n <= N, of the band
    lw + 1 <= n - m <= lw + W."""
    m = np.arange(1, M + 1, dtype=np.int64)
    lo = np.maximum(m + lw + 1, 1)
    hi = np.minimum(m + lw + W, N)
    return int(np.maximum(hi - lo + 1, 0).sum())


def tron_cells(M: int, N: int, lw: int, W: int) -> int:
    """Cells (m, n), 1 <= m <= M, 0 <= n <= N, of the tron band
    lw - 1 <= n - 3m <= lw + W - 2 (three genome columns a residue)."""
    m = np.arange(1, M + 1, dtype=np.int64)
    lo = np.maximum(3 * m + lw - 1, 0)
    hi = np.minimum(3 * m + lw + W - 2, N)
    return int(np.maximum(hi - lo + 1, 0).sum())


def launch_work(kind: str, dagp: bool, Ms, Ns, lws, W: int,
                alphabet: int) -> tuple[int, int]:
    """(int32 operations, bytes) of a forward pass over problems of query
    lengths Ms, genome lengths Ns and band offsets lws at band width W:
    the band cells, each input read once (a query profile row of
    ``alphabet`` ints a residue; 22 ints of genome operands a column for
    cDNA, 4 for tron) and an alignment record of 16 bytes a query row
    written once."""
    ops = nbytes = 0
    for M, N, lw in zip(Ms, Ns, lws):
        M, N, lw = int(M), int(N), int(lw)
        if kind == "tron":
            ops += tron_cells(M, N, lw, W) * OPS_CELL[kind, dagp]
            nbytes += 4 * (M + 4 * (N + 1)) + 16 * M
        else:
            ops += cdna_cells(M, N, lw, W) * OPS_CELL[kind, dagp]
            nbytes += 4 * (M * alphabet + 22 * (N + 1)) + 16 * M
    return ops, nbytes


def least_seconds(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of operations over
    the int32 peak and bytes over the HBM bandwidth."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
