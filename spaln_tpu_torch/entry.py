"""Driver entry points: a one-card forward and a multi-card dry run, the
counterpart of __graft_entry__.py at the repository's root.

    python -m spaln_tpu_torch.entry [n] [--device cuda|cpu]

entry() returns the flagship forward (the batched banded spliced DP,
score-only: K5, ``spliced_slab_score``) with example arguments on a tiny
problem; dryrun_multichip(n) starts n ranks under torch.distributed,
gives each its contiguous shard of a 2n-problem batch, runs K5 and the
end kernel K2e (``spliced_last_ends``) on its device, and all-gathers
the per-problem best row scores and ends (the locus-merge collective);
every rank holds the gathered vectors against the unsharded batch's.
NCCL with a card a rank, gloo with device="cpu" (the plain versions).
The main runs entry()'s forward, then dryrun_multichip(n), n every
local card by default.
"""
from __future__ import annotations

import datetime
import socket
import sys
import time

import numpy as np
import torch

INIT_TIMEOUT_S = 60      # init_process_group and every collective
JOIN_TIMEOUT_S = 300     # the ranks, from spawn to their exit


def _tiny_problem(B: int = 4, M: int = 24, N: int = 96, seed: int = 0):
    """(params, queries, genomes): B random problems of M x N codes,
    drawn as __graft_entry__._tiny_problem draws them."""
    from .config import Config, CvsG, resolve
    from .ops.params import DpParams
    from .score.intron import IntronPenalty
    from .score.simmtx import Simmtx

    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    rng = np.random.default_rng(seed)
    queries = [rng.integers(2, 10, size=M).astype(np.int8) for _ in range(B)]
    genomes = [rng.integers(2, 10, size=N).astype(np.int8) for _ in range(B)]
    return prm, queries, genomes


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (device='cpu' runs "
                           "the plain versions)")
    return device


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): K5's score-only forward over a batch (B=4,
    M=24, N=96, L=8, 3 slabs) prepared on ``device``; fn(bp) returns the
    final row (B, N + 1) int32, whose maximum is a problem's best row
    score."""
    from .ops.dp_spliced import prepare_spliced_batch
    from .ops.dp_spliced_cuda import spliced_slab_score

    B, M, N, L = 4, 24, 96, 8
    prm, queries, genomes = _tiny_problem(B, M, N)
    bp = prepare_spliced_batch(queries, genomes, prm, L=L,
                               device=_device(device))

    def fwd(bp):
        row, _ = spliced_slab_score(bp, prm)
        return row

    return fwd, (bp,)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _best_and_ends(queries, genomes, prm, L, device) -> torch.Tensor:
    """(B, 4) int64 on ``device``: each problem's best final-row score
    (K5) and its (score, end_m, end_n) from K2e."""
    from .ops.dp_spliced import prepare_spliced_batch
    from .ops.dp_spliced_cuda import spliced_last_ends, spliced_slab_score
    bp = prepare_spliced_batch(queries, genomes, prm, L=L, device=device)
    row, rc = spliced_slab_score(bp, prm)
    se = spliced_last_ends(bp, prm, row, rc)
    return torch.cat([row.max(dim=1).values[:, None], se], 1).long()


def _rank_main(rank: int, n: int, device_type: str, port: int) -> None:
    import torch.distributed as dist
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        L, M, N = 8, 8, 64
        B = 2 * n
        prm, queries, genomes = _tiny_problem(B, M, N)
        lo, hi = 2 * rank, 2 * rank + 2            # this rank's shard
        mine = _best_and_ends(queries[lo:hi], genomes[lo:hi], prm, L,
                              device)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine)
        merged = torch.cat(parts).cpu()
        whole = _best_and_ends(queries, genomes, prm, L, device).cpu()
        if merged.shape != (B, 4) or not torch.equal(merged, whole):
            raise AssertionError(f"rank {rank}: gathered {merged.tolist()} "
                                 f"!= unsharded {whole.tolist()}")
        dist.barrier()
        if rank == 0:
            print(f"dryrun_multichip({n}) ok on {backend}: merged scores "
                  f"shape ({B},), max={int(merged[:, 1].max())}, allgather "
                  f"merge max={int(merged[:, 0].max())}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Shard the mapping step's DP over n ranks (one process each, their
    own device: cuda:rank over NCCL, or the CPU over gloo), all-gather
    the per-problem results and hold them against the unsharded batch on
    every rank.  Raises if a rank fails or the ranks outlast
    JOIN_TIMEOUT_S."""
    import torch.multiprocessing as mp
    device_type = torch.device(device).type
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > have:
            raise RuntimeError(f"dryrun_multichip({n_devices}) on cuda needs "
                               f"a card a rank: {have} CUDA devices")
    ctx = mp.spawn(_rank_main, args=(n_devices, device_type, _free_port()),
                   nprocs=n_devices, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"dryrun_multichip({n_devices}): ranks "
                                   f"still running after {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    fn, args = entry(device)
    row = fn(*args)
    print(f"entry ok: {tuple(row.shape)} on {row.device}", flush=True)
    n = int(argv[0]) if argv else (torch.cuda.device_count()
                                   if device == "cuda" else 2)
    dryrun_multichip(n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
