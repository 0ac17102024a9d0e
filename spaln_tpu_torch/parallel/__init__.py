"""Data parallelism over cards (the counterpart of spaln_tpu.parallel's
jax device mesh; the reference's only parallelism is single-node pthreads
+ external sharding via sortgrcd merge, SURVEY.md 2.7).  Query batches
split data-parallel over a list of devices, genome/index on the host,
locus merge as the collective.

Usage:
    devices = local_devices()                # every local card
    res = map_queries_sharded(mapper, queries, devices=devices)
    loci = merge_shards([res, other_host_res, ...])
"""
from __future__ import annotations

import torch


def local_devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` local CUDA devices (all of them by default).  With
    no GPU, or fewer than ``n``, it is an error: the DP never moves to
    the CPU unasked."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("local_devices: no CUDA device is available")
    n = count if n is None else n
    if not 0 < n <= count:
        raise RuntimeError(f"local_devices({n}): {count} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def map_queries_sharded(mapper, queries: list, q_names=None, devices=None,
                        **kw):
    """Run GenomeMapper.map_queries with every batch split over
    ``devices`` (default: local_devices()).

    Each batch makes its plane/UDH choice whole, then runs as contiguous
    shards, one per listed device, at once, with no cross-card
    communication inside the DP (queries are independent, matching the
    reference's lock-free worker design, SURVEY.md A.13); the results
    come back in job order, equal to the unsharded run's.  A device may
    be listed more than once."""
    if devices is None:
        devices = local_devices()
    return mapper.map_queries(queries, q_names=q_names, devices=devices,
                              **kw)


def merge_shards(shard_results: list, q_lens: dict | None = None,
                 filt=None):
    """Merge per-shard mapping results into gene loci (the sortgrcd
    collective: concatenate shards, cluster, filter — works identically
    for one shard or many hosts' gathered outputs)."""
    from ..out.sortgrcd import cluster_loci
    records = []
    for res in shard_results:
        for per_query in res:
            records.extend(per_query)
    return cluster_loci(records, q_lens=q_lens, filt=filt)
