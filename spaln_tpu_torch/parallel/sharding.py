"""Multi-host sharding strategies: genome-sharded vs query-sharded.

The reference scales beyond one node only by external sharding — query
subranges (`file (from to)`) or genome pieces run as independent jobs
whose binary outputs sortgrcd merges (README.md:441-452).  The
equivalents here keep the same durable-artifact contract:

* **query sharding** (default): every host holds the full genome store
  + block index (host RAM; the index for a 3 Gb genome is a few GB of
  CSR, cheap next to genome mapping itself) and maps its slice of the
  query stream.  No cross-host traffic until the final locus merge.
* **genome sharding**: each host builds a store + index over a contig
  slice (`contig_shard`), all queries visit every host, and per-query
  results merge by score (`merge_query_results`).  Choose this only
  when the genome does not fit host RAM — queries/s is then bounded by
  the widest shard, and every query pays h host visits.

Both merges are sortgrcd-shaped: concatenate, cluster, filter — the
same code path as single-host (out/sortgrcd.py), so sharded runs are
bit-equivalent to one big run by construction (tested in
tests/test_sharded_index.py and, for this package,
tests/test_torch_parallel.py).
"""
from __future__ import annotations

import numpy as np


def contig_shard(store, n_hosts: int, host_id: int) -> list[int]:
    """Contig indices of host `host_id`'s genome shard: greedy balanced
    partition by contig length (largest-first), deterministic."""
    lens = [(int(l), i) for i, l in enumerate(store.lengths)]
    lens.sort(key=lambda x: (-x[0], x[1]))
    loads = [0] * n_hosts
    owner = {}
    for ln, ci in lens:
        h = int(np.argmin(loads))
        loads[h] += ln
        owner[ci] = h
    return sorted(ci for ci, h in owner.items() if h == host_id)


def build_shard(store, contig_ids: list[int]):
    """A GenomeStore over a contig subset (a host's genome shard)."""
    from ..seq.genome import GenomeStore
    recs = [(store.names[ci], store.contig(ci)) for ci in contig_ids]

    class _Rec:
        def __init__(self, name, codes, molc):
            self.name, self.codes, self.molc = name, codes, molc

    return GenomeStore.from_records(
        [_Rec(n, c, store.molc) for n, c in recs])


def split_queries(n_queries: int, n_hosts: int, host_id: int) -> slice:
    """Host's query slice for query sharding (contiguous blocks)."""
    per = -(-n_queries // n_hosts)
    return slice(host_id * per, min((host_id + 1) * per, n_queries))


def merge_query_results(per_host: list[list[list]], max_out: int = 1
                        ) -> list[list]:
    """Genome-sharded merge: per query, the best-scoring loci across all
    host shards (the cross-host locus-merge collective; host-side since
    results are tiny next to the DP)."""
    n_q = len(per_host[0])
    out = []
    for qi in range(n_q):
        allres = [gs for host in per_host for gs in host[qi]]
        allres.sort(key=lambda g: -g.score)
        out.append(allres[:max_out])
    return out
