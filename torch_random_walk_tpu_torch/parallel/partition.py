"""Node-range partitioned CSR (twin of ``PartitionedCSR`` and
``build_partition_hashes`` in ``torch_random_walk_tpu/parallel/partition.py``;
the reduction-based v1 walk of that module is not ported yet).

Nodes are split into ``num_shards`` contiguous ranges of ``shard_nodes``
(= ceil(N / D)) ids; owner(v) = v // shard_nodes.  Each shard holds its own
tensors, allocated separately:

    node_meta[d]: (S, 2) int32 [start, deg] per local node, start rebased to
                  the shard's own col tensor; rows past the last node have
                  degree 0.
    col[d]:       (E_max,) int32 global neighbour ids, padded with 0 to the
                  largest shard's edge count (at least 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.graph.hashset import EdgeHashSet


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    node_meta: tuple[torch.Tensor, ...]
    col: tuple[torch.Tensor, ...]
    num_nodes: int
    num_shards: int
    shard_nodes: int

    @property
    def device(self) -> torch.device:
        return self.col[0].device

    @classmethod
    def from_csr(cls, graph: CSRGraph, num_shards: int) -> "PartitionedCSR":
        """Partition on the graph's own device."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        n = graph.num_nodes
        s = -(-n // num_shards)  # ceil
        bounds = [min(d * s, n) for d in range(num_shards + 1)]
        row_ptr = graph.row_ptr.to(torch.int64)
        edge_bounds = row_ptr[torch.tensor(bounds, device=graph.device)].tolist()
        e_max = max(max(b - a for a, b in zip(edge_bounds, edge_bounds[1:])), 1)
        metas, cols = [], []
        for d in range(num_shards):
            lo, hi = bounds[d], bounds[d + 1]
            e_lo, e_hi = edge_bounds[d], edge_bounds[d + 1]
            rp = row_ptr[lo: hi + 1] - e_lo
            meta = torch.zeros((s, 2), dtype=torch.int32, device=graph.device)
            meta[:, 0] = e_hi - e_lo  # padded rows: start at the end, deg 0
            meta[: hi - lo, 0] = rp[:-1]
            meta[: hi - lo, 1] = rp[1:] - rp[:-1]
            col = torch.zeros((e_max,), dtype=torch.int32, device=graph.device)
            col[: e_hi - e_lo] = graph.col_idx[e_lo:e_hi]
            metas.append(meta)
            cols.append(col)
        return cls(node_meta=tuple(metas), col=tuple(cols), num_nodes=n,
                   num_shards=num_shards, shard_nodes=s)


def build_partition_hashes(pgraph: PartitionedCSR, graph: CSRGraph):
    """Per-shard cuckoo edge sets for the routed node2vec engine: shard d's
    set holds the edges whose head lives on shard d, so t's owner answers
    ``cand in N(t)`` alone.  Built on the partitioned graph's device.
    Returns (tables (D, S_h, 2) int32 bit patterns, salts (D,) int32,
    log_size)."""
    return shard_hash_tables(graph.row_ptr, graph.col_idx, pgraph)


def shard_hash_tables(row_ptr, tails, pgraph):
    """The per-shard cuckoo edge sets of a CSR form (``row_ptr`` (N+1,),
    ``tails`` (E,)) node-range sharded like ``pgraph``: every shard's table
    has the size the largest shard needs (log2 of 4 slots an edge, at least
    16 slots); an empty shard gets an empty table of that size and salt 0.
    Returns (tables (D, S_h, 2) int32 bit patterns, salts (D,) int32,
    log_size)."""
    dev = pgraph.device
    row_ptr = row_ptr.to(device=dev, dtype=torch.int64)
    col_idx = tails.to(dev)
    n, s = row_ptr.shape[0] - 1, pgraph.shard_nodes
    shards, max_log = [], 4
    for d in range(pgraph.num_shards):
        lo, hi = min(d * s, n), min((d + 1) * s, n)
        e_lo, e_hi = (int(x) for x in row_ptr[[lo, hi]].tolist())
        heads = torch.repeat_interleave(
            torch.arange(lo, hi, device=dev), row_ptr[lo + 1: hi + 1]
            - row_ptr[lo:hi]) if hi > lo else row_ptr[:0]
        shards.append((heads, col_idx[e_lo:e_hi]))
        e = max(e_hi - e_lo, 1)
        max_log = max(max_log, int(math.ceil(math.log2(max(4 * e, 16)))))
    tables, salts = [], []
    for heads, shard_tails in shards:
        if heads.numel() == 0:
            tables.append(torch.full((1 << max_log, 2), -1, dtype=torch.int32,
                                     device=dev))
            salts.append(0)
            continue
        hs = EdgeHashSet.from_edges_with_log_size(heads, shard_tails,
                                                  max_log)
        tables.append(hs.table)
        salts.append(hs.salt)
    return (torch.stack(tables),
            torch.tensor(salts, dtype=torch.int32, device=dev), max_log)
