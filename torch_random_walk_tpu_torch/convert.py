"""State carried across from the JAX package.

The JAX package's ``CSRGraph`` and ``PartitionedCSR`` fields, handed over as
numpy arrays (``numpy.asarray(graph.row_ptr)`` and so on; this module imports
neither JAX nor the JAX package), become the port's objects with the same
``max_degree``, ``search_iters`` and ``deg_bits``, so that walks over a
converted graph equal walks over the original.  This slice of the port has no
trained weights; the embedding tables of the trainers join this file with
them.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.parallel.partition import PartitionedCSR
from torch_random_walk_tpu_torch.utils.device import resolve_device


def csr_from_numpy(row_ptr, col_idx, device=None) -> CSRGraph:
    """(num_nodes + 1,) row offsets and (num_edges,) neighbour ids, rows
    already sorted (every JAX ``CSRGraph`` constructor guarantees it)."""
    return CSRGraph.from_arrays(np.asarray(row_ptr), np.asarray(col_idx),
                                sort_rows=False, device=device)


def partitioned_from_numpy(node_meta, col, num_nodes: int, num_shards: int,
                           shard_nodes: int, device=None) -> PartitionedCSR:
    """Stacked (D, S, 2) ``node_meta_shards`` and (D, E_max) ``col_shards``
    of a JAX ``PartitionedCSR`` -> one separately allocated tensor pair per
    shard."""
    dev = resolve_device(device)
    node_meta = np.asarray(node_meta)
    col = np.asarray(col)
    if node_meta.shape != (num_shards, shard_nodes, 2):
        raise ValueError(f"node_meta must be ({num_shards}, {shard_nodes}, 2)"
                         f", got {node_meta.shape}")
    if col.ndim != 2 or col.shape[0] != num_shards:
        raise ValueError(f"col must be ({num_shards}, E_max), got {col.shape}")

    def shard(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)  # copies

    return PartitionedCSR(
        node_meta=tuple(shard(node_meta[d]) for d in range(num_shards)),
        col=tuple(shard(col[d]) for d in range(num_shards)),
        num_nodes=int(num_nodes), num_shards=int(num_shards),
        shard_nodes=int(shard_nodes))
