"""Locally generated graphs (PyTorch twin of the generators in
``torch_random_walk_tpu/graph/datasets.py`` that need no download)."""

from __future__ import annotations

import numpy as np

from torch_random_walk_tpu_torch.graph.csr import CSRGraph


def synthetic_power_law(num_nodes: int, avg_degree: int, seed: int = 0,
                        device=None) -> CSRGraph:
    """Synthetic graph with a heavy-tailed in-degree (hub) distribution.

    The edge list is drawn on the host with the same
    ``numpy.random.default_rng(seed)`` calls, in the same order, as the JAX
    package's generator, so it is the same graph edge for edge; the CSR is
    then sorted and built on the device.  A ring through all nodes guarantees
    that no node is a dead end.
    """
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    u = rng.random(num_edges)
    dst = (u * u * num_nodes).astype(np.int64)
    src = rng.integers(0, num_nodes, num_edges)
    ring = np.arange(num_nodes, dtype=np.int64)
    src = np.concatenate([src, ring, (ring + 1) % num_nodes])
    dst = np.concatenate([dst, (ring + 1) % num_nodes, ring])
    return CSRGraph.from_edges(src, dst, num_nodes=num_nodes, device=device)
