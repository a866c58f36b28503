"""Locally generated graphs (PyTorch twin of the generators in
``torch_random_walk_tpu/graph/datasets.py`` that need no download)."""

from __future__ import annotations

import numpy as np

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.graph.triples import TriplesGraph


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


def synthetic_grid_kg(side: int = 45, seed: int = 0, device=None):
    """Grid-world knowledge graph with an exact TransE ground truth.

    Entities are the cells of a side x side grid; relations are translations
    (0 = east, 1 = north, 2 = east-2, 3 = north-east).  Border cells lack
    some out-triples and the far corner is a dead end, which gives triples
    walks their padding path.  A tenth of the triples is held out, drawn
    with the same ``numpy.random.default_rng(seed)`` permutation as the JAX
    package's generator.  Returns (``TriplesGraph`` over the kept triples on
    ``device``, all triples, held-out triples), the last two as (E, 3) int64
    numpy arrays, as the JAX package returns them.
    """
    n = side * side
    offsets = [(1, 0), (0, 1), (2, 0), (1, 1)]  # (dx, dy) per relation
    triples = []
    for r, (dx, dy) in enumerate(offsets):
        x, y = np.meshgrid(np.arange(side - dx), np.arange(side - dy),
                           indexing="ij")
        h = x.ravel() * side + y.ravel()
        t = (x.ravel() + dx) * side + (y.ravel() + dy)
        triples.append(np.stack([h, np.full_like(h, r), t], axis=1))
    triples = np.concatenate(triples)
    perm = np.random.default_rng(seed).permutation(triples.shape[0])
    k = triples.shape[0] // 10
    test, train = triples[perm[:k]], triples[perm[k:]]
    return (TriplesGraph.from_arrays(train, num_entities=n, device=device),
            triples, test)
