"""Indexed edge-list graph container and constructors (PyTorch twin of
``torch_random_walk_tpu/graph/edge_list.py``).

Contracts kept from the JAX package:

- the edge list is (E, 2) [head, tail], sorted by (head, tail); undirected
  networkx graphs get their reversed edges appended;
- ``node_edge_index`` is (N, 2) [start, end] with an *inclusive* end, and
  (-1, -1) for a node without out-edges;
- ids are ``int32``.  The JAX package falls back to ``int64`` from 2^31 on;
  the port's kernels take ``int32`` only, so the constructors raise there.

The packed "fat" tables of the JAX package are not built.  In their place
the graph holds its tails as a column of their own (``EdgeListGraph.tails``,
``edge_list[:, 1]``), which the biased walk kernel K8 reads; the uniform
kernel K7 reads the edge list and its index directly.  Whether the JAX
package would build the fat tables is kept all the same
(``EdgeListGraph.fat``), because it picks the semantics of
``walk_edge_list(graph, p, q)`` (``ops/walk.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from torch_random_walk_tpu_torch.graph.csr import fat_tables_fit
from torch_random_walk_tpu_torch.utils.device import resolve_device

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class EdgeListGraph:
    """Sorted indexed edge list and per-node edge-range index on one device.

    edge_list: (num_edges, 2) int32 [head, tail], sorted by (head, tail).
    node_edge_index: (num_nodes, 2) int32 [start, end-inclusive], (-1, -1)
        for a node without out-edges.
    fat: True where the JAX package's ``EdgeListGraph`` of the same edges
        holds fat tables (``edge_tab is not None``); no table is built here.
    tails: (num_edges,) int32, ``edge_list[:, 1]`` as a column of its own,
        built with the graph (K8's layout: eight tails a 32-byte sector).
    """

    edge_list: torch.Tensor
    node_edge_index: torch.Tensor
    num_nodes: int
    num_edges: int
    max_degree: int
    fat: bool = True
    tails: torch.Tensor = dataclasses.field(init=False, repr=False,
                                            compare=False)

    def __post_init__(self):
        object.__setattr__(self, "tails", self.edge_list[:, 1].contiguous())

    @property
    def device(self) -> torch.device:
        return self.edge_list.device

    @property
    def search_iters(self) -> int:
        """Trip count of a binary search over one node's edges:
        ceil(log2(max_degree)) + 1."""
        return max(1, int(math.ceil(math.log2(max(self.max_degree, 2)))) + 1)

    @classmethod
    def from_arrays(cls, edge_list, num_nodes: int | None = None,
                    device=None) -> "EdgeListGraph":
        """Sort (E, 2) [head, tail] edges by (head, tail) on the device and
        build the inclusive range index.  ``num_nodes`` defaults to the
        largest id + 1."""
        dev = resolve_device(device)
        edges = as_int64(edge_list, dev).reshape(-1, 2)
        if num_nodes is None:
            num_nodes = int(edges.max()) + 1 if edges.numel() else 0
        heads, tails = sort_rows_by(edges[:, 0], edges[:, 1])
        counts = head_counts(heads, num_nodes)
        starts = exclusive_cumsum(counts)
        index = torch.stack([starts, starts + counts - 1], dim=1)
        index[counts == 0] = -1
        num_edges = int(heads.shape[0])
        max_degree = int(counts.max()) if num_nodes else 0
        return cls(edge_list=torch.stack([heads, tails], dim=1)
                   .to(torch.int32).contiguous(),
                   node_edge_index=index.to(torch.int32).contiguous(),
                   num_nodes=num_nodes, num_edges=num_edges,
                   max_degree=max_degree,
                   fat=fat_tables_fit(num_nodes, num_edges, max_degree))

    @classmethod
    def from_networkx(cls, graph, device=None) -> "EdgeListGraph":
        edges, mapping = to_edge_list_indexed(graph, device=device)
        return cls.from_arrays(edges, num_nodes=len(mapping), device=device)


def to_edge_list_indexed(graph, device=None):
    """networkx graph -> ((E, 2) int32 indexed edge list, node -> index
    mapping).  Nodes are indexed in sorted order; an undirected graph gets
    its reversed edges appended."""
    import networkx as nx

    nodes = sorted(graph.nodes())
    mapping = {n: i for i, n in enumerate(nodes)}
    edges = np.array([[mapping[h], mapping[t]] for h, t in graph.edges()],
                     np.int64).reshape(-1, 2)
    if not nx.is_directed(graph):
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    return (torch.from_numpy(edges.astype(np.int32))
            .to(resolve_device(device)), mapping)


def build_node_edge_index(edge_list_indexed, nodes=None, device=None):
    """Sort the edge list by (head, tail) and build the (N, 2)
    [start, end-inclusive] index, N = max(nodes) + 1 (or the largest id of
    the edges + 1).  Returns (node_edge_index, sorted_edge_list)."""
    dev = resolve_device(device)
    edges = as_int64(edge_list_indexed, dev)
    if nodes is not None:
        num_nodes = int(as_int64(nodes, dev).max()) + 1
    else:
        num_nodes = int(edges.max()) + 1 if edges.numel() else 0
    g = EdgeListGraph.from_arrays(edges, num_nodes=num_nodes, device=dev)
    return g.node_edge_index, g.edge_list


# --- helpers shared with graph/triples.py ------------------------------------

def as_int64(x, device: torch.device) -> torch.Tensor:
    """Array-like or tensor of ids -> int64 tensor on ``device``; raises
    where an id does not fit the kernels' int32."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=torch.int64)
    else:
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)
    if t.numel() and (int(t.min()) < INT32_MIN or int(t.max()) > INT32_MAX):
        raise ValueError("ids of 2^31 and more are not supported by the int32 "
                         "kernels")
    return t


def sort_rows_by(*keys: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The key columns reordered by (keys[0], keys[1], ...), ascending: one
    stable sort per key, least significant first (``numpy.lexsort``)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return tuple(key[order] for key in keys)


def head_counts(heads: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Out-degree of each of ``num_nodes`` nodes (``numpy.bincount``), with
    every head required to lie in [0, num_nodes)."""
    if num_nodes >= 2 ** 31 or heads.shape[0] >= 2 ** 31:
        raise ValueError("graphs of 2^31 nodes or edges and more are not "
                         "supported by the int32 kernels")
    if heads.numel() and (int(heads.min()) < 0
                          or int(heads.max()) >= num_nodes):
        raise ValueError(f"head ids out of range [0, {num_nodes})")
    return torch.bincount(heads, minlength=num_nodes)


def exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    starts = torch.zeros_like(counts)
    if counts.numel() > 1:
        torch.cumsum(counts[:-1], 0, out=starts[1:])
    return starts
