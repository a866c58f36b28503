"""Indexed edge-list graph container and constructors (PyTorch twin of
``torch_random_walk_tpu/graph/edge_list.py``).

Contracts kept from the JAX package:

- the edge list is (E, 2) [head, tail], sorted by (head, tail); undirected
  networkx graphs get their reversed edges appended;
- ``node_edge_index`` is (N, 2) [start, end] with an *inclusive* end, and
  (-1, -1) for a node without out-edges;
- ids are ``int32``.  The JAX package falls back to ``int64`` from 2^31 on;
  the port's kernels take ``int32`` only, so the constructors raise there.

Beside the edge list the graph holds, built with it and on its device, the
columns its walk kernels read a step:

- ``EdgeListGraph.tails``, ``edge_list[:, 1]`` as a column of its own, which
  the biased walk kernel K8 reads, and the uniform kernel K7 where the packed
  rows do not fit;
- ``EdgeListGraph.edge_tab``, the JAX package's packed edge rows
  (``torch_random_walk_tpu/graph/edge_list.py``): row e packs (tail,
  start_tail, cnt_tail) into two 32-bit words with the JAX layout's widths,
  so that K7 draws a step with one 8-byte gather.  It exists where the JAX
  package builds it (``EdgeListGraph.fat`` and the layout fits), and is
  derived from the graph's own edge list and range index, so a graph
  constructed directly gets it too.

Whether the JAX package would build the fat tables (``EdgeListGraph.fat``)
also picks the semantics of ``walk_edge_list(graph, p, q)``
(``ops/walk.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from torch_random_walk_tpu_torch.graph.csr import bits_for, fat_tables_fit
from torch_random_walk_tpu_torch.utils.device import resolve_device

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class EdgeListGraph:
    """Sorted indexed edge list and per-node edge-range index on one device.

    edge_list: (num_edges, 2) int32 [head, tail], sorted by (head, tail).
    node_edge_index: (num_nodes, 2) int32 [start, end-inclusive], (-1, -1)
        for a node without out-edges.
    fat: True where the JAX package's ``EdgeListGraph`` of the same edges
        holds fat tables (``edge_tab is not None``); False by default, as
        the JAX dataclass built from its fields holds none.
    tails: (num_edges,) int32, ``edge_list[:, 1]`` as a column of its own,
        built with the graph (K8's layout: eight tails a 32-byte sector).
    edge_tab: (num_edges, 2) int32 bit patterns of the JAX package's packed
        (tail, start_tail, cnt_tail) rows (``packed_edge_rows``), K7's
        layout; None where ``fat`` is false or the packed layout does not
        fit (``fat_tables_fit``), as in the JAX package.
    """

    edge_list: torch.Tensor
    node_edge_index: torch.Tensor
    num_nodes: int
    num_edges: int
    max_degree: int
    fat: bool = False
    tails: torch.Tensor = dataclasses.field(init=False, repr=False,
                                            compare=False)
    edge_tab: torch.Tensor | None = dataclasses.field(init=False, repr=False,
                                                      compare=False)

    def __post_init__(self):
        object.__setattr__(self, "tails", self.edge_list[:, 1].contiguous())
        fits = self.fat and fat_tables_fit(self.num_nodes, self.num_edges,
                                           self.max_degree)
        object.__setattr__(self, "edge_tab", packed_edge_rows(
            self.tails, self.node_edge_index, self.packed_bits)
            if fits else None)

    @property
    def packed_bits(self) -> tuple[int, int, int]:
        """Bit widths (node, start, deg) of the JAX package's packed layout
        (``PackedLayout``) for this graph's sizes."""
        return (bits_for(self.num_nodes), bits_for(self.num_edges + 1),
                bits_for(self.max_degree + 1))

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


# --- the kernels' per-step columns, shared with graph/triples.py ------------

def next_ranges(tails: torch.Tensor, index: torch.Tensor):
    """(start, cnt) int64 of each tail's own range in an (N, 2) [start,
    end-inclusive] index, as the JAX package's fat tables hold them: cnt is
    the range's size, 0 for a node without out-edges (a row of -1), whose
    start is where its range would begin (the end of the ranges of the
    nodes before it).  Raises where a tail lies outside [0, N), which the
    JAX package's tables cannot hold either."""
    num_nodes = index.shape[0]
    if tails.numel() and (int(tails.min()) < 0
                          or int(tails.max()) >= num_nodes):
        raise ValueError(f"tail ids out of range [0, {num_nodes})")
    lo, hi = index[:, 0].to(torch.int64), index[:, 1].to(torch.int64)
    has = (lo >= 0) & (hi >= 0)
    ends = torch.where(has, hi + 1, 0)
    before = torch.zeros_like(ends)
    if num_nodes > 1:
        before[1:] = torch.cummax(ends[:-1], 0).values
    start = torch.where(has, lo, before)
    # the walks' draw bound: at least 1 where the node has a range
    cnt = torch.where(has, (hi + 1 - lo).clamp(min=1), 0)
    t = tails.to(torch.int64)
    return start[t], cnt[t]


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the int32 of the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def packed_edge_rows(tails: torch.Tensor, index: torch.Tensor,
                     layout: tuple[int, int, int]) -> torch.Tensor:
    """(E, 2) int32: row e packs (tails[e], start, cnt) of its tail's range
    into the value tail | start << node_bits | cnt << (node_bits +
    start_bits), split into a low and a high 32-bit word
    (``torch_random_walk_tpu/graph/csr.py::PackedLayout.pack_np``).  Raises
    where a field does not fit its width."""
    start, cnt = next_ranges(tails, index)
    lo = torch.zeros_like(start)
    hi = torch.zeros_like(start)
    offset = 0
    for field, bits in zip((tails.to(torch.int64), start, cnt), layout):
        if field.numel() and int(field.max()) >= 2 ** bits:
            raise ValueError(f"a value does not fit its {bits}-bit field: "
                             "the graph's max_degree is below a degree")
        if offset >= 32:
            hi |= field << (offset - 32)
        else:  # field < 2^31 and offset < 32: no int64 overflow
            lo |= (field << offset) & 0xFFFFFFFF
            hi |= (field << offset) >> 32
        offset += bits
    return torch.stack([as_int32_bits(lo), as_int32_bits(hi)], dim=1)


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
