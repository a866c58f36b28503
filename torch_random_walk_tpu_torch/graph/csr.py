"""CSR graph container and constructors (PyTorch twin of
``torch_random_walk_tpu/graph/csr.py``), and the reference-parity helpers
``to_csr`` and ``nodes_tensor`` of a networkx graph.

Invariants the walk kernels rely on:

- ``col_idx`` is sorted within each row (binary-search membership tests);
  duplicate edges are kept, as the JAX package's native CSR build keeps them;
- ids are ``int32``.  The JAX package falls back to ``int64`` from 2^31 nodes
  or edges on; the port's kernels take ``int32`` only, so the constructors
  raise there.

The packed "fat" tables of the JAX package are not built here: the CUDA
kernels read ``row_ptr`` and ``col_idx`` directly.  Whether the JAX package
would build them for a graph is kept all the same (``CSRGraph.fat``), because
it picks the biased sampler of ``walk(graph, p, q)``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from torch_random_walk_tpu_torch.utils.device import resolve_device


def bits_for(n: int) -> int:
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def fat_tables_fit(num_nodes: int, num_edges: int, max_degree: int) -> bool:
    """Would the JAX package pack this graph into its fat tables?  Its packed
    row holds (node, start, deg) in two 32-bit words: the three field widths
    must sum to at most 64 bits and each must stay below 32
    (``torch_random_walk_tpu/graph/csr.py::PackedLayout.fits``).  A graph with
    no node or no edge gets no tables."""
    if not (num_nodes and num_edges):
        return False
    widths = (bits_for(num_nodes), bits_for(num_edges + 1),
              bits_for(max_degree + 1))
    return sum(widths) <= 64 and max(widths) <= 31


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency on one device.

    row_ptr: (num_nodes + 1,) int32 row offsets into col_idx.
    col_idx: (num_edges,) int32 neighbour ids, sorted within each row.
    fat: True where the JAX package's ``CSRGraph`` of the same arrays holds
        fat tables (``edge_tab is not None``).  ``walk(graph, p, q)`` then
        takes the mixture sampler, as the JAX fat engine does, and the
        rejection sampler otherwise.  No table is built here.  A graph
        built directly from its fields is not fat unless told so, as the
        JAX dataclass built from its fields holds no tables.
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    num_nodes: int
    num_edges: int
    max_degree: int
    fat: bool = False

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def search_iters(self) -> int:
        """Trip count of a binary search over one row:
        ceil(log2(max_degree)) + 1."""
        return max(1, int(math.ceil(math.log2(max(self.max_degree, 2)))) + 1)

    @property
    def deg_bits(self) -> int:
        """Width of the degree field of the JAX package's packed layout
        (``CSRGraph.layout.deg_bits``).  The mixture sampler's integer
        weights are scaled from it, so it is part of the bitstream."""
        return bits_for(self.max_degree + 1)

    @classmethod
    def from_arrays(cls, row_ptr, col_idx, sort_rows: bool = True,
                    build_fat: bool = True, device=None) -> "CSRGraph":
        """``build_fat=False`` gives the graph the JAX package builds with
        the same flag: no fat tables, so biased walks by rejection."""
        dev = resolve_device(device)
        row_ptr = _as_int64(row_ptr, dev)
        col_idx = _as_int64(col_idx, dev)
        if row_ptr.dim() != 1 or row_ptr.shape[0] < 1 or col_idx.dim() != 1:
            raise ValueError("row_ptr must be (num_nodes + 1,) and col_idx "
                             "(num_edges,)")
        num_nodes = int(row_ptr.shape[0]) - 1
        num_edges = int(col_idx.shape[0])
        if num_nodes >= 2 ** 31 or num_edges >= 2 ** 31:
            raise ValueError("graphs of 2^31 nodes or edges and more are not "
                             "supported by the int32 kernels")
        degrees = row_ptr[1:] - row_ptr[:-1]
        if num_nodes and (int(row_ptr[0]) != 0 or int(row_ptr[-1]) != num_edges
                          or int(degrees.min()) < 0):
            raise ValueError("row_ptr must rise from 0 to len(col_idx)")
        if sort_rows and num_edges:
            rows = torch.repeat_interleave(
                torch.arange(num_nodes, device=dev), degrees)
            span = int(col_idx.max()) + 1
            key = torch.sort(rows * span + col_idx).values
            col_idx = key % span
        max_degree = int(degrees.max()) if num_nodes else 0
        return cls(row_ptr=row_ptr.to(torch.int32).contiguous(),
                   col_idx=col_idx.to(torch.int32).contiguous(),
                   num_nodes=num_nodes, num_edges=num_edges,
                   max_degree=max_degree,
                   fat=build_fat and fat_tables_fit(num_nodes, num_edges,
                                                    max_degree))

    @classmethod
    def from_edges(cls, src, dst, num_nodes: int | None = None,
                   symmetrize: bool = False, device=None) -> "CSRGraph":
        """Build from raw edge arrays: edges sorted by (src, dst) on the
        device, duplicates kept.  Equals the JAX package's
        ``native.build_csr`` followed by ``from_arrays``."""
        dev = resolve_device(device)
        src = _as_int64(src, dev)
        dst = _as_int64(dst, dev)
        if src.shape != dst.shape or src.dim() != 1:
            raise ValueError("src and dst must be 1-d arrays of equal length")
        if symmetrize:
            src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        num_edges = int(src.shape[0])
        if num_nodes is None:
            num_nodes = (int(torch.maximum(src.max(), dst.max())) + 1
                         if num_edges else 0)
        if num_nodes >= 2 ** 31 or num_edges >= 2 ** 31:
            raise ValueError("graphs of 2^31 nodes or edges and more are not "
                             "supported by the int32 kernels")
        if num_edges:
            lo = int(torch.minimum(src.min(), dst.min()))
            hi = int(torch.maximum(src.max(), dst.max()))
            if lo < 0 or hi >= num_nodes:
                raise ValueError(f"edge ids out of range [0, {num_nodes}): "
                                 f"found ids in [{lo}, {hi}]")
        # One sort of the 64-bit key src * N + dst orders edges by (src, dst).
        key = torch.sort(src * num_nodes + dst).values if num_edges else src
        col_idx = (key % num_nodes) if num_edges else key
        counts = torch.bincount(src, minlength=num_nodes)
        row_ptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dev)
        torch.cumsum(counts, 0, out=row_ptr[1:])
        max_degree = int(counts.max()) if num_nodes else 0
        return cls(row_ptr=row_ptr.to(torch.int32),
                   col_idx=col_idx.to(torch.int32).contiguous(),
                   num_nodes=num_nodes, num_edges=num_edges,
                   max_degree=max_degree,
                   fat=fat_tables_fit(num_nodes, num_edges, max_degree))

    @classmethod
    def from_networkx(cls, graph, device=None) -> "CSRGraph":
        """Adjacency in ``graph.nodes()`` order, as the reference's
        ``nx.to_scipy_sparse_matrix`` orders it (torch_rw/utils.py:6)."""
        import networkx as nx

        csr = nx.to_scipy_sparse_array(graph, format="csr")
        return cls.from_arrays(csr.indptr, csr.indices, device=device)


def to_csr(graph, device=None):
    """Reference-parity helper (torch_rw/utils.py:5): networkx graph ->
    (row_ptr, col_idx) int32 tensors on ``device``."""
    g = CSRGraph.from_networkx(graph, device=device)
    return g.row_ptr, g.col_idx


def nodes_tensor(graph, device=None) -> torch.Tensor:
    """Reference-parity helper (torch_rw/utils.py:11): the node indices
    0..N-1 in insertion order, int32.  The reference computes
    ``nodes.index(node)`` for each node of ``list(graph.nodes())``; nodes are
    unique, so each one's first occurrence is its own position and the
    result is always ``arange(N)``."""
    return torch.arange(len(graph.nodes()), dtype=torch.int32,
                        device=resolve_device(device))


def _as_int64(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)
