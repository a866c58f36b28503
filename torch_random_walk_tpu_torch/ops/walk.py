"""Public walk entry points (twin of ``torch_random_walk_tpu/ops/walk.py``:
``walk``, ``walk_edge_list``, ``walk_triples``).

Dispatch, as in the JAX package: p == q == 1 selects the uniform walk; a
``CSRGraph`` with fat tables (``graph.fat``, the JAX package's
``edge_tab is not None``) selects the mixture sampler scaled by
``graph.deg_bits``; a ``CSRGraph`` without them selects the rejection sampler
with ``graph.search_iters``; raw (row_ptr, col_idx) arrays select the
rejection sampler with the conservative search depth.  The mixture and the
rejection sampler are two deliberate bitstreams.

``walk_edge_list`` and ``walk_triples`` dispatch as the JAX package does: a
graph with fat tables (``graph.fat``) takes the fat engine's semantics, raw
arrays and graphs without them the oracle's (``ops/edge_list_walk.py``,
``ops/triples_walk.py`` say where the two differ).  The raw edge-list entry
searches with the conservative depth, the graph entry with
``graph.search_iters``.
"""

from __future__ import annotations

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.graph.edge_list import EdgeListGraph
from torch_random_walk_tpu_torch.graph.triples import TriplesGraph
from torch_random_walk_tpu_torch.ops import common, edge_list_walk
from torch_random_walk_tpu_torch.ops.node2vec import (
    NO_PROBS,
    biased_walk,
    mixture_consts,
    node2vec_walk_csr,
)
from torch_random_walk_tpu_torch.ops.triples_walk import (
    uniform_walk_triples,
    uniform_walk_triples_graph,
)
from torch_random_walk_tpu_torch.ops.uniform import uniform_walk_csr
from torch_random_walk_tpu_torch.utils.device import resolve_device


def walk(row_ptr, col_idx=None, target_nodes=None, p=1.0, q=1.0,
         walk_length=10, seed=0, max_rounds=common.DEFAULT_MAX_ROUNDS,
         device=None):
    """Random walks from ``target_nodes``: (B, walk_length + 1) int32.

    The first argument may be a ``CSRGraph`` instead of (row_ptr, col_idx).
    ``device=None`` means the card.  On a fat ``CSRGraph``, a walker whose
    round budget (``max_rounds`` per step) runs out gets -1 in its last
    column, the JAX fat engine's mark of an incomplete walk; the rejection
    forms keep the walker in place for that step, as the JAX oracle does.
    """
    if target_nodes is None:
        raise ValueError("target_nodes is required")
    if isinstance(row_ptr, CSRGraph):
        graph = row_ptr
        dev = _graph_device(graph, device)
        if p == 1.0 and q == 1.0:
            return uniform_walk_csr(graph.row_ptr, graph.col_idx,
                                    target_nodes, walk_length, seed,
                                    device=dev)
        if not graph.fat:
            return node2vec_walk_csr(graph.row_ptr, graph.col_idx,
                                     target_nodes, p, q, walk_length, seed,
                                     search_iters=graph.search_iters,
                                     max_rounds=max_rounds, device=dev)
        out = biased_walk(
            graph.row_ptr, graph.col_idx, target_nodes, walk_length, seed, 0,
            True, NO_PROBS, mixture_consts(float(p), float(q),
                                            graph.deg_bits),
            graph.search_iters, max_rounds, dev)
        out.walks[:, -1].masked_fill_(out.exhausted, -1)
        return out.walks
    if col_idx is None:
        raise ValueError("col_idx is required with a raw row_ptr")
    if p == 1.0 and q == 1.0:
        return uniform_walk_csr(row_ptr, col_idx, target_nodes, walk_length,
                                seed, device=device)
    return node2vec_walk_csr(row_ptr, col_idx, target_nodes, p, q,
                             walk_length, seed, max_rounds=max_rounds,
                             device=device)


def _graph_device(graph, device):
    dev = resolve_device(device)
    if graph.device != dev:
        raise ValueError(f"graph lives on {graph.device}, the walk was asked "
                         f"for {dev}")
    return dev


def walk_edge_list(edge_list_indexed, node_edge_index=None, target_nodes=None,
                   p=1.0, q=1.0, walk_length=10, seed=0, padding_idx=-1,
                   restart=True, max_rounds=common.DEFAULT_MAX_ROUNDS,
                   device=None):
    """Edge-list walks with padding/restart semantics: (B, walk_length + 1)
    int32.  The first argument may be an ``EdgeListGraph`` instead of
    (edge_list_indexed, node_edge_index).  On a fat ``EdgeListGraph``, a
    biased walker whose round budget (``max_rounds`` per step) runs out gets
    -1 in its last column, the JAX fat engine's mark of an incomplete walk;
    the other forms keep the walker in place for that step, as the JAX
    oracle does."""
    if target_nodes is None:
        raise ValueError("target_nodes is required")
    uniform = p == 1.0 and q == 1.0
    if isinstance(edge_list_indexed, EdgeListGraph):
        graph = edge_list_indexed
        dev = _graph_device(graph, device)
        if uniform:
            return edge_list_walk.uniform_walk_edge_list_graph(
                graph, target_nodes, walk_length, seed, padding_idx, restart,
                device=dev)
        out = edge_list_walk.biased_walk(
            graph.edge_list, graph.node_edge_index, target_nodes, p, q,
            walk_length, seed, padding_idx, restart, graph.search_iters,
            max_rounds, graph.fat, device=dev, tails=graph.tails)
        if graph.fat:
            out.walks[:, -1].masked_fill_(out.exhausted, -1)
        return out.walks
    if node_edge_index is None:
        raise ValueError("node_edge_index is required with a raw edge list")
    if uniform:
        return edge_list_walk.uniform_walk_edge_list(
            edge_list_indexed, node_edge_index, target_nodes, walk_length,
            seed, padding_idx, restart, device=device)
    return edge_list_walk.biased_walk_edge_list(
        edge_list_indexed, node_edge_index, target_nodes, p, q, walk_length,
        seed, padding_idx, restart, max_rounds=max_rounds, device=device)


def walk_triples(triples_indexed, relation_tail_index=None, target_nodes=None,
                 walk_length=10, padding_idx=-1, seed=0, restart=True,
                 device=None):
    """KG-triples walks ``[v0, r1, v1, ...]``: (B, 2 * walk_length + 1)
    int32.  The first argument may be a ``TriplesGraph`` instead of
    (triples_indexed, relation_tail_index).  ``restart`` is accepted and
    ignored, as in the JAX package."""
    if target_nodes is None:
        raise ValueError("target_nodes is required")
    if isinstance(triples_indexed, TriplesGraph):
        graph = triples_indexed
        return uniform_walk_triples_graph(
            graph, target_nodes, walk_length, padding_idx, seed,
            device=_graph_device(graph, device))
    if relation_tail_index is None:
        raise ValueError("relation_tail_index is required with raw triples")
    return uniform_walk_triples(triples_indexed, relation_tail_index,
                                target_nodes, walk_length, padding_idx,
                                restart, seed, device=device)
