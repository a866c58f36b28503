"""Public walk entry point (twin of ``torch_random_walk_tpu/ops/walk.py::walk``).

Dispatch, as in the JAX package: p == q == 1 selects the uniform walk; a
``CSRGraph`` with fat tables (``graph.fat``, the JAX package's
``edge_tab is not None``) selects the mixture sampler scaled by
``graph.deg_bits``; a ``CSRGraph`` without them selects the rejection sampler
with ``graph.search_iters``; raw (row_ptr, col_idx) arrays select the
rejection sampler with the conservative search depth.  The mixture and the
rejection sampler are two deliberate bitstreams.
"""

from __future__ import annotations

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.ops.node2vec import (
    NO_PROBS,
    biased_walk,
    mixture_consts,
    node2vec_walk_csr,
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
        dev = resolve_device(device)
        if graph.device != dev:
            raise ValueError(f"graph lives on {graph.device}, walk was asked "
                             f"for {dev}")
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
