"""Edge-list walks with padding/restart semantics (twin of
``torch_random_walk_tpu/ops/edge_list_walk.py``).

- A walker at a node without out-edges moves to ``padding_idx``; a walker
  *at* padding moves to its jump node: its target if ``restart``, else
  padding (absorbing).
- Biased (p/q): the first hop is a plain draw; then a candidate equal to t
  or to padding is accepted with prob_0 (a padding candidate then moves to
  the jump node), a neighbour of t with prob_1, any other with prob_2.

On a CUDA device the walks run in the hand-written kernels K7 (uniform) and
K8 (biased) of ``kernels/edge_list_walk.cu``; the ``*_plain`` functions are
their plain PyTorch versions, used on the CPU and to check the kernels.  On
an ``EdgeListGraph`` K7 reads its packed edge rows (``EdgeListGraph.edge_tab``,
one gather a step) or, where it has none, its tails column; on raw
arrays it reads the range index and column 1 of the edge rows.  K8 reads the
(E,) tails column (``EdgeListGraph.tails``, or a copy made per call for raw
arrays).
``fat`` picks the JAX fat engine's membership test
(``ops/fatwalk.py::node2vec_walk_edge_list_fat``: its cuckoo edge set looks
t up by its own id) over the oracle's (t clamped into [0, N), padding never
a neighbour); the two differ only for a t outside [0, N) or equal to a
padding inside it.  The uniform walk is the same in both engines.
"""

from __future__ import annotations

import torch

from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.ops.node2vec import BiasedWalks
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device


def uniform_walk_edge_list_plain(edge_list, node_edge_index, target_nodes,
                                 walk_length, key, padding_idx, restart,
                                 walker_offset=0):
    """Plain version of K7: a loop over steps, each one vectorised draw."""
    wid = common.walker_ids(target_nodes.shape[0], walker_offset,
                            target_nodes.device)
    cur = target_nodes.to(torch.int64)
    jump = cur if restart else torch.full_like(cur, padding_idx)
    cols = [cur]
    for step in range(1, walk_length + 1):
        bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(step))
        cur = common.sample_edge_neighbor(edge_list, node_edge_index, cur,
                                          jump, padding_idx, bits)
        cols.append(cur)
    return torch.stack(cols, dim=1).to(torch.int32)


def biased_walk_edge_list_plain(edge_list, node_edge_index, target_nodes,
                                walk_length, key, padding_idx, restart, probs,
                                search_iters, max_rounds, fat,
                                walker_offset=0) -> BiasedWalks:
    """Plain version of K8.  Rounds run in lock step over the frontier and
    each walker keeps its first accepted candidate; a walker whose round
    budget runs out keeps v for that step, as the JAX oracle does.  Also
    counts, per walker and step 2..L, the rounds drawn and those whose
    draw needs a search of t's range (``BiasedWalks.rounds``,
    ``.searches``)."""
    dev = target_nodes.device
    num_walkers = target_nodes.shape[0]
    wid = common.walker_ids(num_walkers, walker_offset, dev)
    prob_0, prob_1, prob_2 = (torch.tensor(x, dtype=torch.float32, device=dev)
                              for x in probs)
    p_lo, p_hi = torch.minimum(prob_1, prob_2), torch.maximum(prob_1, prob_2)
    cur0 = target_nodes.to(torch.int64)
    jump = cur0 if restart else torch.full_like(cur0, padding_idx)

    bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(1))
    first = common.sample_edge_neighbor(edge_list, node_edge_index, cur0,
                                        jump, padding_idx, bits)
    cols = [cur0, first]
    exhausted = torch.zeros(num_walkers, dtype=torch.bool, device=dev)
    rounds, searches = [], []
    t, v = cur0, first
    for step in range(2, walk_length + 1):
        resolved = torch.zeros(num_walkers, dtype=torch.bool, device=dev)
        sel = v
        rnd = 0
        step_rounds = torch.zeros(num_walkers, dtype=torch.int32, device=dev)
        step_searches = torch.zeros_like(step_rounds)
        while rnd < max_rounds and not bool(resolved.all()):
            step_rounds += ~resolved
            b_cand, b_acc = prng.counter_bits(
                key, wid, prng.step_round_counter(step, rnd))
            cand = common.sample_edge_neighbor(edge_list, node_edge_index, v,
                                               jump, padding_idx, b_cand)
            r = prng.uniform_from_bits(b_acc)
            is_t = cand == t
            is_pad = cand == padding_idx
            nbr = common.is_neighbor_edge(cand, t, edge_list, node_edge_index,
                                          padding_idx, search_iters, fat)
            accept = torch.where(is_t | is_pad, r < prob_0,
                                 torch.where(nbr, r < prob_1, r < prob_2))
            value = torch.where(is_pad & ~is_t, jump, cand)
            step_searches += (~resolved & ~is_t & ~is_pad & (r >= p_lo)
                              & (r < p_hi))
            sel = torch.where(~resolved & accept, value, sel)
            resolved = resolved | accept
            rnd += 1
        exhausted |= ~resolved
        rounds.append(step_rounds)
        searches.append(step_searches)
        cols.append(sel)
        t, v = v, sel
    walks = torch.stack(cols[: walk_length + 1], dim=1).to(torch.int32)
    per_step = [torch.stack(x, dim=1) if x else
                torch.zeros(num_walkers, 0, dtype=torch.int32, device=dev)
                for x in (rounds, searches)]
    return BiasedWalks(walks, exhausted, *per_step)


def _inputs(edge_list, node_edge_index, target_nodes, device):
    dev = resolve_device(device)
    edge_list = common.as_int32(edge_list, dev).reshape(-1, 2)
    node_edge_index = common.as_int32(node_edge_index, dev).reshape(-1, 2)
    if node_edge_index.shape[0] == 0:
        raise ValueError("node_edge_index must describe at least one node")
    return dev, edge_list, node_edge_index, common.as_int32(target_nodes, dev)


def uniform_walk_edge_list(edge_list, node_edge_index, target_nodes,
                           walk_length, seed, padding_idx, restart,
                           walker_offset=0, device=None):
    """Batched uniform edge-list walks: (B, walk_length + 1) int32.  On the
    card K7 reads the edge list's rows and its index."""
    return _uniform_walk(edge_list, node_edge_index, None, target_nodes,
                         walk_length, seed, padding_idx, restart,
                         walker_offset, device)


def uniform_walk_edge_list_graph(graph, target_nodes, walk_length, seed,
                                 padding_idx, restart, walker_offset=0,
                                 device=None):
    """The same walks on an ``EdgeListGraph``.  On the card K7 reads the
    graph's packed rows (``edge_tab``) where it has them, else its tails
    column and its index."""
    return _uniform_walk(graph.edge_list, graph.node_edge_index, graph,
                         target_nodes, walk_length, seed, padding_idx,
                         restart, walker_offset, device)


def _uniform_walk(edge_list, node_edge_index, graph, target_nodes,
                  walk_length, seed, padding_idx, restart, walker_offset,
                  device):
    dev, edge_list, node_edge_index, target_nodes = _inputs(
        edge_list, node_edge_index, target_nodes, device)
    key = prng.derive_key(seed, prng.STREAM_EDGE_UNIFORM)
    args = (node_edge_index, target_nodes, int(walk_length), key,
            int(padding_idx), bool(restart), int(walker_offset))
    if dev.type == "cuda":
        if graph is None:
            return bindings.uniform_walk_edge_list(edge_list, *args)
        if graph.edge_tab is not None:
            return bindings.uniform_walk_edge_list(
                graph.edge_tab, *args, layout="packed",
                bits=graph.packed_bits)
        return bindings.uniform_walk_edge_list(graph.tails, *args,
                                               layout="tails")
    common.check_walk_length(walk_length)
    return uniform_walk_edge_list_plain(edge_list, *args)


def biased_walk(edge_list, node_edge_index, target_nodes, p, q, walk_length,
                seed, padding_idx, restart, search_iters, max_rounds, fat,
                walker_offset=0, device=None, tails=None) -> BiasedWalks:
    """K8 on a CUDA device, its plain version on the CPU; walks and the
    walkers whose round budget ran out at some step.  K8 reads the edge
    list's tails column: ``tails`` (``EdgeListGraph.tails``) where given,
    else a copy of ``edge_list[:, 1]`` made for this call."""
    dev, edge_list, node_edge_index, target_nodes = _inputs(
        edge_list, node_edge_index, target_nodes, device)
    key = prng.derive_key(seed, prng.STREAM_EDGE_BIASED)
    args = (node_edge_index, target_nodes, int(walk_length), key,
            int(padding_idx), bool(restart),
            common.node2vec_accept_probs(float(p), float(q)),
            int(search_iters), int(max_rounds), bool(fat), int(walker_offset))
    if dev.type == "cuda":
        if tails is None:
            tails = edge_list[:, 1].contiguous()
        walks, exhausted = bindings.biased_walk_edge_list(tails, *args)
        return BiasedWalks(walks, exhausted, None, None)
    common.check_walk_length(walk_length)
    return biased_walk_edge_list_plain(edge_list, *args)


def biased_walk_edge_list(edge_list, node_edge_index, target_nodes, p, q,
                          walk_length, seed, padding_idx, restart,
                          walker_offset=0,
                          search_iters=common.DEFAULT_SEARCH_ITERS,
                          max_rounds=common.DEFAULT_MAX_ROUNDS, device=None):
    """Batched node2vec edge-list walks with the JAX oracle's semantics: a
    walker whose round budget runs out at a step stays where it is."""
    return biased_walk(edge_list, node_edge_index, target_nodes, p, q,
                       walk_length, seed, padding_idx, restart, search_iters,
                       max_rounds, False, walker_offset, device).walks
