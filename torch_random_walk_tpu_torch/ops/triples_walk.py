"""KG-triples relation-aware walks (twin of
``torch_random_walk_tpu/ops/triples_walk.py``).

- Walk layout ``[v0, r1, v1, r2, v2, ...]``, width 2 * walk_length + 1.
- Each step draws a (relation, tail) pair uniformly from the head's sorted
  [start, end]-inclusive range; a head without triples gives
  (padding, padding), and padding absorbs.
- ``restart`` is accepted and ignored, as in the JAX package.

Two semantics, as the JAX package's two engines have them (``fat``):

- the oracle (``fat=False``, raw arrays and graphs without the fat table)
  looks each step's head up clamped into [0, N) and stops at a head equal
  to padding;
- the fat engine (``ops/fatwalk.py::uniform_walk_triples_fat``, a
  ``TriplesGraph`` with the fat table) tests the target alone: padding or
  any id outside [0, N) gives padding from step 1 on, and after that the
  walk follows the tails' own ranges, a tail equal to a padding inside
  [0, N) included.

With 4 entities and target 5, the graph entry gives ``[5, -1, -1, ...]``
and the raw arrays walk from entity 3.

On a CUDA device the walk runs in the hand-written kernel K9
(``kernels/triples.cu``): the fat semantics read ``triple_tab`` rows (one
16-byte gather a step, which also gives the next head's range; a
``TriplesGraph``'s own, or one made per call from raw arrays), the oracle's
read the index and the triples.  ``uniform_walk_triples_plain`` is its
plain PyTorch version, used on the CPU and to check the kernel.
"""

from __future__ import annotations

import torch

from torch_random_walk_tpu_torch.graph.triples import triple_table
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device


def uniform_walk_triples_plain(triples, relation_tail_index, target_nodes,
                               walk_length, key, padding_idx, fat,
                               walker_offset=0):
    """Plain version of K9, either semantics."""
    num_entities = relation_tail_index.shape[0]
    wid = common.walker_ids(target_nodes.shape[0], walker_offset,
                            target_nodes.device)
    cur0 = target_nodes.to(torch.int64)
    pad = torch.full_like(cur0, padding_idx)
    start, end, has = common.edge_ranges(relation_tail_index, cur0)
    if fat:
        has &= (cur0 != padding_idx) & (cur0 >= 0) & (cur0 < num_entities)
    cur = cur0
    cols = [cur0]
    for step in range(1, walk_length + 1):
        bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(step))
        if not fat:
            start, end, has = common.edge_ranges(relation_tail_index, cur)
            has &= cur != padding_idx
        idx = common.sample_range_inclusive(start.clamp(min=0),
                                            end.clamp(min=0), bits)
        rel = torch.where(has, common.gather_rows(triples, idx, 1), pad)
        cur = torch.where(has, common.gather_rows(triples, idx, 2), pad)
        cols += [rel, cur]
        if fat:  # the tail's own range; padding stays padding
            start, end, tail_has = common.edge_ranges(relation_tail_index,
                                                      cur)
            has &= tail_has
    return torch.stack(cols, dim=1).to(torch.int32)


def uniform_walk_triples(triples, relation_tail_index, target_nodes,
                         walk_length, padding_idx, restart, seed,
                         walker_offset=0, fat=False, device=None):
    """Batched triples walks: (B, 2 * walk_length + 1) int32.  ``restart``
    is ignored; ``fat`` as in the module's docstring."""
    del restart  # accepted but unused, as in the JAX package
    return _walk(triples, relation_tail_index, None, target_nodes,
                 walk_length, padding_idx, seed, walker_offset, fat, device)


def uniform_walk_triples_graph(graph, target_nodes, walk_length,
                               padding_idx, seed, walker_offset=0,
                               device=None):
    """The same walks on a ``TriplesGraph``, with the semantics its ``fat``
    picks: on the card K9 reads the graph's ``triple_tab`` where it has one
    (the fat engine's), else its triples (the oracle's)."""
    return _walk(graph.triples, graph.relation_tail_index, graph.triple_tab,
                 target_nodes, walk_length, padding_idx, seed, walker_offset,
                 graph.fat, device)


def _walk(triples, relation_tail_index, triple_tab, target_nodes,
          walk_length, padding_idx, seed, walker_offset, fat, device):
    dev = resolve_device(device)
    triples = common.as_int32(triples, dev).reshape(-1, 3)
    relation_tail_index = common.as_int32(relation_tail_index,
                                          dev).reshape(-1, 2)
    if relation_tail_index.shape[0] == 0:
        raise ValueError("relation_tail_index must describe at least one "
                         "entity")
    target_nodes = common.as_int32(target_nodes, dev)
    key = prng.derive_key(seed, prng.STREAM_TRIPLES)
    args = (relation_tail_index, target_nodes, int(walk_length), key,
            int(padding_idx), bool(fat), int(walker_offset))
    if dev.type == "cuda":
        table = triples
        if fat:
            table = (triple_tab if triple_tab is not None
                     else triple_table(triples, relation_tail_index))
        return bindings.uniform_walk_triples(table, *args)
    common.check_walk_length(walk_length)
    return uniform_walk_triples_plain(triples, *args)
