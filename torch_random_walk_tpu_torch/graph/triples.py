"""KG-triples graph container and constructors (PyTorch twin of
``torch_random_walk_tpu/graph/triples.py``).

Contract kept: triples are (E, 3) [head, relation, tail], sorted by
(head, relation, tail); the index is (N, 2) [start, end-inclusive] with
(-1, -1) for an entity that heads no triple; ids are ``int32`` (the
constructors raise from 2^31 on).

Beside the triples a graph with ``TriplesGraph.fat`` holds, built with it
and on its device, the JAX package's fat table ``TriplesGraph.triple_tab``
(``triple_table``): row i is (relation_i, tail_i, start_tail_i, cnt_tail_i)
int32, so that the walk kernel K9 reads a step's output pair and the next
head's range in one 16-byte gather.  It is derived from the graph's own
triples and range index, so a graph constructed directly gets it too.
``fat`` also picks the semantics of ``walk_triples(graph)``
(``ops/walk.py``); a graph without it walks the raw triples with the
oracle's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from torch_random_walk_tpu_torch.graph.edge_list import (
    as_int64,
    exclusive_cumsum,
    head_counts,
    next_ranges,
    sort_rows_by,
)
from torch_random_walk_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TriplesGraph:
    """KG triples and per-head range index on one device.

    triples: (num_triples, 3) int32 [head, relation, tail], sorted.
    relation_tail_index: (num_entities, 2) int32 [start, end-inclusive],
        (-1, -1) for an entity without triples.
    fat: True where the JAX package's ``TriplesGraph`` of the same triples
        holds its fat table (``triple_tab is not None``: some entity and
        some triple, all ids below 2^31, which the port requires anyway);
        False by default, as the JAX dataclass built from its fields holds
        no table.
    triple_tab: (num_triples, 4) int32 [relation, tail, start_tail,
        cnt_tail], the JAX package's ``triple_tab`` (``triple_table``), K9's
        layout under the fat semantics; None where ``fat`` is false, as in
        the JAX package.
    """

    triples: torch.Tensor
    relation_tail_index: torch.Tensor
    num_entities: int
    num_triples: int
    max_degree: int
    num_relations: int = 0
    fat: bool = False
    triple_tab: torch.Tensor | None = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "triple_tab", triple_table(
            self.triples, self.relation_tail_index) if self.fat else None)

    @property
    def device(self) -> torch.device:
        return self.triples.device

    @property
    def search_iters(self) -> int:
        return max(1, int(math.ceil(math.log2(max(self.max_degree, 2)))) + 1)

    @classmethod
    def from_arrays(cls, triples, num_entities: int | None = None,
                    num_relations: int | None = None,
                    device=None) -> "TriplesGraph":
        """``num_entities`` and ``num_relations`` default to the largest id
        + 1 of the given triples; pass them where these triples are a subset
        (a train split) of a larger id space."""
        dev = resolve_device(device)
        t = as_int64(triples, dev).reshape(-1, 3)
        if num_entities is None:
            num_entities = (int(torch.maximum(t[:, 0].max(), t[:, 2].max()))
                            + 1 if t.numel() else 0)
        if num_relations is None:
            num_relations = int(t[:, 1].max()) + 1 if t.numel() else 0
        heads, rels, tails = sort_rows_by(t[:, 0], t[:, 1], t[:, 2])
        counts = head_counts(heads, num_entities)
        starts = exclusive_cumsum(counts)
        index = torch.stack([starts, starts + counts - 1], dim=1)
        index[counts == 0] = -1
        num_triples = int(heads.shape[0])
        return cls(
            triples=torch.stack([heads, rels, tails], dim=1)
            .to(torch.int32).contiguous(),
            relation_tail_index=index.to(torch.int32).contiguous(),
            num_entities=num_entities, num_triples=num_triples,
            max_degree=int(counts.max()) if num_entities else 0,
            num_relations=num_relations,
            fat=bool(num_entities and num_triples))


def build_relation_tail_index(triples_indexed, all_entities, device=None):
    """Returns (relation_tail_index, sorted_triples) over
    max(all_entities) + 1 entities."""
    dev = resolve_device(device)
    num_entities = int(as_int64(all_entities, dev).max()) + 1
    g = TriplesGraph.from_arrays(triples_indexed, num_entities=num_entities,
                                 device=dev)
    return g.relation_tail_index, g.triples


def triple_table(triples: torch.Tensor,
                 relation_tail_index: torch.Tensor) -> torch.Tensor:
    """(T, 4) int32 [relation, tail, start_tail, cnt_tail] of (T, 3) [head,
    relation, tail] triples sorted by head and their (N, 2) range index: the
    JAX package's ``triple_tab`` (cnt 0 for a tail that heads no triple).
    Raises where a tail lies outside [0, N)."""
    tails = triples[:, 2]
    start, cnt = next_ranges(tails, relation_tail_index)
    return torch.stack([triples[:, 1], tails, start.to(torch.int32),
                        cnt.to(torch.int32)], dim=1)
