"""KG-triples graph container and constructors (PyTorch twin of
``torch_random_walk_tpu/graph/triples.py``).

Contract kept: triples are (E, 3) [head, relation, tail], sorted by
(head, relation, tail); the index is (N, 2) [start, end-inclusive] with
(-1, -1) for an entity that heads no triple; ids are ``int32`` (the
constructors raise from 2^31 on).

The JAX package's fat table is not built: the CUDA kernels read the triples
and the index directly.  Whether it would be built is kept
(``TriplesGraph.fat``), because it picks the semantics of
``walk_triples(graph)`` (``ops/walk.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from torch_random_walk_tpu_torch.graph.edge_list import (
    as_int64,
    exclusive_cumsum,
    head_counts,
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
        some triple, all ids below 2^31, which the port requires anyway).
    """

    triples: torch.Tensor
    relation_tail_index: torch.Tensor
    num_entities: int
    num_triples: int
    max_degree: int
    num_relations: int = 0
    fat: bool = True

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
