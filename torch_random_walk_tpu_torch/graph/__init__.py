from torch_random_walk_tpu_torch.graph.bloom import (  # noqa: F401
    bloom_maybe,
    build_node_blooms,
)
from torch_random_walk_tpu_torch.graph.csr import (  # noqa: F401
    CSRGraph,
    nodes_tensor,
    to_csr,
)
from torch_random_walk_tpu_torch.graph.datasets import (  # noqa: F401
    synthetic_grid_kg,
    synthetic_power_law,
)
from torch_random_walk_tpu_torch.graph.edge_list import (  # noqa: F401
    EdgeListGraph,
    build_node_edge_index,
    to_edge_list_indexed,
)
from torch_random_walk_tpu_torch.graph.hashset import (  # noqa: F401
    EdgeHashSet,
)
from torch_random_walk_tpu_torch.graph.triples import (  # noqa: F401
    TriplesGraph,
    build_relation_tail_index,
)
from torch_random_walk_tpu_torch.graph import datasets, oracle  # noqa: F401

__all__ = [
    "CSRGraph",
    "EdgeListGraph",
    "TriplesGraph",
    "to_csr",
    "nodes_tensor",
    "to_edge_list_indexed",
    "build_node_edge_index",
    "build_relation_tail_index",
    "datasets",
    "oracle",
]
