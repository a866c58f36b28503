"""torch_random_walk_tpu_torch: the PyTorch/CUDA port of
``torch_random_walk_tpu``, with hand-written CUDA kernels for an NVIDIA H100.

Ported so far: the counter-based PRNG and the alias tables of the degree^0.75
negatives, the CSR graph and the power-law generator, uniform and node2vec
(rejection and mixture) CSR walks behind ``walk``, the indexed edge-list and
KG-triples graphs with their walks (``walk_edge_list``, ``walk_triples``) and
the grid-world KG generator, skip-gram and CBOW node and triple windows, the
node-range partition, the walker-record all-to-all and all five owner-routed
engines (uniform and node2vec CSR, uniform and node2vec edge list, KG
triples; serial and overlapped schedules, with per-shard cuckoo edge sets and
Bloom filters), and the trainers ``SkipGramModel`` (blockwise and per-window
losses; dense Adam, the touched-rows step, or a custom optimizer),
``CBOWModel``, ``Node2Vec`` in all its modes (block or windows, dense or
sparse update, uniform or degree^0.75 negatives) and the KG-embedding trainer
``KGEmbedding`` (``KGEModel``: TransE, DistMult, RotatE, triple skip-gram and
CBOW; dense or touched-rows Adam), the evaluations of
``models/eval.py`` (link-prediction AUCs, node classification, KG tail
ranking), and the data axis of the multi-device layer on
``torch.distributed`` (``parallel``: ``init_distributed``, ``make_mesh``,
``data_sharding``, the three data-parallel walks, ``ShardedNode2Vec`` and
``ShardedKGEmbedding``), the dataset loaders and generators of
``graph.datasets`` (``.npz`` edge files, the OGB edge cache, the Planetoid
files, the SBM, power-law and ogbn-products-shaped graphs), the exact
transition oracle ``graph.oracle``, the reference-parity helpers ``to_csr``
and ``nodes_tensor``, checkpoint and elastic resume (``utils.checkpoint``,
``utils.elastic``: ``run_resumable``, ``Heartbeat``), logging and profiling
(``utils.logging``, ``utils.profiling``), and the command-line entry points
``trw-torch-walk``, ``trw-torch-train`` and ``trw-torch-train-kg``
(``cli``).  Sub-packages mirror the JAX package's (``utils``, ``graph``,
``ops``, ``models``, ``parallel``); ``kernels`` holds the CUDA sources, their
build and their bindings; ``convert`` carries graphs and trainer state over
from the JAX package.

Every entry point takes ``device=None``, which means the card and raises
when there is none; the CPU runs the kernels' plain PyTorch versions and only
when asked by ``device="cpu"``.  For the same graph, targets and seed the
walks and windows equal the JAX package's value for value.  This package
imports ``torch`` and ``numpy`` only.
"""

from torch_random_walk_tpu_torch import (  # noqa: F401
    convert,
    graph,
    kernels,
    models,
    ops,
    parallel,
    utils,
)
from torch_random_walk_tpu_torch.graph.csr import (
    CSRGraph,
    nodes_tensor,
    to_csr,
)
from torch_random_walk_tpu_torch.graph.datasets import (
    synthetic_grid_kg,
    synthetic_power_law,
)
from torch_random_walk_tpu_torch.graph.edge_list import (
    EdgeListGraph,
    build_node_edge_index,
    to_edge_list_indexed,
)
from torch_random_walk_tpu_torch.graph.triples import (
    TriplesGraph,
    build_relation_tail_index,
)
from torch_random_walk_tpu_torch.models.cbow import CBOWModel
from torch_random_walk_tpu_torch.models.eval import (
    kg_tail_ranking_metrics,
    link_prediction_auc,
    link_prediction_auc_trained,
    node_classification_accuracy,
    sample_negative_edges,
    sbm_oracle_auc,
)
from torch_random_walk_tpu_torch.models.kge import (
    KGEmbedding,
    KGEmbeddingConfig,
    KGEModel,
    corrupt_triples,
)
from torch_random_walk_tpu_torch.models.node2vec import Node2Vec, Node2VecConfig
from torch_random_walk_tpu_torch.models.skipgram import SkipGramModel
from torch_random_walk_tpu_torch.ops.walk import walk, walk_edge_list, walk_triples
from torch_random_walk_tpu_torch.ops.windows import (
    to_windows,
    to_windows_cbow,
    to_windows_triples,
    to_windows_triples_cbow,
)
from torch_random_walk_tpu_torch.parallel.partition import (
    PartitionedCSR,
    build_partition_hashes,
)
from torch_random_walk_tpu_torch.parallel.partition_v2 import (
    PartitionedEdgeList,
    PartitionedTriples,
    RoutedConfig,
    build_edge_list_partition_blooms,
    build_edge_list_partition_hashes,
    build_partition_blooms,
    walk_edge_list_node2vec_partitioned_routed,
    walk_edge_list_partitioned_routed,
    walk_partitioned_node2vec_routed,
    walk_partitioned_routed,
    walk_triples_partitioned_routed,
)

__version__ = "0.1.0"

__all__ = [
    "CBOWModel",
    "CSRGraph",
    "EdgeListGraph",
    "KGEModel",
    "KGEmbedding",
    "KGEmbeddingConfig",
    "Node2Vec",
    "Node2VecConfig",
    "PartitionedCSR",
    "PartitionedEdgeList",
    "PartitionedTriples",
    "RoutedConfig",
    "SkipGramModel",
    "TriplesGraph",
    "build_edge_list_partition_blooms",
    "build_edge_list_partition_hashes",
    "build_node_edge_index",
    "build_partition_blooms",
    "build_partition_hashes",
    "build_relation_tail_index",
    "corrupt_triples",
    "kg_tail_ranking_metrics",
    "link_prediction_auc",
    "link_prediction_auc_trained",
    "node_classification_accuracy",
    "nodes_tensor",
    "sample_negative_edges",
    "sbm_oracle_auc",
    "synthetic_grid_kg",
    "synthetic_power_law",
    "to_csr",
    "to_edge_list_indexed",
    "to_windows",
    "to_windows_cbow",
    "to_windows_triples",
    "to_windows_triples_cbow",
    "walk",
    "walk_edge_list",
    "walk_edge_list_node2vec_partitioned_routed",
    "walk_edge_list_partitioned_routed",
    "walk_partitioned_node2vec_routed",
    "walk_partitioned_routed",
    "walk_triples",
    "walk_triples_partitioned_routed",
    "graph",
    "models",
    "ops",
    "parallel",
    "utils",
]
