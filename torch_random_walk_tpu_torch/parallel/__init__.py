from torch_random_walk_tpu_torch.parallel.exchange import (  # noqa: F401
    all_to_all_chunks,
)
from torch_random_walk_tpu_torch.parallel.kge_trainer import (  # noqa: F401
    ShardedKGEmbedding,
    ShardedKGEmbeddingConfig,
)
from torch_random_walk_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    init_distributed,
    make_mesh,
)
from torch_random_walk_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionedCSR,
    build_partition_hashes,
)
from torch_random_walk_tpu_torch.parallel.partition_v2 import (  # noqa: F401
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
from torch_random_walk_tpu_torch.parallel.trainer import (  # noqa: F401
    ShardedNode2Vec,
    ShardedNode2VecConfig,
)
from torch_random_walk_tpu_torch.parallel.walk_dp import (  # noqa: F401
    walk_data_parallel,
    walk_edge_list_data_parallel,
    walk_triples_data_parallel,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "data_sharding",
    "all_to_all_chunks",
    "walk_data_parallel",
    "walk_edge_list_data_parallel",
    "walk_triples_data_parallel",
    "PartitionedCSR",
    "build_partition_hashes",
    "PartitionedEdgeList",
    "PartitionedTriples",
    "RoutedConfig",
    "build_partition_blooms",
    "build_edge_list_partition_blooms",
    "build_edge_list_partition_hashes",
    "walk_edge_list_node2vec_partitioned_routed",
    "walk_edge_list_partitioned_routed",
    "walk_partitioned_routed",
    "walk_partitioned_node2vec_routed",
    "walk_triples_partitioned_routed",
    "ShardedNode2Vec",
    "ShardedNode2VecConfig",
    "ShardedKGEmbedding",
    "ShardedKGEmbeddingConfig",
]
