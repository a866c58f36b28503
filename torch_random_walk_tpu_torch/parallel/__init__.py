from torch_random_walk_tpu_torch.parallel.exchange import (  # noqa: F401
    all_to_all_chunks,
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
