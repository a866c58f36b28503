from torch_random_walk_tpu_torch.parallel.exchange import (  # noqa: F401
    all_to_all_chunks,
)
from torch_random_walk_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionedCSR,
    build_partition_hashes,
)
from torch_random_walk_tpu_torch.parallel.partition_v2 import (  # noqa: F401
    RoutedConfig,
    build_partition_blooms,
    walk_partitioned_node2vec_routed,
    walk_partitioned_routed,
)
