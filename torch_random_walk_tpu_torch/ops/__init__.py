from torch_random_walk_tpu_torch.ops import common  # noqa: F401
from torch_random_walk_tpu_torch.ops.edge_list_walk import (  # noqa: F401
    biased_walk_edge_list,
    uniform_walk_edge_list,
)
from torch_random_walk_tpu_torch.ops.node2vec import (  # noqa: F401
    node2vec_walk_csr,
    node2vec_walk_csr_mixture,
)
from torch_random_walk_tpu_torch.ops.triples_walk import (  # noqa: F401
    uniform_walk_triples,
)
from torch_random_walk_tpu_torch.ops.uniform import uniform_walk_csr  # noqa: F401
from torch_random_walk_tpu_torch.ops.walk import (  # noqa: F401
    walk,
    walk_edge_list,
    walk_triples,
)
from torch_random_walk_tpu_torch.ops.windows import (  # noqa: F401
    to_windows,
    to_windows_cbow,
    to_windows_triples,
    to_windows_triples_cbow,
)
