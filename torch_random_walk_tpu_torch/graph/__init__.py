from torch_random_walk_tpu_torch.graph.csr import CSRGraph  # noqa: F401
from torch_random_walk_tpu_torch.graph.datasets import (  # noqa: F401
    synthetic_power_law,
)
