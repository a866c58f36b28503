from torch_random_walk_tpu_torch.utils import device, prng  # noqa: F401
from torch_random_walk_tpu_torch.utils.elastic import (  # noqa: F401
    ElasticConfig,
    Heartbeat,
    run_resumable,
)
from torch_random_walk_tpu_torch.utils.logging import get_logger  # noqa: F401

__all__ = ["prng", "get_logger", "ElasticConfig", "Heartbeat",
           "run_resumable"]
