"""Hand-written CUDA kernels of the port (sources, build, ctypes bindings).

Nothing is compiled or loaded when this package is imported: the library is
built at the first launch (``bindings.library``).
"""

from torch_random_walk_tpu_torch.kernels.bindings import (  # noqa: F401
    KERNEL_NAMES,
    launch_counts,
    reset_launch_counts,
)
