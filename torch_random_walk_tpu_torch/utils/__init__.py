from torch_random_walk_tpu_torch.utils import device, prng  # noqa: F401
