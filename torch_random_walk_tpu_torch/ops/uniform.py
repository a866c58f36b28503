"""Uniform CSR random walks (twin of ``torch_random_walk_tpu/ops/uniform.py``;
same bitstream as ``ops/fatwalk.py::uniform_walk_fat``).

Output layout: (num_walkers, walk_length + 1) int32 with walks[:, 0] =
target_nodes.  On a CUDA device the walk runs in the hand-written kernel K1
(``kernels/uniform_walk.cu``); ``uniform_walk_csr_plain`` is its plain
PyTorch version, used on the CPU and to check the kernel.
"""

from __future__ import annotations

import torch

from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device


def uniform_walk_csr_plain(row_ptr, col_idx, target_nodes, walk_length, key,
                           walker_offset=0):
    """Plain version: a Python loop over steps, each step one vectorised
    Threefry draw and CSR gather over the whole frontier."""
    num_walkers = target_nodes.shape[0]
    wid = common.walker_ids(num_walkers, walker_offset, target_nodes.device)
    cur = target_nodes.to(torch.int64)
    cols = [cur]
    for step in range(1, walk_length + 1):
        bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(step))
        cur = common.sample_csr_neighbor(row_ptr, col_idx, cur, bits)
        cols.append(cur)
    return torch.stack(cols, dim=1).to(torch.int32)


def uniform_walk_csr(row_ptr, col_idx, target_nodes, walk_length, seed,
                     walker_offset=0, device=None):
    """Batched uniform walks: a pure function of (graph, targets, seed,
    walker_offset)."""
    dev = resolve_device(device)
    row_ptr = common.as_int32(row_ptr, dev)
    col_idx = common.as_int32(col_idx, dev)
    target_nodes = common.as_int32(target_nodes, dev)
    key = prng.derive_key(seed, prng.STREAM_CSR_UNIFORM)
    if dev.type == "cuda":
        return bindings.uniform_walk_csr(row_ptr, col_idx, target_nodes,
                                         int(walk_length), key,
                                         int(walker_offset))
    common.check_walk_length(walk_length)
    return uniform_walk_csr_plain(row_ptr, col_idx, target_nodes,
                                  int(walk_length), key, int(walker_offset))
