"""Walk -> training-window generators (twin of
``torch_random_walk_tpu/ops/windows.py``; node windows only so far).

- to_windows:      (num_win,), (num_win, W-1), (num_win, W-1) with
                   num_win = (L - W + 1) * num_walks, walk-major layout;
                   target = window middle, positives = the other W-1
                   elements, negatives = uniform nodes.
- to_windows_cbow: (num_win,), (num_win,), (num_win, W-1); one negative node
                   per window, exactly uniform over the nodes other than the
                   positive.

On a CUDA device ``to_windows`` runs in the hand-written kernel K3
(``kernels/windows.cu``); ``to_windows_plain`` is its plain PyTorch version.
``to_windows_cbow`` is plain tensor code on every device.
"""

from __future__ import annotations

import torch

from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device


def _neg_bits(key, num: int, device):
    """One uint32 word per output slot, keyed by the flat slot index."""
    ids = torch.arange(num, dtype=torch.int64, device=device) & prng.MASK32
    return prng.counter_bits(key, ids, 0)[0]


def _split_windows(walks, window_size: int):
    """(num_walks, L) -> middles (num_win,), contexts (num_win, W-1)."""
    if walks.dim() != 2 or not 2 <= window_size <= walks.shape[1]:
        raise ValueError(f"walks must be 2-d and window_size in "
                         f"[2, {walks.shape[-1]}], got {window_size}")
    win = walks.unfold(1, window_size, 1)  # (num_walks, per_walk, W) view
    mid = window_size // 2
    middles = win[:, :, mid].reshape(-1)
    contexts = torch.cat([win[:, :, :mid], win[:, :, mid + 1:]], dim=-1)
    return middles, contexts.reshape(-1, window_size - 1)


def to_windows_plain(walks, window_size, num_nodes, key):
    """Plain version of K3."""
    targets, pos = _split_windows(walks, window_size)
    bits = _neg_bits(key, pos.numel(), walks.device)
    neg = prng.randint_from_bits(bits, num_nodes).to(walks.dtype)
    return targets.contiguous(), pos, neg.reshape(pos.shape)


def to_windows(walks, window_size, num_nodes, seed=0, device=None):
    """Skip-gram windows of int32 walks."""
    dev = resolve_device(device)
    walks = common.as_int32(walks, dev)
    key = prng.derive_key(seed, prng.STREAM_WINDOWS_SG)
    if dev.type == "cuda":
        return bindings.to_windows(walks, int(window_size), int(num_nodes),
                                   key)
    return to_windows_plain(walks, int(window_size), int(num_nodes), key)


def to_windows_cbow(walks, window_size, num_nodes, seed=0, device=None):
    """CBOW windows of int32 walks: (positives, negatives, contexts)."""
    dev = resolve_device(device)
    walks = common.as_int32(walks, dev)
    key = prng.derive_key(seed, prng.STREAM_WINDOWS_CBOW)
    pos_nodes, context = _split_windows(walks, int(window_size))
    bits = _neg_bits(key, pos_nodes.numel(), dev)
    u = prng.randint_from_bits(bits, max(int(num_nodes) - 1, 1))
    neg_nodes = (u + (u >= pos_nodes)).to(walks.dtype)
    return pos_nodes.contiguous(), neg_nodes, context
