"""Alias-method categorical sampling, Vose construction (twin of
``torch_random_walk_tpu/utils/alias.py``).

Degree-weighted (unigram^0.75) shared negatives for ``Node2Vec`` with
``negative_distribution="degree75"``.  The tables are built once on the host
in NumPy by the same Vose loop in the same pop order as the JAX package's, so
``prob`` (float32) and ``alias`` (int32) are equal bit for bit, and move to
the device once.  A draw is two table gathers and a select on the (seed,
STREAM_TRAIN) Threefry words; the S = 256 draws of a step are plain tensor
code on every device (too few to need a kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device


def build_alias(weights, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Vose alias tables for a categorical over ``weights`` (any nonnegative,
    not all zero).  Returns (prob float32 (N,), alias int32 (N,)) on
    ``device``."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.shape[0]
    if n == 0 or not np.all(w >= 0) or w.sum() == 0:
        raise ValueError("weights must be nonempty, nonnegative, nonzero")
    scaled = w * (n / w.sum())
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = np.flatnonzero(scaled < 1.0).tolist()
    large = np.flatnonzero(scaled >= 1.0).tolist()
    scaled = scaled.tolist()  # Python floats: the same doubles, faster loop
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    # Leftovers are 1.0 within float error.
    dev = resolve_device(device)
    return (torch.from_numpy(prob.astype(np.float32)).to(dev),
            torch.from_numpy(alias.astype(np.int32)).to(dev))


def sample_alias(prob, alias, bits_slot, bits_coin) -> torch.Tensor:
    """Categorical ids from alias tables, one a pair of 32-bit words (int64
    masked): ``bits_slot`` picks the slot (full-range multiply-high),
    ``bits_coin`` the keep-or-alias coin at 24-bit resolution."""
    n = prob.shape[0]
    slot = prng.randint_from_bits(bits_slot, n)
    u = (bits_coin >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.where(u < prob[slot], slot, alias[slot].to(slot.dtype))


def degree75_weights(row_ptr) -> np.ndarray:
    """deg(v)^0.75 over CSR out-degrees (isolated nodes keep weight 0 and are
    never drawn)."""
    if isinstance(row_ptr, torch.Tensor):
        row_ptr = row_ptr.cpu().numpy()
    deg = np.diff(np.asarray(row_ptr)).astype(np.float64)
    return deg ** 0.75


def shared_negative_ids_alias(seed, num: int, prob, alias) -> torch.Tensor:
    """``num`` negatives (int32) from the alias distribution, on the same
    (seed, STREAM_TRAIN) counter stream as the uniform
    ``models.skipgram.shared_negative_ids``; equal to the JAX package's
    value for value."""
    key = prng.derive_key(seed, prng.STREAM_TRAIN)
    ids = torch.arange(num, dtype=torch.int64, device=prob.device)
    b0, b1 = prng.counter_bits(key, ids, torch.zeros_like(ids))
    return sample_alias(prob, alias, b0, b1).to(torch.int32)
