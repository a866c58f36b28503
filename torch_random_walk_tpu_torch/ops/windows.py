"""Walk -> training-window generators (twin of
``torch_random_walk_tpu/ops/windows.py``).

- to_windows:      (num_win,), (num_win, W-1), (num_win, W-1) with
                   num_win = (L - W + 1) * num_walks, walk-major layout;
                   target = window middle, positives = the other W-1
                   elements, negatives = uniform nodes.
- to_windows_cbow: (num_win,), (num_win,), (num_win, W-1); one negative node
                   per window, exactly uniform over the nodes other than the
                   positive.
- to_windows_triples[_cbow]: targets (num_win, 3), windows (num_win, 2W, 3)
                   with num_win = ((width - 1) / 2) * num_walks over
                   [v0, r1, v1, ...] walks; negatives (num_win, 2W, 3),
                   real triples drawn uniformly, or for CBOW (num_win, 3),
                   the first of four draws that differs from the target
                   triple, else the last.  Left-window heads are
                   walk[head_idx] (the reference's copy bug is fixed, as in
                   the JAX package).

On a CUDA device ``to_windows`` runs in the hand-written kernel K3
(``kernels/windows.cu``) and both triples generators in K10
(``kernels/triples.cu``: one kernel a generator); ``to_windows_plain`` and
``to_windows_triples_plain`` are their plain PyTorch versions.
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


# Draws of one CBOW negative triple: the first that differs from the target
# triple is kept, else the last.
CBOW_TRIPLE_ROUNDS = 4


def _triples_targets_and_windows(walks, window_size: int, padding_idx: int):
    """Target triples at the odd (relation) positions of [v0, r1, v1, ...]
    walks; ``window_size`` context triples to each side at stride 2, each
    component outside the walk padded."""
    num_walks, width = walks.shape
    per_walk = (width - 1) // 2
    dev = walks.device
    rel_pos = 1 + 2 * torch.arange(per_walk, device=dev)
    targets = torch.stack([walks[:, rel_pos - 1], walks[:, rel_pos],
                           walks[:, rel_pos + 1]], dim=-1).reshape(-1, 3)
    hops = 2 * (torch.arange(window_size, device=dev) + 1)
    rel_idx = torch.cat([rel_pos[:, None] - hops, rel_pos[:, None] + hops],
                        dim=1)  # (per_walk, 2W)
    pad = torch.tensor(padding_idx, dtype=walks.dtype, device=dev)

    def component(idx):
        valid = (idx >= 0) & (idx < width)
        return torch.where(valid, walks[:, idx.clamp(0, width - 1)], pad)

    windows = torch.stack([component(rel_idx - 1), component(rel_idx),
                           component(rel_idx + 1)], dim=-1)
    return targets, windows.reshape(num_walks * per_walk, 2 * window_size, 3)


def to_windows_triples_plain(walks, window_size, padding_idx, triples, key,
                             cbow: bool):
    """Plain version of K10, either generator."""
    targets, windows = _triples_targets_and_windows(walks, window_size,
                                                    padding_idx)
    num_win = targets.shape[0]
    draws = CBOW_TRIPLE_ROUNDS if cbow else 2 * window_size
    bits = _neg_bits(key, num_win * draws, walks.device)
    idx = prng.randint_from_bits(bits, triples.shape[0])
    cands = triples[idx].to(walks.dtype).reshape(num_win, draws, 3)
    if not cbow:
        return targets, windows, cands
    collides = (cands == targets[:, None, :]).all(dim=-1)
    pick = torch.argmax((~collides).to(torch.int8), dim=1)
    pick = torch.where(collides.all(dim=1), draws - 1, pick)
    negatives = cands[torch.arange(num_win, device=walks.device), pick]
    return targets, negatives, windows


def _triples_windows(walks, window_size, padding_idx, triples, seed, cbow,
                     device):
    dev = resolve_device(device)
    walks = common.as_int32(walks, dev)
    triples = common.as_int32(triples, dev).reshape(-1, 3)
    if walks.dim() != 2 or int(window_size) < 1:
        raise ValueError("walks must be 2-d and window_size >= 1, got "
                         f"{tuple(walks.shape)} and {window_size}")
    if triples.shape[0] == 0:
        raise ValueError("negatives need at least one triple")
    stream = (prng.STREAM_WINDOWS_TRIPLES_CBOW if cbow
              else prng.STREAM_WINDOWS_TRIPLES_SG)
    key = prng.derive_key(seed, stream)
    args = (walks, int(window_size), int(padding_idx), triples, key, cbow)
    if dev.type == "cuda":
        return bindings.to_windows_triples(*args)
    return to_windows_triples_plain(*args)


def to_windows_triples(walks, window_size, num_nodes, padding_idx, triples,
                       seed=0, device=None):
    """Triples skip-gram windows of int32 [v0, r1, v1, ...] walks: (targets,
    windows, negatives), 2 * window_size negative triples a window drawn
    uniformly from ``triples``.  ``num_nodes`` is accepted and unused, as in
    the JAX package."""
    del num_nodes
    return _triples_windows(walks, window_size, padding_idx, triples, seed,
                            False, device)


def to_windows_triples_cbow(walks, window_size, num_nodes, padding_idx,
                            triples, seed=0, device=None):
    """Triples CBOW windows: (target triples, one negative triple a window,
    windows).  ``num_nodes`` is accepted and unused."""
    del num_nodes
    return _triples_windows(walks, window_size, padding_idx, triples, seed,
                            True, device)
