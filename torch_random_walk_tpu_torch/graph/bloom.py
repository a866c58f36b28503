"""Per-node Bloom filters over out-neighbour sets (twin of the 128-bit
filters of ``torch_random_walk_tpu/graph/bloom.py``).

The routed node2vec engine carries N(t)'s filter in each walker record, so
that most draws whose acceptance depends on being a neighbour of t are
decided where they are drawn: a negative probe proves the draw is no
neighbour (no false negatives), and only positives need the exact test at
t's owner.  Two multiply-shift probes per neighbour; a hub saturates to all
ones, which only turns the shortcut off for it.

Words are uint32 patterns: int64 masked to 32 bits in the arithmetic, int32
bit patterns in the built tables.  The 96-bit width of the JAX package's
single-chip fat rows is not ported.
"""

from __future__ import annotations

import torch

from torch_random_walk_tpu_torch.utils import prng

BLOOM_WORDS = 4  # 128 bits: the routed walker records' width
BLOOM_MULS = (0x9E3779B9, 0x85EBCA6B)


def bloom_positions(x):
    """Bit position of each probe for values ``x`` (uint32 patterns as
    int64): mulhi(x * mul mod 2^32, 32 * BLOOM_WORDS)."""
    x = prng.as_u32(x)
    return [prng.mulhi32(prng.mullo32(x, m), 32 * BLOOM_WORDS)
            for m in BLOOM_MULS]


def build_node_blooms(row_ptr: torch.Tensor,
                      col_idx: torch.Tensor) -> torch.Tensor:
    """(N, BLOOM_WORDS) int32 bit patterns: each node's filter over its
    out-neighbours, built on the graph's device.  Every (node, word, bit)
    that some probe sets is kept once, so a word is the sum of its distinct
    powers of two: the same words as the JAX package's ``bitwise_or.at``,
    with no scatter-or."""
    dev = row_ptr.device
    n = row_ptr.shape[0] - 1
    deg = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    heads = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    keys = torch.cat([(heads * BLOOM_WORDS + (pos >> 5)) * 32 + (pos & 31)
                      for pos in bloom_positions(col_idx)])
    keys = torch.unique(keys)
    blooms = torch.zeros(n * BLOOM_WORDS, dtype=torch.int64, device=dev)
    blooms.index_add_(0, keys >> 5, torch.ones_like(keys) << (keys & 31))
    return prng.to_i32_bits(blooms).view(n, BLOOM_WORDS)


def bloom_maybe(bloom_rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """True unless the filter of each lane (``bloom_rows`` (..., BLOOM_WORDS),
    int32 patterns or uint32 patterns as int64) proves ``cand`` is not in
    its set."""
    rows = prng.as_u32(bloom_rows)
    hit = torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
    for pos in bloom_positions(cand):
        word = torch.gather(rows, -1, (pos >> 5).unsqueeze(-1)).squeeze(-1)
        hit &= ((word >> (pos & 31)) & 1) != 0
    return hit
