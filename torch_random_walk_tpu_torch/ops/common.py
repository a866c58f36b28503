"""Shared vectorised sampling primitives of the plain PyTorch versions
(twin of ``torch_random_walk_tpu/ops/common.py``).

Every function works on a whole (num_walkers,) frontier of ``int64`` tensors;
32-bit random words are uint32 patterns held as non-negative ``int64`` (see
``utils/prng.py``).  Where the JAX code relies on gathers that clamp their
indices, the clamp is written out here, because PyTorch raises (CPU) or
faults (CUDA) on an index out of range.
"""

from __future__ import annotations

import torch

from torch_random_walk_tpu_torch.utils import prng

# Trip count of a binary search that covers any row of < 2^31 edges.
DEFAULT_SEARCH_ITERS = 32
# Rejection-round cap per step.  Acceptance per round is bounded away from
# zero, so unresolved walkers vanish geometrically; 4096 is far beyond need.
DEFAULT_MAX_ROUNDS = 4096


def compact_indices(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Indices of the first ``capacity`` True lanes of ``mask``, in order,
    padded with the sentinel ``mask.shape[0]``.  One cumsum and one scatter,
    no host synchronisation.  Lanes beyond the capacity all land in one spare
    slot that is cut off, which is why the scatter needs no "drop" mode."""
    num = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    write = torch.where(mask & (pos < capacity), pos,
                        torch.full_like(pos, capacity))
    buf = torch.full((capacity + 1,), num, dtype=torch.int64,
                     device=mask.device)
    buf[write] = torch.arange(num, dtype=torch.int64, device=mask.device)
    return buf[:capacity]


def row_bounds(row_ptr: torch.Tensor, node: torch.Tensor):
    """(start, end) of each node's row as int64; ids are clamped into
    [0, num_nodes), as the JAX gathers clamp them."""
    node = node.clamp(0, row_ptr.shape[0] - 2)
    return row_ptr[node].to(torch.int64), row_ptr[node + 1].to(torch.int64)


def gather_col(col_idx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return col_idx[idx.clamp(0, max(col_idx.shape[0] - 1, 0))].to(torch.int64)


def sample_csr_neighbor(row_ptr, col_idx, cur, bits):
    """Uniform out-neighbour of each ``cur`` drawn from ``bits``.  Degree-0
    rows stay at ``cur``; a graph with no edges leaves every walker in
    place."""
    if col_idx.shape[0] == 0:
        return cur
    start, end = row_bounds(row_ptr, cur)
    deg = end - start
    off = prng.randint_from_bits(bits, deg.clamp(min=1))
    nxt = gather_col(col_idx, start + off)
    return torch.where(deg > 0, nxt, cur)


def lower_bound(col_idx, lo, hi, x, strict: bool, iters: int):
    """First index in each [lo, hi) whose value is >= x (or > x when
    ``strict``), by ``iters`` halvings; a lane is idle once lo == hi."""
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        val = gather_col(col_idx, mid)
        go_right = (val <= x) if strict else (val < x)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def is_neighbor_csr(cand, t, row_ptr, col_idx, iters=DEFAULT_SEARCH_ITERS):
    """Is ``cand`` an out-neighbour of ``t``?  Binary search over the sorted
    row of ``t``."""
    if col_idx.shape[0] == 0:
        return torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
    lo, end = row_bounds(row_ptr, t)
    lo = lower_bound(col_idx, lo, end, cand, False, iters)
    return (lo < end) & (gather_col(col_idx, lo) == cand)


def sample_range_inclusive(ranges_start, ranges_end, bits):
    """Uniform index in [start, end], end inclusive.  The caller masks the
    (-1, -1) rows."""
    cnt = ranges_end - ranges_start + 1
    return ranges_start + prng.randint_from_bits(bits, cnt.clamp(min=1))


def edge_ranges(node_edge_index, node):
    """(start, end-inclusive) of each node's edges as int64, ids clamped into
    [0, num_nodes) as the JAX gathers clamp them, and whether the node has
    edges at all (its row is not the (-1, -1) sentinel)."""
    safe = node.clamp(0, max(node_edge_index.shape[0] - 1, 0))
    start = node_edge_index[safe, 0].to(torch.int64)
    end = node_edge_index[safe, 1].to(torch.int64)
    return start, end, (start >= 0) & (end >= 0)


def gather_rows(table, idx, column: int) -> torch.Tensor:
    """``table[idx, column]`` as int64 with ``idx`` clamped into the table;
    zeros for an empty table, whose lanes every caller masks."""
    if table.shape[0] == 0:
        return torch.zeros_like(idx)
    return table[idx.clamp(0, table.shape[0] - 1), column].to(torch.int64)


def sample_edge_neighbor(edge_list, node_edge_index, cur, jump, padding_idx,
                         bits):
    """Uniform edge-list step: cur == padding -> jump; a node without
    out-edges -> padding; else the tail of a uniform out-edge of cur."""
    start, end, has = edge_ranges(node_edge_index, cur)
    idx = sample_range_inclusive(start.clamp(min=0), end.clamp(min=0), bits)
    nxt = torch.where(has, gather_rows(edge_list, idx, 1),
                      torch.full_like(cur, padding_idx))
    return torch.where(cur == padding_idx, jump, nxt)


def is_neighbor_edge(cand, t, edge_list, node_edge_index, padding_idx,
                     iters=DEFAULT_SEARCH_ITERS, fat: bool = False):
    """Does t have an out-edge to cand?  Binary search over the tails of t's
    [start, end]-inclusive range (sorted by (head, tail)); t == padding is
    never a neighbour.  ``fat``: the answer of the JAX package's cuckoo edge
    set (``ops/fatwalk.py::_edge_set_contains``) instead, which looks t up
    by its own id: false for any t outside [0, num_nodes), padding or not,
    and true for t == padding inside it where the edge exists."""
    start, end_incl, has = edge_ranges(node_edge_index, t)
    if fat:
        valid = has & (t >= 0) & (t < node_edge_index.shape[0])
    else:
        valid = has & (t != padding_idx)
    lo = start.clamp(min=0)
    end = end_incl.clamp(min=0) + 1
    hi = end
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = gather_rows(edge_list, mid, 1) < cand
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return valid & (lo < end) & (gather_rows(edge_list, lo, 1) == cand)


def node2vec_accept_probs(p: float, q: float):
    """Normalised node2vec acceptance probabilities: prob_0 (return to t),
    prob_1 (distance 1), prob_2 (distance 2)."""
    max_prob = max(1.0 / p, 1.0, 1.0 / q)
    return 1.0 / p / max_prob, 1.0 / max_prob, 1.0 / q / max_prob


def walker_ids(num_walkers: int, offset: int, device):
    """Global walker ids (the PRNG identity of each walker), wrapping in 32
    bits."""
    ids = torch.arange(num_walkers, dtype=torch.int64, device=device)
    return (ids + (int(offset) & prng.MASK32)) & prng.MASK32


def as_int32(x, device: torch.device) -> torch.Tensor:
    """Array-like or tensor -> contiguous int32 tensor on ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=torch.int32).contiguous()


def check_walk_length(walk_length: int) -> None:
    """The CPU path's twin of the kernel wrappers' check."""
    if walk_length < 1:
        raise ValueError(f"walk_length must be >= 1, got {walk_length}")
