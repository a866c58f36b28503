"""Cuckoo hash set over directed edges (twin of
``torch_random_walk_tpu/graph/hashset.py``): exact membership of (u, v) in
two table probes, whatever u's degree.

A key (u, v) is stored as the row (lo, hi) = (v, u) of an (S, 2) table of
uint32 words (int32 bit patterns here); the all-ones row is empty.  The
build follows the JAX package's NumPy build step for step, on the device of
the given edges: keys deduplicated and sorted, then rounds in which every
pending key writes itself to the slot of its current hash choice, the last
pending key of a slot wins (the NumPy fancy assignment's rule, taken here by
``scatter_reduce("amax")`` over the pending order), and losers and evicted
occupants flip their choice and wait; the same salts are tried in the same
order.  So the table equals the NumPy build's bit for bit.  (The JAX package
uses its compiled native routine where present, which lays the keys out
differently; membership, and so every walk, is the same.)
"""

from __future__ import annotations

import dataclasses

import torch

from torch_random_walk_tpu_torch.utils import prng

EMPTY = 0xFFFFFFFF
# Odd multipliers per (hash index, word), xored with a salt per rehash.
H_CONSTS = (
    (0x9E3779B1, 0x85EBCA77),
    (0xC2B2AE3D, 0x27D4EB2F),
)
SALT_TRIES = 64


def hash_slot(lo, hi, salt: int, which: int, log_size: int):
    """Slot of key (lo, hi) under hash ``which`` (uint32 patterns as int64;
    ``salt`` a Python int or a tensor of them)."""
    a, b = H_CONSTS[which]
    a = a ^ salt
    b = b ^ ((salt * 0x9E3779B9) & prng.MASK32)
    h = (prng.mullo32(lo, a) + prng.mullo32(hi, b) + which + 1) & prng.MASK32
    h = h ^ (h >> 16)
    h = prng.mullo32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    return h >> (32 - log_size)


@dataclasses.dataclass(frozen=True)
class EdgeHashSet:
    """Static cuckoo set of directed (u, v) edges."""

    table: torch.Tensor  # (S, 2) int32 (v, u) rows; all ones = empty
    log_size: int        # S == 1 << log_size
    salt: int

    @classmethod
    def from_edges_with_log_size(cls, src, dst, log_size: int,
                                 max_rounds: int = 256) -> "EdgeHashSet":
        """Build a table of 2^log_size rows (the size every shard of a
        partition shares), trying the salts in turn; raises if none
        converges."""
        src = prng.as_u32(src)
        dst = prng.as_u32(dst, device=src.device)
        keys = torch.unique((src << 32) | dst)  # sorted, deduplicated
        lo, hi = keys & prng.MASK32, keys >> 32
        for salt in range(SALT_TRIES):
            slots = _place(lo, hi, salt, log_size, max_rounds)
            if slots is not None:
                table = torch.full((1 << log_size, 2), -1, dtype=torch.int32,
                                   device=keys.device)
                used = slots >= 0
                table[used, 0] = prng.to_i32_bits(lo[slots[used]])
                table[used, 1] = prng.to_i32_bits(hi[slots[used]])
                return cls(table=table, log_size=log_size, salt=salt)
        raise RuntimeError("cuckoo build failed to converge (pathological "
                           "input)")

    def contains(self, u, v) -> torch.Tensor:
        """Is (u, v) in the set?  Two row probes."""
        return table_contains(self.table, self.salt, self.log_size, u, v)


def _place(lo, hi, salt: int, log_size: int, max_rounds: int):
    """Key index held by each slot (-1 = empty) once every key is placed,
    or None if ``max_rounds`` rounds leave some pending."""
    k, dev = lo.shape[0], lo.device
    size = 1 << log_size
    slot_of = torch.full((size,), -1, dtype=torch.int64, device=dev)
    h01 = torch.stack([hash_slot(lo, hi, salt, w, log_size) for w in (0, 1)],
                      dim=1)
    choice = torch.zeros(k, dtype=torch.int64, device=dev)
    pending = torch.arange(k, device=dev)
    for _ in range(max_rounds):
        if pending.numel() == 0:
            return slot_of
        pos = h01[pending, choice[pending]]
        old = slot_of[pos]
        order = torch.arange(pending.numel(), device=dev)
        last = torch.full((size,), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, pos, order, "amax")
        landed = last[pos] == order
        slot_of[pos[landed]] = pending[landed]
        evicted = old[landed]
        evicted = evicted[evicted >= 0]
        choice[evicted] ^= 1
        pending = torch.cat([pending[~landed], evicted])
    return None


def table_contains(table, salt, log_size: int, u, v,
                   shard=None) -> torch.Tensor:
    """Membership of (u, v) in an (S, 2) int32 table of ``salt`` (an int),
    or with ``shard`` given in table ``shard`` of a stack of them (D, S, 2)
    with its salt (``salt`` a (D,) tensor)."""
    lo, hi = prng.as_u32(v), prng.as_u32(u)
    if shard is not None:
        salt = salt[shard]
    hit = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    for which in (0, 1):
        pos = hash_slot(lo, hi, salt, which, log_size)
        row = prng.as_u32(table[pos] if shard is None else table[shard, pos])
        hit |= (row[..., 0] == lo) & (row[..., 1] == hi)
    return hit
