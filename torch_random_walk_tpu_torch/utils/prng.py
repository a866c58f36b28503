"""Counter-based, stateless PRNG for walker sampling (PyTorch twin).

Every random draw is a pure function of

    (seed, stream, walker id, step, round)

computed through Threefry-2x32 (20 rounds), the same function the JAX
package evaluates in ``torch_random_walk_tpu/utils/prng.py``.  Equal inputs
give equal words, which is what makes the port's walks and windows equal the
JAX package's value for value.

``torch`` has no ``uint32`` add/shift/compare on the CPU, so a 32-bit word is
held here as a non-negative ``int64`` and every wrapping operation is masked
with ``0xFFFFFFFF``.  The same code runs on CUDA tensors and is the plain
version that the CUDA kernels (``kernels/threefry.cuh``) are held against.
Every function also accepts plain Python ints, which is how keys are derived
on the host.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Threefry-2x32 rotation constants (Salmon et al., SC'11).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

# Stream ids: one per independent consumer of randomness (same numbering as
# the JAX package; adding a stream never perturbs existing ones).
STREAM_CSR_UNIFORM = 0
STREAM_CSR_BIASED = 1
STREAM_EDGE_UNIFORM = 2
STREAM_EDGE_BIASED = 3
STREAM_TRIPLES = 4
STREAM_WINDOWS_SG = 5
STREAM_WINDOWS_CBOW = 6
STREAM_WINDOWS_TRIPLES_SG = 7
STREAM_WINDOWS_TRIPLES_CBOW = 8
STREAM_TRAIN = 9
STREAM_KGE_NEG = 10

# Max rejection rounds folded into one step's counter space.
MAX_ROUNDS_PER_STEP = 1 << 16

# The trainers' per-epoch seed stride (the golden-ratio word).
EPOCH_STRIDE = 0x9E3779B1


def as_u32(x, device=None):
    """Integer tensor/array/int -> ``int64`` tensor holding the value's low
    32 bits as a non-negative number (the uint32 bit pattern)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK32


def to_i32_bits(u):
    """Non-negative ``int64`` uint32 pattern -> ``int32`` with the same bits
    (values >= 2^31 become negative)."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds.  Words are uint32 patterns held as
    non-negative ``int64`` tensors (or Python ints); returns two such words
    per counter."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    for group in range(5):
        rots = _ROTATIONS[0:4] if group % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & MASK32
    return x0, x1


def derive_key(seed: int, stream: int) -> tuple[int, int]:
    """(k0, k1) key words, as Python ints, from a user seed (any sign or
    width; folded to 64 bits, low word first) and a stream id."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return threefry2x32(seed & MASK32, seed >> 32, int(stream), 0x9E3779B9)


def epoch_seed(seed: int, epoch: int) -> int:
    """uint32(seed) + uint32(epoch) * 0x9E3779B1, wrapping, as a Python int
    in [0, 2^32): the seed of a trainer's epoch step, as the JAX trainers
    compute it in uint32 (so never the large-seed path of ``derive_key``)."""
    return ((int(seed) & MASK32)
            + (int(epoch) & MASK32) * EPOCH_STRIDE) & MASK32


def counter_bits(key, c0, c1):
    """Two independent uint32 words per (c0, c1) counter pair."""
    return threefry2x32(key[0], key[1], c0, c1)


def step_round_counter(step, round_idx=0):
    """Pack (step, round) into the c1 counter word (wraps in 32 bits)."""
    return (step * MAX_ROUNDS_PER_STEP + round_idx) & MASK32


def uniform_from_bits(bits):
    """uint32 pattern -> float32 uniform in [0, 1) from the top 24 bits
    (exactly representable, always < 1)."""
    return (bits >> 8).to(torch.float32) * torch.tensor(
        1.0 / (1 << 24), dtype=torch.float32, device=bits.device)


def mulhi32(a, b):
    """High 32 bits of the unsigned 32x32 -> 64 product.  Split in 16-bit
    halves so that no intermediate leaves the signed ``int64`` range."""
    mask = 0xFFFF
    a_lo, a_hi = a & mask, a >> 16
    b_lo, b_hi = b & mask, b >> 16
    t = a_hi * b_lo + ((a_lo * b_lo) >> 16)
    u = a_lo * b_hi + (t & mask)
    return (a_hi * b_hi + (t >> 16) + (u >> 16)) & MASK32


def mullo32(a, b):
    """Low 32 bits of the unsigned 32x32 product (uint32 multiplication that
    wraps), split in 16-bit halves so that no intermediate leaves the signed
    ``int64`` range."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & MASK32


def randint_from_bits(bits, n):
    """uint32 pattern -> uniform integer in [0, n) by multiply-shift:
    floor(bits * n / 2^32), exact for any n < 2^31."""
    return mulhi32(bits, n)
