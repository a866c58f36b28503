"""The port's PRNG (torch_random_walk_tpu_torch/utils/prng.py) against the
JAX package's, word for word.  Tolerance 0: the outputs are integers, and
the one float function is an exact scaling of 24 bits."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_random_walk_tpu.ops import common as jcommon
from torch_random_walk_tpu.utils import prng as jprng
from torch_random_walk_tpu_torch.ops import common as tcommon
from torch_random_walk_tpu_torch.utils import prng as tprng


def _words(seed, n=4096):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return tprng.as_u32(a.astype(np.int64))


def test_stream_ids_and_constants():
    names = [n for n in dir(jprng) if n.startswith("STREAM_")]
    assert names
    for n in names + ["MAX_ROUNDS_PER_STEP"]:
        assert getattr(tprng, n) == getattr(jprng, n), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_matches_jax(seed):
    k0, k1 = (int(x) for x in _words(100 + seed, 2))
    c0, c1 = _words(seed), _words(seed + 50)
    j0, j1 = jprng.threefry2x32(np.uint32(k0), np.uint32(k1), c0, c1)
    t0, t1 = tprng.threefry2x32(k0, k1, _t(c0), _t(c1))
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), np.asarray(j1))


@pytest.mark.parametrize("seed", [0, 10, -1, -12345, 2**40 + 7, 2**70 + 3])
@pytest.mark.parametrize("stream", [0, 1, 5])
def test_derive_key_matches_jax(seed, stream):
    want = tuple(int(x) for x in jprng.derive_key(seed, stream))
    assert tprng.derive_key(seed, stream) == want


def test_mulhi_and_randint_match_jax():
    a = _words(3)
    # n up to 2^31 (the documented range) and the full 32-bit range for mulhi
    b_full = _words(4)
    n = np.concatenate([np.random.default_rng(5).integers(
        1, 2**31, a.size - 4, dtype=np.int64), [1, 2, 2**31 - 1, 2**31]]
    ).astype(np.uint32)
    np.testing.assert_array_equal(
        tprng.mulhi32(_t(a), _t(b_full)).numpy().astype(np.uint32),
        np.asarray(jprng.mulhi32(a, b_full)))
    np.testing.assert_array_equal(
        tprng.mulhi32(_t(a), _t(n)).numpy(),
        (a.astype(np.uint64) * n.astype(np.uint64) >> np.uint64(32)))
    small = (n % np.uint32(2**31 - 1)) + np.uint32(1)
    np.testing.assert_array_equal(
        tprng.randint_from_bits(_t(a), _t(small)).numpy(),
        np.asarray(jprng.randint_from_bits(a, small)))


def test_uniform_from_bits_matches_jax():
    bits = np.concatenate([_words(6), np.array([0, 2**32 - 1, 255, 256],
                                               np.uint32)])
    got = tprng.uniform_from_bits(_t(bits))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jprng.uniform_from_bits(bits)))
    assert float(got.max()) < 1.0


def test_step_round_counter_and_counter_bits_match_jax():
    step = np.arange(0, 70000, 977, dtype=np.uint32)
    rnd = (step * np.uint32(31)) % np.uint32(4096)
    jc = jprng.step_round_counter(step, rnd)
    tc = tprng.step_round_counter(_t(step), _t(rnd))
    np.testing.assert_array_equal(tc.numpy().astype(np.uint32), np.asarray(jc))
    key = tprng.derive_key(7, tprng.STREAM_CSR_BIASED)
    jkey = jprng.derive_key(7, jprng.STREAM_CSR_BIASED)
    wid = _words(8, step.size)
    j0, j1 = jprng.counter_bits(jkey, wid, jc)
    t0, t1 = tprng.counter_bits(key, _t(wid), tc)
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), np.asarray(j1))


@pytest.mark.parametrize("offset", [0, 17, 2**32 - 5])
def test_walker_ids_wrap_like_jax(offset):
    got = tcommon.walker_ids(16, offset, "cpu")
    want = jcommon.walker_ids(16, jnp.uint32(offset))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))


def test_i32_bit_patterns_round_trip():
    w = _words(9)
    back = tprng.as_u32(tprng.to_i32_bits(_t(w)))
    np.testing.assert_array_equal(back.numpy().astype(np.uint32), w)
    assert tprng.to_i32_bits(_t(w)).dtype == torch.int32
