"""The port's window generators against torch_random_walk_tpu/ops/windows.py
(tolerance 0: node ids), and the slice as a whole: graph -> walk -> windows
through both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.ops.windows import _sliding
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops.windows import to_windows_plain
from torch_port_util import eq, need_cuda, power_law_edges


@pytest.fixture(scope="module")
def walks():
    return np.random.default_rng(40).integers(0, 97, (24, 9)).astype(np.int32)


def test_golden_windows():
    walks = torch.tensor(np.arange(12).reshape(2, 6) % 9)
    tgt, pos, neg = tt.to_windows(walks, 3, 9, seed=4, device="cpu")
    eq(tgt, [1, 2, 3, 4, 7, 8, 0, 1])
    eq(pos, [[0, 2], [1, 3], [2, 4], [3, 5], [6, 8], [7, 0], [8, 1], [0, 2]])
    eq(neg, [[2, 5], [5, 4], [0, 8], [6, 8], [3, 0], [2, 4], [5, 0], [7, 3]])


@pytest.mark.parametrize("window", [2, 5, 9])
def test_to_windows_equals_jax(walks, window):
    want = trw.to_windows(jnp.asarray(walks), window, 97, seed=6)
    got = tt.to_windows(walks, window, 97, seed=6, device="cpu")
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        eq(g, w)


@pytest.mark.parametrize("window,num_nodes", [(4, 97), (5, 1)])
def test_to_windows_cbow_equals_jax(walks, window, num_nodes):
    w = walks % num_nodes
    want = trw.to_windows_cbow(jnp.asarray(w), window, num_nodes, seed=6)
    got = tt.to_windows_cbow(w, window, num_nodes, seed=6, device="cpu")
    for g, x in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and tuple(g.shape) == x.shape
        eq(g, x)
    if num_nodes > 1:
        assert bool((got[1] != got[0]).all())  # negative never the positive


def test_window_size_out_of_range_raises(walks):
    with pytest.raises(ValueError, match="window_size"):
        tt.to_windows(walks, 10, 97, device="cpu")


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0)])
def test_slice_graph_walk_windows_equals_jax(p, q):
    """The whole single-device leg through the public entry points."""
    n = 200
    src, dst = power_law_edges(n, 5, seed=50)
    jg = trw.CSRGraph.from_edges(src, dst, num_nodes=n)
    tg = tt.CSRGraph.from_edges(src, dst, num_nodes=n, device="cpu")
    t = (np.arange(48) * 7 % n).astype(np.int32)
    jw = trw.walk(jg, target_nodes=jnp.asarray(t), p=p, q=q, walk_length=8,
                  seed=12)
    tw = tt.walk(tg, target_nodes=t, p=p, q=q, walk_length=8, seed=12,
                 device="cpu")
    eq(tw, jw)
    for g, w in zip(tt.to_windows(tw, 5, n, seed=13, device="cpu"),
                    trw.to_windows(jw, 5, n, seed=13), strict=True):
        eq(g, w)


def k3_thread_map(plan, num_walks, window):
    """Python mirror of K3's thread -> (walk, offset, j, slot) mapping
    (kernels/windows.cu::to_windows_kernel) with the kernel's 32-bit
    arithmetic: thread t of block (x, group) takes window u = x * 256 + t of
    its group, in the group's walk u * magic >> shift, at word u + walk *
    (W - 1) of the group's words.  Returns, per thread that writes, its
    (walk, offset, window, first slot)."""
    ctx = window - 1
    group, x, t = (a.ravel().astype(np.uint64) for a in np.meshgrid(
        np.arange(plan.groups), np.arange(plan.blocks),
        np.arange(bindings.WINDOW_THREADS), indexing="ij"))
    walk0 = group * np.uint64(plan.group_walks)
    here = np.minimum(plan.group_walks, num_walks - walk0) * plan.per_walk
    u = x * np.uint64(bindings.WINDOW_THREADS) + t
    u, group, walk0 = u[u < here], group[u < here], walk0[u < here]
    assert (u < 2**31).all()
    walk_in_group = (u * np.uint64(plan.magic)) >> np.uint64(plan.shift)
    offset = u - walk_in_group * np.uint64(plan.per_walk)
    word = u + walk_in_group * np.uint64(ctx)  # staged address, 32-bit
    assert (word < 2**32).all()
    win = group * np.uint64(plan.group_windows) + u
    slot = (group * np.uint64(plan.group_slots)
            + u * np.uint64(ctx)) & 0xFFFFFFFF
    walk = walk0 + walk_in_group
    return walk, offset, word, win, slot


@pytest.mark.parametrize("window,length,num_walks,group_words", [
    (2, 2, 1, None), (3, 3, 33, None), (5, 5, 4097, 3 * 5), (8, 8, 33, None),
    (5, 21, 33, 2 * 21 + 5), (3, 12, 4097, None), (2, 9, 33, 9)])
def test_windows_thread_mapping_mirror_equals_jax_layout(
        window, length, num_walks, group_words):
    """K3's mapping, mirrored on the CPU, writes every window once, reads
    the words of JAX's sliding windows (walks coded by their flat position)
    and keys window win's slot j by win * (W-1) + j, _neg_bits' flat order;
    small ``group_words`` cut the walks into many groups."""
    kw = {} if group_words is None else {"group_words": group_words}
    plan = bindings.windows_plan(num_walks, length, window, **kw)
    walk, offset, word, win, slot = k3_thread_map(plan, num_walks, window)
    num_win = num_walks * (length - window + 1)
    np.testing.assert_array_equal(np.sort(win), np.arange(num_win))
    np.testing.assert_array_equal(walk * plan.per_walk + offset, win)
    group_first = walk - walk % plan.group_walks
    np.testing.assert_array_equal(
        group_first * length + word, walk * length + offset)
    coded = np.arange(num_walks * length, dtype=np.int32).reshape(num_walks,
                                                                  length)
    sliding, _ = _sliding(jnp.asarray(coded), window)
    want_words = np.asarray(sliding).reshape(num_win, window)[
        win.astype(np.int64)]
    got_words = (walk * length + offset)[:, None] + np.arange(window)
    np.testing.assert_array_equal(got_words, want_words)
    ctx = window - 1
    flat = np.arange(num_win * ctx, dtype=np.uint64).reshape(num_win, ctx)
    np.testing.assert_array_equal(
        slot[:, None] + np.arange(ctx, dtype=np.uint64),
        flat[win.astype(np.int64)] & 0xFFFFFFFF)


@pytest.mark.parametrize("divisor", [1, 2, 3, 7, 77, 1000, 2**16 + 1,
                                     2**30, 2**30 + 1, 2**31 - 1])
def test_windows_division_magic_is_exact(divisor):
    magic, shift = bindings.division_magic(divisor)
    assert magic < 2**32
    rng = np.random.default_rng(divisor)
    u = np.concatenate([rng.integers(0, 2**31, 20000),
                        np.arange(2**31 - 2000, 2**31),
                        divisor * np.arange(1, 200) - 1]).astype(np.uint64)
    u = u[u < 2**31]
    np.testing.assert_array_equal((u * np.uint64(magic)) >> np.uint64(shift),
                                  u // np.uint64(divisor))


def test_windows_plan_groups_and_limits():
    plan = bindings.windows_plan(131_072, 81, 5)
    assert (plan.groups, plan.group_walks, plan.per_walk) == (1, 131_072, 77)
    assert plan.blocks == -(-131_072 * 77 // 256)
    cut = bindings.windows_plan(10, 6, 2, group_words=13)
    assert (cut.group_walks, cut.groups, cut.group_windows) == (2, 5, 10)
    with pytest.raises(ValueError, match="do not fit"):
        bindings.windows_plan(1, 20, 2, group_words=13)


@pytest.mark.cuda
def test_windows_kernel_equals_plain_version(walks):
    need_cuda()
    got = tt.to_windows(walks, 5, 97, seed=6)
    want = tt.to_windows(walks, 5, 97, seed=6, device="cpu")
    for g, w in zip(got, want, strict=True):
        assert g.is_cuda
        eq(g, w.numpy())
    # both instantiations (W = 5 and any W), windows as long as the walk,
    # ragged last blocks, and the num_nodes edges
    rng = np.random.default_rng(41)
    for window in (2, 3, 5, 8):
        for num_walks in (1, 33, 4097):
            for num_nodes in (1, 97, 2**31 - 1):
                for length in (window, window + 76):
                    w = rng.integers(0, 2**31 - 1, (num_walks, length))
                    w = w.astype(np.int32)
                    got = tt.to_windows(w, window, num_nodes, seed=num_walks)
                    want = tt.to_windows(w, window, num_nodes, seed=num_walks,
                                         device="cpu")
                    for g, x in zip(got, want, strict=True):
                        eq(g, x.numpy())
    # many groups of walks (blockIdx.y), as more than 2^31 words would take:
    # two walks a group, the last group ragged
    w = rng.integers(0, 97, (33, 21)).astype(np.int32)
    key = (123, 456)
    got = bindings.to_windows(torch.from_numpy(w).cuda(), 5, 97, key,
                              group_words=2 * 21 + 5)
    want = to_windows_plain(torch.from_numpy(w), 5, 97, key)
    for g, x in zip(got, want, strict=True):
        eq(g, x.numpy())
    got = bindings.to_windows(torch.from_numpy(w).cuda(), 3, 97, key,
                              group_words=21)
    want = to_windows_plain(torch.from_numpy(w), 3, 97, key)
    for g, x in zip(got, want, strict=True):
        eq(g, x.numpy())
