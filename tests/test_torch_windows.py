"""The port's window generators against torch_random_walk_tpu/ops/windows.py
(tolerance 0: node ids), and the slice as a whole: graph -> walk -> windows
through both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
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


@pytest.mark.cuda
def test_windows_kernel_equals_plain_version(walks):
    need_cuda()
    got = tt.to_windows(walks, 5, 97, seed=6)
    want = tt.to_windows(walks, 5, 97, seed=6, device="cpu")
    for g, w in zip(got, want, strict=True):
        assert g.is_cuda
        eq(g, w.numpy())
