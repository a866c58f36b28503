"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


def need_cuda():
    """Call at the top of a ``@pytest.mark.cuda`` test: skips where there is
    no card.  Decided while the test runs, never at import, so that every
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")


def power_law_edges(n, avg_deg, seed, dead_ends=True):
    """Random edges with a heavy-tailed in-degree; with ``dead_ends`` the
    last quarter of the nodes has no out-edge."""
    rng = np.random.default_rng(seed)
    e = n * avg_deg
    u = rng.random(e)
    dst = (u * u * n).astype(np.int64)
    src = rng.integers(0, n, e)
    if dead_ends:
        keep = src < (3 * n) // 4
        src, dst = src[keep], dst[keep]
    return src, dst


def eq(torch_out, jax_out):
    """Exact equality (tolerance 0: every compared output is an integer)."""
    np.testing.assert_array_equal(torch_out.cpu().numpy(),
                                  np.asarray(jax_out))
