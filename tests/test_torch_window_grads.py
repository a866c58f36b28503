"""K17's design in tensor code, against the JAX package: the plain mirrors
of its counting sort (``bucket_slots_plain``) and of its owner sums
(``owner_rows_plain``, composed in ``windows_grads_plain``) and the train
step's ``windows_loss_and_grads`` on the CPU, each held against the JAX
package's ``loss_fn`` under ``jax.value_and_grad`` from identical tables
and windows made with numpy.  The kernels themselves, the heavy-row owner
pass included, are held against the plain version on the card
(``tests/test_torch_trainer_modes.py``).

Tolerances: ids, offsets and slot orders exactly; float32 sums in another
order than autograd's or JAX's: the loss rtol 1e-5, gradients within 1e-5
of the largest entry of their table (JAX float32: 1e-4 relative, 1e-6
absolute, as ``tests/test_torch_trainer_modes.py``); bfloat16 tables read
exactly as float32 by the port's mirrors, against JAX's bfloat16 gradient
(and the CPU train step's, summed in bfloat16 as JAX's, against either):
within 4 bfloat16 ulps of the table's largest entry (atol 4 * 2^-8 * max);
JAX's CBOW, float32 only, takes the bfloat16 tables as float32 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_random_walk_tpu.models import CBOWModel as JCBOW
from torch_random_walk_tpu.models.skipgram import SkipGramModel as JModel
from torch_random_walk_tpu_torch.models import skipgram as tsg

N, B = 40, 24
BF16_ULP = 2.0 ** -8


def tables(seed, d, n=N):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32)
            for _ in range(2)]


def windows(seed, cbow, b=B, n=N):
    """(in ids (B, CI), pos (B, CO), neg (B, CO)) int32 with -1 among each
    kind and a duplicate id inside some windows: skip-gram CI = 1, CO = 4;
    CBOW CI = 4, CO = 1."""
    rng = np.random.default_rng(seed)
    ci, co = (4, 1) if cbow else (1, 4)
    in_ids = rng.integers(0, n, (b, ci)).astype(np.int32)
    pos = rng.integers(0, n, (b, co)).astype(np.int32)
    neg = rng.integers(0, n, (b, co)).astype(np.int32)
    in_ids[::5, 0] = -1
    pos[::3, -1] = -1
    neg[1::4, 0] = -1
    if cbow:
        in_ids[::2, 1] = in_ids[::2, 0]
    else:
        neg[::2, 1] = pos[::2, 0]
    return in_ids, pos, neg


_J_GRADS = {False: jax.jit(jax.value_and_grad(JModel.loss_fn)),
            True: jax.jit(jax.value_and_grad(JCBOW.loss_fn))}


def jax_loss_and_grads(t, dtype, ids, cbow):
    """JAX's value_and_grad of the form's loss_fn, gradients as float32
    numpy (in_emb's, out_emb's).  JAX's CBOW trains float32 tables only, so
    a bfloat16 CBOW case gives it the tables rounded to bfloat16 as float32
    (the values the port reads): its reference is float32 arithmetic."""
    params = {"in_emb": jnp.asarray(t[0]).astype(dtype),
              "out_emb": jnp.asarray(t[1]).astype(dtype)}
    if cbow:
        params = {k: v.astype(jnp.float32) for k, v in params.items()}
    in_ids, pos, neg = (jnp.asarray(x) for x in ids)
    args = ((pos[:, 0], neg[:, 0], in_ids) if cbow
            else (in_ids[:, 0], pos, neg))
    loss, grads = _J_GRADS[cbow](params, *args)
    return float(loss), [np.asarray(grads[k].astype(jnp.float32))
                         for k in ("in_emb", "out_emb")]


def port_tables(t, dtype):
    return [torch.tensor(x).to(getattr(torch, dtype)) for x in t]


def assert_rows_close(got, want, rel):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# --- the counting sort ---------------------------------------------------------------

def bucket_case(case):
    """Slot rows of one case: (ids as the windows hold them, N)."""
    rng = np.random.default_rng(len(case))
    if case == "minus-one":
        ids = np.concatenate([rng.integers(-1, N, 60), [-1, N - 1, -1]])
    elif case == "rows-with-no-slot":
        ids = rng.integers(0, N // 4, 50) * 4
    elif case == "one-hot-row":
        ids = np.full(300, 7)
    elif case == "duplicates-in-a-window":
        ids = np.repeat(rng.integers(0, N, 20), 3)
    else:
        ids = np.array([3])
    return ids.astype(np.int32), N


@pytest.mark.parametrize("case", ["minus-one", "rows-with-no-slot",
                                  "one-hot-row", "duplicates-in-a-window",
                                  "one-slot"])
def test_bucketing_equals_a_stable_numpy_grouping(case):
    ids, n = bucket_case(case)
    rows = tsg.table_rows(torch.tensor(ids), n)
    np.testing.assert_array_equal(rows.numpy(), np.where(ids < 0, ids + n,
                                                         ids))
    offsets, order = tsg.bucket_slots_plain(rows, n)
    want_rows = np.where(ids < 0, ids + n, ids)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want_rows, kind="stable"))
    np.testing.assert_array_equal(
        offsets.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(want_rows, minlength=n))]))
    for r in range(n):
        slots = order[offsets[r]:offsets[r + 1]].numpy()
        assert (want_rows[slots] == r).all() and (np.diff(slots) > 0).all()


# --- the owner-computed gradient -------------------------------------------------------

@pytest.mark.parametrize("d", [1, 7, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cbow", [False, True], ids=["skip-gram", "cbow"])
def test_owner_gradient_equals_autograd_and_jax(cbow, dtype, d):
    t = tables(d, d)
    ids = windows(d + 100, cbow)
    in_emb, out_emb = port_tables(t, dtype)
    tids = [torch.tensor(x) for x in ids]
    loss, grads = tsg.windows_grads_plain(in_emb, out_emb, *tids)
    # autograd of the plain loss on float32 copies (exact for bfloat16)
    leaves = [x.float().requires_grad_(True) for x in (in_emb, out_emb)]
    want_loss = tsg.windows_loss_plain(*leaves, *tids)
    want = torch.autograd.grad(want_loss, leaves)
    np.testing.assert_allclose(float(loss), float(want_loss.detach()),
                               rtol=1e-5)
    for got, ref in zip(grads, want):
        assert got.dtype == torch.float32 and got.shape == (N, d)
        assert_rows_close(got.numpy(), ref.numpy(), 1e-5)
    jloss, jgrads = jax_loss_and_grads(t, jnp.dtype(dtype), ids, cbow)
    f32_reference = dtype == "float32" or cbow
    np.testing.assert_allclose(float(loss), jloss,
                               rtol=1e-5 if f32_reference else 1e-4)
    for got, ref in zip(grads, jgrads):
        if f32_reference:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-6)
        else:
            assert_rows_close(got.numpy(), ref, 4 * BF16_ULP)


def test_window_terms_are_the_logits_gradient_and_scale_with_grad_loss():
    """g is autograd's gradient of the loss by the logits (times grad_loss),
    dh / CI its product with the out rows, h the in rows' mean."""
    t = tables(5, 6)
    in_emb, out_emb = port_tables(t, "float32")
    ids = [torch.tensor(x) for x in windows(6, cbow=True)]
    loss, g, h, dh = tsg.window_terms_plain(in_emb, out_emb, *ids,
                                            grad_loss=2.5)
    np.testing.assert_allclose(
        h.numpy(), in_emb[tsg.table_rows(ids[0], N)].mean(1).numpy(),
        rtol=1e-6)
    rows = out_emb[tsg.table_rows(torch.cat(ids[1:], 1), N)]
    x = (h[:, None] * rows).sum(-1).requires_grad_(True)
    ref = -(torch.nn.functional.logsigmoid(x[:, :1]).sum(-1)
            + torch.nn.functional.logsigmoid(-x[:, 1:]).sum(-1)).mean()
    (dx,) = torch.autograd.grad(2.5 * ref, x)
    np.testing.assert_allclose(float(loss), float(ref.detach()), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), dx.numpy(), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dh.numpy(),
                               ((g[..., None] * rows).sum(1) / 4).numpy(),
                               rtol=1e-6)


# --- the train step's entry on the CPU --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cbow", [False, True], ids=["skip-gram", "cbow"])
def test_windows_loss_and_grads_on_the_cpu_equals_jax(cbow, dtype):
    t = tables(7, 16)
    ids = windows(8, cbow)
    in_emb, out_emb = port_tables(t, dtype)
    loss, grads = tsg.windows_loss_and_grads(
        in_emb, out_emb, *[torch.tensor(x) for x in ids], cbow)
    jloss, jgrads = jax_loss_and_grads(t, jnp.dtype(dtype), ids, cbow)
    assert loss.dtype == torch.float32 and not loss.requires_grad
    np.testing.assert_allclose(
        float(loss), jloss, rtol=1e-5 if dtype == "float32" or cbow else 1e-4)
    for got, ref in zip(grads, jgrads):
        assert got.dtype == torch.float32
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-6)
        else:
            assert_rows_close(got.numpy(), ref, 4 * BF16_ULP)
