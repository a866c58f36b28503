"""The port's blockwise SGNS loss, its gradients and its dense Adam against
the JAX package, from the same numpy inputs.  Everything runs on the CPU
through the plain PyTorch version; the CUDA kernels K5/K6 are held against
that same plain version on the card (tests marked ``cuda``, and
chip_smoke.py).

Tolerances: float32 tables differ from JAX only in the order of float32 sums
(loss rtol 1e-5; gradients rtol 1e-4, atol 1e-6; three chained Adam steps
rtol 1e-4 on parameters and moments).  bfloat16 tables hold 8 significant
bits: the loss (float32 from identical bfloat16 rows) keeps rtol 1e-4, and
after three Adam steps, where optax rounds after every elementwise operation
and the port once per stored value, the losses keep rtol 1e-3 and parameters
and moments agree to 4 bfloat16 ulps of their scale (atol 4 * 2^-8 * max|x|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_random_walk_tpu.models.skipgram import SkipGramModel as JModel
from torch_random_walk_tpu.models.skipgram import (
    shared_negative_ids as j_shared_negative_ids,
)
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.models import skipgram as tsg
from torch_port_util import eq, need_cuda

N, D, B, L, S = 48, 8, 16, 8, 6
LR = 5e-2


def make_inputs(seed, n=N, d=D, b=B, length=L, s=S):
    rng = np.random.default_rng(seed)
    return {
        "in_emb": rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32),
        "out_emb": rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32),
        "walks": rng.integers(0, n, (b, length + 1)).astype(np.int32),
        "neg_ids": rng.integers(0, n, s).astype(np.int32),
    }


def jax_params(x, dtype=jnp.float32):
    return {"in_emb": jnp.asarray(x["in_emb"]).astype(dtype),
            "out_emb": jnp.asarray(x["out_emb"]).astype(dtype)}


def torch_model(x, dtype="float32"):
    return convert.skipgram_from_numpy(x["in_emb"], x["out_emb"], dtype,
                                       learning_rate=LR, device="cpu")


def jax_loss_and_grads(x, window, num_neg, dtype=jnp.float32):
    loss, grads = jax.value_and_grad(JModel.walk_loss_fn)(
        jax_params(x, dtype), jnp.asarray(x["walks"]),
        jnp.asarray(x["neg_ids"]), window, num_neg)
    return float(loss), {k: np.asarray(v.astype(jnp.float32))
                         for k, v in grads.items()}


# --- shared negatives -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1, 2**31 + 7])
@pytest.mark.parametrize("num_nodes", [10, 2**24 + 3, 2**31 - 1])
def test_shared_negative_ids_equal_jax(seed, num_nodes):
    got = tsg.shared_negative_ids(seed, 64, num_nodes, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (64,)
    eq(got, j_shared_negative_ids(seed, 64, num_nodes))


def test_shared_negative_ids_equal_jax_for_a_traced_uint32_seed():
    seed = (7 + 3 * 0x9E3779B1) & 0xFFFFFFFF
    eq(tsg.shared_negative_ids(seed, 32, 1000, device="cpu"),
       j_shared_negative_ids(jnp.uint32(seed), 32, 1000))


# --- loss and gradients -----------------------------------------------------------

@pytest.mark.parametrize("window,length,num_neg", [
    (5, L, 4), (3, L, 2), (5, 4, 4), (3, 2, 2), (5, L, 0), (4, L, 3)],
    ids=["W5", "W3", "W5-one-center", "W3-one-center", "no-negatives", "W4"])
def test_walk_loss_and_gradients_match_jax_float32(window, length, num_neg):
    x = make_inputs(3, length=length)
    model = torch_model(x)
    loss = model.walk_loss(torch.tensor(x["walks"]), torch.tensor(x["neg_ids"]),
                           window, num_neg)
    want_loss, want = jax_loss_and_grads(x, window, num_neg)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    loss.backward()
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6)


def test_walk_loss_and_grads_helper_equals_autograd():
    x = make_inputs(4)
    model = torch_model(x)
    loss, grads = model.walk_loss_and_grads(x["walks"], x["neg_ids"], 5, 4)
    want_loss, want = jax_loss_and_grads(x, 5, 4)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert not loss.requires_grad
    for name in ("in_emb", "out_emb"):
        assert grads[name].dtype == torch.float32
        np.testing.assert_allclose(grads[name].numpy(), want[name], rtol=1e-4,
                                   atol=1e-6)


def test_walk_loss_matches_jax_bfloat16():
    x = make_inputs(5)
    model = torch_model(x, "bfloat16")
    loss = model.walk_loss(x["walks"], x["neg_ids"], 5, 4)
    assert loss.dtype == torch.float32
    want_loss, _ = jax_loss_and_grads(x, 5, 4, jnp.bfloat16)
    # same bfloat16 rows on both sides, float32 products and sums
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)


def test_minus_one_in_the_last_column_addresses_the_last_row():
    x = make_inputs(6)
    x["walks"][::3, -1] = -1
    model = torch_model(x)
    loss = model.walk_loss(x["walks"], x["neg_ids"], 5, 4)
    want_loss, want = jax_loss_and_grads(x, 5, 4)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    loss.backward()
    np.testing.assert_allclose(model.out_emb.grad.numpy(), want["out_emb"],
                               rtol=1e-4, atol=1e-6)
    wrapped = dict(x, walks=np.where(x["walks"] < 0, N - 1, x["walks"]))
    same = torch_model(wrapped).walk_loss(wrapped["walks"], x["neg_ids"], 5, 4)
    assert float(same) == float(loss)


# --- three chained train steps ------------------------------------------------------

def chained_steps(dtype_name, steps=3):
    jdtype = jnp.dtype(dtype_name)
    x = make_inputs(7)
    jmodel = JModel(N, D, optimizer=optax.adam(LR), dtype=jdtype,
                    learning_rate=LR)
    params = jax_params(x, jdtype)
    opt_state = jmodel.optimizer.init(params)
    model = torch_model(x, dtype_name)
    rng = np.random.default_rng(8)
    losses = []
    for _ in range(steps):
        walks = rng.integers(0, N, (B, L + 1)).astype(np.int32)
        neg = rng.integers(0, N, S).astype(np.int32)
        params, opt_state, jloss = jmodel.walk_train_step(
            params, opt_state, jnp.asarray(walks), jnp.asarray(neg), 5, 4)
        tloss = model.walk_train_step(walks, neg, 5, 4)
        losses.append((float(tloss), float(jloss)))
    adam = opt_state[0]
    f32 = lambda t: {k: np.asarray(v.astype(jnp.float32)) for k, v in t.items()}
    return model, f32(params), f32(adam.mu), f32(adam.nu), int(adam.count), losses


def test_three_chained_train_steps_match_jax_float32():
    model, params, mu, nu, count, losses = chained_steps("float32")
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got_mu, got_nu, got_count = convert.adam_state_to_numpy(model)
    assert got_count == count == 3
    got_params = convert.skipgram_to_numpy(model)
    for name in ("in_emb", "out_emb"):
        np.testing.assert_allclose(got_params[name], params[name], rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(got_mu[name], mu[name], rtol=1e-4,
                                   atol=1e-9)
        np.testing.assert_allclose(got_nu[name], nu[name], rtol=1e-4,
                                   atol=1e-12)


def test_three_chained_train_steps_match_jax_bfloat16():
    model, params, mu, nu, count, losses = chained_steps("bfloat16")
    assert model.in_emb.dtype == model.mu["in_emb"].dtype == torch.bfloat16
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-3)
    got_params = convert.skipgram_to_numpy(model)
    got_mu, got_nu, _ = convert.adam_state_to_numpy(model)
    ulp = 2.0 ** -8
    for name in ("in_emb", "out_emb"):
        for got, want in ((got_params[name], params[name]),
                          (got_mu[name], mu[name]), (got_nu[name], nu[name])):
            np.testing.assert_allclose(
                got, want, rtol=0, atol=4 * ulp * float(np.abs(want).max()))


def test_dense_adam_moves_rows_with_zero_gradient():
    x = make_inputs(9)
    model = torch_model(x)
    walks = np.zeros((2, L + 1), np.int32)       # only row 0 is touched
    neg = np.zeros(S, np.int32)
    model.walk_train_step(walks, neg, 5, 4)
    before = model.in_emb.detach().clone()
    model.walk_train_step(walks, neg, 5, 4)
    assert model.count == 2
    # row 5 never had a gradient: its moments are zero and so is its step
    assert torch.equal(before[5], model.in_emb.detach()[5])
    assert float(model.mu["in_emb"][0].abs().sum()) > 0


# --- conversion -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skipgram_numpy_round_trip_is_exact(dtype):
    x = make_inputs(10)
    tables = {k: np.asarray(jnp.asarray(x[k]).astype(jnp.dtype(dtype))
                            .astype(jnp.float32))
              for k in ("in_emb", "out_emb")}
    model = convert.skipgram_from_numpy(tables["in_emb"], tables["out_emb"],
                                        dtype, device="cpu")
    assert model.in_emb.dtype == getattr(torch, dtype)
    back = convert.skipgram_to_numpy(model)
    for k in tables:
        np.testing.assert_array_equal(back[k], tables[k])
    convert.adam_state_from_numpy(model, tables, tables, 4)
    mu, nu, count = convert.adam_state_to_numpy(model)
    assert count == 4
    for k in tables:
        np.testing.assert_array_equal(mu[k], tables[k])
        np.testing.assert_array_equal(nu[k], tables[k])


def test_skipgram_from_numpy_rejects_mismatched_tables():
    with pytest.raises(ValueError, match="expected shape"):
        convert.skipgram_from_numpy(np.zeros((4, 2)), np.zeros((4, 3)),
                                    device="cpu")


# --- construction -----------------------------------------------------------------

def test_model_rejects_an_unknown_dtype_and_needs_a_card_by_default():
    with pytest.raises(ValueError, match="dtype"):
        tsg.SkipGramModel(4, 2, dtype="float16", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsg.SkipGramModel(4, 2)


# --- the rounding of the bfloat16 tensor-core K6, on the CPU -----------------------

def bf16_values(a):
    """float32 copies of the bfloat16 rounding of ``a``."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def tensor_core_grads(x, window, num_neg):
    """K6's gradients formed as its bfloat16 tensor-core build rounds them:
    the table values enter exactly (they are bfloat16), the logits are
    float32 sums of exact products, and dloss/dlogit of the negatives is
    split into a bfloat16 high part and the bfloat16 rounding of the rest
    before the two products with the rows (du = g Vn, dVn = g^T U), which sum
    in float32.  The positive pairs run in float32, as on the CUDA cores."""
    tables = {k: torch.tensor(x[k]) for k in ("in_emb", "out_emb")}
    n = x["in_emb"].shape[0]
    walks = torch.tensor(x["walks"]).long()
    walks = torch.where(walks < 0, walks + n, walks)
    neg = torch.tensor(x["neg_ids"]).long()
    neg = torch.where(neg < 0, neg + n, neg)
    b, length1 = walks.shape
    hw = window // 2
    c = length1 - 2 * hw
    scale = 1.0 / (b * c)
    neg_scale = scale * num_neg / neg.shape[0]
    centers = walks[:, hw: length1 - hw].reshape(-1)
    u = tables["in_emb"][centers]                              # (B*C, D)
    vn = tables["out_emb"][neg]                                # (S, D)
    g = neg_scale * torch.sigmoid(u @ vn.T)
    hi = g.to(torch.bfloat16).float()
    lo = (g - hi).to(torch.bfloat16).float()
    du = hi @ vn + lo @ vn
    dvn = hi.T @ u + lo.T @ u
    grad_in = torch.zeros_like(tables["in_emb"])
    grad_out = torch.zeros_like(tables["out_emb"])
    u3 = u.view(b, c, -1)
    du3 = du.view(b, c, -1)
    for off in [o for o in range(-hw, hw + 1) if o != 0]:
        ctx = walks[:, hw + off: length1 - hw + off]            # (B, C)
        o = tables["out_emb"][ctx]
        gp = -scale * torch.sigmoid(-(u3 * o).sum(-1, keepdim=True))
        du3 += gp * o
        grad_out.index_add_(0, ctx.reshape(-1), (gp * u3).reshape(b * c, -1))
    grad_in.index_add_(0, centers, du)
    grad_out.index_add_(0, neg, dvn)
    return {"in_emb": grad_in.numpy(), "out_emb": grad_out.numpy()}


@pytest.mark.parametrize("window,length,s,d", [
    (5, 16, 256, 32), (3, 2, 37, 8), (5, 40, 16, 130)],
    ids=["W5-S256", "one-center-S37", "D130"])
def test_tensor_core_rounding_of_the_gradients_holds_the_kernel_limit(
        window, length, s, d):
    """The split of dloss/dlogit into two bfloat16 parts keeps K6 within the
    limit its kernel is held to: every entry within 1e-4 of its table's
    largest entry of JAX's value_and_grad on the same bfloat16 values."""
    x = make_inputs(12, n=64, d=d, b=24, length=length, s=s)
    x["walks"][::5, -1] = -1
    x["neg_ids"][0] = -1
    x = dict(x, in_emb=bf16_values(x["in_emb"]),
             out_emb=bf16_values(x["out_emb"]))
    _, want = jax_loss_and_grads(x, window, window - 1)
    got = tensor_core_grads(x, window, window - 1)
    for name in ("in_emb", "out_emb"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[name]).max())


# --- the kernels, on the card -------------------------------------------------------

# (d, window, length, walks, negatives, nodes): the shapes the tiles of the
# bfloat16 build meet at their edges.
KERNEL_CASES = {
    "small": (8, 5, 8, 32, 8, 64),
    "one-center": (16, 3, 2, 32, 8, 64),          # C = 1
    "D130": (130, 5, 10, 32, 8, 64),              # rows of 260 bytes
    "odd-D": (7, 5, 10, 32, 8, 64),               # rows of 14 bytes
    "ragged-tiles": (128, 5, 16, 100, 256, 500),  # 12 tiles of 9 walks, last 1
    "walk-longer-than-a-tile": (32, 5, 200, 4, 24, 300),
    "S37": (24, 5, 12, 40, 37, 200),              # S not a multiple of 16
    "S300": (64, 5, 12, 40, 300, 400),            # two chunks in K6
    "hub": (128, 5, 16, 64, 40, 50),              # every walk on one row
    "one-stage": (256, 201, 202, 4, 8, 64),       # two stages do not fit
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_loss_kernels_match_the_plain_version(dtype, case):
    need_cuda()
    d, window, length, b, s, n = KERNEL_CASES[case]
    x = make_inputs(11, n=n, d=d, b=b, length=length, s=s)
    x["walks"][::5, -1] = -1
    x["neg_ids"][::7] = -1
    if case == "hub":
        x["walks"][:, ::2] = 3
        x["neg_ids"][::2] = 3
    model = convert.skipgram_from_numpy(x["in_emb"], x["out_emb"], dtype)
    if case == "one-stage":
        if dtype == "float32":  # one walk's rows exceed K6's shared memory
            with pytest.raises(ValueError, match="do not fit the loss kernel"):
                model.walk_loss_and_grads(x["walks"], x["neg_ids"], window,
                                          window - 1)
            return
        plan = bindings.walk_sgns_plan(model.in_emb, torch.tensor(
            x["walks"], device="cuda"), torch.tensor(x["neg_ids"]), window)
        assert plan["fwd"]["stages"] == plan["bwd_rows"]["stages"] == 1
    # The plain version on float32 copies of the tables' values (its autograd
    # would sum a bfloat16 table's gradient in bfloat16): both sides multiply
    # the same numbers in float32.
    plain = convert.skipgram_from_numpy(
        *convert.skipgram_to_numpy(model).values(), "float32", device="cpu")
    loss = model.walk_loss(x["walks"], x["neg_ids"], window, window - 1)
    want = plain.walk_loss(x["walks"], x["neg_ids"], window, window - 1)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    loss.backward()
    want.backward()
    direct_loss, direct = model.walk_loss_and_grads(x["walks"], x["neg_ids"],
                                                    window, window - 1)
    assert float(direct_loss) == float(loss)
    # through autograd the gradient is rounded once to the tables' type
    rounding = 0 if dtype == "float32" else 2.0 ** -8
    for name, param in model.named_parameters():
        ref = dict(plain.named_parameters())[name].grad.numpy()
        atol = 1e-4 * np.abs(ref).max()
        np.testing.assert_allclose(direct[name].cpu().numpy(), ref, rtol=1e-4,
                                   atol=atol)
        np.testing.assert_allclose(param.grad.float().cpu().numpy(), ref,
                                   rtol=1e-4 + rounding, atol=atol)
