"""Node2Vec's window, touched-rows and degree^0.75 modes, the CBOW trainer
and a custom optimizer of the port against the JAX package, from identical
tables injected on both sides (the JAX trainers initialise with jax.random).
The CPU tests run the plain PyTorch versions; the kernels K16 and K17 (the
per-window loss and its gradient) and K18 (one-pass Adam, dense and rows
entries) are held against those plain versions on the card (tests marked
``cuda``, which skip here, and chip_smoke.py).

Tolerances, as in test_torch_skipgram.py: ids, windows, negatives, alias
tables and draws, the dedup and the scatter exactly; float32 tables differ
from JAX only in the order of float32 sums (loss rtol 1e-5, gradients rtol
1e-4 atol 1e-6, three chained steps rtol 1e-4 on parameters and moments,
whole epoch steps of Node2Vec rtol 1e-4 on the loss as in
test_torch_node2vec_model.py); bfloat16 tables: the loss rtol 1e-4, and
gradients, and parameters and moments after three steps, within 4 bfloat16
ulps of their scale (atol 4 * 2^-8 * max|x|; 8 for the touched-rows step's
float32 second moments, squares of bfloat16 gradients), the losses of later
steps rtol 1e-3, and Adam's parameters with the allowance that
``close_after_adam`` states for gradients that nearly cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.models import CBOWModel as JCBOW
from torch_random_walk_tpu.models import Node2Vec as JNode2Vec
from torch_random_walk_tpu.models import Node2VecConfig as JConfig
from torch_random_walk_tpu.models.skipgram import SkipGramModel as JModel
from torch_random_walk_tpu.models.skipgram import (
    scatter_rows as j_scatter_rows,
)
from torch_random_walk_tpu.models.skipgram import (
    sorted_unique_with_locations as j_sorted_unique,
)
from torch_random_walk_tpu.ops import fatwalk
from torch_random_walk_tpu.ops.fatwalk import FatMeta
from torch_random_walk_tpu.ops.node2vec import (
    node2vec_walk_csr,
    node2vec_walk_csr_mixture,
)
from torch_random_walk_tpu.ops.uniform import uniform_walk_csr
from torch_random_walk_tpu.ops.windows import to_windows as j_to_windows
from torch_random_walk_tpu.utils import alias as jalias
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.models import skipgram as tsg
from torch_random_walk_tpu_torch.utils import alias
from torch_port_util import eq, need_cuda, power_law_edges

N, D, B, L, S = 48, 8, 16, 8, 6
LR = 5e-2
BF16_ULP = 2.0 ** -8


def tables(seed, n=N, d=D):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32))


def jparams(t, dtype=jnp.float32):
    return {"in_emb": jnp.asarray(t[0]).astype(dtype),
            "out_emb": jnp.asarray(t[1]).astype(dtype)}


def f32(tree) -> dict:
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in tree.items()}


def close(got, want, dtype, ulps=4):
    """float32: rtol 1e-4 (atol 1e-7); bfloat16: ``ulps`` ulps of the
    scale."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=ulps * BF16_ULP * float(np.abs(want).max()))


def close_after_adam(got, want, dtype, steps):
    """Parameters after ``steps`` Adam steps from the same state: as
    ``close``, except that on bfloat16 tables at most 2 % of the elements
    may differ by more, up to 2 * lr a step.  Adam moves an element by about
    lr whatever the size of its gradient (m/sqrt(v) is +-1 at the first
    step), so where a bfloat16 gradient sum nearly cancels (its exact value
    below the rounding of its terms: one element here has -1.8e-6 exact,
    -7.6e-6 in JAX's bfloat16 sum and 0 in the port's) the element moves by
    lr in one implementation and not in the other, or by +lr and -lr."""
    if dtype == "float32":
        close(got, want, dtype)
        return
    diff = np.abs(got - want)
    off = diff > 4 * BF16_ULP * float(np.abs(want).max())
    assert int(off.sum()) <= off.size // 50, (int(off.sum()), diff)
    assert float(diff.max()) <= 2 * LR * steps, float(diff.max())


_J_MODELS = {}


def jax_model(dtype="float32"):
    """One JAX Adam model a table type for the whole file, so that each of
    its jitted steps compiles once."""
    if dtype not in _J_MODELS:
        _J_MODELS[dtype] = JModel(N, D, optimizer=optax.adam(LR),
                                  dtype=jnp.dtype(dtype), learning_rate=LR)
    return _J_MODELS[dtype]


def windows(seed, n=N, b=B, c=4, minus_one=True):
    """Random (targets, pos, neg) windows; -1 in some targets and
    positives, as windows of walks marked -1 hold it."""
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, n, b).astype(np.int32)
    pos = rng.integers(0, n, (b, c)).astype(np.int32)
    neg = rng.integers(0, n, (b, c)).astype(np.int32)
    if minus_one:
        tgt[::5] = -1
        pos[::3, -1] = -1
    return tgt, pos, neg


# --- the dedup and the row scatter ----------------------------------------------

_j_sorted_unique = jax.jit(j_sorted_unique, static_argnums=1)


@pytest.mark.parametrize("case", ["dups", "minus-one", "one-value", "single",
                                  "no-dups"])
def test_sorted_unique_with_locations_equals_jax(case):
    rng = np.random.default_rng(len(case))
    x = {"dups": rng.integers(0, 20, 64),
         "minus-one": np.concatenate([rng.integers(-1, 20, 50), [-1, 19]]),
         "one-value": np.full(17, 5),
         "single": np.array([3]),
         "no-dups": rng.permutation(40)}[case].astype(np.int32)
    uids, loc = tsg.sorted_unique_with_locations(torch.tensor(x), 40)
    want_uids, want_loc = _j_sorted_unique(jnp.asarray(x), 40)
    assert uids.dtype == torch.int32 and loc.dtype == torch.int32
    eq(uids, want_uids)
    eq(loc, want_loc)
    assert torch.equal(uids[loc.long()], torch.tensor(x))


_j_scatter = jax.jit(j_scatter_rows, static_argnums=3)


def scatter_case(kind, n, d, seed):
    """Sorted-unique ids padded with n, as the touched-rows step makes
    them: no -1, -1 at the head without n - 1, and -1 with n - 1."""
    rng = np.random.default_rng(seed)
    real = np.sort(rng.choice(n - 1, size=n // 3, replace=False))
    if kind == "minus-one-and-last":
        real = np.append(real[:-1], n - 1)
    ids = np.concatenate([[-1] if kind != "pads" else [], real,
                          [n] * 5]).astype(np.int32)
    table = rng.normal(size=(n, d)).astype(np.float32)
    rows = rng.normal(size=(ids.shape[0], d)).astype(np.float32)
    return table, ids, rows


@pytest.mark.parametrize("group", [True, False], ids=["group", "plain"])
@pytest.mark.parametrize("d", [8, 16, 64, 128])
@pytest.mark.parametrize("kind", ["pads", "minus-one", "minus-one-and-last"])
def test_scatter_rows_equals_jax(kind, d, group):
    """Against JAX's plain scatter (``group=False``), also for ``group=True``:
    the port's scatter is one form.  JAX's grouped form equals its plain
    form for every case here but one kind: a -1 slot (row N - 1) is lost
    there when another row of the last group is written and N - 1 is not
    (the merged group row of that later slot carries N - 1's old values),
    so the grouped reference is compared only where it equals the plain
    one."""
    n = 64
    table, ids, rows = scatter_case(kind, n, d, seed=d)
    g = 128 // d
    lost_minus_one = kind == "minus-one" and bool(
        ((ids >= n - g) & (ids < n - 1)).any())
    got = tsg.scatter_rows(torch.tensor(table), torch.tensor(ids),
                           torch.tensor(rows), group=group)
    plain = _j_scatter(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows),
                       False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(plain))
    grouped = np.asarray(_j_scatter(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(rows), True))
    assert np.array_equal(grouped, np.asarray(plain)) != lost_minus_one
    if not lost_minus_one:
        np.testing.assert_array_equal(got.numpy(), grouped)


def test_scatter_rows_later_slot_wins_as_jax():
    got = tsg.scatter_rows(torch.zeros(4), torch.tensor([-1, 3]),
                           torch.tensor([5.0, 6.0]))
    assert got.tolist() == [0, 0, 0, 6]
    got = tsg.scatter_rows(torch.zeros(4), torch.tensor([-5, 2, -4, 4]),
                           torch.tensor([5.0, 6.0, 7.0, 8.0]))
    want = jnp.zeros(4).at[jnp.array([-5, 2, -4, 4])].set(
        jnp.array([5.0, 6.0, 7.0, 8.0]), mode="drop", unique_indices=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the alias tables -------------------------------------------------------------

def test_alias_tables_and_draws_equal_jax():
    src, dst = power_law_edges(200, 4, seed=5)
    jg = trw.CSRGraph.from_edges(src, dst, num_nodes=200)
    row_ptr = np.asarray(jg.row_ptr)
    w75 = alias.degree75_weights(torch.tensor(row_ptr))
    np.testing.assert_array_equal(w75, jalias.degree75_weights(row_ptr))
    assert (w75 == 0).any()  # dead ends: never drawn
    rng = np.random.default_rng(6)
    for w in (w75, rng.random(333), np.r_[np.zeros(5), 1.0, 3.0],
              np.ones(7)):
        prob, tab = alias.build_alias(w, device="cpu")
        jprob, jtab = jalias.build_alias(w)
        assert prob.dtype == torch.float32 and tab.dtype == torch.int32
        np.testing.assert_array_equal(prob.numpy(), np.asarray(jprob))
        np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
        for seed in (0, 1, 12345, 2**32 - 1):
            got = alias.shared_negative_ids_alias(seed, 256, prob, tab)
            assert got.dtype == torch.int32
            eq(got, jalias.shared_negative_ids_alias(jnp.uint32(seed), 256,
                                                     jprob, jtab))
    with pytest.raises(ValueError, match="nonnegative"):
        alias.build_alias([0.0, 0.0], device="cpu")


# --- the per-window loss ------------------------------------------------------------

_j_window_grad = jax.jit(jax.value_and_grad(JModel.loss_fn))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_loss_and_gradients_match_jax(dtype):
    t = tables(1)
    tgt, pos, neg = windows(2)
    model = convert.skipgram_from_numpy(*t, dtype, device="cpu")
    want_loss, want = _j_window_grad(jparams(t, jnp.dtype(dtype)),
                                     jnp.asarray(tgt), jnp.asarray(pos),
                                     jnp.asarray(neg))
    want = f32(want)
    loss = model.loss_fn(tgt, pos, neg)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5 if dtype == "float32" else 1e-4)
    loss.backward()
    for name, param in model.named_parameters():
        if dtype == "float32":
            np.testing.assert_allclose(param.grad.numpy(), want[name],
                                       rtol=1e-4, atol=1e-6)
        else:
            close(param.grad.float().numpy(), want[name], dtype)


def test_window_loss_minus_one_addresses_the_last_row():
    t = tables(3)
    tgt, pos, neg = windows(4)
    model = convert.skipgram_from_numpy(*t, device="cpu")
    wrap = lambda a: np.where(a < 0, N - 1, a)
    assert float(model.loss_fn(tgt, pos, neg).detach()) == float(
        model.loss_fn(wrap(tgt), wrap(pos), wrap(neg)).detach())


def chained_window_steps(dtype, optimizer=None, steps=3):
    jdtype = jnp.dtype(dtype)
    t = tables(5)
    jmodel = (JModel(N, D, optimizer=optimizer, dtype=jdtype) if optimizer
              else jax_model(dtype))
    params = jparams(t, jdtype)
    opt_state = jmodel.optimizer.init(params)
    factory = None
    if optimizer is not None:
        factory = lambda p: torch.optim.SGD(p, lr=LR)
    model = convert.skipgram_from_numpy(*t, dtype, learning_rate=LR,
                                        optimizer=factory, device="cpu")
    losses = []
    for step in range(steps):
        tgt, pos, neg = windows(10 + step, b=B * 5)
        params, opt_state, jloss = jmodel.train_step(
            params, opt_state, jnp.asarray(tgt), jnp.asarray(pos),
            jnp.asarray(neg))
        losses.append((float(model.train_step(tgt, pos, neg)), float(jloss)))
    return model, params, opt_state, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_chained_window_train_steps_match_jax(dtype):
    model, params, opt_state, losses = chained_window_steps(dtype)
    for i, (got, want) in enumerate(losses):
        np.testing.assert_allclose(
            got, want, rtol=1e-5 if dtype == "float32" or i == 0 else 1e-3)
    adam = opt_state[0]
    assert model.count == int(adam.count) == 3
    got = convert.skipgram_to_numpy(model)
    mu, nu, _ = convert.adam_state_to_numpy(model)
    for name in ("in_emb", "out_emb"):
        close_after_adam(got[name], f32(params)[name], dtype, 3)
        close(mu[name], f32(adam.mu)[name], dtype)
        close(nu[name], f32(adam.nu)[name], dtype)


# --- the touched-rows step ----------------------------------------------------------

def sparse_walks(kind, seed):
    """(B, L+1) walks and S negatives over [0, N - 1) ("none"), with -1 at
    column L of some walks ("minus-one", N - 1 nowhere), and with N - 1 also
    among the centers and the negatives ("minus-one-and-last")."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, N - 1, (B, L + 1)).astype(np.int32)
    neg = rng.integers(0, N - 1, S).astype(np.int32)
    if kind != "none":
        walks[::3, -1] = -1
    if kind == "minus-one-and-last":
        walks[1, 3] = N - 1
        neg[0] = N - 1
    return walks, neg


@pytest.mark.parametrize("kind", ["none", "minus-one", "minus-one-and-last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_chained_sparse_steps_match_jax(dtype, kind):
    """Against JAX's step with its plain scatter (``group_scatter=False``;
    its grouped form loses a -1 slot, see test_scatter_rows_equals_jax).
    float32 tables run the three steps each on its own; bfloat16 ones take
    each step from the state JAX's chain reached (carried across by
    ``convert``), so that an element turned round at one step (see
    ``close_after_adam``) does not spread into the next step's gradients."""
    jmodel = jax_model(dtype)
    t = tables(20)
    params = jparams(t, jnp.dtype(dtype))
    state = jmodel.init_sparse_opt_state(params)
    model = convert.skipgram_from_numpy(*t, dtype, learning_rate=LR,
                                        device="cpu")
    model.init_sparse_opt_state()
    for step in range(3):
        if dtype == "bfloat16" and step:
            model = convert.skipgram_from_numpy(
                *f32(params).values(), dtype, learning_rate=LR, device="cpu")
            convert.sparse_state_from_numpy(
                model, {"mu": f32(state["mu"]), "nu": f32(state["nu"]),
                        "count": int(state["count"])})
        walks, neg = sparse_walks(kind, 30 + step)
        params, state, jloss = jmodel.walk_train_step_sparse(
            params, state, jnp.asarray(walks), jnp.asarray(neg), 5, 4, False)
        loss = model.walk_train_step_sparse(walks, neg, 5, 4)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=1e-5 if dtype == "float32" else 1e-4)
        got = convert.sparse_state_to_numpy(model)
        assert got["count"] == int(state["count"]) == step + 1
        assert all(m.dtype == torch.float32 for m in model.mu.values())
        tabs = convert.skipgram_to_numpy(model)
        for name in ("in_emb", "out_emb"):
            close_after_adam(tabs[name], f32(params)[name], dtype,
                             1 if dtype == "bfloat16" else step + 1)
            close(got["mu"][name], f32(state["mu"])[name], dtype)
            # nu holds squares of bfloat16 gradients: twice their error.
            close(got["nu"][name], f32(state["nu"])[name], dtype, ulps=8)


def test_sparse_step_leaves_untouched_rows_bitwise():
    """JAX's TestSparseAdam.test_untouched_rows_unchanged on the port."""
    t = tables(21, n=32)
    model = convert.skipgram_from_numpy(*t, learning_rate=LR, device="cpu")
    model.init_sparse_opt_state()
    walks = np.full((4, 7), 3, np.int32)
    neg = np.array([5, 6], np.int32)
    before = {k: v.copy() for k, v in convert.skipgram_to_numpy(model).items()}
    model.walk_train_step_sparse(walks, neg, 3, 2)
    after = convert.skipgram_to_numpy(model)
    touched = np.zeros(32, bool)
    touched[[3, 5, 6]] = True
    for name in ("in_emb", "out_emb"):
        np.testing.assert_array_equal(after[name][~touched],
                                      before[name][~touched])
    assert not np.array_equal(after["out_emb"][3], before["out_emb"][3])
    assert model.mu["out_emb"][torch.tensor(~touched)].abs().sum() == 0
    assert model.mu["in_emb"][5].abs().sum() == 0  # a negative, no center


def test_sparse_equals_dense_when_every_row_is_touched():
    """JAX's TestSparseAdam.test_matches_dense_when_all_rows_touched on the
    port: every node among the centers and the walks every step."""
    n = 8
    t = tables(22, n=n)
    dense = convert.skipgram_from_numpy(*t, learning_rate=LR, device="cpu")
    sparse = convert.skipgram_from_numpy(*t, learning_rate=LR, device="cpu")
    sparse.init_sparse_opt_state()
    rng = np.random.default_rng(0)
    for _ in range(5):
        walks = rng.integers(0, n, (16, 7)).astype(np.int32)
        walks[:n, 2] = np.arange(n)
        neg = np.arange(n, dtype=np.int32)
        ld = dense.walk_train_step(walks, neg, 3, 2)
        ls = sparse.walk_train_step_sparse(walks, neg, 3, 2)
        np.testing.assert_allclose(float(ld), float(ls), rtol=1e-6)
    for name in ("in_emb", "out_emb"):
        np.testing.assert_allclose(getattr(dense, name).detach().numpy(),
                                   getattr(sparse, name).detach().numpy(),
                                   rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5, 1000])
def test_bias_correction_equals_jax_float32(count):
    c = jnp.float32(count)
    for b in (0.9, 0.999):
        want = float(jnp.float32(1.0) - jnp.float32(b) ** c)
        assert tsg.sparse_bias_correction(b, count) == want


def test_sparse_step_refuses_as_jax():
    model = tsg.SkipGramModel(8, 4, optimizer=lambda p: torch.optim.SGD(
        p, lr=0.1), device="cpu")
    model.init_sparse_opt_state()
    walks, neg = np.zeros((2, 7), np.int32), np.zeros(2, np.int32)
    jmodel = JModel(8, dim=4, optimizer=optax.adam(5e-2))
    jp = jparams(tables(7, n=8, d=4))
    with pytest.raises(ValueError) as ref:
        jmodel.walk_train_step_sparse(jp, jmodel.init_sparse_opt_state(jp),
                                      jnp.asarray(walks), jnp.asarray(neg),
                                      3, 2)
    with pytest.raises(ValueError) as port:
        model.walk_train_step_sparse(walks, neg, 3, 2)
    assert str(port.value) == str(ref.value)
    dense_state = tsg.SkipGramModel(8, 4, device="cpu")
    with pytest.raises(ValueError, match="init_sparse_opt_state"):
        dense_state.walk_train_step_sparse(walks, neg, 3, 2)
    model = tsg.SkipGramModel(8, 4, learning_rate=0.1, device="cpu")
    model.init_sparse_opt_state()
    with pytest.raises(ValueError, match="touched-rows state"):
        model.walk_train_step(walks, neg, 3, 2)
    with pytest.raises(TypeError, match="factory"):
        tsg.SkipGramModel(8, 4, optimizer=optax.sgd(0.1), device="cpu")


# --- a custom optimizer ---------------------------------------------------------------

def test_custom_sgd_window_steps_match_optax_sgd():
    model, params, _, losses = chained_window_steps(
        "float32", optimizer=optax.sgd(LR))
    assert isinstance(model.optimizer, torch.optim.SGD) and model.mu == {}
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got = convert.skipgram_to_numpy(model)
    for name in ("in_emb", "out_emb"):
        np.testing.assert_allclose(got[name], f32(params)[name], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_custom_sgd_walk_steps_match_optax_sgd(dtype):
    t = tables(23)
    jmodel = JModel(N, D, optimizer=optax.sgd(LR), dtype=jnp.dtype(dtype))
    params = jparams(t, jnp.dtype(dtype))
    opt_state = jmodel.optimizer.init(params)
    seen = []

    def factory(p):
        seen.extend(p)
        return torch.optim.SGD(p, lr=LR)

    model = convert.skipgram_from_numpy(*t, dtype, optimizer=factory,
                                        device="cpu")
    assert seen[0] is model.in_emb and seen[1] is model.out_emb
    rng = np.random.default_rng(24)
    for step in range(3):
        walks = rng.integers(0, N, (B, L + 1)).astype(np.int32)
        neg = rng.integers(0, N, S).astype(np.int32)
        params, opt_state, jloss = jmodel.walk_train_step(
            params, opt_state, jnp.asarray(walks), jnp.asarray(neg), 5, 4)
        loss = model.walk_train_step(walks, neg, 5, 4)
        np.testing.assert_allclose(
            float(loss), float(jloss),
            rtol=1e-5 if dtype == "float32" or step == 0 else 1e-3)
        assert model.in_emb.grad is None
    got = convert.skipgram_to_numpy(model)
    for name in ("in_emb", "out_emb"):
        close(got[name], f32(params)[name], dtype)


# --- CBOW -------------------------------------------------------------------------------

def cbow_windows(seed, n=N):
    walks = np.random.default_rng(seed).integers(0, n, (B, L + 1)).astype(
        np.int32)
    walks[::4, -1] = -1
    return [x.numpy() for x in tt.to_windows_cbow(
        torch.tensor(walks), 5, n, seed, device="cpu")]


def test_cbow_loss_and_gradients_match_jax():
    t = tables(40)
    pos, neg, ctx = cbow_windows(41)
    model = convert.cbow_from_numpy(*t, device="cpu")
    assert model.in_emb.dtype == torch.float32 and model.learning_rate == 1e-3
    want_loss, want = jax.jit(jax.value_and_grad(JCBOW.loss_fn))(
        jparams(t), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(ctx))
    loss = model.loss_fn(pos, neg, ctx)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    loss.backward()
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), f32(want)[name],
                                   rtol=1e-4, atol=1e-6)


def test_three_cbow_train_steps_match_jax():
    t = tables(42)
    jmodel = JCBOW(N, D)
    params = jparams(t)
    opt_state = jmodel.optimizer.init(params)
    model = convert.cbow_from_numpy(*t, device="cpu")
    for step in range(3):
        pos, neg, ctx = cbow_windows(43 + step)
        params, opt_state, jloss = jmodel.train_step(
            params, opt_state, jnp.asarray(pos), jnp.asarray(neg),
            jnp.asarray(ctx))
        np.testing.assert_allclose(float(model.train_step(pos, neg, ctx)),
                                   float(jloss), rtol=1e-5)
    adam = opt_state[0]
    got = convert.cbow_to_numpy(model)
    mu, nu, count = convert.adam_state_to_numpy(model)
    assert count == int(adam.count) == 3
    for name in ("in_emb", "out_emb"):
        close(got[name], f32(params)[name], "float32")
        close(mu[name], f32(adam.mu)[name], "float32")
        close(nu[name], f32(adam.nu)[name], "float32")
    np.testing.assert_array_equal(model.embeddings().numpy(), got["in_emb"])


# --- Node2Vec in each mode ------------------------------------------------------------

# The shapes of the file's other steps (B walks of L + 1, S negatives, dim
# D, B * 5 windows), so that the shared JAX model's steps compile once.
CONFIG = dict(dim=D, walk_length=L, window_size=5, learning_rate=LR, seed=11,
              shared_negatives=S)
MODES = {
    "windows": dict(train_mode="windows"),
    "sparse": dict(update_mode="sparse"),
    "degree75": dict(negative_distribution="degree75"),
    "degree75-sparse": dict(negative_distribution="degree75",
                            update_mode="sparse"),
}


@pytest.fixture(scope="module")
def world():
    """The JAX graph with and without fat tables, one JAX trainer a mode
    (for its degree^0.75 tables and shared negatives) and jitted JAX walk
    oracles."""
    src, dst = power_law_edges(N, 5, seed=31)
    jg = trw.CSRGraph.from_edges(src, dst, num_nodes=N)
    row_ptr, col_idx = np.asarray(jg.row_ptr), np.asarray(jg.col_idx)
    thin = trw.CSRGraph.from_arrays(row_ptr, col_idx, build_fat=False)
    return {"jg": jg, "thin": thin,
            "trainers": {m: JNode2Vec(jg, JConfig(**CONFIG, **kw))
                         for m, kw in MODES.items()},
            "uniform_fat": jax.jit(fatwalk.uniform_walk_fat,
                                   static_argnums=(3, 4)),
            "biased_fat": jax.jit(node2vec_walk_csr_mixture,
                                  static_argnums=(3, 4, 5, 7),
                                  static_argnames=("search_iters",)),
            "uniform_thin": jax.jit(uniform_walk_csr, static_argnums=(3,)),
            "biased_thin": jax.jit(node2vec_walk_csr,
                                   static_argnums=(3, 4, 5),
                                   static_argnames=("search_iters",))}


def jax_train(jn2v, params, opt_state, walks, seed):
    """The train half of the JAX ``epoch_step`` (``Node2Vec._train``) on the
    file's shared JAX model (``jax_model``: the same configuration, each step
    compiled once): windows and ``train_step``, or the shared negatives and
    the dense or touched-rows step (its plain scatter, which equals the
    grouped one on walks without -1)."""
    cfg, model = jn2v.config, jax_model()
    if cfg.train_mode != "block":
        tgt, pos, neg = j_to_windows(walks, cfg.window_size, N, seed)
        return model.train_step(params, opt_state, tgt, pos, neg)
    neg_ids = jn2v._shared_negatives(seed, jn2v._neg_tabs)
    if cfg.update_mode == "sparse":
        return model.walk_train_step_sparse(params, opt_state, walks, neg_ids,
                                            cfg.window_size,
                                            cfg.window_size - 1, False)
    return model.walk_train_step(params, opt_state, walks, neg_ids,
                                 cfg.window_size, cfg.window_size - 1)


def jax_walks(world, fat, targets, p, q, seed):
    """The walks of the JAX ``epoch_step`` for the uint32 step seed: the fat
    engine (biased: its mixture oracle, as test_torch_node2vec_model.py
    takes it), or ``_jnp_step``'s ``uniform_walk_csr`` and
    ``node2vec_walk_csr`` on a graph without fat tables."""
    targets, seed, length = jnp.asarray(targets), jnp.uint32(seed), CONFIG[
        "walk_length"]
    g = world["jg"] if fat else world["thin"]
    if fat and p == q == 1.0:
        return world["uniform_fat"](g.edge_tab, g.node_tab, targets,
                                    FatMeta.of(g), length, seed)
    if fat:
        return world["biased_fat"](g.row_ptr, g.col_idx, targets, p, q,
                                   length, seed, g.layout.deg_bits,
                                   search_iters=g.search_iters)
    if p == q == 1.0:
        return world["uniform_thin"](g.row_ptr, g.col_idx, targets, length,
                                     seed)
    return world["biased_thin"](g.row_ptr, g.col_idx, targets, p, q, length,
                                seed, search_iters=g.search_iters)


@pytest.mark.parametrize("fat", [True, False], ids=["fat", "thin"])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0)],
                         ids=["uniform", "p0.5-q2"])
@pytest.mark.parametrize("mode", list(MODES))
def test_three_epoch_steps_match_jax_in_each_mode(world, mode, p, q, fat):
    jn2v = world["trainers"][mode]
    jg = world["jg"] if fat else world["thin"]
    t = tables(61)
    params = jparams(t)
    opt_state = (jax_model().init_sparse_opt_state(params)
                 if "sparse" in mode else jax_model().optimizer.init(params))
    tg = convert.csr_from_numpy(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                                build_fat=fat, device="cpu")
    tn2v = tt.Node2Vec(tg, tt.Node2VecConfig(p=p, q=q, **CONFIG, **MODES[mode]),
                       device="cpu")
    tn2v.model = convert.skipgram_from_numpy(*t, learning_rate=LR,
                                             device="cpu")
    if "sparse" in mode:
        tn2v.model.init_sparse_opt_state()
    if "degree75" in mode:
        for got, want in zip(tn2v.neg_tabs, jn2v._neg_tabs):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    targets = np.random.default_rng(32).integers(0, N, B).astype(np.int32)
    for epoch in range(3):
        seed = tn2v.step_seed(epoch)
        walks = tn2v.walks(targets, epoch)
        eq(walks, jax_walks(world, fat, targets, p, q, seed))
        jwalks = jnp.asarray(walks.numpy())
        if mode == "windows":
            for got, want in zip(tn2v.windows(walks, epoch),
                                 j_to_windows(jwalks, 5, N, jnp.uint32(seed))):
                eq(got, want)
        else:
            eq(tn2v.negatives(epoch),
               jn2v._shared_negatives(jnp.uint32(seed), jn2v._neg_tabs))
        params, opt_state, jloss = jax_train(jn2v, params, opt_state, jwalks,
                                             jnp.uint32(seed))
        tloss = tn2v.epoch_step(targets, epoch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    got = convert.skipgram_to_numpy(tn2v.model)
    for name in ("in_emb", "out_emb"):
        np.testing.assert_allclose(got[name], np.asarray(params[name]),
                                   rtol=1e-3, atol=1e-5)


def test_node2vec_modes_learn_the_barbell_from_their_own_init():
    import networkx as nx
    csr = nx.to_scipy_sparse_array(nx.barbell_graph(5, 0), format="csr")
    graph = tt.CSRGraph.from_arrays(csr.indptr, csr.indices, device="cpu")
    for kw in MODES.values():
        cfg = tt.Node2VecConfig(dim=8, walk_length=8, window_size=3,
                                learning_rate=5e-2, seed=1, **kw)
        model, losses = tt.Node2Vec(graph, cfg, device="cpu").train(25)
        assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.9
        if "sparse" in kw.get("update_mode", ""):
            assert model.mu["in_emb"].dtype == torch.float32


# --- state carried across ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_state_numpy_round_trip_is_exact(dtype):
    t = tables(50)
    model = convert.skipgram_from_numpy(*t, dtype, device="cpu")
    model.init_sparse_opt_state()
    state = {"mu": {"in_emb": t[0], "out_emb": t[1]},
             "nu": {"in_emb": t[1] ** 2, "out_emb": t[0] ** 2}, "count": 7}
    convert.sparse_state_from_numpy(model, state)
    assert model.mu["in_emb"].dtype == torch.float32 and model.sparse_state
    back = convert.sparse_state_to_numpy(model)
    assert back["count"] == 7
    for key in ("mu", "nu"):
        for name in ("in_emb", "out_emb"):
            np.testing.assert_array_equal(back[key][name], state[key][name])
    with pytest.raises(ValueError, match="expected shape"):
        convert.sparse_state_from_numpy(
            model, dict(state, mu={"in_emb": t[0][:3], "out_emb": t[1]}))


def test_cbow_numpy_round_trip_is_exact():
    t = tables(51)
    model = convert.cbow_from_numpy(*t, device="cpu")
    back = convert.cbow_to_numpy(model)
    np.testing.assert_array_equal(back["in_emb"], t[0])
    np.testing.assert_array_equal(back["out_emb"], t[1])


def test_exports():
    from torch_random_walk_tpu_torch import models, ops
    from torch_random_walk_tpu_torch.ops import edge_list_walk, triples_walk
    assert tt.CBOWModel is models.CBOWModel
    assert ops.uniform_walk_edge_list is edge_list_walk.uniform_walk_edge_list
    assert ops.biased_walk_edge_list is edge_list_walk.biased_walk_edge_list
    assert ops.uniform_walk_triples is triples_walk.uniform_walk_triples
    import torch_random_walk_tpu.ops as jops
    missing = [n for n in jops.__all__ if not hasattr(ops, n)]
    assert not missing, missing


# --- the kernels, on the card -------------------------------------------------------------

def _card_tables(n, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.empty((n, d), device="cuda").uniform_(
        -0.5, 0.5, generator=gen).to(getattr(torch, dtype)) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("cbow", [False, True], ids=["skip-gram", "cbow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,b,c,hot", [
    (1, 33, 4, False), (7, 100, 4, False), (7, 300, 4, True),
    (128, 1, 4, False), (128, 5000, 4, False), (128, 5000, 4, True),
    (512, 300, 2, False), (512, 300, 2, True), (130, 64, 1, False),
    (130, 700, 1, True)])
def test_window_kernels_match_the_plain_version(d, b, c, hot, dtype, cbow):
    """K16 against the plain loss within 1e-5 and bit for bit when run
    again; K17, and the fused entry ``sgns_windows_loss_and_grads``, within
    K6's limit, 1e-4 of the largest entry of each table (a row's slots are
    summed in the order the scatter's atomics place them); the fused loss
    equal to K16's bit for bit; ids of -1 among every kind of row; with
    ``hot`` one row that every window hits as its first positive (and, CBOW,
    its first context id), more slots than a group of lanes takes, so the
    block-a-row pass sums it."""
    need_cuda()
    n = 300
    in_emb, out_emb = _card_tables(n, d, dtype, seed=d + b)
    gen = torch.Generator(device="cuda").manual_seed(b)
    ids = lambda *shape: torch.randint(-1, n, shape, device="cuda",
                                       generator=gen, dtype=torch.int32)
    in_ids, pos, neg = ((ids(b, c), ids(b, 1), ids(b, 1)) if cbow
                        else (ids(b, 1), ids(b, c), ids(b, c)))
    if hot:
        assert b * (1 if cbow else 2 * c) > bindings.SGNS_WINDOWS_HEAVY_SLOTS
        pos[:, 0] = 5
        if cbow:
            in_ids[:, 0] = 5
    loss = bindings.sgns_windows_loss_fwd(in_emb, out_emb, in_ids, pos, neg,
                                          cbow)
    again = bindings.sgns_windows_loss_fwd(in_emb, out_emb, in_ids, pos, neg,
                                           cbow)
    assert torch.equal(loss, again)
    grads = bindings.sgns_windows_loss_bwd(
        in_emb, out_emb, in_ids, pos, neg,
        torch.full((), 2.0, device="cuda"), cbow)
    fused_loss, *fused = bindings.sgns_windows_loss_and_grads(
        in_emb, out_emb, in_ids, pos, neg, cbow)
    assert torch.equal(fused_loss, loss)
    plain = [t.float().requires_grad_(True) for t in (in_emb, out_emb)]
    want = tsg.windows_loss_plain(*plain, in_ids, pos, neg)
    want_grads = torch.autograd.grad(want, plain)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for scale, got_grads in ((2.0, grads), (1.0, fused)):
        for got, ref in zip(got_grads, want_grads):
            ref = scale * ref.cpu().numpy()
            np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max())


def ulp_diff(got, want, dtype):
    """Per element, how many units in the last place of ``dtype`` apart
    (on the bit patterns in sign-magnitude order, so that -0 is +0)."""
    bits, mag = {torch.float32: (torch.int32, 0x7FFFFFFF),
                 torch.bfloat16: (torch.int16, 0x7FFF)}[dtype]

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mag), i)

    return (ordered(got) - ordered(want)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("numel", [1, 7, 4096 + 5, 300 * 128])
def test_adam_dense_kernel_matches_the_plain_version(dtype, numel):
    need_cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(numel)
    rand = lambda: torch.randn(numel, device="cuda", generator=gen)
    param, mu, nu = rand().to(dt), (0.1 * rand()).to(dt), rand().abs().to(dt)
    grad = rand()
    want = [t.clone() for t in (param, mu, nu)]
    bc1 = float(torch.tensor(1 - 0.9 ** 3).to(dt))
    bc2 = float(torch.tensor(1 - 0.999 ** 3).to(dt))
    tsg.adam_dense_plain(*want, grad.clone(), 1e-2, 0.9, 0.999, 1e-8, bc1, bc2)
    bindings.adam_dense(param, mu, nu, grad, 1e-2, 0.9, 0.999, 1e-8, bc1, bc2)
    for got, ref in zip((param, mu, nu), want):
        assert int(ulp_diff(got, ref, dt).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 7, 128, 512])
@pytest.mark.parametrize("case", ["flagged", "no-flag", "all-pad-tail",
                                  "no-flagged-slot"])
def test_adam_rows_kernel_matches_the_plain_version(dtype, d, case):
    need_cuda()
    dt = getattr(torch, dtype)
    n, m = 500, 64
    gen = torch.Generator(device="cuda").manual_seed(d)
    param = torch.randn((n, d), device="cuda", generator=gen).to(dt)
    mu = 0.1 * torch.randn((n, d), device="cuda", generator=gen)
    nu = torch.rand((n, d), device="cuda", generator=gen)
    grad = torch.randn((m, d), device="cuda", generator=gen)
    ids = torch.sort(torch.randperm(n - 1, device="cuda",
                                    generator=gen)[:m]).values.to(torch.int32)
    ids[0] = -1
    if case == "all-pad-tail":
        ids[m // 2:] = n
    flag = None
    if case in ("flagged", "no-flagged-slot"):
        flag = (torch.arange(m, device="cuda") % 3 != 0).to(torch.uint8)
        if case == "no-flagged-slot":
            flag.zero_()
    want = [t.clone() for t in (param, mu, nu)]
    tsg.adam_rows_plain(*want, grad, ids, flag, 1e-2, 0.9, 0.999, 1e-8,
                        0.271, 0.00299)
    bindings.adam_rows(param, mu, nu, grad, ids, flag, 1e-2, 0.9, 0.999, 1e-8,
                       0.271, 0.00299)
    for got, ref in zip((param, mu, nu), want):
        assert int(ulp_diff(got, ref, got.dtype).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_node2vec_modes_on_the_card_match_the_cpu(mode):
    """Each mode's epoch steps through K16-K18 (and K5/K6) against the same
    steps on the CPU from the same tables: losses rtol 1e-4."""
    need_cuda()
    src, dst = power_law_edges(500, 5, seed=3)
    cfg = tt.Node2VecConfig(p=0.5, q=2.0, **CONFIG, **MODES[mode])
    runs = []
    for dev in ("cpu", "cuda"):
        graph = tt.CSRGraph.from_edges(src, dst, num_nodes=500, device=dev)
        n2v = tt.Node2Vec(graph, cfg, device=dev)
        t = tables(60, n=500)
        n2v.model = convert.skipgram_from_numpy(*t, learning_rate=LR,
                                                device=dev)
        if "sparse" in mode:
            n2v.model.init_sparse_opt_state()
        runs.append([float(n2v.epoch_step(np.arange(200, dtype=np.int32), e))
                     for e in range(3)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-4)
