"""The KG-embedding trainer of the port (``models/kge.py``) against the JAX
package's, on the grid-world KG, from identical tables injected on both
sides (the JAX model initialises with jax.random, the port with
torch.Generator).  The CPU tests run the plain PyTorch versions; the kernels
K19 (the pair loss) and K20 (the triple window losses), both entries, are
held against those plain versions on the card (tests marked ``cuda``, which
skip here, and chip_smoke.py).

Tolerances, as in test_torch_trainer_modes.py: negatives, walks, positives
and windows exactly; float32 tables differ from JAX only in the order of
float32 sums (loss rtol 1e-5, gradients 1e-4 of the largest entry, atol
1e-6; three chained steps: losses rtol 1e-4, tables and moments rtol 1e-4
through ``close_after_adam``); bfloat16 tables: the losses are held against
JAX's loss functions compiled without XLA's excess precision, so that each
bfloat16 operation rounds as it does op by op (by default XLA's CPU compiler
keeps float32 precision between the bfloat16 operations of a jitted
function: 1.3e-4 relative on one loss here), loss rtol 1e-5 and
gradients within 4 bfloat16 ulps of their scale (JAX rounds each product of
the backward pass to bfloat16 and sums the rows' gradients in bfloat16, the
plain version sums them in bfloat16 in another order).  At ||d|| = 0 the
TransE gradient is NaN in both, at the same entries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.graph.datasets import synthetic_grid_kg as j_grid_kg
from torch_random_walk_tpu.models.kge import KGEmbedding as JKGE
from torch_random_walk_tpu.models.kge import KGEmbeddingConfig as JConfig
from torch_random_walk_tpu.models.kge import KGEModel as JModel
from torch_random_walk_tpu.models.kge import corrupt_triples as j_corrupt
from torch_random_walk_tpu.ops.windows import (
    _triples_targets_and_windows as j_targets_and_windows,
)
from torch_random_walk_tpu.ops.windows import (
    to_windows_triples as j_windows_sg,
)
from torch_random_walk_tpu.ops.windows import (
    to_windows_triples_cbow as j_windows_cbow,
)
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.models import kge as tkge
from torch_port_util import eq, need_cuda

SIDE, NE, NR = 6, 36, 4
PAD = NE  # max(num_entities, num_relations), the trainer's default
LR = 5e-2
BF16_ULP = 2.0 ** -8


def close(got, want, dtype, rel=1e-4, ulps=4):
    """float32: rtol ``rel`` and atol 1e-6 of the largest entry; bfloat16:
    ``ulps`` ulps of the scale."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rel,
                                   atol=1e-6 * scale + 1e-9)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ulps * BF16_ULP * scale + 1e-9)


def close_after_adam(got, want, dtype, steps):
    """As in test_torch_trainer_modes.py: float32 rtol 1e-4; bfloat16
    within 4 ulps of the scale except at most 2 % of the elements, by at
    most 2 lr a step (Adam turns a nearly cancelling gradient into a full
    step in one implementation and not the other)."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        return
    diff = np.abs(got - want)
    off = diff > 4 * BF16_ULP * float(np.abs(want).max())
    assert int(off.sum()) <= off.size // 50, (int(off.sum()), diff)
    assert float(diff.max()) <= 2 * LR * steps, float(diff.max())


def f32(tree) -> dict:
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def graphs():
    """The grid KG built by both packages, with its fat table (and the
    oracle's graphs: the same triples without it)."""
    jg, j_all, _ = j_grid_kg(SIDE, seed=3)
    tg, t_all, _ = tt.synthetic_grid_kg(SIDE, seed=3, device="cpu")
    np.testing.assert_array_equal(t_all, j_all)
    assert tg.fat and jg.triple_tab is not None
    return {True: (jg, tg),
            False: (dataclasses.replace(jg, triple_tab=None, node_meta=None),
                    dataclasses.replace(tg, fat=False))}


def tables(objective, dim, seed, scale=0.5):
    """Random float32 tables of an objective, keyed as the JAX params."""
    rng = np.random.default_rng(seed)
    if objective in tkge.PAIR_OBJECTIVES:
        rel_dim = dim // 2 if objective == "rotate" else dim
        hi = np.pi if objective == "rotate" else scale
        return {"ent": rng.uniform(-scale, scale,
                                   (NE, dim)).astype(np.float32),
                "rel": rng.uniform(-hi, hi, (NR, rel_dim)).astype(np.float32)}
    return {name: rng.uniform(-scale, scale, (NR if "rel" in name else NE,
                                              dim)).astype(np.float32)
            for name in tkge.WINDOW_TABLES}


def jparams(t, dtype):
    return {k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in t.items()}


# --- negatives ---------------------------------------------------------------

_j_corrupt = jax.jit(j_corrupt, static_argnums=(1, 2))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 32 - 1],
                         ids=["0", "7", "2^31+5", "2^32-1"])
def test_corrupt_triples_equals_jax(seed):
    """Bit for bit, at step seeds past 2^31 (the trainer passes JAX a uint32
    seed, the port a Python int in [0, 2^32)) and at several epochs, with an
    odd number of negatives a positive."""
    num_neg = 5
    rng = np.random.default_rng(num_neg)
    pos = np.stack([rng.integers(0, NE, 40), rng.integers(0, NR, 40),
                    rng.integers(0, NE, 40)], 1).astype(np.int32)
    for epoch in (0, 1, 2 ** 31 + 3):
        want = _j_corrupt(jnp.asarray(pos), NE, num_neg, jnp.uint32(seed),
                          jnp.uint32(epoch))
        got = tt.corrupt_triples(torch.tensor(pos), NE, num_neg, seed, epoch)
        assert got.dtype == torch.int32 and got.shape == (40, num_neg, 3)
        eq(got, want)


# --- the losses and their gradients ------------------------------------------

def pair_batch(seed, b=24, k=3):
    """Positives (some of padding relation, some components out of range,
    as clipping meets them) and negatives."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.integers(0, NE, b), rng.integers(0, NR, b),
                    rng.integers(0, NE, b)], 1).astype(np.int32)
    pos[::5, 1] = PAD
    pos[1, 0], pos[2, 2] = PAD, -1
    neg = np.stack([rng.integers(0, NE, (b, k)), rng.integers(0, NR, (b, k)),
                    rng.integers(0, NE, (b, k))], 2).astype(np.int32)
    return pos, neg


# XLA's CPU compiles at optimization level 0 (about 0.3 s a function here
# in place of 0.5-1.5 s; the same IEEE operations), and bfloat16 functions
# without XLA's excess precision, so that each bfloat16 operation rounds as
# it does op by op.
_FAST = {"xla_backend_optimization_level": 0}
_EXACT_BF16 = {**_FAST, "xla_allow_excess_precision": False}
_J_COMPILED = {}


def jax_compiled(key, fn, *args, options=_FAST):
    """``fn`` jitted and compiled for ``args`` once for the whole file under
    ``key``."""
    if key not in _J_COMPILED:
        _J_COMPILED[key] = jax.jit(fn).lower(*args).compile(options)
    return _J_COMPILED[key]


def jax_value_and_grad(objective, fn_name, args, dim=2, dtype="float32"):
    """JAX's value and gradient of a loss function on ``args`` (params, ids,
    padding_idx), compiled once a case (a model a dim for RotatE, whose
    score reads its dim)."""
    m = JModel(NE, NR, dim=dim, objective=objective, margin=2.0)
    *arrays, pad = args
    key = (objective, fn_name, dim, dtype, pad,
           str(jax.tree.map(lambda a: a.shape, arrays)))
    fn = jax_compiled(
        key, lambda *a: jax.value_and_grad(getattr(m, fn_name))(*a, pad),
        *arrays, options=_FAST if dtype == "float32" else _EXACT_BF16)
    return fn(*arrays)


def port_model(objective, dim, dtype, t):
    model = tt.KGEModel(NE, NR, dim=dim, objective=objective, dtype=dtype,
                        device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.tensor(t[name]).to(p.dtype))
    return model


def port_loss_and_grads(model, fn_name, *batch):
    loss = getattr(model, fn_name)(*batch)
    loss.backward()
    grads = {n: p.grad.float().numpy() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


PAIR_DIMS = {"transe": (1, 2, 7, 16), "distmult": (1, 2, 7, 16),
             "rotate": (2, 16)}
PAIR_CASES = [(o, d) for o, dims in PAIR_DIMS.items() for d in dims]
_PAIR_REF = {}


def pair_case(objective, dim):
    """Tables, positives (some masked) and negatives of one case, and the
    same positives with every relation the padding."""
    pos, neg = pair_batch(seed=dim)
    all_pad = pos.copy()
    all_pad[:, 1] = PAD
    return tables(objective, dim, seed=dim), pos, all_pad, neg


def pair_reference(objective, dtype):
    """JAX's value and gradients of ``pair_loss_fn`` for every dim of an
    objective, both batches, from one compiled function (so one compile an
    objective and table type)."""
    if (objective, dtype) not in _PAIR_REF:
        dims = PAIR_DIMS[objective]
        models = [JModel(NE, NR, dim=d, objective=objective, margin=2.0)
                  for d in dims]
        cases = [pair_case(objective, d) for d in dims]
        args = [(jparams(t, dtype), *map(jnp.asarray, (pos, all_pad, neg)))
                for t, pos, all_pad, neg in cases]

        def run(args):  # both batches of a case in one vmapped program
            return [jax.vmap(
                lambda q, m=m, p=p, neg=neg: jax.value_and_grad(
                    m.pair_loss_fn)(p, q, neg, PAD))(jnp.stack([pos, all_pad]))
                for m, (p, pos, all_pad, neg) in zip(models, args)]

        out = jax_compiled(("pair", objective, dtype), run, args,
                           options=_FAST if dtype == "float32"
                           else _EXACT_BF16)(args)
        _PAIR_REF[objective, dtype] = {
            d: [(loss[i], {k: v[i] for k, v in grads.items()})
                for i in range(2)] for d, (loss, grads) in zip(dims, out)}
    return _PAIR_REF[objective, dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("objective,dim", PAIR_CASES,
                         ids=[f"{o}-D{d}" for o, d in PAIR_CASES])
def test_pair_loss_and_grads_equal_jax(objective, dim, dtype):
    """``pair_loss_fn`` and its gradients against JAX's, with masked
    positives and clipped components, and on an all-padding batch."""
    t, pos, all_pad, neg = pair_case(objective, dim)
    for p, (want_loss, want) in zip((pos, all_pad),
                                    pair_reference(objective, dtype)[dim]):
        model = port_model(objective, dim, dtype, t)
        loss, grads = port_loss_and_grads(model, "pair_loss_fn", p, neg, PAD)
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5,
                                   atol=1e-7)
        for name, g in f32(want).items():
            close(grads[name], g, dtype)


def test_transe_gradient_at_zero_distance_is_nan_as_in_jax():
    """e_h + w_r = e_t exactly for one positive: JAX's gradient is NaN on
    that positive's rows (sqrt's derivative at 0 times a zero vector), and
    so is the port's, at the same entries."""
    t = tables("transe", 4, seed=1)
    pos, neg = pair_batch(seed=1)
    h, r, tl = pos[3]
    t["ent"][tl] = t["ent"][h] + t["rel"][r]
    want_loss, want = jax_value_and_grad(
        "transe", "pair_loss_fn",
        (jparams(t, "float32"), jnp.asarray(pos), jnp.asarray(neg), PAD))
    loss, grads = port_loss_and_grads(port_model("transe", 4, "float32", t),
                                      "pair_loss_fn", pos, neg, PAD)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for name, g in f32(want).items():
        assert np.isnan(g).any() or name == "rel"
        np.testing.assert_array_equal(np.isnan(grads[name]), np.isnan(g))
        ok = ~np.isnan(g)
        close(grads[name][ok], g[ok], "float32")


def window_batch(seed, w, cbow, b=20):
    """A triple window batch with padded components (the padding id, ids
    past the tables, -1) and slots of padding relation."""
    rng = np.random.default_rng(seed)

    def trips(*shape):
        x = np.stack([rng.integers(0, NE, shape), rng.integers(0, NR, shape),
                      rng.integers(0, NE, shape)], -1).astype(np.int32)
        pad = rng.random(shape) < 0.25
        x[pad] = PAD
        x[..., 0][rng.random(shape) < 0.1] = -1
        x[..., 2][rng.random(shape) < 0.1] = NE + 3
        return x

    if cbow:
        pos, neg, win = trips(b), trips(b), trips(b, 2 * w)
        pos[0, 1] = PAD
        win[1] = PAD  # a window of padding only
        return pos, neg, win
    tgt, pw, nw = trips(b), trips(b, 2 * w), trips(b, 2 * w)
    tgt[0, 1] = PAD
    nw[2, :, 1] = PAD  # negatives are never masked
    return tgt, pw, nw


WINDOW_SIZES, WINDOW_DIM = (1, 2, 3), 5
_WINDOW_REF = {}


def window_reference(objective, dtype):
    """JAX's value and gradients of a window loss at every W, from one
    compiled function an objective and table type."""
    if (objective, dtype) not in _WINDOW_REF:
        model = JModel(NE, NR, dim=WINDOW_DIM, objective=objective)
        fn = getattr(model, f"{objective}_loss_fn")
        args = [(jparams(tables(objective, WINDOW_DIM, seed=w), dtype),
                 *map(jnp.asarray, window_batch(w, w, objective == "cbow")))
                for w in WINDOW_SIZES]

        def run(args):
            return [jax.value_and_grad(fn)(*a, PAD) for a in args]

        out = jax_compiled(("windows", objective, dtype), run, args,
                           options=_FAST if dtype == "float32"
                           else _EXACT_BF16)(args)
        _WINDOW_REF[objective, dtype] = dict(zip(WINDOW_SIZES, out))
    return _WINDOW_REF[objective, dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", WINDOW_SIZES)
@pytest.mark.parametrize("objective", ["skipgram", "cbow"])
def test_window_loss_and_grads_equal_jax(objective, w, dtype):
    """The skip-gram and CBOW losses over composed triples and their
    gradients against JAX's, with padded components (the padding id, ids
    past the tables, -1), masked slots and a window of padding only."""
    t = tables(objective, WINDOW_DIM, seed=w)
    batch = window_batch(w, w, objective == "cbow")
    want_loss, want = window_reference(objective, dtype)[w]
    loss, grads = port_loss_and_grads(
        port_model(objective, WINDOW_DIM, dtype, t), f"{objective}_loss_fn",
        *batch, PAD)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for name, g in f32(want).items():
        close(grads[name], g, dtype)


# --- the trainer -------------------------------------------------------------

TRAIN_CASES = {
    "transe-dense": dict(objective="transe"),
    "rotate-sparse-bf16": dict(objective="rotate", update_mode="sparse",
                               dtype="bfloat16"),
    "skipgram": dict(objective="skipgram", window_size=2),
    "cbow": dict(objective="cbow", window_size=2),
}
TRAIN_DIM, TRAIN_L, TRAIN_B = 8, 4, 24


def trainers(graphs, fat, case, seed=2 ** 31 + 11):
    """(JAX trainer, port trainer) of one case, seed past 2^31."""
    jg, tg = graphs[fat]
    kw = dict(dim=TRAIN_DIM, walk_length=TRAIN_L, learning_rate=LR,
              num_negatives=3, seed=seed, **TRAIN_CASES[case])
    return (JKGE(jg, JConfig(**kw)),
            tt.KGEmbedding(tg, tt.KGEmbeddingConfig(**kw), device="cpu"))


def jax_batch(jt, fat, targets, epoch):
    """The JAX step's walks and batch, as ``_step_impl`` makes them (the
    walks of every case of one graph are the same function: compiled once
    a graph)."""
    cfg, g = jt.config, jt.graph
    seed = jnp.uint32(cfg.seed) + jnp.uint32(epoch) * jnp.uint32(0x9E3779B1)
    tabs = ((g.triple_tab, g.node_meta) if g.triple_tab is not None
            else (g.triples, g.relation_tail_index))
    args = (jnp.asarray(targets), seed, *tabs)
    walks = jax_compiled(("walks", fat, cfg.walk_length, cfg.seed),
                         jt._walk, *args)(*args)
    pad = jt.padding_idx
    if cfg.objective in tkge.PAIR_OBJECTIVES:
        def make(walks, seed, epoch):
            pos, _ = j_targets_and_windows(walks, 1, pad)
            return pos, j_corrupt(pos, g.num_entities, cfg.num_negatives,
                                  seed, epoch)
    else:
        gen = j_windows_sg if cfg.objective == "skipgram" else j_windows_cbow

        def make(walks, seed, epoch):
            return gen(walks, cfg.window_size, g.num_entities, pad,
                       g.triples, seed)
    args = (walks, seed, jnp.uint32(epoch))
    return walks, jax_compiled(("batch", fat, cfg.objective), make,
                               *args)(*args)


@pytest.mark.parametrize("fat", [True, False], ids=["fat", "oracle"])
@pytest.mark.parametrize("case", ["transe-dense", "skipgram", "cbow"])
def test_epoch_step_walks_and_batches_equal_jax(graphs, fat, case):
    """The walks, positives and negatives (pair) or windows of an epoch step,
    bit for bit, on the fat graph and the oracle's, at epochs 0 and 2."""
    jt, pt = trainers(graphs, fat, case)
    targets = np.arange(-1, TRAIN_B - 1, dtype=np.int32) % NE
    for epoch in (0, 2):
        walks, batch = jax_batch(jt, fat, targets, epoch)
        got_walks = pt.walks(torch.tensor(targets), epoch)
        eq(got_walks, walks)
        got = pt.batch(got_walks, epoch)
        assert len(got) == len(batch)
        for g, w in zip(got, batch):
            eq(g, w)


def jax_init(jt, t):
    params = jparams(t, jt.config.dtype)
    if jt.config.update_mode == "sparse":
        return params, jt.model.init_sparse_opt_state(params)
    return params, jt.model.optimizer.init(params)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_three_epoch_steps_equal_jax(graphs, case):
    """Three chained ``epoch_step``s of each mode from tables carried over
    by ``convert``: losses, tables and optimizer state against JAX's."""
    jt, pt = trainers(graphs, True, case)
    cfg = pt.config
    t = tables(cfg.objective, TRAIN_DIM, seed=len(case))
    params, opt = jax_init(jt, t)
    pt.model = convert.kge_from_numpy(t, cfg.objective, cfg.margin,
                                      cfg.dtype, LR, device="cpu")
    if cfg.update_mode == "sparse":
        pt.model.init_sparse_opt_state()
    targets = np.arange(TRAIN_B, dtype=np.int32) % NE
    g = jt.graph
    for epoch in range(3):
        # JAX's epoch_step, its jitted _step compiled as jax_compiled does
        args = (params, opt, jnp.asarray(targets), jnp.uint32(epoch),
                g.triple_tab, g.node_meta, g.triples)
        params, opt, want = jax_compiled(
            ("step", case), jt._step, *args,
            options=_FAST if cfg.dtype == "float32" else _EXACT_BF16)(*args)
        got = pt.epoch_step(torch.tensor(targets), epoch)
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=1e-5 if epoch == 0 else 1e-4)
    for name, want in f32(params).items():
        close_after_adam(convert.kge_to_numpy(pt.model)[name], want,
                         cfg.dtype, 3)
    if cfg.update_mode == "sparse":
        state = convert.sparse_state_to_numpy(pt.model)
        assert state["count"] == int(opt["count"]) == 3
        moments = (opt["mu"], opt["nu"])
    else:
        mu, nu, count = convert.adam_state_to_numpy(pt.model)
        assert count == int(opt[0].count) == 3
        state, moments = {"mu": mu, "nu": nu}, (opt[0].mu, opt[0].nu)
    for key, want in zip(("mu", "nu"), moments):
        for name, w in f32(want).items():
            if cfg.dtype == "float32":
                np.testing.assert_allclose(state[key][name], w, rtol=1e-4,
                                           atol=1e-7)
            else:
                close(state[key][name], w, cfg.dtype, ulps=8)


def test_train_from_fresh_tables_lowers_the_loss(graphs):
    """``train`` (default batch: every entity) from torch.Generator tables;
    the embeddings are the entity table."""
    _, tg = graphs[True]
    emb = tt.KGEmbedding(tg, tt.KGEmbeddingConfig(dim=16, walk_length=4,
                                                  learning_rate=5e-2),
                         device="cpu")
    model, losses = emb.train(6)
    assert losses.shape == (6,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert emb.embeddings().shape == (NE, 16)
    assert model.relation_embeddings().shape == (NR, 16)


def test_kge_state_converts_both_ways():
    t = tables("rotate", 6, seed=4)
    model = convert.kge_from_numpy(t, "rotate", dtype="bfloat16",
                                   device="cpu")
    assert model.rel.shape == (NR, 3) and model.dtype == torch.bfloat16
    back = convert.kge_to_numpy(model)
    for name in t:
        np.testing.assert_array_equal(
            back[name], np.asarray(jnp.asarray(t[name]).astype(
                jnp.bfloat16).astype(jnp.float32)))
    model.init_sparse_opt_state()
    state = {"mu": {k: v + 1 for k, v in t.items()},
             "nu": {k: v + 2 for k, v in t.items()}, "count": 5}
    convert.sparse_state_from_numpy(model, state)
    again = convert.sparse_state_to_numpy(model)
    assert again["count"] == 5
    for key in ("mu", "nu"):
        for name in t:
            np.testing.assert_array_equal(again[key][name], state[key][name])
    with pytest.raises(ValueError, match="takes the tables"):
        convert.kge_from_numpy(t, "skipgram", device="cpu")


# --- errors ------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(padding_idx=2), "valid relation id"),
    (dict(padding_idx=10), "valid entity id"),
    (dict(update_mode="lazy"), "unknown update_mode"),
    (dict(update_mode="sparse", objective="skipgram"), "requires a pair"),
    (dict(objective="rotate", dim=7), "even dim"),
    (dict(objective="complex"), "unknown objective"),
], ids=["pad-relation", "pad-entity", "update-mode", "sparse-window",
        "rotate-odd", "objective"])
def test_trainer_raises_where_jax_raises(graphs, kw, match):
    jg, tg = graphs[True]
    with pytest.raises(ValueError, match=match):
        JKGE(jg, JConfig(**kw))
    with pytest.raises(ValueError, match=match):
        tt.KGEmbedding(tg, tt.KGEmbeddingConfig(**kw), device="cpu")


class PlainSGD:
    """A custom optimizer as the factory returns one (any object with
    ``step``; torch.optim's first step costs seconds of imports)."""

    def __init__(self, params, lr):
        self.params, self.lr = params, lr

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p.add_(p.grad, alpha=-self.lr)


def test_sparse_step_with_a_custom_optimizer_raises_as_in_jax():
    t = tables("transe", 4, seed=2)
    pos, neg = pair_batch(seed=2)
    jm = JModel(NE, NR, dim=4, optimizer=optax.sgd(0.1))
    params = jparams(t, "float32")
    with pytest.raises(ValueError, match="custom optax optimizer"):
        jm.pair_train_step_sparse(params, jm.init_sparse_opt_state(params),
                                  jnp.asarray(pos), jnp.asarray(neg), PAD)
    model = tt.KGEModel(NE, NR, dim=4, device="cpu",
                        optimizer=lambda p: PlainSGD(p, 0.1))
    model.init_sparse_opt_state()
    with pytest.raises(ValueError, match="custom optimizer"):
        model.pair_train_step_sparse(pos, neg, PAD)
    # the dense step steps the custom optimizer, as optax's in JAX
    before = model.ent.detach().clone()
    model.reset_optimizer()
    model.pair_train_step(pos, neg, PAD)
    assert not torch.equal(model.ent.detach(), before)
    with pytest.raises(ValueError, match="has no window loss"):
        model.skipgram_loss_fn(*window_batch(0, 1, False), PAD)


def test_entry_points_need_a_card_or_the_cpu(graphs):
    _, tg = graphs[True]
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.KGEModel(NE, NR, dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.KGEmbedding(tg, tt.KGEmbeddingConfig(dim=4))


# --- on the card: K19 and K20 against their plain versions -------------------

def _card_tables(objective, n, r, dim, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rel_dim = dim // 2 if objective == "rotate" else dim
    names = (tkge.PAIR_TABLES if objective in tkge.PAIR_OBJECTIVES
             else tkge.WINDOW_TABLES)
    out = []
    for name in names:
        rows = r if name.startswith("rel") else n
        width = rel_dim if name == "rel" else dim
        out.append(torch.empty((rows, width), device="cuda").uniform_(
            -0.5, 0.5, generator=gen).to(dtype))
    return out


def _plain_grads(fn, tables, *args):
    leaves = [t.detach().float().requires_grad_(True) for t in tables]
    loss = fn(leaves, *args)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _rel_err(got, want):
    """Largest difference over the largest entry of ``want``, away from its
    NaN entries (JAX's TransE gradient at ||d|| = 0, met by bfloat16 tables
    at small D), which must be NaN in ``got`` too."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if bool(nan.all()):
        return 0.0
    scale = max(float(want[~nan].abs().max()), 1e-30)
    return float((got - want)[~nan].abs().max()) / scale


def _vocabularies(width, dtype, tables, dim):
    """(relation rows, the relation path K19/K20 takes) to check at ``dim``:
    7 rows; at D = 128 and 130 also the most rows whose sums fit the shared
    budget and one more (that row by global row adds)."""
    out = [(7, "shared")]
    if dim in (128, 130):
        wide = 16 // torch.empty((), dtype=dtype).element_size()
        vec = wide if width % wide == 0 else 1
        edge = bindings.KGE_REL_SHARED_BYTES // (
            bindings.kge_rel_shared_bytes(1, width, vec, tables))
        out += [(edge, "shared"), (edge + 1, "shared and global")]
    return out


def _check_pair_on_the_card(ent, rel, pos, neg, valid, objective, dtype,
                            what):
    want, want_g = _plain_grads(
        lambda tabs, *a: tkge.pair_loss_plain(objective, 2.0, *tabs, *a,
                                              rounding=dtype),
        (ent, rel), pos, neg, valid)
    loss = bindings.kge_pair_loss(ent, rel, pos, neg, valid, objective, 2.0)
    loss2, g_ent, g_rel = bindings.kge_pair_loss_and_grads(
        ent, rel, pos, neg, valid, objective, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2), what
    assert abs(float(loss) - float(want)) <= 1e-5 * max(
        abs(float(want)), 1e-3), (what, float(loss), float(want))
    for g, w in zip((g_ent, g_rel), want_g):
        assert _rel_err(g, w) <= 1e-4, (what, _rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("objective", ["transe", "distmult", "rotate"])
def test_k19_equals_its_plain_version_on_the_card(objective, dtype):
    """Both entries at D = 1 (not RotatE), 7 (not RotatE), 128, 130, 512;
    K = 1 and 33; a hub entity every positive hits; a relation every
    positive has (the hottest row); an all-padding batch; at D = 128 and 130
    the relation vocabularies just under the shared budget and just over it
    (the last, hot row by global row adds); and the touched-rows step's
    sub-tables (a relation table padded to its static size).  The plain
    version reads the tables as float32 (exact for bfloat16) and rounds
    where K19 rounds on bfloat16 tables (``rounding``)."""
    need_cuda()
    n = 500
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def ints(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device="cuda")

    dims = (2, 128, 130, 512) if objective == "rotate" else (1, 7, 128, 130,
                                                             512)
    for dim in dims:
        width = dim // 2 if objective == "rotate" else dim
        for r, path in _vocabularies(width, dtype, 1, dim):
            ent, rel = _card_tables(objective, n, r, dim, dtype, dim + r)
            assert bindings.kge_plan((ent, rel))["relation_path"] == path
            cases = ((1, 1, "one"), (700, 4, "plain"), (300, 33, "wide"),
                     (700, 4, "hub"), (700, 4, "hot_relation"),
                     (200, 4, "all_pad"))
            for b, k, case in cases if r == 7 else (cases[1], cases[4]):
                pos = torch.stack([ints(n, b), ints(r, b), ints(n, b)],
                                  1).int()
                if case == "hub":
                    pos[:, 0] = 5
                if case == "hot_relation":
                    pos[:, 1] = r - 1
                pos = pos.contiguous()
                neg = tt.corrupt_triples(pos, n, k, 9, 1)
                valid = (torch.rand(b, device="cuda", generator=gen)
                         > 0.2).to(torch.uint8)
                if case == "all_pad":
                    valid.zero_()
                _check_pair_on_the_card(ent, rel, pos, neg, valid, objective,
                                        dtype, (dim, r, case))
    model = tt.KGEModel(n, 7, dim=16, objective=objective,
                        dtype=str(dtype).split(".")[1], device="cuda")
    pos = torch.stack([ints(n, 600), ints(7, 600), ints(n, 600)], 1).int()
    neg = tt.corrupt_triples(pos.contiguous(), n, 4, 9, 1)
    _, _, pos_l, neg_l, ent_sub, rel_sub = model.gather_touched_rows(pos, neg)
    assert bindings.kge_plan((ent_sub, rel_sub))["relation_path"] == (
        "shared and global")  # padded to 3 000 rows; the ids address 7
    valid = torch.ones(600, dtype=torch.uint8, device="cuda")
    _check_pair_on_the_card(ent_sub, rel_sub, pos_l.contiguous(),
                            neg_l.contiguous(), valid, objective, dtype,
                            "touched rows")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
def test_k20_equals_its_plain_version_on_the_card(cbow, dtype):
    """Both entries at D = 1, 7, 128, 130, 512 and W = 1, 3 and 11, windows
    with padded components, a window of padding only, a hub entity, and
    batches whose unmasked slots all have one relation (the hottest row);
    at D = 128 and 130 the relation vocabularies just under the shared
    budget and just over it (the last, hot row by global row adds)."""
    need_cuda()
    n = 400
    pad = n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def trips(r, *shape):
        x = torch.stack([torch.randint(-1, n + 2, shape, generator=gen,
                                       device="cuda"),
                         torch.randint(0, r, shape, generator=gen,
                                       device="cuda"),
                         torch.randint(0, n, shape, generator=gen,
                                       device="cuda")], -1).int()
        x[torch.rand(shape, generator=gen, device="cuda") < 0.2] = pad
        return x

    for dim in (1, 7, 128, 130, 512):
        for r, path in _vocabularies(dim, dtype, 2, dim):
            tabs = _card_tables("cbow" if cbow else "skipgram", n, r, dim,
                                dtype, dim + r)
            assert bindings.kge_plan(tabs)["relation_path"] == path
            sizes = ((1, 1), (600, 1), (600, 11), (600, 3))
            for b, w in sizes if r == 7 else sizes[3:]:
                for hot in (False, True):
                    one, many = (trips(r, b), trips(r, b)), trips(r, b, 2 * w)
                    many[0] = pad
                    many[:, 0, 0] = 7  # a hub entity
                    if hot:
                        many[..., 1] = torch.where(many[..., 1] == pad, pad,
                                                   r - 1)
                    batch = ((*one, many) if cbow else
                             (one[0], many, trips(r, b, 2 * w)))
                    batch = [x.contiguous() for x in batch]
                    what = (dim, r, b, w, hot)
                    want, want_g = _plain_grads(
                        lambda t, *a: tkge.windows_loss_plain(
                            t, *a, pad, cbow, rounding=dtype), tabs, *batch)
                    loss = bindings.kge_windows_loss(tabs, *batch, pad, cbow)
                    loss2, grads = bindings.kge_windows_loss_and_grads(
                        tabs, *batch, pad, cbow)
                    torch.cuda.synchronize()
                    assert torch.equal(loss, loss2), what
                    assert abs(float(loss) - float(want)) <= 1e-5 * max(
                        abs(float(want)), 1e-3), (what, float(loss),
                                                  float(want))
                    for g, wg in zip(grads, want_g):
                        assert _rel_err(g, wg) <= 1e-4, (what,
                                                         _rel_err(g, wg))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_kge_modes_on_the_card_match_the_cpu(graphs, case):
    """Three epoch steps on the card (K9, K10, K19 or K20, K18) against the
    same on the CPU (the plain versions), from the same tables."""
    need_cuda()
    _, tg = graphs[True]
    kw = dict(dim=16, walk_length=TRAIN_L, learning_rate=LR, num_negatives=3,
              seed=5, **TRAIN_CASES[case])
    t = tables(kw["objective"], 16, seed=9)
    runs = []
    for dev in ("cpu", "cuda"):
        g = convert.triples_from_numpy(tg.triples.numpy(), NE, NR, device=dev)
        emb = tt.KGEmbedding(g, tt.KGEmbeddingConfig(**kw), device=dev)
        cfg = emb.config
        emb.model = convert.kge_from_numpy(t, cfg.objective, cfg.margin,
                                           cfg.dtype, LR, device=dev)
        if cfg.update_mode == "sparse":
            emb.model.init_sparse_opt_state()
        targets = torch.arange(NE, dtype=torch.int32, device=dev)
        losses = [float(emb.epoch_step(targets, e)) for e in range(3)]
        runs.append((losses, convert.kge_to_numpy(emb.model)))
    (cpu_l, cpu_t), (gpu_l, gpu_t) = runs
    np.testing.assert_allclose(gpu_l, cpu_l, rtol=1e-4)
    for name in cpu_t:
        close_after_adam(gpu_t[name], cpu_t[name], kw.get("dtype", "float32"),
                         3)
