"""The slice as a whole: the port's ``Node2Vec`` (walk -> shared negatives ->
fused SGNS train step) against the JAX package's, on the same graph, with the
tables carried across from the JAX ``Node2Vec.init()``.  Per epoch the walks
and negatives must equal JAX's value for value (tolerance 0); the losses of
three chained ``epoch_step``s agree to rtol 1e-4 (float32 tables: only the
order of float32 sums differs).  Everything runs on the CPU."""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.models import Node2Vec as JNode2Vec
from torch_random_walk_tpu.models import Node2VecConfig as JConfig
from torch_random_walk_tpu.models.skipgram import (
    shared_negative_ids as j_shared_negative_ids,
)
from torch_random_walk_tpu.ops import fatwalk
from torch_random_walk_tpu.ops.fatwalk import FatMeta
from torch_random_walk_tpu.ops.node2vec import (
    node2vec_walk_csr,
    node2vec_walk_csr_mixture,
)
from torch_random_walk_tpu_torch import convert
from torch_port_util import eq, power_law_edges

N, B = 64, 32
CONFIG = dict(dim=8, walk_length=8, window_size=5, learning_rate=5e-2, seed=11,
              shared_negatives=8)


@pytest.fixture(scope="module")
def graphs():
    src, dst = power_law_edges(N, 5, seed=31, dead_ends=False)
    jg = trw.CSRGraph.from_edges(src, dst, num_nodes=N)
    tg = convert.csr_from_numpy(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                                device="cpu")
    return jg, tg


def carried_over(jg, tg, p, q):
    """The two trainers, the port's holding the JAX trainer's initial
    tables."""
    jn2v = JNode2Vec(jg, JConfig(p=p, q=q, **CONFIG))
    params, opt_state = jn2v.init()
    tn2v = tt.Node2Vec(tg, tt.Node2VecConfig(p=p, q=q, **CONFIG), device="cpu")
    tn2v.model = convert.skipgram_from_numpy(
        np.asarray(params["in_emb"]), np.asarray(params["out_emb"]),
        "float32",
        learning_rate=CONFIG["learning_rate"], device="cpu")
    return jn2v, params, opt_state, tn2v


def jax_epoch_walks(jg, targets, p, q, seed):
    """The walks of the JAX ``epoch_step`` for the uint32 step seed.  Uniform:
    the fat-table engine ``_fat_step_impl`` calls.  Biased: the mixture
    oracle, which the JAX package's own tests hold equal to the free-running
    fat engine of ``_fat_step_impl`` (compiling that engine a second time
    outside the fused step would double this file's run time; the fused
    step's loss below still goes through it)."""
    targets, seed = jnp.asarray(targets), jnp.uint32(seed)
    length = CONFIG["walk_length"]
    if p == 1.0 and q == 1.0:
        return fatwalk.uniform_walk_fat(jg.edge_tab, jg.node_tab, targets,
                                        FatMeta.of(jg), length, seed)
    return node2vec_walk_csr_mixture(
        jg.row_ptr, jg.col_idx, targets, p, q, length, seed,
        jg.layout.deg_bits, search_iters=jg.search_iters)


def test_config_has_the_jax_fields_and_defaults():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tt.Node2VecConfig)}
    assert jf == tf


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0)],
                         ids=["uniform", "p0.5-q2"])
def test_three_epoch_steps_match_jax(graphs, p, q):
    jg, tg = graphs
    jn2v, params, opt_state, tn2v = carried_over(jg, tg, p, q)
    targets = np.random.default_rng(32).integers(0, N, B).astype(np.int32)
    # out_emb starts at zero on both sides: step 1 has every logit 0; the
    # later steps run on trained tables.
    for epoch in range(3):
        seed = tn2v.step_seed(epoch)
        assert seed == (CONFIG["seed"] + epoch * 0x9E3779B1) % 2**32
        walks, neg_ids = tn2v.sample(targets, epoch)
        eq(walks, jax_epoch_walks(jg, targets, p, q, seed))
        eq(neg_ids, j_shared_negative_ids(jnp.uint32(seed),
                                          CONFIG["shared_negatives"], N))
        params, opt_state, jloss = jn2v.epoch_step(
            params, opt_state, jnp.asarray(targets), jnp.uint32(epoch))
        tloss = tn2v.epoch_step(targets, epoch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    got = convert.skipgram_to_numpy(tn2v.model)
    for name in ("in_emb", "out_emb"):
        np.testing.assert_allclose(got[name], np.asarray(params[name]),
                                   rtol=1e-3, atol=1e-5)


def test_sample_without_fat_tables_gives_the_jax_step_walks(graphs):
    """On a graph built with ``build_fat=False`` the JAX ``epoch_step`` takes
    its ``_jnp_step``, whose biased walks are ``node2vec_walk_csr`` with
    ``graph.search_iters`` (no mixture, no -1 mark); ``sample`` must give
    those walks."""
    jg, _ = graphs
    row_ptr, col_idx = np.asarray(jg.row_ptr), np.asarray(jg.col_idx)
    thin = trw.CSRGraph.from_arrays(row_ptr, col_idx, build_fat=False)
    assert thin.edge_tab is None
    tn2v = tt.Node2Vec(
        convert.csr_from_numpy(row_ptr, col_idx, build_fat=False,
                               device="cpu"),
        tt.Node2VecConfig(p=0.5, q=2.0, **CONFIG), device="cpu")
    targets = np.random.default_rng(33).integers(0, N, B).astype(np.int32)
    jax_walks = jax.jit(node2vec_walk_csr, static_argnums=(3, 4, 5),
                        static_argnames=("search_iters",))
    for epoch in range(2):
        seed = tn2v.step_seed(epoch)
        walks, _ = tn2v.sample(targets, epoch)
        eq(walks, jax_walks(thin.row_ptr, thin.col_idx, jnp.asarray(targets),
                            0.5, 2.0, CONFIG["walk_length"], jnp.uint32(seed),
                            search_iters=thin.search_iters))


def barbell():
    g = nx.barbell_graph(5, 0)
    csr = nx.to_scipy_sparse_array(g, format="csr")
    return tt.CSRGraph.from_arrays(csr.indptr, csr.indices, device="cpu")


def test_train_learns_the_barbell_communities_from_its_own_init():
    cfg = tt.Node2VecConfig(dim=16, walk_length=10, window_size=5,
                            learning_rate=5e-2, seed=0)
    n2v = tt.Node2Vec(barbell(), cfg, device="cpu")
    model, losses = n2v.train(num_epochs=60)
    assert losses.shape == (60,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    emb = n2v.embeddings().numpy()
    assert emb.shape == (10, 16)
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim = emb @ emb.T
    a, b = list(range(5)), list(range(5, 10))
    intra = ((sim[np.ix_(a, a)].sum() - 5) / 20 / 2
             + (sim[np.ix_(b, b)].sum() - 5) / 20 / 2)
    inter = sim[np.ix_(a, b)].mean()
    assert intra > inter + 0.1, f"communities not separated: {intra} vs {inter}"


def test_init_is_reproducible_and_resets_the_optimizer():
    n2v = tt.Node2Vec(barbell(), tt.Node2VecConfig(dim=4, walk_length=6),
                      device="cpu")
    first = n2v.init().in_emb.detach().clone()
    n2v.epoch_step(np.arange(10, dtype=np.int32), 0)
    assert n2v.model.count == 1
    again = n2v.init()
    assert torch.equal(first, again.in_emb.detach()) and again.count == 0
    assert float(first.abs().max()) <= 0.5 and float(again.out_emb.detach().abs().max()) == 0
    assert all(float(m.abs().max()) == 0 for m in again.mu.values())


def test_walks_per_node_tiles_the_batch():
    cfg = tt.Node2VecConfig(dim=4, walk_length=6, walks_per_node=3)
    n2v = tt.Node2Vec(barbell(), cfg, device="cpu")
    seen = []
    n2v.epoch_step = lambda targets, epoch: seen.append(targets) or torch.zeros(())
    n2v.train(1, batch_nodes=[1, 2])
    assert seen[0].tolist() == [1, 2, 1, 2, 1, 2]


@pytest.mark.parametrize("kwargs,message", [
    (dict(update_mode="lazy"), "unknown update_mode 'lazy'"),
    (dict(update_mode="sparse", train_mode="windows"),
     "update_mode='sparse' requires train_mode='block'"),
    (dict(negative_distribution="zipf"), "unknown negative_distribution 'zipf'"),
    (dict(negative_distribution="degree75", train_mode="windows"),
     "negative_distribution='degree75' requires"),
])
def test_unknown_values_raise_the_jax_value_errors(kwargs, message):
    with pytest.raises(ValueError, match=message) as port:
        tt.Node2Vec(barbell(), tt.Node2VecConfig(**kwargs), device="cpu")
    with pytest.raises(ValueError) as ref:
        JNode2Vec(trw.CSRGraph.from_networkx(nx.barbell_graph(5, 0)),
                  JConfig(**kwargs))
    assert str(port.value) == str(ref.value)


def test_graph_and_trainer_must_share_a_device():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.Node2Vec(barbell())
