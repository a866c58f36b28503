"""The port's graph constructors and walks against the JAX package, value for
value (tolerance 0: node ids).  Everything runs on the CPU through the plain
PyTorch versions; the CUDA kernels are held against those same plain
versions on the card (tests marked ``cuda`` below, and chip_smoke.py)."""

import networkx as nx
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.graph.csr import PackedLayout
from torch_random_walk_tpu.graph.csr import _bits_for as j_bits_for
from torch_random_walk_tpu.graph.datasets import synthetic_power_law as j_power_law
from torch_random_walk_tpu.ops import fatwalk as jfatwalk
from torch_random_walk_tpu.ops import node2vec as jn2v
from torch_random_walk_tpu.ops.uniform import uniform_walk_csr as j_uniform
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.graph.csr import fat_tables_fit
from torch_random_walk_tpu_torch.ops import common as tcommon
from torch_random_walk_tpu_torch.ops import node2vec as tn2v
from torch_random_walk_tpu_torch.ops.uniform import uniform_walk_csr as t_uniform
from torch_port_util import eq, need_cuda, power_law_edges

N, B, L = 300, 64, 6


@pytest.fixture(scope="module")
def graphs():
    """One random power-law graph with dead ends, built by both packages
    from the same edges."""
    src, dst = power_law_edges(N, 6, seed=21)
    return (trw.CSRGraph.from_edges(src, dst, num_nodes=N),
            tt.CSRGraph.from_edges(src, dst, num_nodes=N, device="cpu"))


@pytest.fixture(scope="module")
def targets():
    return np.random.default_rng(22).integers(0, N, B).astype(np.int32)


def toy_graphs():
    g = nx.Graph()
    for e in [("A", "B"), ("A", "C"), ("B", "C"), ("B", "D"), ("D", "C"),
              ("E", "A"), ("E", "D")]:
        g.add_edge(*e)
    csr = nx.to_scipy_sparse_array(g, format="csr")
    return tt.CSRGraph.from_arrays(csr.indptr, csr.indices, device="cpu")


# --- graph constructors ---------------------------------------------------------

def test_from_edges_equals_jax_constructor(graphs):
    jg, tg = graphs
    eq(tg.row_ptr, jg.row_ptr)
    eq(tg.col_idx, jg.col_idx)
    assert tg.row_ptr.dtype == tg.col_idx.dtype == torch.int32
    assert (tg.num_nodes, tg.num_edges, tg.max_degree, tg.search_iters) == (
        jg.num_nodes, jg.num_edges, jg.max_degree, jg.search_iters)
    assert tg.deg_bits == jg.layout.deg_bits


def test_from_edges_symmetrize_and_inferred_size():
    src, dst = power_law_edges(50, 3, seed=1, dead_ends=False)
    jg = trw.CSRGraph.from_edges(src, dst, symmetrize=True)
    tg = tt.CSRGraph.from_edges(src, dst, symmetrize=True, device="cpu")
    eq(tg.row_ptr, jg.row_ptr)
    eq(tg.col_idx, jg.col_idx)
    assert tg.num_nodes == jg.num_nodes


def test_from_arrays_sorts_rows_like_jax():
    rng = np.random.default_rng(2)
    deg = rng.integers(0, 6, 40)
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    col = rng.integers(0, 40, row_ptr[-1])
    jg = trw.CSRGraph.from_arrays(row_ptr, col)
    tg = tt.CSRGraph.from_arrays(row_ptr, col, device="cpu")
    eq(tg.col_idx, jg.col_idx)
    eq(tg.row_ptr, jg.row_ptr)
    assert tg.deg_bits == jg.layout.deg_bits


def test_from_edges_rejects_ids_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        tt.CSRGraph.from_edges([0, 5], [1, 2], num_nodes=4, device="cpu")


def test_synthetic_power_law_is_the_same_graph():
    jg = j_power_law(400, 4, seed=3)
    tg = tt.synthetic_power_law(400, 4, seed=3, device="cpu")
    eq(tg.row_ptr, jg.row_ptr)
    eq(tg.col_idx, jg.col_idx)
    assert tg.deg_bits == jg.layout.deg_bits


def test_convert_csr_from_numpy(graphs):
    jg, tg = graphs
    cg = convert.csr_from_numpy(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                                device="cpu")
    eq(cg.row_ptr, jg.row_ptr)
    eq(cg.col_idx, jg.col_idx)
    assert (cg.max_degree, cg.search_iters, cg.deg_bits) == (
        jg.max_degree, jg.search_iters, jg.layout.deg_bits)


def test_mixture_consts_copied_exactly():
    for p, q, bits in [(0.5, 2.0, 5), (4.0, 0.25, 9), (1.0, 3.0, 1),
                       (0.1, 0.1, 20)]:
        assert tn2v.mixture_consts(p, q, bits) == jfatwalk._mixture_consts(
            p, q, bits)


def test_device_none_means_the_card_and_raises_without_one(graphs, targets):
    if torch.cuda.is_available():
        pytest.skip("there is a card: device=None is the normal path")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.walk(graphs[1], target_nodes=targets, walk_length=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.synthetic_power_law(10, 2)


# --- goldens of tests/test_golden.py through the port's walk ---------------

def test_golden_uniform_walk():
    walks = tt.walk(toy_graphs(), target_nodes=np.arange(5), walk_length=6,
                    seed=10, device="cpu")
    assert walks.dtype == torch.int32 and tuple(walks.shape) == (5, 7)
    eq(walks, [[0, 1, 2, 0, 1, 0, 4], [1, 0, 4, 3, 4, 0, 2],
               [2, 0, 1, 0, 2, 1, 0], [3, 1, 2, 3, 1, 0, 2],
               [4, 0, 4, 0, 1, 0, 4]])


def test_golden_node2vec_walk():
    walks = tt.walk(toy_graphs(), target_nodes=np.arange(5), p=0.5, q=2.0,
                    walk_length=6, seed=10, device="cpu")
    eq(walks, [[0, 1, 0, 1, 0, 1, 0], [1, 3, 2, 0, 2, 1, 2],
               [2, 3, 2, 3, 2, 3, 4], [3, 4, 3, 4, 3, 4, 3],
               [4, 0, 4, 3, 4, 3, 2]])


def test_golden_node2vec_walk_raw_arrays():
    g = toy_graphs()
    walks = tt.walk(g.row_ptr, g.col_idx, np.arange(5), p=0.5, q=2.0,
                    walk_length=6, seed=10, device="cpu")
    eq(walks, [[0, 1, 0, 1, 0, 2, 1], [1, 3, 2, 3, 1, 2, 1],
               [2, 3, 1, 3, 1, 3, 1], [3, 4, 3, 4, 0, 4, 0],
               [4, 0, 1, 0, 2, 0, 2]])


# --- walks on the random graph ----------------------------------------------

def test_uniform_walk_equals_jax_entry(graphs, targets):
    jg, tg = graphs
    want = trw.walk(jg, target_nodes=jnp.asarray(targets), walk_length=L,
                    seed=5)
    eq(tt.walk(tg, target_nodes=targets, walk_length=L, seed=5, device="cpu"),
       want)
    eq(tt.walk(tg.row_ptr, tg.col_idx, targets, walk_length=L, seed=5,
               device="cpu"), want)


def test_uniform_walker_offset_chunks_equal_one_launch(graphs, targets):
    jg, tg = graphs
    want = j_uniform(jg.row_ptr, jg.col_idx, jnp.asarray(targets), L, 5,
                     walker_offset=7)
    eq(t_uniform(tg.row_ptr, tg.col_idx, targets, L, 5, walker_offset=7,
                 device="cpu"), want)
    half = B // 2
    parts = [t_uniform(tg.row_ptr, tg.col_idx, targets[lo:lo + half], L, 5,
                       walker_offset=7 + lo, device="cpu")
             for lo in (0, half)]
    eq(torch.cat(parts), want)


@pytest.mark.parametrize("mixture", [False, True],
                         ids=["rejection", "mixture"])
def test_node2vec_walker_offset_chunks_equal_one_call(graphs, targets,
                                                      mixture):
    """A walker's draws are keyed by (walker id, step, round) alone, which
    lets the kernel run each walker at its own pace: chunks of the batch
    with their walker offsets give the walks of one call, and each chunk
    equals the JAX function on the same chunk."""
    jg, tg = graphs
    if mixture:
        def jax_walk(t, offset):
            return jn2v.node2vec_walk_csr_mixture(
                jg.row_ptr, jg.col_idx, jnp.asarray(t), 0.5, 2.0, L, 11,
                jg.layout.deg_bits, walker_offset=offset,
                search_iters=jg.search_iters)

        def torch_walk(t, offset):
            return tn2v.node2vec_walk_csr_mixture(
                tg.row_ptr, tg.col_idx, t, 0.5, 2.0, L, 11, tg.deg_bits,
                walker_offset=offset, search_iters=tg.search_iters,
                device="cpu")
    else:
        def jax_walk(t, offset):
            return jn2v.node2vec_walk_csr(jg.row_ptr, jg.col_idx,
                                          jnp.asarray(t), 0.5, 2.0, L, 11,
                                          walker_offset=offset)

        def torch_walk(t, offset):
            return tn2v.node2vec_walk_csr(tg.row_ptr, tg.col_idx, t, 0.5, 2.0,
                                          L, 11, walker_offset=offset,
                                          device="cpu")
    whole = torch_walk(targets, 7)
    half = B // 2
    for lo in (0, half):
        part = torch_walk(targets[lo:lo + half], 7 + lo)
        eq(part, whole[lo:lo + half].numpy())
        eq(part, jax_walk(targets[lo:lo + half], 7 + lo))


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (4.0, 0.25)])
def test_rejection_walk_equals_jax(graphs, targets, p, q):
    jg, tg = graphs
    want = jn2v.node2vec_walk_csr(jg.row_ptr, jg.col_idx, jnp.asarray(targets),
                                  p, q, L, 11, walker_offset=3)
    eq(tn2v.node2vec_walk_csr(tg.row_ptr, tg.col_idx, targets, p, q, L, 11,
                              walker_offset=3, device="cpu"), want)


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (4.0, 0.25)])
def test_mixture_walk_equals_jax(graphs, targets, p, q):
    jg, tg = graphs
    want = jn2v.node2vec_walk_csr_mixture(
        jg.row_ptr, jg.col_idx, jnp.asarray(targets), p, q, L, 11,
        jg.layout.deg_bits, walker_offset=3, search_iters=jg.search_iters)
    eq(tn2v.node2vec_walk_csr_mixture(
        tg.row_ptr, tg.col_idx, targets, p, q, L, 11, tg.deg_bits,
        walker_offset=3, search_iters=tg.search_iters, device="cpu"), want)


def test_biased_entry_points_pick_the_jax_bitstreams(graphs, targets):
    """walk(graph) is the mixture bitstream scaled by graph.deg_bits,
    walk(row_ptr, col_idx) the rejection bitstream, as in the JAX package
    (whose own graph entry is compared in test_torch_windows.py)."""
    jg, tg = graphs
    jt = jnp.asarray(targets)
    eq(tt.walk(tg, target_nodes=targets, p=0.5, q=2.0, walk_length=L, seed=4,
               device="cpu"),
       jn2v.node2vec_walk_csr_mixture(
           jg.row_ptr, jg.col_idx, jt, 0.5, 2.0, L, 4, jg.layout.deg_bits,
           search_iters=jg.search_iters))
    eq(tt.walk(tg.row_ptr, tg.col_idx, targets, p=0.5, q=2.0, walk_length=L,
               seed=4, device="cpu"),
       trw.walk(jg.row_ptr, jg.col_idx, jt, p=0.5, q=2.0, walk_length=L,
                seed=4))


def test_early_exit_search_equals_fixed_trip_count(graphs, targets):
    """A search depth far beyond need changes nothing: the fixed-trip-count
    search is idle once it has converged, which is what lets the CUDA kernel
    leave its loop early."""
    _, tg = graphs
    a = tn2v.node2vec_walk_csr(tg.row_ptr, tg.col_idx, targets, 0.5, 2.0, L,
                               11, search_iters=tg.search_iters, device="cpu")
    b = tn2v.node2vec_walk_csr(tg.row_ptr, tg.col_idx, targets, 0.5, 2.0, L,
                               11, search_iters=32, device="cpu")
    eq(a, b.numpy())


@pytest.mark.parametrize("mixture", [False, True],
                         ids=["rejection", "mixture"])
def test_plain_node2vec_counts_rounds_and_searches(graphs, targets, mixture):
    """The plain version's per-step counts, which size K2's bound: every
    step draws at least one round, a search only in a round it draws, and
    none where the two thresholds are equal (p = q = 1 accepts every
    candidate at round 0)."""
    _, tg = graphs

    def counts(p, q):
        if mixture:
            args = (tn2v.NO_PROBS, tn2v.mixture_consts(p, q, tg.deg_bits))
        else:
            args = (tcommon.node2vec_accept_probs(p, q), tn2v.NO_CONSTS)
        return tn2v.biased_walk(tg.row_ptr, tg.col_idx, targets, L, 11, 0,
                                mixture, *args, tg.search_iters,
                                tcommon.DEFAULT_MAX_ROUNDS, device="cpu")

    biased = counts(0.5, 2.0)
    assert tuple(biased.rounds.shape) == tuple(biased.searches.shape) == (
        len(targets), L - 1)
    assert bool((biased.rounds >= 1).all())
    assert bool((biased.searches <= biased.rounds).all())
    assert 0 < int(biased.searches.sum()) < int(biased.rounds.sum())
    flat = counts(1.0, 1.0)
    assert bool((flat.rounds == 1).all()) and not bool(flat.searches.any())


def test_walk_length_one(graphs, targets):
    jg, tg = graphs
    jt = jnp.asarray(targets)
    eq(tt.walk(tg, target_nodes=targets, walk_length=1, seed=2, device="cpu"),
       j_uniform(jg.row_ptr, jg.col_idx, jt, 1, 2))
    eq(tt.walk(tg.row_ptr, tg.col_idx, targets, p=0.5, q=2.0, walk_length=1,
               seed=2, device="cpu"),
       jn2v.node2vec_walk_csr(jg.row_ptr, jg.col_idx, jt, 0.5, 2.0, 1, 2))
    eq(tt.walk(tg, target_nodes=targets, p=0.5, q=2.0, walk_length=1, seed=2,
               device="cpu"),
       jn2v.node2vec_walk_csr_mixture(jg.row_ptr, jg.col_idx, jt, 0.5, 2.0, 1,
                                      2, jg.layout.deg_bits))


def test_zero_edge_graph_everyone_stays():
    jg = trw.CSRGraph.from_arrays(np.zeros(9, np.int64), np.zeros(0, np.int64))
    tg = tt.CSRGraph.from_arrays(np.zeros(9, np.int64), np.zeros(0, np.int64),
                                 device="cpu")
    t = np.arange(8, dtype=np.int32)
    stay = np.repeat(t[:, None], 4, axis=1)
    eq(tt.walk(tg, target_nodes=t, walk_length=3, device="cpu"),
       trw.walk(jg, target_nodes=jnp.asarray(t), walk_length=3))
    for got in (tt.walk(tg, target_nodes=t, walk_length=3, device="cpu"),
                tt.walk(tg, target_nodes=t, p=0.5, q=2.0, walk_length=3,
                        device="cpu"),
                tt.walk(tg.row_ptr, tg.col_idx, t, p=0.5, q=2.0,
                        walk_length=3, device="cpu")):
        eq(got, stay)


@pytest.fixture(scope="module")
def ring_graphs():
    """No dead ends and no self-loops, so a walker stays in place only when
    its round budget ran out."""
    src, dst = power_law_edges(120, 4, seed=31, dead_ends=False)
    ring = np.arange(120)
    keep = src != dst
    src = np.concatenate([src[keep], ring])
    dst = np.concatenate([dst[keep], (ring + 1) % 120])
    return (trw.CSRGraph.from_edges(src, dst, num_nodes=120),
            tt.CSRGraph.from_edges(src, dst, num_nodes=120, device="cpu"))


def test_small_round_budget_raw_arrays_keep_v_like_the_oracle(ring_graphs):
    jg, tg = ring_graphs
    t = np.arange(B, dtype=np.int32)
    want = np.asarray(jn2v.node2vec_walk_csr(
        jg.row_ptr, jg.col_idx, jnp.asarray(t), 4.0, 0.25, L, 8, max_rounds=1))
    got = tt.walk(tg.row_ptr, tg.col_idx, t, p=4.0, q=0.25, walk_length=L,
                  seed=8, max_rounds=1, device="cpu")
    eq(got, want)
    assert (want[:, 2:] == want[:, 1:-1]).any()  # budgets did run out


def test_small_round_budget_graph_entry_marks_last_column(ring_graphs):
    """The oracle keeps v where the budget ran out; the graph entry point
    also writes -1 into the last column of such a walk, the JAX graph
    engine's mark of an incomplete walk."""
    jg, tg = ring_graphs
    t = np.arange(B, dtype=np.int32)
    oracle = np.asarray(jn2v.node2vec_walk_csr_mixture(
        jg.row_ptr, jg.col_idx, jnp.asarray(t), 4.0, 0.25, L, 8,
        jg.layout.deg_bits, search_iters=jg.search_iters, max_rounds=1))
    ran_out = (oracle[:, 2:] == oracle[:, 1:-1]).any(axis=1)
    assert ran_out.any() and not ran_out.all()
    want = oracle.copy()
    want[ran_out, -1] = -1
    eq(tt.walk(tg, target_nodes=t, p=4.0, q=0.25, walk_length=L, seed=8,
               max_rounds=1, device="cpu"), want)
    eq(tn2v.node2vec_walk_csr_mixture(
        tg.row_ptr, tg.col_idx, t, 4.0, 0.25, L, 8, tg.deg_bits,
        search_iters=tg.search_iters, max_rounds=1, device="cpu"), oracle)


# --- graphs without the JAX package's fat tables -----------------------------

# (num_nodes, num_edges, max_degree): node, start and degree fields of the
# packed row on both sides of 64 bits, a 32-bit field, no nodes, no edges.
FAT_SHAPES = {
    "64_bits": (2 ** 26, 1_200_000_000, 127),        # 26 + 31 + 7
    "65_bits": (2 ** 26, 1_200_000_000, 128),        # 26 + 31 + 8
    "start_31_bits": (1000, 2 ** 31 - 1, 10),
    "start_32_bits": (1000, 2 ** 31, 10),
    "node_32_bits": (2 ** 31 + 1, 2 ** 20, 4),
    "small": (300, 1800, 40),
    "no_edges": (8, 0, 0),
    "no_nodes": (0, 0, 0),
}


@pytest.mark.parametrize("shape", list(FAT_SHAPES))
def test_fat_predicate_equals_jax_packed_layout(shape):
    """The port decides from (N, E, max_degree) alone what the JAX
    ``from_arrays`` decides by building a ``PackedLayout``."""
    n, e, d = FAT_SHAPES[shape]
    want = bool(n and e and PackedLayout(j_bits_for(n), j_bits_for(e + 1),
                                         j_bits_for(d + 1)).fits)
    assert fat_tables_fit(n, e, d) == want
    assert want == (shape in ("64_bits", "start_31_bits", "small"))


@pytest.fixture(scope="module")
def thin_graphs(ring_graphs):
    """The ring graph built with ``build_fat=False`` by both packages."""
    jg, _ = ring_graphs
    row_ptr, col_idx = np.asarray(jg.row_ptr), np.asarray(jg.col_idx)
    return (trw.CSRGraph.from_arrays(row_ptr, col_idx, build_fat=False),
            tt.CSRGraph.from_arrays(row_ptr, col_idx, build_fat=False,
                                    device="cpu"))


def test_build_fat_flag_and_graph_size_decide_fat(graphs, thin_graphs):
    jg, tg = graphs
    assert tg.fat and jg.edge_tab is not None
    jthin, tthin = thin_graphs
    assert not tthin.fat and jthin.edge_tab is None
    cg = convert.csr_from_numpy(np.asarray(jthin.row_ptr),
                                np.asarray(jthin.col_idx), build_fat=False,
                                device="cpu")
    assert not cg.fat
    empty = tt.CSRGraph.from_edges([], [], num_nodes=4, device="cpu")
    assert not empty.fat
    assert tt.CSRGraph(tg.row_ptr, tg.col_idx, N, tg.num_edges,
                       tg.max_degree, fat=True).fat
    assert not tt.CSRGraph(tg.row_ptr, tg.col_idx, N, tg.num_edges,
                           tg.max_degree).fat


# 5 nodes, 12 edges: the JAX graph built from its fields holds no fat tables,
# so its graph entry differs from from_arrays' at p=0.5 q=2, L=12, seed 3.
DIRECT_ROW_PTR = np.array([0, 3, 5, 8, 10, 12])
DIRECT_COL_IDX = np.array([1, 2, 4, 0, 3, 0, 1, 4, 2, 4, 0, 3])


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (1.0, 1.0)],
                         ids=["p0.5-q2", "uniform"])
def test_directly_built_graph_walks_like_the_directly_built_jax_graph(p, q):
    """A graph built from its fields walks as the JAX graph built from the
    same fields, which holds no fat tables: the rejection sampler (or the
    uniform walk), not the mixture of a from_arrays graph."""
    jg = trw.CSRGraph(row_ptr=jnp.asarray(DIRECT_ROW_PTR, jnp.int32),
                      col_idx=jnp.asarray(DIRECT_COL_IDX, jnp.int32),
                      num_nodes=5, num_edges=12, max_degree=3)
    tg = tt.CSRGraph(torch.tensor(DIRECT_ROW_PTR, dtype=torch.int32),
                     torch.tensor(DIRECT_COL_IDX, dtype=torch.int32), 5, 12, 3)
    assert jg.edge_tab is None and not tg.fat
    t = np.arange(40, dtype=np.int32) % 5
    kw = dict(p=p, q=q, walk_length=12, seed=3)
    got = tt.walk(tg, target_nodes=t, device="cpu", **kw)
    eq(got, trw.walk(jg, target_nodes=jnp.asarray(t), **kw))
    if p != q:  # the from_arrays graph takes the other bitstream
        fat = trw.CSRGraph.from_arrays(DIRECT_ROW_PTR, DIRECT_COL_IDX)
        assert not np.array_equal(
            got.numpy(), np.asarray(trw.walk(fat, target_nodes=jnp.asarray(t),
                                             **kw)))


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (1.0, 1.0)],
                         ids=["p0.5-q2", "uniform"])
def test_graph_without_fat_tables_walks_like_jax(thin_graphs, p, q):
    """Without fat tables the JAX graph entry runs the rejection sampler
    with ``graph.search_iters`` (or the uniform walk); so does the port's."""
    jg, tg = thin_graphs
    t = np.arange(B, dtype=np.int32) % tg.num_nodes
    eq(tt.walk(tg, target_nodes=t, p=p, q=q, walk_length=L, seed=9,
               device="cpu"),
       trw.walk(jg, target_nodes=jnp.asarray(t), p=p, q=q, walk_length=L,
                seed=9))


def test_graph_without_fat_tables_marks_no_walk(thin_graphs):
    """With a round budget of 1 the rejection walks keep v where it ran out
    and write no -1: the oracle with the same budget and search depth."""
    jg, tg = thin_graphs
    t = np.arange(B, dtype=np.int32)
    want = np.asarray(jn2v.node2vec_walk_csr(
        jg.row_ptr, jg.col_idx, jnp.asarray(t), 4.0, 0.25, L, 8,
        search_iters=jg.search_iters, max_rounds=1))
    assert (want[:, 2:] == want[:, 1:-1]).any()  # budgets did run out
    assert (want >= 0).all()
    eq(tt.walk(tg, target_nodes=t, p=4.0, q=0.25, walk_length=L, seed=8,
               max_rounds=1, device="cpu"), want)


# --- the kernels against their plain versions (on the card only) -----------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "rejection", "mixture"])
def test_walk_kernels_equal_plain_versions(case):
    need_cuda()
    g = tt.synthetic_power_law(5000, 8, seed=1)
    cpu = tt.CSRGraph(g.row_ptr.cpu(), g.col_idx.cpu(), g.num_nodes,
                      g.num_edges, g.max_degree, fat=g.fat)
    t = np.random.default_rng(3).integers(0, g.num_nodes, 4096)
    for graph_arg, dev in ((g, None), (cpu, "cpu")):
        if case == "uniform":
            out = tt.walk(graph_arg, target_nodes=t, walk_length=20, seed=6,
                          device=dev)
        elif case == "mixture":
            out = tt.walk(graph_arg, target_nodes=t, p=0.5, q=2.0,
                          walk_length=20, seed=6, device=dev)
        else:
            out = tt.walk(graph_arg.row_ptr, graph_arg.col_idx, t, p=0.5,
                          q=2.0, walk_length=20, seed=6, device=dev)
        if dev is None:
            on_card = out
    assert on_card.is_cuda
    eq(on_card, out.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("graph_kind", ["dead_ends", "zero_edges"])
@pytest.mark.parametrize("walkers", [1, 33, 4097])
@pytest.mark.parametrize("length", [1, 7, 8, 9, 16, 80])
def test_uniform_kernel_edges_equal_plain_version(length, walkers, graph_kind):
    """K1 against its plain version, tolerance 0, where its row writer has
    its edges: it stores each walk a 32-byte sector at a time from
    registers, and rows of L+1 words start at every word of a sector (L+1
    not a multiple of 8, L = 1, the train step's L = 16), with one, a
    ragged warp and many walkers; with and without a walker offset, on a
    graph with dead ends and on one without edges, from targets outside
    [0, N) (clamped as the JAX gathers clamp them)."""
    need_cuda()
    if graph_kind == "zero_edges":
        g = tt.CSRGraph.from_arrays(np.zeros(9, np.int64),
                                    np.zeros(0, np.int64), device="cpu")
    else:
        src, dst = power_law_edges(3000, 6, seed=5)  # last quarter: dead ends
        g = tt.CSRGraph.from_edges(src, dst, num_nodes=3000, device="cpu")
    t = np.random.default_rng(length * walkers).integers(
        -3, g.num_nodes + 3, walkers).astype(np.int32)
    for offset in (0, 100_003):
        got, want = (t_uniform(g.row_ptr, g.col_idx, t, length, 6,
                               walker_offset=offset, device=dev)
                     for dev in (None, "cpu"))
        assert got.is_cuda
        eq(got, want.numpy())


def _multigraph_hub():
    """A ring of 50 nodes both ways, with node 0's edge to 1 repeated 70 000
    times and node 1's edge to 0 six times: a walk 0 -> 1 -> ? sees t = 0
    seven times in v's row (past the kernel's forward scan), and 1 -> 0 -> ?
    sees t = 1 70 001 times (past the mixture's 16-bit clamp)."""
    ring = np.arange(50)
    src = np.concatenate([ring, (ring + 1) % 50, np.zeros(70_000, np.int64),
                          np.ones(6, np.int64)])
    dst = np.concatenate([(ring + 1) % 50, ring, np.ones(70_000, np.int64),
                          np.zeros(6, np.int64)])
    return tt.CSRGraph.from_edges(src, dst, num_nodes=50, device="cpu")


# case: (graph, walk_length, max_rounds, walker_offset, search_iters; None
# is the sampler's own)
K2_EDGE_CASES = {
    "budget_1": ("power_law", 20, 1, 0, None),
    "budget_2": ("power_law", 20, 2, 0, None),
    "length_1": ("power_law", 1, tcommon.DEFAULT_MAX_ROUNDS, 0, None),
    "length_2": ("power_law", 2, tcommon.DEFAULT_MAX_ROUNDS, 0, None),
    "zero_edges": ("zero_edges", 5, tcommon.DEFAULT_MAX_ROUNDS, 0, None),
    "multigraph_hub": ("multigraph_hub", 20, tcommon.DEFAULT_MAX_ROUNDS, 0,
                       None),
    "walker_offset": ("power_law", 20, tcommon.DEFAULT_MAX_ROUNDS, 100_003,
                      None),
    "search_cut_short": ("multigraph_hub", 20, tcommon.DEFAULT_MAX_ROUNDS, 0,
                         2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mixture", [False, True],
                         ids=["rejection", "mixture"])
@pytest.mark.parametrize("case", list(K2_EDGE_CASES))
def test_node2vec_kernel_edges_equal_plain_version(case, mixture):
    """K2 against its plain version, walks and exhausted flags, tolerance 0,
    where the free-running loop has its edges: the round budget spent at a
    step (the step-boundary branch keeps v), walks of 1 and 2 steps, no edges
    at all, a multiplicity beyond the forward scan and the 16-bit clamp, a
    walker offset, and searches cut short by a small ``search_iters``."""
    need_cuda()
    kind, walk_length, max_rounds, offset, iters = K2_EDGE_CASES[case]
    if kind == "power_law":
        g = tt.synthetic_power_law(3000, 8, seed=2, device="cpu")
    elif kind == "zero_edges":
        g = tt.CSRGraph.from_arrays(np.zeros(9, np.int64),
                                    np.zeros(0, np.int64), device="cpu")
    else:
        g = _multigraph_hub()
    t = np.random.default_rng(4).integers(0, g.num_nodes, 2048)
    t[:512] = np.arange(512) % 2  # walks from the hub's ends
    if mixture:
        sampler = (tn2v.NO_PROBS, tn2v.mixture_consts(0.5, 2.0, g.deg_bits),
                   iters or g.search_iters)
    else:
        sampler = (tcommon.node2vec_accept_probs(0.5, 2.0), tn2v.NO_CONSTS,
                   iters or tcommon.DEFAULT_SEARCH_ITERS)
    got, want = (tn2v.biased_walk(g.row_ptr, g.col_idx, t, walk_length, 6,
                                  offset, mixture, *sampler, max_rounds,
                                  device=dev) for dev in (None, "cpu"))
    assert got.walks.is_cuda
    eq(got.walks, want.walks.numpy())
    eq(got.exhausted, want.exhausted.numpy())
    if max_rounds <= 2:
        assert bool(want.exhausted.any())  # the budget did run out
