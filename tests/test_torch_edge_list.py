"""The port's edge-list graph and walks against the JAX package, value for
value (tolerance 0: node ids).  Everything runs on the CPU through the plain
PyTorch versions; K7 and K8 are held against those same plain versions on
the card (tests marked ``cuda`` below, and chip_smoke.py)."""

import dataclasses

import networkx as nx
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.graph.edge_list import (
    build_node_edge_index as j_build_node_edge_index,
    to_edge_list_indexed as j_to_edge_list_indexed,
)
from torch_random_walk_tpu.ops.edge_list_walk import (
    biased_walk_edge_list as j_biased,
)
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.ops import common as tcommon
from torch_random_walk_tpu_torch.ops import edge_list_walk as tel
from torch_random_walk_tpu_torch.utils import prng
from torch_port_util import eq, need_cuda, power_law_edges

N, B, L = 200, 64, 6


@pytest.fixture(scope="module")
def graphs():
    """One random power-law edge list whose last quarter of nodes has no
    out-edges, built by both packages from the same (unsorted) edges."""
    src, dst = power_law_edges(N, 6, seed=41)
    edges = np.stack([src, dst], axis=1)
    return (trw.EdgeListGraph.from_arrays(edges, num_nodes=N),
            tt.EdgeListGraph.from_arrays(edges, num_nodes=N, device="cpu"))


@pytest.fixture(scope="module")
def targets():
    """Targets in [-3, N + 3): ids outside [0, N), -1 and N among them."""
    t = np.random.default_rng(42).integers(-3, N + 3, B).astype(np.int32)
    t[:4] = [-1, N, N + 2, -3]
    return t


# --- constructors ------------------------------------------------------------

def test_from_arrays_equals_jax(graphs):
    jg, tg = graphs
    eq(tg.edge_list, jg.edge_list)
    eq(tg.node_edge_index, jg.node_edge_index)
    assert tg.edge_list.dtype == tg.node_edge_index.dtype == torch.int32
    assert (tg.num_nodes, tg.num_edges, tg.max_degree, tg.search_iters) == (
        jg.num_nodes, jg.num_edges, jg.max_degree, jg.search_iters)
    assert tg.fat and jg.edge_tab is not None
    assert int((tg.node_edge_index[:, 0] == -1).sum()) > N // 5  # dead ends


def test_from_arrays_infers_size_and_flags_a_graph_without_edges():
    jg = trw.EdgeListGraph.from_arrays(np.array([[3, 1], [0, 7], [3, 0]]))
    tg = tt.EdgeListGraph.from_arrays(np.array([[3, 1], [0, 7], [3, 0]]),
                                      device="cpu")
    eq(tg.edge_list, jg.edge_list)
    eq(tg.node_edge_index, jg.node_edge_index)
    assert tg.num_nodes == jg.num_nodes == 8
    empty = np.zeros((0, 2), np.int64)
    jg = trw.EdgeListGraph.from_arrays(empty, num_nodes=4)
    tg = tt.EdgeListGraph.from_arrays(empty, num_nodes=4, device="cpu")
    eq(tg.node_edge_index, jg.node_edge_index)
    assert tg.fat is False and jg.edge_tab is None


def _constructed(how):
    """An EdgeListGraph built one way, and the (E, 2) edges it must hold."""
    edges = np.array([[2, 1], [0, 3], [2, 0], [0, 1], [4, 4], [2, 1]])
    if how == "from_arrays":
        g = tt.EdgeListGraph.from_arrays(edges, num_nodes=6, device="cpu")
    elif how == "from_arrays_inferred":
        g = tt.EdgeListGraph.from_arrays(edges, device="cpu")
    elif how == "empty":
        g = tt.EdgeListGraph.from_arrays(np.zeros((0, 2), np.int64),
                                         num_nodes=4, device="cpu")
    elif how == "from_networkx":
        g = tt.EdgeListGraph.from_networkx(nx.karate_club_graph(),
                                           device="cpu")
    elif how == "convert":
        g = convert.edge_list_from_numpy(edges[np.lexsort(edges.T[::-1])], 5,
                                         device="cpu")
    elif how == "dataclass":
        base = tt.EdgeListGraph.from_arrays(edges, device="cpu")
        g = tt.EdgeListGraph(base.edge_list, base.node_edge_index,
                             base.num_nodes, base.num_edges, base.max_degree,
                             fat=True)
    else:  # dataclasses.replace builds it again from the new edge list
        base = tt.EdgeListGraph.from_arrays(edges, device="cpu")
        g = dataclasses.replace(base, edge_list=base.edge_list.flip(0))
    return g, g.edge_list


@pytest.mark.parametrize("how", ["from_arrays", "from_arrays_inferred",
                                 "empty", "from_networkx", "convert",
                                 "dataclass", "replace"])
def test_tails_column_equals_the_edge_lists_second_column(how):
    """Every constructor builds ``tails``, K8's (E,) int32 layout of the
    tails, equal to ``edge_list[:, 1]`` and a contiguous tensor of its own;
    it is no field of the constructor, so a replaced edge list rebuilds
    it."""
    g, edges = _constructed(how)
    assert g.tails.dtype == torch.int32 and g.tails.is_contiguous()
    assert tuple(g.tails.shape) == (g.num_edges,) == (edges.shape[0],)
    eq(g.tails, edges[:, 1].numpy())
    if g.num_edges:
        assert g.tails.data_ptr() != g.edge_list.data_ptr()
    assert "tails" not in repr(g)
    assert "tails" not in {f.name for f in dataclasses.fields(g) if f.init}


def _packed_pair(how):
    """(JAX graph, port graph) of the same edges, built one way."""
    if how == "dataclass":  # constructed directly, not through from_arrays
        jg, base = _packed_pair("power_law")
        return jg, tt.EdgeListGraph(base.edge_list.clone(),
                                    base.node_edge_index.clone(),
                                    base.num_nodes, base.num_edges,
                                    base.max_degree, fat=True)
    if how == "power_law":  # dead ends: cnt 0 rows with a start of their own
        src, dst = power_law_edges(N, 6, seed=41)
        edges, n = np.stack([src, dst], axis=1), N
    elif how == "one_edge":
        edges, n = np.array([[5, 9]]), 40
    elif how == "karate":
        edges = np.asarray(j_to_edge_list_indexed(nx.karate_club_graph())[0])
        n = 34
    return (trw.EdgeListGraph.from_arrays(edges, num_nodes=n),
            tt.EdgeListGraph.from_arrays(edges, num_nodes=n, device="cpu"))


@pytest.mark.parametrize("how", ["power_law", "one_edge", "karate",
                                 "dataclass"])
def test_edge_tab_equals_jax_packed_rows(how):
    """K7's packed rows (``EdgeListGraph.edge_tab``) are the JAX package's
    ``edge_tab`` bit for bit (its uint32 words as int32), with the JAX
    layout's widths; unpacked through the JAX layout's fields they are each
    edge's tail and the tail's range; the tails column, K7's layout where
    the rows do not fit, is the sorted table's tail column."""
    jg, tg = _packed_pair(how)
    jl = jg.layout
    assert tg.packed_bits == (jl.node_bits, jl.start_bits, jl.deg_bits)
    assert tg.edge_tab.dtype == torch.int32 and tg.edge_tab.is_contiguous()
    eq(tg.edge_tab, np.asarray(jg.edge_tab).view(np.int32))
    node, start, cnt = (np.asarray(x) for x in jl.unpack(
        jnp.asarray(tg.edge_tab.numpy().view(np.uint32))))
    j_node, j_start, j_cnt = (np.asarray(x) for x in jl.unpack(jg.edge_tab))
    np.testing.assert_array_equal(node, j_node)
    np.testing.assert_array_equal(start, j_start)
    np.testing.assert_array_equal(cnt, j_cnt)
    eq(tg.tails, np.asarray(jg.edge_list)[:, 1])
    eq(tg.tails, node)
    index = np.asarray(jg.node_edge_index)[node]
    has = index[:, 0] >= 0
    np.testing.assert_array_equal(start[has], index[has, 0])
    np.testing.assert_array_equal(cnt, np.where(has, index[:, 1] - index[:, 0]
                                                + 1, 0))


def test_edge_tab_absent_or_refused_where_the_layout_does_not_fit():
    """No packed rows where the JAX package builds none (no edges; a degree
    field of 32 bits; a graph without fat tables), and a graph whose
    ``max_degree`` is below a degree, which the rows cannot hold, is
    refused."""
    empty = tt.EdgeListGraph.from_arrays(np.zeros((0, 2), np.int64),
                                         num_nodes=4, device="cpu")
    assert empty.edge_tab is None
    assert trw.EdgeListGraph.from_arrays(np.zeros((0, 2), np.int64),
                                         num_nodes=4).edge_tab is None
    base = tt.EdgeListGraph.from_arrays(
        np.array([[0, 1], [0, 2], [0, 3], [2, 0]]), device="cpu")
    wide = tt.EdgeListGraph(base.edge_list, base.node_edge_index,
                            base.num_nodes, base.num_edges, 2 ** 31, fat=True)
    assert wide.edge_tab is None and wide.packed_bits[2] == 32
    eq(wide.tails, base.tails.numpy())
    thin = dataclasses.replace(base, fat=False)
    assert base.edge_tab is not None and thin.edge_tab is None
    eq(thin.tails, base.tails.numpy())
    with pytest.raises(ValueError, match="max_degree"):
        tt.EdgeListGraph(base.edge_list, base.node_edge_index,
                         base.num_nodes, base.num_edges, 1, fat=True)
    with pytest.raises(ValueError, match="tail ids out of range"):
        tt.EdgeListGraph.from_arrays(np.array([[0, 5]]), num_nodes=3,
                                     device="cpu")


def _packed_rows_walk_mirror(g, targets, length, seed, pad, restart):
    """K7's walk on the packed rows as ``uniform_walk_edge_rows_kernel``
    runs it: the target's range from the index, then one row a step,
    unpacked by the kernel's shifts and masks."""
    key = prng.derive_key(seed, prng.STREAM_EDGE_UNIFORM)
    wid = tcommon.walker_ids(len(targets), 0, "cpu")
    words = g.edge_tab.to(torch.int64) & 0xFFFFFFFF
    value = words[:, 0] | (words[:, 1] << 32)
    nb, sb, db = g.packed_bits
    index = g.node_edge_index.to(torch.int64)
    node = torch.from_numpy(targets.astype(np.int64))
    row = index[node.clamp(0, g.num_nodes - 1)]
    has = (row[:, 0] >= 0) & (row[:, 1] >= 0)
    start = row[:, 0].clamp(min=0)
    cnt = torch.where(has, (row[:, 1] + 1 - start).clamp(min=1), 0)
    jump = ((node, start, cnt) if restart else
            (torch.full_like(node, pad), torch.zeros_like(start),
             torch.zeros_like(cnt)))
    cols = [node]
    for s in range(1, length + 1):
        bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(s))
        e = (start + prng.randint_from_bits(bits, cnt.clamp(min=1))).clamp(
            0, g.num_edges - 1)
        v = value[e]
        drawn = (v & (2 ** nb - 1), (v >> nb) & (2 ** sb - 1),
                 (v >> (nb + sb)) & (2 ** db - 1))
        at_pad, dead = node == pad, cnt == 0
        node, start, cnt = (
            torch.where(at_pad, j, torch.where(dead, d, x))
            for j, d, x in zip(jump, (pad, 0, 0), drawn))
        cols.append(node)
    return torch.stack(cols, dim=1).to(torch.int32)


@pytest.mark.parametrize("pad, restart", [(-1, True), (-1, False), (N, True),
                                          (N, False)])
def test_packed_rows_walk_mirror_equals_the_graph_entry(graphs, targets, pad,
                                                        restart):
    """A Python mirror of K7's packed-row walk equals the graph entry's
    walks (which equal the JAX fat engine's): dead ends, padding -1 and N,
    restart both ways, targets outside [0, N)."""
    _, tg = graphs
    got = _packed_rows_walk_mirror(tg, targets, L, 7, pad, restart)
    eq(got, tt.walk_edge_list(tg, target_nodes=targets, walk_length=L,
                              seed=7, padding_idx=pad, restart=restart,
                              device="cpu").numpy())
    assert bool((got == pad).any())


def test_from_arrays_rejects_heads_out_of_range_and_64_bit_ids():
    with pytest.raises(ValueError, match="out of range"):
        tt.EdgeListGraph.from_arrays([[0, 1], [5, 2]], num_nodes=4,
                                     device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        tt.EdgeListGraph.from_arrays([[0, 2 ** 31]], num_nodes=4,
                                     device="cpu")


@pytest.mark.parametrize("directed", [False, True])
def test_networkx_constructors_equal_jax(directed):
    g = nx.karate_club_graph()
    if directed:
        g = nx.DiGraph(g)
        g.remove_edges_from([(u, v) for u, v in list(g.edges()) if u > v + 3])
    j_edges, j_map = j_to_edge_list_indexed(g)
    t_edges, t_map = tt.to_edge_list_indexed(g, device="cpu")
    eq(t_edges, j_edges)
    assert t_map == j_map and t_edges.dtype == torch.int32
    jg = trw.EdgeListGraph.from_networkx(g)
    tg = tt.EdgeListGraph.from_networkx(g, device="cpu")
    eq(tg.edge_list, jg.edge_list)
    eq(tg.node_edge_index, jg.node_edge_index)


@pytest.mark.parametrize("nodes", [None, np.arange(10)])
def test_build_node_edge_index_equals_jax(nodes):
    edges = np.array([[2, 1], [0, 3], [2, 0], [0, 1], [4, 4], [2, 1]])
    j_index, j_sorted = j_build_node_edge_index(edges, nodes)
    t_index, t_sorted = tt.build_node_edge_index(edges, nodes, device="cpu")
    eq(t_index, j_index)
    eq(t_sorted, j_sorted)


def test_convert_edge_list_from_numpy(graphs):
    jg, _ = graphs
    cg = convert.edge_list_from_numpy(np.asarray(jg.edge_list), jg.num_nodes,
                                      device="cpu")
    eq(cg.edge_list, jg.edge_list)
    eq(cg.node_edge_index, jg.node_edge_index)
    assert (cg.max_degree, cg.search_iters, cg.fat) == (
        jg.max_degree, jg.search_iters, True)


def test_edge_list_primitives_equal_jax(graphs):
    """``sample_edge_neighbor`` and ``is_neighbor_edge`` of ops/common.py
    against the JAX package's, padding and ids outside [0, N) included."""
    from torch_random_walk_tpu.ops import common as jcommon
    jg, tg = graphs
    rng = np.random.default_rng(3)
    cur = rng.integers(-2, N + 2, 400)
    cand = rng.integers(-2, N + 2, 400)
    bits = rng.integers(0, 2 ** 32, 400, dtype=np.uint64)
    for pad in (-1, N):
        want = jcommon.sample_edge_neighbor(
            jg.edge_list, jg.node_edge_index, jnp.asarray(cur, jnp.int32),
            jnp.asarray(cur[::-1].copy(), jnp.int32), pad,
            jnp.asarray(bits, jnp.uint32))
        got = tcommon.sample_edge_neighbor(
            tg.edge_list, tg.node_edge_index, torch.from_numpy(cur),
            torch.from_numpy(cur[::-1].copy()), pad,
            torch.from_numpy(bits.astype(np.int64)))
        eq(got, want)
        # every (t, tail) pair of the graph is a neighbour, and random pairs
        # are answered as JAX answers them
        heads = np.asarray(jg.edge_list)[:, 0]
        tails = np.asarray(jg.edge_list)[:, 1]
        t_all = np.concatenate([cur, heads])
        c_all = np.concatenate([cand, tails])
        want = jcommon.is_neighbor_edge(
            jnp.asarray(c_all, jnp.int32), jnp.asarray(t_all, jnp.int32),
            jg.edge_list, jg.node_edge_index, pad)
        got = tcommon.is_neighbor_edge(
            torch.from_numpy(c_all), torch.from_numpy(t_all), tg.edge_list,
            tg.node_edge_index, pad)
        eq(got, want)
        assert bool(got[len(cur):].all())


# --- goldens of tests/test_golden.py through the port -----------------------

def test_golden_edge_list_walks():
    el = tt.EdgeListGraph.from_arrays(
        np.array([[0, 1], [1, 2], [2, 3], [3, 0], [1, 3]]), num_nodes=5,
        device="cpu")
    targets = np.array([0, 4], np.int32)
    restart = tt.walk_edge_list(el, target_nodes=targets, walk_length=5,
                                seed=2, padding_idx=-1, restart=True,
                                device="cpu")
    assert restart.dtype == torch.int32
    eq(restart, [[0, 1, 3, 0, 1, 3], [4, -1, 4, -1, 4, -1]])
    absorbing = tt.walk_edge_list(el, target_nodes=targets, walk_length=5,
                                  seed=2, padding_idx=-1, restart=False,
                                  device="cpu")
    eq(absorbing, [[0, 1, 3, 0, 1, 3], [4, -1, -1, -1, -1, -1]])


# --- walks on the random graph against both JAX entries ---------------------

# (p/q-biased, padding, restart): uniform walks in all four settings; the
# biased ones, whose JAX graph engine takes seconds to compile, with each
# padding and each restart value once.
WALK_CASES = {
    "uniform-minus_one-restart": (False, -1, True),
    "uniform-minus_one-absorb": (False, -1, False),
    "uniform-N-restart": (False, N, True),
    "uniform-N-absorb": (False, N, False),
    "biased-minus_one-restart": (True, -1, True),
    "biased-N-absorb": (True, N, False),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_edge_list_equals_jax_both_entries(graphs, targets, case):
    """Graph entry (the JAX fat engine) and raw arrays (the oracle), each
    against its own JAX entry, with dead ends and targets outside [0, N)."""
    jg, tg = graphs
    biased, pad, restart = WALK_CASES[case]
    kw = dict(walk_length=L, seed=7, padding_idx=pad, restart=restart)
    if biased:
        kw.update(p=0.5, q=2.0)
    jt = jnp.asarray(targets)
    got = tt.walk_edge_list(tg, target_nodes=targets, device="cpu", **kw)
    eq(got, trw.walk_edge_list(jg, target_nodes=jt, **kw))
    raw = tt.walk_edge_list(tg.edge_list, tg.node_edge_index, targets,
                            device="cpu", **kw)
    eq(raw, trw.walk_edge_list(jg.edge_list, jg.node_edge_index,
                               target_nodes=jt, **kw))
    # padding moves and dead ends are on the path
    assert bool((got == kw["padding_idx"]).any())


@pytest.mark.parametrize("pad, restart", [(-1, False), (N, True)],
                         ids=["minus_one-absorb", "N-restart"])
def test_biased_raw_entry_padding_and_restart_equal_jax(graphs, targets, pad,
                                                        restart):
    """The biased raw-array entry on the plain path against the JAX oracle
    for the padding and restart settings that
    ``test_walk_edge_list_equals_jax_both_entries`` leaves out.  (On the CPU
    the entry makes no tails column; K8 on the column is held to this plain
    version by the ``cuda`` tests.  The graph entry's JAX engine compiles
    for seconds per setting; it is held in the two settings above.)"""
    jg, tg = graphs
    kw = dict(p=0.5, q=2.0, walk_length=L, seed=9, padding_idx=pad,
              restart=restart)
    got = tt.walk_edge_list(tg.edge_list, tg.node_edge_index, targets,
                            device="cpu", **kw)
    eq(got, trw.walk_edge_list(jg.edge_list, jg.node_edge_index,
                               target_nodes=jnp.asarray(targets), **kw))
    assert bool((got == pad).any())


def test_biased_walker_offset_chunks_equal_one_call(graphs, targets):
    """A walker's draws are keyed by (walker id, step, round) alone: chunks
    with their walker offsets give the walks of one call, which equals the
    JAX oracle (its entry compiled by the biased case above)."""
    jg, tg = graphs
    whole = tel.biased_walk_edge_list(tg.edge_list, tg.node_edge_index,
                                      targets, 0.5, 2.0, L, 7, -1, True,
                                      device="cpu")
    eq(whole, trw.walk_edge_list(jg.edge_list, jg.node_edge_index,
                                 target_nodes=jnp.asarray(targets), p=0.5,
                                 q=2.0, walk_length=L, seed=7))
    half = B // 2
    for lo in (0, half):
        part = tel.biased_walk_edge_list(
            tg.edge_list, tg.node_edge_index, targets[lo:lo + half], 0.5,
            2.0, L, 7, -1, True, walker_offset=lo, device="cpu")
        eq(part, whole[lo:lo + half].numpy())


def test_graph_without_fat_tables_walks_by_the_oracle(graphs, targets):
    """A graph that the JAX package leaves without fat tables takes the
    oracle with the graph's own search depth: the membership test clamps t,
    so out-of-range targets walk as the raw arrays walk."""
    jg, tg = graphs
    j_thin = dataclasses.replace(jg, layout=None, edge_tab=None,
                                 node_tab=None)
    t_thin = dataclasses.replace(tg, fat=False)
    kw = dict(p=0.5, q=2.0, walk_length=L, seed=11, padding_idx=-1)
    jt = jnp.asarray(targets)
    got = tt.walk_edge_list(t_thin, target_nodes=targets, device="cpu", **kw)
    eq(got, trw.walk_edge_list(j_thin, target_nodes=jt, **kw))
    eq(got, tt.walk_edge_list(tg.edge_list, tg.node_edge_index, targets,
                              device="cpu", **kw))


@pytest.mark.parametrize("biased", [False, True], ids=["uniform", "biased"])
@pytest.mark.parametrize("pad", [-1, N], ids=["minus_one", "N"])
def test_directly_built_graph_walks_like_the_directly_built_jax_graph(
        graphs, targets, biased, pad):
    """A graph built from its fields walks as the JAX graph built from the
    same fields, which holds no fat tables: the oracle, whose membership
    test clamps t and never counts padding, and no -1 mark."""
    jg, tg = graphs
    j_direct = trw.EdgeListGraph(jg.edge_list, jg.node_edge_index,
                                 jg.num_nodes, jg.num_edges, jg.max_degree)
    t_direct = tt.EdgeListGraph(tg.edge_list, tg.node_edge_index,
                                tg.num_nodes, tg.num_edges, tg.max_degree)
    assert j_direct.edge_tab is None
    assert not t_direct.fat and t_direct.edge_tab is None
    eq(t_direct.tails, np.asarray(jg.edge_list)[:, 1])
    kw = dict(walk_length=L, seed=13, padding_idx=pad)
    if biased:
        kw.update(p=0.5, q=2.0)
    got = tt.walk_edge_list(t_direct, target_nodes=targets, device="cpu",
                            **kw)
    eq(got, trw.walk_edge_list(j_direct, target_nodes=jnp.asarray(targets),
                               **kw))


@pytest.fixture(scope="module")
def ring_graphs():
    """No dead ends and no self-loops, so a biased walker stays in place only
    when its round budget ran out."""
    src, dst = power_law_edges(120, 4, seed=43, dead_ends=False)
    ring = np.arange(120)
    keep = src != dst
    edges = np.stack([np.concatenate([src[keep], ring]),
                      np.concatenate([dst[keep], (ring + 1) % 120])], axis=1)
    return (trw.EdgeListGraph.from_arrays(edges, num_nodes=120),
            tt.EdgeListGraph.from_arrays(edges, num_nodes=120, device="cpu"))


@pytest.mark.parametrize("max_rounds", [1, 2])
def test_small_round_budget_keeps_v_and_graph_entry_marks(ring_graphs,
                                                          max_rounds):
    """The oracle keeps v where the budget ran out; the graph entry also
    writes -1 into the last column of such a walk, the JAX fat engine's
    mark of an incomplete walk (whose global budget is not comparable)."""
    jg, tg = ring_graphs
    t = np.arange(B, dtype=np.int32)
    oracle = np.asarray(j_biased(jg.edge_list, jg.node_edge_index,
                                 jnp.asarray(t), 4.0, 0.25, L, 8, -1, True,
                                 search_iters=jg.search_iters,
                                 max_rounds=max_rounds))
    ran_out = (oracle[:, 2:] == oracle[:, 1:-1]).any(axis=1)
    assert ran_out.any() and not ran_out.all()
    eq(tt.walk_edge_list(tg.edge_list, tg.node_edge_index, t, p=4.0, q=0.25,
                         walk_length=L, seed=8, max_rounds=max_rounds,
                         device="cpu"), oracle)
    want = oracle.copy()
    want[ran_out, -1] = -1
    eq(tt.walk_edge_list(tg, target_nodes=t, p=4.0, q=0.25, walk_length=L,
                         seed=8, max_rounds=max_rounds, device="cpu"), want)


def test_walk_length_one_and_errors(graphs, targets):
    """One step is the first hop alone, the same in the graph engine and the
    oracle."""
    jg, tg = graphs
    jt = jnp.asarray(targets)
    for kw in (dict(), dict(p=0.5, q=2.0)):
        want = trw.walk_edge_list(jg.edge_list, jg.node_edge_index,
                                  target_nodes=jt, walk_length=1, seed=2, **kw)
        eq(tt.walk_edge_list(tg, target_nodes=targets, walk_length=1, seed=2,
                             device="cpu", **kw), want)
    with pytest.raises(ValueError, match="walk_length"):
        tt.walk_edge_list(tg, target_nodes=targets, walk_length=0,
                          device="cpu")
    with pytest.raises(ValueError, match="node_edge_index"):
        tt.walk_edge_list(tg.edge_list, target_nodes=targets, device="cpu")


def test_device_none_means_the_card_and_raises_without_one(graphs, targets):
    if torch.cuda.is_available():
        pytest.skip("there is a card: device=None is the normal path")
    _, tg = graphs
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.walk_edge_list(tg, target_nodes=targets, walk_length=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.walk_edge_list(tg.edge_list, tg.node_edge_index, targets,
                          walk_length=2)
    for build in (lambda: tt.EdgeListGraph.from_arrays([[0, 1]]),
                  lambda: tt.build_node_edge_index([[0, 1]]),
                  lambda: tt.to_edge_list_indexed(nx.path_graph(3))):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


# --- the kernels against their plain versions (on the card) -----------------

def _kernel_graph():
    src, dst = power_law_edges(3000, 6, seed=5)  # last quarter: dead ends
    return tt.EdgeListGraph.from_arrays(np.stack([src, dst], axis=1),
                                        num_nodes=3000, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pad_minus_one_restart", "pad_N_absorb"])
@pytest.mark.parametrize("walkers", [1, 33, 4097])
@pytest.mark.parametrize("length", [1, 7, 8, 9, 80])
def test_uniform_kernel_equals_plain_version(length, walkers, case):
    """K7 against its plain version, tolerance 0: dead ends, padding -1 and
    N, restart both ways, targets outside [0, N), and the row writer's
    edges (L + 1 not a multiple of 8, one walker, a ragged warp)."""
    need_cuda()
    g = _kernel_graph()
    pad, restart = (-1, True) if case == "pad_minus_one_restart" else (
        g.num_nodes, False)
    t = np.random.default_rng(length * walkers).integers(
        -3, g.num_nodes + 3, walkers).astype(np.int32)
    got, want = (tel.uniform_walk_edge_list(
        g.edge_list, g.node_edge_index, t, length, 6, pad, restart,
        walker_offset=100_003, device=dev) for dev in (None, "cpu"))
    assert got.is_cuda
    eq(got, want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("fat", [False, True], ids=["oracle", "fat"])
@pytest.mark.parametrize("case", ["pad_minus_one", "pad_N_absorb",
                                  "rounds_1", "rounds_2", "length_1",
                                  "length_9"])
def test_biased_kernel_equals_plain_version(case, fat):
    """K8 against its plain version, walks and exhausted flags, tolerance 0:
    budgets of 1 and 2 rounds, walks of 1 and 9 steps, padding -1 and N,
    restart both ways, both membership tests."""
    need_cuda()
    g = _kernel_graph()
    pad = g.num_nodes if case == "pad_N_absorb" else -1
    restart = case != "pad_N_absorb"
    length = {"length_1": 1, "length_9": 9}.get(case, 20)
    rounds = {"rounds_1": 1, "rounds_2": 2}.get(case, 4096)
    t = np.random.default_rng(8).integers(-3, g.num_nodes + 3,
                                          2049).astype(np.int32)
    key = prng.derive_key(6, prng.STREAM_EDGE_BIASED)
    got = tel.biased_walk(g.edge_list, g.node_edge_index, t, 0.5, 2.0, length,
                          6, pad, restart, g.search_iters, rounds, fat,
                          walker_offset=7, device=None)
    want = tel.biased_walk_edge_list_plain(
        g.edge_list, g.node_edge_index, tcommon.as_int32(t, "cpu"), length,
        key, pad, restart, tcommon.node2vec_accept_probs(0.5, 2.0),
        g.search_iters, rounds, fat, walker_offset=7)
    assert got.walks.is_cuda
    eq(got.walks, want.walks.numpy())
    eq(got.exhausted, want.exhausted.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("fat", [False, True], ids=["oracle", "fat"])
@pytest.mark.parametrize("case", ["one_edge_graph", "search_1_trip",
                                  "search_2_trips", "budget_exhausted",
                                  "tails_made_per_call"])
def test_biased_kernel_tails_edges_equal_plain_version(case, fat):
    """K8 on the tails column against its plain version, walks and
    exhausted flags, tolerance 0: a graph of one edge (every other node has
    none), searches cut short at 1 and 2 trips (the last probe does not
    answer), a round budget of 3 at p = 8, q = 0.125 that most steps
    exhaust, and the column made per call (the raw-array entry's path)
    beside the graph's own."""
    need_cuda()
    g = _kernel_graph()
    if case == "one_edge_graph":
        g = tt.EdgeListGraph.from_arrays(np.array([[5, 9]]), num_nodes=40,
                                         device="cpu")
    iters = {"search_1_trip": 1, "search_2_trips": 2}.get(case,
                                                          g.search_iters)
    rounds = 3 if case == "budget_exhausted" else 4096
    p, q = (8.0, 0.125) if case == "budget_exhausted" else (0.5, 2.0)
    t = np.random.default_rng(9).integers(-3, g.num_nodes + 3,
                                          4097).astype(np.int32)
    key = prng.derive_key(6, prng.STREAM_EDGE_BIASED)
    tails = None if case == "tails_made_per_call" else g.tails.cuda()
    got = tel.biased_walk(g.edge_list, g.node_edge_index, t, p, q, 20, 6, -1,
                          True, iters, rounds, fat, walker_offset=11,
                          device=None, tails=tails)
    want = tel.biased_walk_edge_list_plain(
        g.edge_list, g.node_edge_index, tcommon.as_int32(t, "cpu"), 20, key,
        -1, True, tcommon.node2vec_accept_probs(p, q), iters, rounds, fat,
        walker_offset=11)
    assert got.walks.is_cuda
    eq(got.walks, want.walks.numpy())
    eq(got.exhausted, want.exhausted.numpy())
    if case == "budget_exhausted":
        assert bool(want.exhausted.any())


def _unfit_graph(device):
    """The kernel graph with a max_degree whose field takes 32 bits: the
    packed layout does not fit, so the graph holds no packed rows."""
    g = _kernel_graph()
    g = tt.EdgeListGraph(g.edge_list.to(device), g.node_edge_index.to(device),
                         g.num_nodes, g.num_edges, 2 ** 31, fat=True)
    assert g.edge_tab is None
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "tails_unfit"])
@pytest.mark.parametrize("case", ["pad_minus_one_restart", "pad_N_absorb"])
@pytest.mark.parametrize("walkers", [1, 33, 4097])
@pytest.mark.parametrize("length", [1, 7, 8, 9, 80])
def test_uniform_kernel_graph_tables_equal_plain_version(length, walkers,
                                                         case, layout):
    """K7 on a graph's tables against its plain version, tolerance 0: the
    packed rows, and the tails column of a graph whose packed layout does
    not fit; dead ends, padding -1 and N, restart both ways, targets outside
    [0, N), a walker offset, the row writer's edges."""
    need_cuda()
    cpu = _kernel_graph()
    g = (tt.EdgeListGraph.from_arrays(cpu.edge_list, cpu.num_nodes,
                                      device="cuda") if layout == "packed"
         else _unfit_graph("cuda"))
    assert (g.edge_tab is not None) == (layout == "packed")
    pad, restart = (-1, True) if case == "pad_minus_one_restart" else (
        g.num_nodes, False)
    t = np.random.default_rng(length * walkers).integers(
        -3, g.num_nodes + 3, walkers).astype(np.int32)
    got = tel.uniform_walk_edge_list_graph(g, t, length, 6, pad, restart,
                                           walker_offset=100_003)
    want = tel.uniform_walk_edge_list(cpu.edge_list, cpu.node_edge_index, t,
                                      length, 6, pad, restart,
                                      walker_offset=100_003, device="cpu")
    assert got.is_cuda
    eq(got, want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("fits", [True, False], ids=["packed", "unfit"])
def test_graph_entry_launches_k7_on_its_table(fits):
    """``walk_edge_list(graph)`` reads the packed rows where the graph holds
    them and its tails column where it does not, one K7 launch a call, and
    equals the plain version; a malformed table raises."""
    need_cuda()
    from torch_random_walk_tpu_torch.kernels import bindings
    cpu = _kernel_graph()
    g = (tt.EdgeListGraph.from_arrays(cpu.edge_list, cpu.num_nodes,
                                      device="cuda") if fits
         else _unfit_graph("cuda"))
    assert (g.edge_tab is not None) == fits
    t = np.random.default_rng(3).integers(-3, g.num_nodes + 3,
                                          999).astype(np.int32)
    kw = dict(target_nodes=t, walk_length=20, seed=6, padding_idx=-1)
    before = bindings.launch_counts["uniform_walk_edge_list"]
    got = tt.walk_edge_list(g, **kw)
    assert bindings.launch_counts["uniform_walk_edge_list"] == before + 1
    eq(got, tt.walk_edge_list(cpu, device="cpu", **kw).numpy())
    with pytest.raises(ValueError):
        bindings.uniform_walk_edge_list(
            g.tails, g.node_edge_index, torch.as_tensor(t, device="cuda"),
            20, (1, 2), -1, True, 0, layout="packed", bits=g.packed_bits)
