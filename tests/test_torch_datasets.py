"""The port's dataset loaders and generators, graph exports and transition
oracle against the JAX package's, on the CPU, at small sizes.  Every
compared output is an integer array or a graph's CSR arrays (tolerance 0),
but the oracle's probabilities, which must be equal too: both packages run
the same NumPy code.  The loaders read miniature files in the formats the
real datasets ship in (the GCN codebase's ``ind.{name}.*`` pickles, the OGB
edge cache); the power-law cache crosses between the packages at 500 000
nodes, where caching starts."""

import os
import pickle

import networkx as nx
import numpy as np
import pytest
import torch

from torch_random_walk_tpu.graph import csr as j_csr
from torch_random_walk_tpu.graph import datasets as jd
from torch_random_walk_tpu.graph import oracle as j_oracle
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu_torch.graph import datasets as td
from torch_random_walk_tpu_torch.graph import oracle as t_oracle


def same_graph(tg, jg):
    np.testing.assert_array_equal(tg.row_ptr.numpy(), np.asarray(jg.row_ptr))
    np.testing.assert_array_equal(tg.col_idx.numpy(), np.asarray(jg.col_idx))
    assert tg.num_nodes == jg.num_nodes and tg.num_edges == jg.num_edges
    assert tg.fat == (jg.edge_tab is not None)


@pytest.fixture
def planetoid_dir(tmp_path):
    """The JAX loader tests' miniature 8-node planetoid dataset in the GCN
    pickle format: nodes 0-5 are 'allx/ally' (train) nodes, 6-7 test
    nodes."""
    adj = {
        0: [1, 2], 1: [0, 2], 2: [0, 1, 3], 3: [2, 4], 4: [3, 5],
        5: [4, 6], 6: [5, 7], 7: [6],
    }
    with open(tmp_path / "ind.tiny.graph", "wb") as f:
        pickle.dump(adj, f)
    y_all = np.zeros((6, 3), np.int64)
    y_all[np.arange(6), [0, 0, 1, 1, 2, 2]] = 1
    with open(tmp_path / "ind.tiny.ally", "wb") as f:
        pickle.dump(y_all, f)
    y_test = np.zeros((2, 3), np.int64)  # test nodes 7, 6 (index order)
    y_test[[0, 1], [2, 0]] = 1
    with open(tmp_path / "ind.tiny.ty", "wb") as f:
        pickle.dump(y_test, f)
    np.savetxt(tmp_path / "ind.tiny.test.index", np.array([7, 6]), fmt="%d")
    return str(tmp_path)


def test_npz_round_trip_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 150), rng.integers(0, 40, 150)
    path = str(tmp_path / "g")  # no suffix: '.npz' is appended
    td.save_npz(path, src, dst, num_nodes=45)
    assert os.listdir(tmp_path) == ["g.npz"]  # no temporary left
    g = td.load_npz(path + ".npz", device="cpu")
    same_graph(g, jd.load_npz(path + ".npz"))
    assert g.num_nodes == 45


def test_planetoid_pickles_and_cache_equal_jax(planetoid_dir):
    g, labels = td.load_planetoid("Tiny", root=planetoid_dir, device="cpu")
    jg, jlabels = jd.load_planetoid("tiny", root=planetoid_dir)
    same_graph(g, jg)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(labels, [0, 0, 1, 1, 2, 2, 0, 2])
    # The cache wins over the pickles, in both packages.
    np.savez(os.path.join(planetoid_dir, "tiny_edges.npz"), src=[0, 1],
             dst=[1, 2], num_nodes=4, labels=[1, 0, 1, 1])
    g, labels = td.load_planetoid("tiny", root=planetoid_dir, device="cpu")
    jg, jlabels = jd.load_planetoid("tiny", root=planetoid_dir)
    same_graph(g, jg)
    assert g.num_nodes == 4 and g.num_edges == 4  # symmetrized
    np.testing.assert_array_equal(labels, jlabels)


def test_planetoid_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no planetoid data"):
        td.load_planetoid("absent", root=str(tmp_path), device="cpu")


def test_ogbn_from_the_edge_cache_equals_jax(tmp_path):
    root = str(tmp_path)
    with pytest.raises(ImportError, match="ogbn_tiny_edges.npz"):
        td.load_ogbn("ogbn-tiny", root=root, device="cpu")
    jd.save_npz(os.path.join(root, "ogbn_tiny_edges.npz"),
                src=[0, 1, 2, 4], dst=[1, 2, 0, 0], num_nodes=6)
    np.save(os.path.join(root, "ogbn_tiny_labels.npy"),
            np.array([0, 1, 1, 0, 2, 2]))
    for sym in (True, False):
        g, labels = td.load_ogbn("ogbn-tiny", root=root, symmetrize=sym,
                                 device="cpu")
        jg, jlabels = jd.load_ogbn("ogbn-tiny", root=root, symmetrize=sym)
        same_graph(g, jg)
        np.testing.assert_array_equal(labels, jlabels)
    assert g.num_nodes == 6 and g.num_edges == 4


def test_sbm_equals_jax():
    g, labels, edges = td.synthetic_sbm(300, 4, 6.0, seed=5, device="cpu")
    jg, jlabels, jedges = jd.synthetic_sbm(300, 4, 6.0, seed=5)
    same_graph(g, jg)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(edges, jedges)


def test_power_law_cache_crosses_between_the_packages(tmp_path, monkeypatch):
    """At 500 000 nodes (the threshold) each package reads the other's cache
    file as the same graph; the legacy unversioned name loads too, and
    $TRW_GRAPH_CACHE stands in for cache_root; below the threshold nothing
    is written."""
    root = str(tmp_path)
    n = td._POWERLAW_CACHE_MIN_NODES
    jg = jd.synthetic_power_law(n, 1, 5, cache_root=root)  # JAX writes
    assert os.listdir(root) == ["powerlaw_v1_500000_1_5.npz"]
    same_graph(td.synthetic_power_law(n, 1, 5, cache_root=root,
                                      device="cpu"), jg)
    tg = td.synthetic_power_law(n, 1, 6, cache_root=root, device="cpu")
    assert "powerlaw_v1_500000_1_6.npz" in os.listdir(root)  # port writes
    jg = jd.synthetic_power_law(n, 1, 6, cache_root=root)
    same_graph(tg, jg)
    os.rename(os.path.join(root, "powerlaw_v1_500000_1_6.npz"),
              os.path.join(root, "powerlaw_500000_1_6.npz"))
    monkeypatch.setenv("TRW_GRAPH_CACHE", root)
    same_graph(td.synthetic_power_law(n, 1, 6, device="cpu"), jg)
    assert "powerlaw_v1_500000_1_6.npz" not in os.listdir(root)
    small = td.synthetic_power_law(n - 1, 1, 6, device="cpu")
    assert len(os.listdir(root)) == 2
    same_graph(small, jd.synthetic_power_law(n - 1, 1, 6))


def test_products_shape_graph_through_a_small_cache(tmp_path, monkeypatch):
    """The products-shape graph is 127 M edges, so its generator runs here
    at a small shape (PRODUCTS_SHAPE patched): the port draws, builds and
    writes ``products_shape_csr.npz`` with JAX's keys; JAX loads that file
    as its own generator's graph, and the port's second call loads it."""
    root = str(tmp_path / "ds")
    monkeypatch.setattr(td, "PRODUCTS_SHAPE", (3000, 6, 0))
    g = td.products_shape_graph(root=root, device="cpu")
    path = os.path.join(root, "products_shape_csr.npz")
    with np.load(path) as data:
        assert sorted(data.files) == ["col_idx", "row_ptr"]
    want = jd.synthetic_power_law(3000, 6, 0)
    same_graph(g, want)
    same_graph(g, jd.products_shape_graph(root=root))
    monkeypatch.setattr(td, "PRODUCTS_SHAPE", None)  # must not draw again
    same_graph(td.products_shape_graph(root=root, device="cpu"), want)


def test_grid_kg_triples_equal_jax():
    _, j_all, j_test = jd.synthetic_grid_kg(7, seed=2)
    triples, test, train = td.grid_kg_triples(7, seed=2)
    np.testing.assert_array_equal(triples, j_all)
    np.testing.assert_array_equal(test, j_test)
    assert len(train) + len(test) == len(triples)


def test_networkx_exports_equal_jax():
    g = nx.gnm_random_graph(60, 200, seed=4, directed=True)
    g = nx.relabel_nodes(g, {v: (v * 7) % 60 for v in g.nodes()})
    row_ptr, col_idx = tt.to_csr(g, device="cpu")
    j_row_ptr, j_col_idx = j_csr.to_csr(g)
    np.testing.assert_array_equal(row_ptr.numpy(), np.asarray(j_row_ptr))
    np.testing.assert_array_equal(col_idx.numpy(), np.asarray(j_col_idx))
    assert row_ptr.dtype == col_idx.dtype == torch.int32
    same_graph(tt.CSRGraph.from_networkx(g, device="cpu"),
               j_csr.CSRGraph.from_networkx(g))
    nodes = tt.nodes_tensor(g, device="cpu")
    np.testing.assert_array_equal(nodes.numpy(),
                                  np.asarray(j_csr.nodes_tensor(g)))
    assert nodes.dtype == torch.int32
    assert tt.graph.to_csr is tt.to_csr
    assert tt.graph.nodes_tensor is tt.nodes_tensor


def test_exports_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    g = nx.path_graph(4)
    for call in (lambda: tt.to_csr(g), lambda: tt.nodes_tensor(g),
                 lambda: td.synthetic_sbm(20, 2, 3.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_oracle_equals_jax_on_random_inputs():
    rng = np.random.default_rng(9)
    n = 30
    src, dst = rng.integers(0, n, 120), rng.integers(0, n - 5, 120)
    g = tt.CSRGraph.from_edges(src, dst, num_nodes=n, device="cpu")
    rp, ci = g.row_ptr.numpy(), g.col_idx.numpy()
    el = np.stack([np.sort(src), dst[np.argsort(src, kind="stable")]], 1)
    index = np.full((n, 2), -1, np.int64)
    for v in range(n):
        rows = np.nonzero(el[:, 0] == v)[0]
        if rows.size:
            index[v] = rows[0], rows[-1]
    triples = np.stack([el[:, 0], rng.integers(0, 3, el.shape[0]), el[:, 1]],
                       1)
    assert t_oracle is tt.graph.oracle
    for v in range(n):
        t = int(rng.integers(0, n))
        pad = n if v % 2 else n + 3
        pairs = [
            ("uniform_csr_probs", (rp, ci, v, n)),
            ("node2vec_csr_probs", (rp, ci, t, v, 0.5, 2.0, n)),
            ("uniform_edge_probs", (el, index, v, 3, pad, n)),
            ("biased_edge_probs", (el, index, t, v, 4.0, 0.25, 3, pad, n)),
        ]
        for name, args in pairs:
            np.testing.assert_array_equal(getattr(t_oracle, name)(*args),
                                          getattr(j_oracle, name)(*args))
        assert (t_oracle.triples_probs(triples, index, v, pad, n, 3)
                == j_oracle.triples_probs(triples, index, v, pad, n, 3))
    got = t_oracle.walk_uniform_csr(rp, ci, np.arange(n), 6,
                                    np.random.default_rng(1))
    want = j_oracle.walk_uniform_csr(rp, ci, np.arange(n), 6,
                                     np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
