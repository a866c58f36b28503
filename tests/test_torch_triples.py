"""The port's KG-triples graph, walks and triple windows against the JAX
package, value for value (tolerance 0: ids).  Everything runs on the CPU
through the plain PyTorch versions; K9 and K10 are held against those same
plain versions on the card (tests marked ``cuda`` below, and
chip_smoke.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.graph.datasets import synthetic_grid_kg as j_grid_kg
from torch_random_walk_tpu.graph.triples import (
    build_relation_tail_index as j_build_relation_tail_index,
)
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.ops import common as tcommon
from torch_random_walk_tpu_torch.ops import triples_walk as ttw
from torch_random_walk_tpu_torch.ops import windows as twin
from torch_random_walk_tpu_torch.utils import prng
from torch_port_util import eq, need_cuda

SIDE, B, L = 7, 48, 5


@pytest.fixture(scope="module")
def graphs():
    """The grid-world KG (border cells lack some out-triples, the far corner
    is a dead end), built by both packages."""
    jg, j_all, j_test = j_grid_kg(SIDE, seed=3)
    tg, t_all, t_test = tt.synthetic_grid_kg(SIDE, seed=3, device="cpu")
    np.testing.assert_array_equal(t_all, j_all)
    np.testing.assert_array_equal(t_test, j_test)
    return jg, tg


@pytest.fixture(scope="module")
def targets():
    """Entities, -1, N and ids beyond them."""
    n = SIDE * SIDE
    t = np.random.default_rng(5).integers(-2, n + 2, B).astype(np.int32)
    t[:5] = [-1, n, n + 1, n - 1, 0]
    return t


# --- constructors ------------------------------------------------------------

def test_grid_kg_and_from_arrays_equal_jax(graphs):
    jg, tg = graphs
    eq(tg.triples, jg.triples)
    eq(tg.relation_tail_index, jg.relation_tail_index)
    assert tg.triples.dtype == tg.relation_tail_index.dtype == torch.int32
    assert (tg.num_entities, tg.num_triples, tg.max_degree, tg.num_relations,
            tg.search_iters) == (jg.num_entities, jg.num_triples,
                                 jg.max_degree, jg.num_relations,
                                 jg.search_iters)
    assert tg.fat and jg.triple_tab is not None
    assert int((tg.relation_tail_index[:, 0] == -1).sum()) >= 1


@pytest.mark.parametrize("sizes", [(None, None), (12, 20)],
                         ids=["inferred", "explicit"])
def test_from_arrays_sorts_by_head_relation_tail(sizes):
    rng = np.random.default_rng(9)
    t = np.stack([rng.integers(0, 10, 60), rng.integers(0, 4, 60),
                  rng.integers(0, 10, 60)], axis=1)
    jg = trw.TriplesGraph.from_arrays(t, *sizes)
    tg = tt.TriplesGraph.from_arrays(t, *sizes, device="cpu")
    eq(tg.triples, jg.triples)
    eq(tg.relation_tail_index, jg.relation_tail_index)
    assert (tg.num_entities, tg.num_relations) == (jg.num_entities,
                                                   jg.num_relations)
    empty = np.zeros((0, 3), np.int64)
    jg = trw.TriplesGraph.from_arrays(empty, num_entities=3)
    tg = tt.TriplesGraph.from_arrays(empty, num_entities=3, device="cpu")
    eq(tg.relation_tail_index, jg.relation_tail_index)
    assert tg.fat is False and jg.triple_tab is None


def test_build_relation_tail_index_and_convert_equal_jax(graphs):
    jg, _ = graphs
    raw = np.random.default_rng(1).permutation(np.asarray(jg.triples))
    ents = np.arange(jg.num_entities + 2)
    j_index, j_sorted = j_build_relation_tail_index(raw, ents)
    t_index, t_sorted = tt.build_relation_tail_index(raw, ents, device="cpu")
    eq(t_index, j_index)
    eq(t_sorted, j_sorted)
    cg = convert.triples_from_numpy(np.asarray(jg.triples), jg.num_entities,
                                    jg.num_relations, device="cpu")
    eq(cg.triples, jg.triples)
    eq(cg.relation_tail_index, jg.relation_tail_index)
    assert (cg.max_degree, cg.num_relations, cg.fat) == (
        jg.max_degree, jg.num_relations, True)


# --- goldens of tests/test_golden.py through the port -----------------------

def test_golden_triples_walk():
    tg = tt.TriplesGraph.from_arrays(
        np.array([[0, 7, 1], [1, 8, 2], [2, 9, 0], [0, 7, 2]]),
        num_entities=4, device="cpu")
    walks = tt.walk_triples(tg, target_nodes=np.array([0, 1, 3], np.int32),
                            walk_length=3, seed=5, padding_idx=-1,
                            device="cpu")
    assert walks.dtype == torch.int32
    eq(walks, [[0, 7, 2, 9, 0, 7, 2], [1, 8, 2, 9, 0, 7, 2],
               [3, -1, -1, -1, -1, -1, -1]])


# --- walks against both JAX entries ----------------------------------------

@pytest.mark.parametrize("pad", ["minus_one", "N", "inside"])
def test_walk_triples_equals_jax_both_entries(graphs, targets, pad):
    """Graph entry (the JAX fat engine) and raw arrays (the oracle), each
    against its own JAX entry: dead ends, padding -1, N and an entity id,
    targets outside [0, N)."""
    jg, tg = graphs
    n = tg.num_entities
    padding_idx = {"minus_one": -1, "N": n, "inside": n - 2}[pad]
    kw = dict(walk_length=L, seed=4, padding_idx=padding_idx)
    jt = jnp.asarray(targets)
    got = tt.walk_triples(tg, target_nodes=targets, device="cpu", **kw)
    eq(got, trw.walk_triples(jg, target_nodes=jt, **kw))
    raw = tt.walk_triples(tg.triples, tg.relation_tail_index, targets,
                          device="cpu", **kw)
    eq(raw, trw.walk_triples(jg.triples, jg.relation_tail_index,
                             target_nodes=jt, **kw))
    assert bool((got[:, 1:] == padding_idx).any())
    if pad != "N":  # targets outside [0, N) walk apart in the two engines
        assert not torch.equal(got, raw)


def test_out_of_range_target_differs_by_entry_as_in_jax():
    """With 4 entities and target 5 the JAX graph entry writes padding and
    the raw arrays walk from the clamped entity 3; the port reproduces
    each."""
    t = np.array([[0, 7, 1], [1, 8, 2], [2, 9, 0], [0, 7, 2], [3, 5, 0]])
    jg = trw.TriplesGraph.from_arrays(t, num_entities=4)
    tg = tt.TriplesGraph.from_arrays(t, num_entities=4, device="cpu")
    target = np.array([5], np.int32)
    kw = dict(target_nodes=target, walk_length=3, seed=5, padding_idx=-1)
    graph_walk = tt.walk_triples(tg, device="cpu", **kw)
    raw_walk = tt.walk_triples(tg.triples, tg.relation_tail_index,
                               device="cpu", **kw)
    eq(graph_walk, [[5, -1, -1, -1, -1, -1, -1]])
    eq(raw_walk, [[5, 5, 0, 7, 2, 9, 0]])
    eq(graph_walk, trw.walk_triples(jg, **{**kw, "target_nodes":
                                           jnp.asarray(target)}))
    eq(raw_walk, trw.walk_triples(jg.triples, jg.relation_tail_index,
                                  **{**kw, "target_nodes":
                                     jnp.asarray(target)}))


def test_restart_ignored_offsets_and_thin_graph(graphs, targets):
    """``restart`` changes nothing; chunks with their walker offsets give
    one call's walks; a graph without the fat table walks by the oracle."""
    jg, tg = graphs
    kw = dict(walk_length=L, seed=4, padding_idx=-1)
    base = tt.walk_triples(tg, target_nodes=targets, device="cpu", **kw)
    eq(tt.walk_triples(tg, target_nodes=targets, restart=False, device="cpu",
                       **kw), base.numpy())
    half = B // 2
    for lo in (0, half):
        part = ttw.uniform_walk_triples(
            tg.triples, tg.relation_tail_index, targets[lo:lo + half], L, -1,
            True, 4, walker_offset=lo, fat=True, device="cpu")
        eq(part, base[lo:lo + half].numpy())
    thin = dataclasses.replace(tg, fat=False)
    eq(tt.walk_triples(thin, target_nodes=targets, device="cpu", **kw),
       trw.walk_triples(jg.triples, jg.relation_tail_index,
                        target_nodes=jnp.asarray(targets), **kw))


def test_device_none_means_the_card_and_raises_without_one(graphs, targets):
    if torch.cuda.is_available():
        pytest.skip("there is a card: device=None is the normal path")
    _, tg = graphs
    walks = tt.walk_triples(tg, target_nodes=targets, walk_length=2,
                            device="cpu")
    for call in (
            lambda: tt.walk_triples(tg, target_nodes=targets, walk_length=2),
            lambda: tt.walk_triples(tg.triples, tg.relation_tail_index,
                                    targets, walk_length=2),
            lambda: tt.to_windows_triples(walks, 2, 0, -1, tg.triples),
            lambda: tt.to_windows_triples_cbow(walks, 2, 0, -1, tg.triples),
            lambda: tt.TriplesGraph.from_arrays([[0, 1, 2]]),
            lambda: tt.build_relation_tail_index([[0, 1, 2]], [0, 1, 2]),
            lambda: tt.synthetic_grid_kg(3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# --- triple windows ---------------------------------------------------------

@pytest.mark.parametrize("window", [1, 2, 5])
def test_triples_windows_equal_jax(graphs, targets, window):
    """Both generators on walks with padding (dead ends, out-of-range
    targets), padding -1, the windows running past both ends of the walk."""
    jg, tg = graphs
    walks = tt.walk_triples(tg, target_nodes=targets, walk_length=L, seed=4,
                            padding_idx=-1, device="cpu")
    jw = jnp.asarray(walks.numpy())
    args = (window, tg.num_entities, -1)
    got = tt.to_windows_triples(walks, *args, tg.triples, seed=3,
                                device="cpu")
    want = trw.to_windows_triples(jw, *args, jg.triples, seed=3)
    assert [tuple(x.shape) for x in got] == [
        (B * L, 3), (B * L, 2 * window, 3), (B * L, 2 * window, 3)]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        eq(g, w)
    got = tt.to_windows_triples_cbow(walks, *args, tg.triples, seed=3,
                                     device="cpu")
    want = trw.to_windows_triples_cbow(jw, *args, jg.triples, seed=3)
    for g, w in zip(got, want, strict=True):
        eq(g, w)


def test_triples_cbow_collisions_fall_through_to_the_last_draw():
    """A table of two triples: most first draws collide with the target
    triple; with one triple every draw does, and the last is kept."""
    walks = np.array([[0, 1, 2, 1, 2], [2, 1, 2, 3, 4], [0, 1, 2, 3, 4]],
                     np.int32)
    for table in (np.array([[0, 1, 2], [2, 3, 4]], np.int32),
                  np.array([[0, 1, 2]], np.int32)):
        got = tt.to_windows_triples_cbow(walks, 1, 5, 9, table, seed=1,
                                         device="cpu")
        want = trw.to_windows_triples_cbow(jnp.asarray(walks), 1, 5, 9,
                                           jnp.asarray(table), seed=1)
        for g, w in zip(got, want, strict=True):
            eq(g, w)
    eq(got[1], np.repeat(table, 6, axis=0))  # every draw collided or not


# --- the kernels against their plain versions (on the card) -----------------

def _kernel_graph():
    return tt.synthetic_grid_kg(60, seed=2, device="cpu")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("fat", [False, True], ids=["oracle", "fat"])
@pytest.mark.parametrize("walkers", [1, 33, 4097])
@pytest.mark.parametrize("length", [1, 7, 8, 9, 80])
def test_walk_kernel_equals_plain_version(length, walkers, fat):
    """K9 against its plain version, tolerance 0: dead ends, padding N,
    targets outside [0, N), both semantics, the row writer's edges (2L + 1
    words a row, one walker, a ragged warp)."""
    need_cuda()
    g = _kernel_graph()
    t = np.random.default_rng(length * walkers).integers(
        -3, g.num_entities + 3, walkers).astype(np.int32)
    got, want = (ttw.uniform_walk_triples(
        g.triples, g.relation_tail_index, t, length, g.num_entities, True, 6,
        walker_offset=100_003, fat=fat, device=dev) for dev in (None, "cpu"))
    assert got.is_cuda
    eq(got, want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
@pytest.mark.parametrize("window", [1, 2, 5])
def test_windows_kernel_equals_plain_version(window, cbow):
    """K10 against its plain version, tolerance 0, on walks with padding,
    and on a table of two triples, where CBOW's draws collide."""
    need_cuda()
    g = _kernel_graph()
    t = np.random.default_rng(window).integers(-2, g.num_entities + 2, 4097)
    walks = ttw.uniform_walk_triples(g.triples, g.relation_tail_index, t, 20,
                                     -1, True, 6, fat=True, device=None)
    stream = (prng.STREAM_WINDOWS_TRIPLES_CBOW if cbow
              else prng.STREAM_WINDOWS_TRIPLES_SG)
    key = prng.derive_key(3, stream)
    for table in (g.triples, g.triples[:2].contiguous()):
        gen = tt.to_windows_triples_cbow if cbow else tt.to_windows_triples
        got = gen(walks, window, g.num_entities, -1, table, seed=3)
        want = twin.to_windows_triples_plain(
            walks.cpu(), window, -1, tcommon.as_int32(table, "cpu"), key,
            cbow)
        for a, b in zip(got, want, strict=True):
            assert a.is_cuda
            eq(a, b.numpy())
