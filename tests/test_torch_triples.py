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
from torch_random_walk_tpu_torch.kernels import bindings
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


def _tab_pair(how, graphs):
    """(JAX graph, port graph) of the same triples, built one way."""
    if how == "grid":  # border cells lack triples, the far corner heads none
        return graphs
    if how == "dataclass":  # constructed directly, not through from_arrays
        jg, base = graphs
        return jg, tt.TriplesGraph(
            base.triples.clone(), base.relation_tail_index.clone(),
            base.num_entities, base.num_triples, base.max_degree,
            base.num_relations, fat=True)
    if how == "one_triple":
        t, n = np.array([[3, 1, 5]]), 9
    else:  # "random": duplicate triples, a relation id past the entities
        rng = np.random.default_rng(21)
        t = np.stack([rng.integers(0, 30, 200), rng.integers(0, 70, 200),
                      rng.integers(0, 40, 200)], axis=1)
        n = 40
    return (trw.TriplesGraph.from_arrays(t, num_entities=n),
            tt.TriplesGraph.from_arrays(t, num_entities=n, device="cpu"))


@pytest.mark.parametrize("how", ["grid", "random", "one_triple", "dataclass"])
def test_triple_tab_equals_jax(graphs, how):
    """K9's rows (``TriplesGraph.triple_tab``) are the JAX package's
    ``triple_tab`` exactly: (relation, tail, start_tail, cnt_tail), cnt 0
    for a tail that heads no triple; their first two columns are the
    sorted triples' relation and tail columns."""
    jg, tg = _tab_pair(how, graphs)
    assert tg.triple_tab.dtype == torch.int32
    assert tuple(tg.triple_tab.shape) == (tg.num_triples, 4)
    eq(tg.triple_tab, jg.triple_tab)
    eq(tg.triple_tab[:, :2], np.asarray(jg.triples)[:, 1:])


def test_triple_tab_of_an_empty_graph_and_tails_out_of_range(graphs):
    """No ``triple_tab`` where the JAX package builds none (no triples; a
    graph without the fat table), and a tail outside [0, N) is refused."""
    empty = tt.TriplesGraph.from_arrays(np.zeros((0, 3), np.int64),
                                        num_entities=3, device="cpu")
    assert empty.triple_tab is None and not empty.fat
    _, tg = graphs
    assert dataclasses.replace(tg, fat=False).triple_tab is None
    with pytest.raises(ValueError, match="tail ids out of range"):
        tt.TriplesGraph.from_arrays(np.array([[0, 0, 4]]), num_entities=2,
                                    device="cpu")


def test_directly_built_graph_walks_like_the_directly_built_jax_graph(
        graphs, targets):
    """A graph built from its fields walks as the JAX graph built from the
    same fields, which holds no fat table: the oracle, which clamps a target
    outside [0, N) and walks on from there."""
    jg, tg = graphs
    j_direct = trw.TriplesGraph(jg.triples, jg.relation_tail_index,
                                jg.num_entities, jg.num_triples,
                                jg.max_degree, num_relations=jg.num_relations)
    t_direct = tt.TriplesGraph(tg.triples, tg.relation_tail_index,
                               tg.num_entities, tg.num_triples, tg.max_degree,
                               tg.num_relations)
    assert j_direct.triple_tab is None
    assert not t_direct.fat and t_direct.triple_tab is None
    kw = dict(walk_length=L, seed=4, padding_idx=-1)
    eq(tt.walk_triples(t_direct, target_nodes=targets, device="cpu", **kw),
       trw.walk_triples(j_direct, target_nodes=jnp.asarray(targets), **kw))


def _row_walk_mirror(g, targets, length, seed, pad):
    """K9's fat walk on ``triple_tab`` as ``uniform_walk_triples_kernel<true>``
    runs it: the target's range from the index, then one row a step, which
    gives the output pair and the next head's range."""
    key = prng.derive_key(seed, prng.STREAM_TRIPLES)
    wid = tcommon.walker_ids(len(targets), 0, "cpu")
    tab = g.triple_tab.to(torch.int64)
    cur = torch.from_numpy(targets.astype(np.int64))
    row = g.relation_tail_index.to(torch.int64)[
        cur.clamp(0, g.num_entities - 1)]
    has = ((row[:, 0] >= 0) & (row[:, 1] >= 0) & (cur != pad) & (cur >= 0)
           & (cur < g.num_entities))
    start = row[:, 0].clamp(min=0)
    cnt = torch.where(has, row[:, 1] + 1 - start, 0)
    cols = [cur]
    for s in range(1, length + 1):
        bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(s))
        i = (start + prng.randint_from_bits(bits, cnt.clamp(min=1))).clamp(
            0, g.num_triples - 1)
        has = cnt > 0
        rel, tail, start, cnt = (torch.where(has, tab[i, c], p) for c, p in
                                 zip(range(4), (pad, pad, 0, 0)))
        cols += [rel, tail]
    return torch.stack(cols, dim=1).to(torch.int32)


@pytest.mark.parametrize("pad", ["minus_one", "N", "inside"])
def test_row_walk_mirror_equals_the_graph_entry(graphs, targets, pad):
    """A Python mirror of K9's walk on ``triple_tab`` equals the graph
    entry's walks (which equal the JAX fat engine's): dead ends, padding
    -1, N and an entity id, targets outside [0, N)."""
    _, tg = graphs
    padding_idx = {"minus_one": -1, "N": tg.num_entities,
                   "inside": tg.num_entities - 2}[pad]
    got = _row_walk_mirror(tg, targets, L, 4, padding_idx)
    eq(got, tt.walk_triples(tg, target_nodes=targets, walk_length=L, seed=4,
                            padding_idx=padding_idx, device="cpu").numpy())


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


@pytest.mark.parametrize("parity", ["odd", "even"])
@pytest.mark.parametrize("window", [1, 5])
def test_triples_windows_equal_jax_odd_and_even_width(graphs, targets, window,
                                                      parity):
    """Both generators at windows of 1 and 5 on walks of an odd width (2L +
    1, as walks come) and of an even width (a walk cut after a relation),
    padding N."""
    jg, tg = graphs
    n = tg.num_entities
    walks = tt.walk_triples(tg, target_nodes=targets[:16], walk_length=4,
                            seed=8, padding_idx=n, device="cpu")
    if parity == "even":
        walks = walks[:, :-1].contiguous()
    jw = jnp.asarray(walks.numpy())
    for ours, theirs in ((tt.to_windows_triples, trw.to_windows_triples),
                         (tt.to_windows_triples_cbow,
                          trw.to_windows_triples_cbow)):
        got = ours(walks, window, n, n, tg.triples, seed=2, device="cpu")
        want = theirs(jw, window, n, n, jg.triples, seed=2)
        assert got[0].shape[0] == 16 * ((walks.shape[1] - 1) // 2)
        for g, w in zip(got, want, strict=True):
            eq(g, w)


STAGE_WORDS = 1024  # kernels/triples.cu::kStageWords


def _slot_relation(rel, j, window):
    return rel - 2 * (j + 1) if j < window else rel + 2 * (j - window + 1)


def _cbow_mapping_mirror(walks, window, pad, plan):
    """What K10's CBOW kernel computes, by its own index arithmetic, for each
    warp of 32 threads of each group of ``plan``: each live lane's window
    index, first draw counter (the group's base mod 2^32 plus 4u) and target
    triple (its walk by multiply and shift); and the windows output as the
    warp's staged stores leave it: each lane's row put into the stage two
    slots at a time, the span written in pieces of STAGE_WORDS words."""
    num_walks, width = walks.shape
    row_words = 6 * window
    out = np.full(num_walks * plan.per_walk * row_words, -7, np.int64)
    wins, draws, tgts = [], [], []
    for g in range(plan.groups):
        walk0 = g * plan.group_walks
        here = min(num_walks - walk0, plan.group_walks) * plan.per_walk
        for u0 in range(0, here, 32):
            lanes = min(here - u0, 32)
            rows, rels = [], []
            for u in range(u0, u0 + lanes):
                wl = (u * plan.magic) >> plan.shift
                rels.append(1 + 2 * (u - wl * plan.per_walk))
                rows.append(walks[walk0 + wl])
                wins.append(g * plan.group_windows + u)
                draws.append((g * plan.group_draws + 4 * u) & 0xFFFFFFFF)
                tgts.append(rows[-1][rels[-1] - 1:rels[-1] + 2])
            span = lanes * row_words
            dst = (g * plan.group_windows + u0) * row_words
            for c0 in range(0, span, STAGE_WORDS):
                stage = np.full(STAGE_WORDS, -9, np.int64)
                for lane, (row, rel) in enumerate(zip(rows, rels)):
                    def word(k, row=row):
                        return int(row[k]) if 0 <= k < width else pad
                    for t in range(window):
                        at = lane * row_words + 6 * t
                        if at + 6 <= c0 or at >= c0 + STAGE_WORDS:
                            continue
                        a = _slot_relation(rel, 2 * t, window) - 1
                        b = _slot_relation(rel, 2 * t + 1, window) - 1
                        v = [word(a), word(a + 1), word(a + 2), word(b),
                             word(b + 1), word(b + 2)]
                        for q in range(3):
                            o = at - c0 + 2 * q
                            if 0 <= o < STAGE_WORDS:
                                stage[o:o + 2] = v[2 * q:2 * q + 2]
                n = min(span - c0, STAGE_WORDS)
                out[dst + c0:dst + c0 + n] = stage[:n]
    return (np.array(wins), np.array(draws), np.array(tgts, np.int64),
            out.reshape(-1, 2 * window, 3))


@pytest.mark.parametrize("window", [2, 11])
@pytest.mark.parametrize("group_windows", [bindings.TRIPLE_WINDOW_GROUP, 13, 7],
                         ids=["one_group", "groups_of_13", "groups_of_7"])
def test_cbow_thread_mapping_mirror_equals_jax_layout(graphs, targets,
                                                      group_windows, window):
    """A Python mirror of K10 CBOW's thread mapping and staged stores, cut
    into groups as the launch plan cuts it (several groups, odd group
    bases), at W = 2 (a warp's rows in one piece of the stage) and W = 11
    (three pieces): every window once, in JAX's order, its first draw
    counter 4 * window, and its target triple and window rows equal to
    JAX's."""
    jg, tg = graphs
    walks = tt.walk_triples(tg, target_nodes=targets[:9], walk_length=5,
                            seed=8, padding_idx=-1, device="cpu").numpy()
    plan = bindings.triple_windows_plan(*walks.shape, group_windows)
    wins, draws, tgts, rows = _cbow_mapping_mirror(walks, window, -1, plan)
    num_win = 9 * 5
    np.testing.assert_array_equal(wins, np.arange(num_win))
    np.testing.assert_array_equal(draws, 4 * np.arange(num_win))
    want_t, _, want_w = trw.to_windows_triples_cbow(
        jnp.asarray(walks), window, tg.num_entities, -1, jg.triples, seed=2)
    eq(torch.from_numpy(tgts), want_t)
    eq(torch.from_numpy(rows), want_w)
    assert plan.groups == -(-9 // max(1, min(9, group_windows // 5)))


def test_triple_windows_plan_counters_past_2_32_and_errors():
    """At 2^27 walks of 80 windows (more than 2^32 draws) the plan's groups
    keep every window index of a group below 2^31 and its draw counter at
    4 * window mod 2^32; walks without a window and grids past 65 535
    groups raise."""
    num_walks, per_walk = 2 ** 27, 80
    plan = bindings.triple_windows_plan(num_walks, 2 * per_walk + 1)
    assert plan.group_windows + 255 < 2 ** 31 and plan.groups > 1
    assert plan.group_draws == plan.group_windows * 4 % 2 ** 32
    for g, u in ((0, 0), (1, 5), (plan.groups - 1,
                                  (num_walks - (plan.groups - 1)
                                   * plan.group_walks) * per_walk - 1)):
        win = g * plan.group_windows + u
        assert (g * plan.group_draws + 4 * u) % 2 ** 32 == 4 * win % 2 ** 32
        walk = g * plan.group_walks + (u * plan.magic >> plan.shift)
        assert walk == win // per_walk
    with pytest.raises(ValueError, match="windows"):
        bindings.triple_windows_plan(3, 2)
    with pytest.raises(ValueError, match="groups"):
        bindings.triple_windows_plan(70_000, 11, group_windows=5)
    assert bindings.TRIPLE_CBOW_ROUNDS == twin.CBOW_TRIPLE_ROUNDS


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
@pytest.mark.parametrize("fat", [False, True], ids=["oracle", "fat"])
@pytest.mark.parametrize("walkers", [1, 33, 4097])
@pytest.mark.parametrize("length", [1, 7, 8, 9, 80])
def test_walk_kernel_graph_tables_equal_plain_version(length, walkers, fat):
    """K9 through a graph against its plain version, tolerance 0: the fat
    semantics on the graph's ``triple_tab`` (the next head's range from the
    rows), the oracle's on the triples of a graph without the fat table;
    dead ends, padding -1, targets outside [0, N), a walker offset, the row
    writer's edges."""
    need_cuda()
    cpu = _kernel_graph()
    g = dataclasses.replace(
        tt.TriplesGraph.from_arrays(cpu.triples, cpu.num_entities,
                                    cpu.num_relations, device="cuda"),
        fat=fat)
    assert (g.triple_tab is not None) == fat
    t = np.random.default_rng(length + walkers).integers(
        -3, g.num_entities + 3, walkers).astype(np.int32)
    got = ttw.uniform_walk_triples_graph(g, t, length, -1, 6,
                                         walker_offset=100_003)
    want = ttw.uniform_walk_triples(
        cpu.triples, cpu.relation_tail_index, t, length, -1, True, 6,
        walker_offset=100_003, fat=fat, device="cpu")
    assert got.is_cuda
    eq(got, want.numpy())


@pytest.mark.cuda
def test_graph_entry_launches_k9_on_triple_tab():
    """``walk_triples(graph)`` on the card reads ``triple_tab``, one K9
    launch a call, equal to the plain version; a table of another width,
    the raw triples under the fat semantics among them, raises."""
    need_cuda()
    cpu = _kernel_graph()
    g = tt.TriplesGraph.from_arrays(cpu.triples, cpu.num_entities,
                                    cpu.num_relations, device="cuda")
    t = np.random.default_rng(4).integers(-3, g.num_entities + 3,
                                          999).astype(np.int32)
    kw = dict(target_nodes=t, walk_length=20, seed=6, padding_idx=-1)
    before = bindings.launch_counts["uniform_walk_triples"]
    got = tt.walk_triples(g, **kw)
    assert bindings.launch_counts["uniform_walk_triples"] == before + 1
    eq(got, tt.walk_triples(cpu, device="cpu", **kw).numpy())
    for table in (g.triple_tab[:, :1].contiguous(), g.triples):
        with pytest.raises(ValueError):
            bindings.uniform_walk_triples(
                table, g.relation_tail_index,
                torch.as_tensor(t, device="cuda"), 20, (1, 2), -1, True, 0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
@pytest.mark.parametrize("case", ["ragged_count", "window_1", "window_11",
                                  "one_triple", "all_padding",
                                  "odd_group_bases", "even_width"])
def test_windows_kernel_launch_edges_equal_plain_version(case, cbow):
    """K10 against its plain version, tolerance 0, at the edges of its
    launch plans: 33 walks of 7 windows (231, a multiple of neither the
    warp nor the block), W = 1, W = 11 (a warp's CBOW rows staged in three
    pieces), a table of a single triple (every CBOW draw
    collides with some target), walks of padding alone, CBOW's launch cut
    into groups of 999 windows (odd group bases put every other group's
    rows off a 16-byte boundary), and walks of an even width."""
    need_cuda()
    g = _kernel_graph()
    n = g.num_entities
    num, length, window, table = 33, 7, 5, g.triples
    if case != "ragged_count":
        num, length = 4097, 9
    t = np.random.default_rng(17).integers(-2, n + 2, num)
    walks = ttw.uniform_walk_triples(g.triples, g.relation_tail_index, t,
                                     length, n, True, 6, fat=True, device=None)
    if case == "window_1":
        window = 1
    elif case == "window_11":
        window = 11
    elif case == "one_triple":
        table = g.triples[:1].contiguous()
    elif case == "all_padding":
        walks = torch.full_like(walks, n)
    elif case == "even_width":
        walks = walks[:, :-1].contiguous()
    groups = 999 if case == "odd_group_bases" else bindings.TRIPLE_WINDOW_GROUP
    stream = (prng.STREAM_WINDOWS_TRIPLES_CBOW if cbow
              else prng.STREAM_WINDOWS_TRIPLES_SG)
    key = prng.derive_key(3, stream)
    got = bindings.to_windows_triples(walks, window, n, table.cuda(), key,
                                      cbow, groups)
    want = twin.to_windows_triples_plain(walks.cpu(), window, n,
                                         table.cpu(), key, cbow)
    for a, b in zip(got, want, strict=True):
        assert a.is_cuda
        eq(a, b.numpy())
