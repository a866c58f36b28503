"""The port's routed edge-list and KG-triples engines, their partitions and
the edge-list cuckoo tables and Bloom filters against the JAX package
(tolerance 0: ids, bits and counts).

Each case's walks and ``info`` are held against the JAX routed engine
(``exchange="xla"``) on the 8-device virtual mesh; its runs are shared
through one module fixture because each compiles for seconds, and the
cases that differ only in their targets or filters share a compile.  The
graphs cross from the JAX package's arrays through ``convert``.  K13, K14
and K15 are held against the plain phase bodies on the card, phase by phase
(tests marked ``cuda``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_random_walk_tpu as trw
from torch_random_walk_tpu import native
from torch_random_walk_tpu.parallel import partition_v2 as jv2
from torch_random_walk_tpu.parallel.mesh import make_mesh
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.parallel import partition_v2 as tv2
from torch_random_walk_tpu_torch.utils import prng
from torch_port_util import eq, need_cuda, power_law_edges

B, D, SEED = 256, 8, 11
N = 1000  # nodes of the random KGs and of the edge list


def random_kg(n, avg_deg, seed, dead_frac):
    """(E, 3) random triples over 8 relations whose last ``dead_frac`` of
    the entities head none."""
    rng = np.random.default_rng(seed)
    t = n * avg_deg
    heads = rng.integers(0, max(int(n * (1 - dead_frac)), 1), t)
    return np.stack([heads, rng.integers(0, 8, t), rng.integers(0, n, t)], 1)


def hub_kg(n=64):
    """Every entity points at entity 0, which fans out to all of them."""
    return np.array([(h, 0, 0) for h in range(n)]
                    + [(0, 1, t) for t in range(n)])


def absorbed_kg(n=32):
    """Heads 0..7 have one triple each, to an entity without triples."""
    return np.array([(h, 2, 24 + h) for h in range(8)]), n


@pytest.fixture(scope="module")
def numpy_cuckoo():
    """The JAX package builds its cuckoo tables with its compiled native
    routine where present, which lays keys out unlike its NumPy build; the
    port follows the NumPy build, so the tables are compared with that."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "cuckoo_build", lambda *a, **k: None)
        yield


def _triples_pair(triples, n):
    jg = trw.TriplesGraph.from_arrays(triples, num_entities=n)
    tg = convert.triples_from_numpy(np.asarray(jg.triples), jg.num_entities,
                                    jg.num_relations, device="cpu")
    return (jv2.PartitionedTriples.from_triples(jg, D),
            tt.PartitionedTriples.from_triples(tg, D), jg, tg)


@pytest.fixture(scope="module")
def world(numpy_cuckoo):
    """Both packages' graphs and partitions over D shards: two random KGs
    (no dead heads, and 30 % dead), the hub KG and the all-absorbing KG;
    the power-law edge list whose last quarter of nodes has no out-edge,
    with both packages' cuckoo tables and Bloom filters."""
    out = {"kg0": _triples_pair(random_kg(N, 5, 7, 0.0), N),
           "kg3": _triples_pair(random_kg(N, 5, 7, 0.3), N),
           "hub": _triples_pair(hub_kg(), 64),
           "absorbed": _triples_pair(*absorbed_kg())}
    src, dst = power_law_edges(N, 5, seed=61)
    jel = trw.EdgeListGraph.from_arrays(np.stack([src, dst], 1), num_nodes=N)
    tel = convert.edge_list_from_numpy(np.asarray(jel.edge_list),
                                       jel.num_nodes, device="cpu")
    jpe = jv2.PartitionedEdgeList.from_edge_list(jel, D)
    tpe = tt.PartitionedEdgeList.from_edge_list(tel, D)
    out["el"] = (jpe, tpe, jel, tel)
    out["el_tables"] = (
        (jv2.build_edge_list_partition_hashes(jpe, jel),
         jv2.build_edge_list_partition_blooms(jpe, jel)),
        (tt.build_edge_list_partition_hashes(tpe, tel),
         tt.build_edge_list_partition_blooms(tpe, tel)))
    return out


def targets_for(kind, n=N, pad=N):
    """The walkers' start nodes: random (``random``), with four of them on
    the padding (``with_pad``), or B // 8 walkers (``small``)."""
    if kind == "small":
        return (np.arange(32) % n).astype(np.int32)
    t = np.random.default_rng(62).integers(0, n, B).astype(np.int32)
    if kind == "with_pad":
        t[[0, 5, 77, 200]] = pad
    return t


REAL_PAD = 7  # a padding id that is a node of the graph

# name: (engine, graph, walk length, padding, restart, schedule,
#        (pair capacity, carry, max phases) or None, targets, p, q)
RUNS = {
    "triples_dead0_serial": ("triples", "kg0", 7, N + 3, None, "serial",
                             None, "random", None, None),
    "triples_dead0.3_overlapped": ("triples", "kg3", 7, N + 3, None,
                                   "overlapped", None, "random", None, None),
    "triples_hub_carry_pool": ("triples", "hub", 6, 64, None, "serial",
                               (2, 64, 400), "hub", None, None),
    "triples_all_absorbed": ("triples", "absorbed", 5, 32, None, "serial",
                             None, "small", None, None),
    "el_restart_serial_target_at_pad": ("edge_list", "el", 10, N, True,
                                        "serial", None, "with_pad", None,
                                        None),
    "el_restart_real_pad_serial": ("edge_list", "el", 10, REAL_PAD, True,
                                   "serial", None, "with_pad", None, None),
    "el_absorbing_real_pad_overlapped_carry_pool": (
        "edge_list", "el", 10, REAL_PAD, False, "overlapped", (4, B, 0),
        "with_pad", None, None),
    "n2v_pq0.5-2_restart_serial_target_at_pad": (
        "edge_list_node2vec", "el", 10, N, True, "serial", None, "with_pad",
        0.5, 2.0),
    "n2v_pq4-0.25_absorbing_real_pad_overlapped_carry_pool": (
        "edge_list_node2vec", "el", 10, REAL_PAD, False, "overlapped",
        (4, B, 0), "with_pad", 4.0, 0.25),
}


def _targets(run):
    engine, graph, _, pad, *_, kind, _, _ = run
    if graph == "hub":
        return np.arange(64, dtype=np.int32)
    return targets_for(kind, N if graph in ("kg0", "kg3", "el") else 32, pad)


def _config(cfg, rc):
    if cfg is None:
        return None
    cap, carry, phases = cfg
    return rc(pair_capacity=cap, carry_capacity=carry, max_phases=phases)


@pytest.fixture(scope="module")
def jax_runs(world):
    """Each JAX routed run, made once, on first use; ``blooms`` False runs
    the saturated filters."""
    mesh, done = make_mesh(), {}

    def get(name, blooms=True):
        key = (name, blooms)
        if key not in done:
            engine, graph, length, pad, restart, schedule, cfg, _, p, q = \
                RUNS[name]
            jpg = world[graph][0]
            targets = jnp.asarray(_targets(RUNS[name]))
            kw = dict(seed=SEED, config=_config(cfg, jv2.RoutedConfig),
                      schedule=schedule, exchange="xla")
            if engine == "triples":
                out = jv2.walk_triples_partitioned_routed(
                    jpg, targets, mesh, length, pad, **kw)
            elif engine == "edge_list":
                out = jv2.walk_edge_list_partitioned_routed(
                    jpg, targets, mesh, length, pad, restart=restart, **kw)
            else:
                jh, jb = world["el_tables"][0]
                out = jv2.walk_edge_list_node2vec_partitioned_routed(
                    jpg, jh, targets, mesh, p, q, length, pad,
                    restart=restart, blooms=jb if blooms else None, **kw)
            done[key] = (np.asarray(out[0]), out[1])
        return done[key]

    return get


def port_run(world, name, blooms=True, **over):
    engine, graph, length, pad, restart, schedule, cfg, _, p, q = RUNS[name]
    tpg = world[graph][1]
    kw = dict(seed=SEED, config=_config(cfg, tt.RoutedConfig),
              schedule=schedule, device="cpu")
    kw.update(over)
    targets = _targets(RUNS[name])
    if engine == "triples":
        return tt.walk_triples_partitioned_routed(tpg, targets, length, pad,
                                                  **kw)
    if engine == "edge_list":
        return tt.walk_edge_list_partitioned_routed(
            tpg, targets, length, pad, restart=restart, **kw)
    th, tb = world["el_tables"][1]
    return tt.walk_edge_list_node2vec_partitioned_routed(
        tpg, th, targets, p, q, length, pad, restart=restart,
        blooms=tb if blooms else None, **kw)


CASES = [(name, blooms) for name in RUNS for blooms in (True, False)
         if blooms or RUNS[name][0] == "edge_list_node2vec"]


@pytest.mark.parametrize("name,blooms", CASES,
                         ids=[n + ("" if b else "_saturated")
                              for n, b in CASES])
def test_routed_family_equals_jax(world, jax_runs, name, blooms):
    """Walks and every ``info`` count equal the JAX routed engine's: triples
    without and with dead heads, a hub head whose pair capacity queues the
    walkers in the carry pool, every walk absorbed; the uniform and biased
    edge-list engines with restart and absorbing, the padding outside and
    inside [0, N), targets on the padding, p, q = (0.5, 2) and (4, 0.25),
    Bloom filters and saturated ones; both schedules."""
    got, info = port_run(world, name, blooms)
    jw, jinfo = jax_runs(name, blooms)
    eq(got, jw)
    assert info == jinfo
    assert info["overflow_dropped"] == 0 and info["terminated"] == \
        got.shape[0]


def test_the_cases_reach_what_they_name(world, jax_runs):
    """Walkers restart more than once in a walk, the absorbing runs end
    walks early, the all-absorbed run logs few positions, and the Bloom
    filters save records."""
    walks = jax_runs("el_restart_serial_target_at_pad")[0]
    assert ((walks[:, 1:] == N).sum(1) >= 2).any()  # restarts cycle
    absorbing = jax_runs("el_absorbing_real_pad_overlapped_carry_pool")[0]
    assert (absorbing[:, -1] == REAL_PAD).mean() > 0.2
    info = jax_runs("triples_all_absorbed")[1]
    assert info["log_entries"] < 32 * 5 and info["terminated"] == 32
    for name in ("n2v_pq0.5-2_restart_serial_target_at_pad",
                 "n2v_pq4-0.25_absorbing_real_pad_overlapped_carry_pool"):
        assert (jax_runs(name)[1]["exchanged_records"]
                < jax_runs(name, False)[1]["exchanged_records"])


@pytest.mark.parametrize("engine", ["triples", "edge_list",
                                    "edge_list_node2vec"])
def test_routed_family_equals_the_single_device_walk(world, engine):
    """With the padding outside [0, N) and every target inside it (the bench
    families' setting), the routed walks equal the port's single-device
    walks on the same graph (the fat semantics), as the JAX package's do."""
    t = targets_for("random")
    if engine == "triples":
        tpg, tg = world["kg3"][1], world["kg3"][3]
        got = tt.walk_triples_partitioned_routed(tpg, t, 7, N, seed=SEED,
                                                 device="cpu")[0]
        want = tt.walk_triples(tg, target_nodes=t, walk_length=7,
                               padding_idx=N, seed=SEED, device="cpu")
    else:
        tpg, tel = world["el"][1], world["el"][3]
        pq = (0.5, 2.0) if engine == "edge_list_node2vec" else (1.0, 1.0)
        if engine == "edge_list":
            got = tt.walk_edge_list_partitioned_routed(
                tpg, t, 10, N, seed=SEED, device="cpu")[0]
        else:
            th, tb = world["el_tables"][1]
            got = tt.walk_edge_list_node2vec_partitioned_routed(
                tpg, th, t, *pq, 10, N, seed=SEED, blooms=tb,
                device="cpu")[0]
        want = tt.walk_edge_list(tel, target_nodes=t, p=pq[0], q=pq[1],
                                 walk_length=10, seed=SEED, padding_idx=N,
                                 device="cpu")
    eq(got, want.numpy())


@pytest.mark.parametrize("name", ["triples_hub_carry_pool",
                                  "el_absorbing_real_pad_overlapped_carry_pool",
                                  "n2v_pq4-0.25_absorbing_real_pad_overlapped_"
                                  "carry_pool"])
def test_a_small_pair_capacity_fills_the_carry_pool(world, name):
    """The carry-pool runs do queue walkers: in some phase some shard of
    every pipeline carries records."""
    engine, graph, length, pad, restart, schedule, cfg, _, p, q = RUNS[name]
    tpg = world[graph][1]
    targets = torch.from_numpy(_targets(RUNS[name]))
    routing = None
    if engine == "edge_list_node2vec":
        routing = tv2.node2vec_routing(tpg, p, q, 6, *world["el_tables"][1])
    run = tv2.RoutedWalk(
        tpg, targets, length, (0, 0), tt.RoutedConfig.resolve(
            _config(cfg, tt.RoutedConfig), targets.shape[0], D, length),
        schedule, "plain", node2vec=routing, engine=engine, padding=pad,
        restart=bool(restart))
    run.start()
    carried = run.live[:, :, 1].sum(1)
    while run.inflight() > 0:
        run.phase()
        carried = torch.maximum(carried, run.live[:, :, 1].sum(1))
    assert bool((carried > 0).all())


@pytest.mark.parametrize("engine", ["triples", "edge_list",
                                    "edge_list_node2vec"])
def test_walk_length_zero_and_divisibility(world, engine):
    """L = 0 returns the target column and the JAX ``info`` (nothing is
    routed); a batch that D does not divide raises as in JAX."""
    mesh = make_mesh()
    graph = "kg0" if engine == "triples" else "el"
    jpg, tpg = world[graph][:2]
    t = targets_for("random")
    jh, jb = world["el_tables"][0]
    th, tb = world["el_tables"][1]
    if engine == "triples":
        want = jv2.walk_triples_partitioned_routed(jpg, jnp.asarray(t), mesh,
                                                   0, N)
        got = tt.walk_triples_partitioned_routed(tpg, t, 0, N, device="cpu")
        bad = lambda: tt.walk_triples_partitioned_routed(  # noqa: E731
            tpg, t[:13], 4, N, device="cpu")
    elif engine == "edge_list":
        want = jv2.walk_edge_list_partitioned_routed(jpg, jnp.asarray(t),
                                                     mesh, 0, N)
        got = tt.walk_edge_list_partitioned_routed(tpg, t, 0, N, device="cpu")
        bad = lambda: tt.walk_edge_list_partitioned_routed(  # noqa: E731
            tpg, t[:13], 4, N, device="cpu")
    else:
        want = jv2.walk_edge_list_node2vec_partitioned_routed(
            jpg, jh, jnp.asarray(t), mesh, 0.5, 2.0, 0, N)
        got = tt.walk_edge_list_node2vec_partitioned_routed(
            tpg, th, t, 0.5, 2.0, 0, N, device="cpu")
        bad = lambda: tt.walk_edge_list_node2vec_partitioned_routed(  # noqa: E731
            tpg, th, t[:13], 0.5, 2.0, 4, N, device="cpu")
    eq(got[0], want[0])
    assert got[1] == want[1]
    with pytest.raises(ValueError, match="divisible"):
        bad()


def test_truncated_phase_budget_raises(world):
    with pytest.raises(RuntimeError, match="routed triples walk incomplete"):
        port_run(world, "triples_dead0_serial",
                 config=tt.RoutedConfig(pair_capacity=128, max_phases=5))
    with pytest.raises(RuntimeError,
                       match="routed edge-list-node2vec walk incomplete"):
        port_run(world, "n2v_pq0.5-2_restart_serial_target_at_pad",
                 config=tt.RoutedConfig(pair_capacity=128, max_phases=5))


def test_biased_edge_list_engine_checks_its_tables(world):
    tpg = world["el"][1]
    th, tb = world["el_tables"][1]
    t = targets_for("random")
    with pytest.raises(ValueError, match="hashes must be"):
        tt.walk_edge_list_node2vec_partitioned_routed(
            tpg, None, t, 0.5, 2.0, 4, N, device="cpu")
    with pytest.raises(ValueError, match="blooms must be"):
        tt.walk_edge_list_node2vec_partitioned_routed(
            tpg, th, t, 0.5, 2.0, 4, N, blooms=tb[:, :-1], device="cpu")
    with pytest.raises(ValueError, match="padding_idx"):
        tt.walk_edge_list_partitioned_routed(tpg, t, 4, 2 ** 31,
                                             device="cpu")


@pytest.mark.parametrize("graph", ["kg3", "hub", "absorbed", "el"])
def test_partitions_equal_jax(world, graph):
    jpg, tpg = world[graph][:2]
    if graph == "el":
        jmeta, jpay = jpg.node_meta_shards, jpg.tail_shards
        assert tpg.num_nodes == jpg.num_nodes
    else:
        jmeta, jpay = jpg.node_meta_shards, jpg.rel_tail_shards
        assert tpg.num_nodes == jpg.num_entities
    assert (tpg.num_shards, tpg.shard_nodes) == (jpg.num_shards,
                                                  jpg.shard_nodes
                                                  if graph == "el"
                                                  else jpg.shard_entities)
    for d in range(D):
        eq(tpg.node_meta[d], jmeta[d])
        eq(tpg.col[d], jpay[d])


def test_edge_list_tables_equal_jax(world):
    (jh, jb), (th, tb) = world["el_tables"]
    eq(th[0], np.asarray(jh[0]).view(np.int32))
    eq(th[1], np.asarray(jh[1]).view(np.int32))
    assert th[2] == jh[2]
    eq(tb, np.asarray(jb).view(np.int32))


@pytest.mark.parametrize("n,shards", [(10, 8), (37, 3), (200, 16)],
                         ids=["empty_trailing_shards", "ragged", "D16"])
def test_edge_list_partition_and_tables_at_other_shapes(numpy_cuckoo, n,
                                                        shards):
    """Shards past the last node (empty meta, payload and tables), a ragged
    last shard, and sixteen shards, bit for bit."""
    src, dst = power_law_edges(n, 4, seed=n)
    jel = trw.EdgeListGraph.from_arrays(np.stack([src, dst], 1), num_nodes=n)
    tel = convert.edge_list_from_numpy(np.asarray(jel.edge_list), n,
                                       device="cpu")
    jpe = jv2.PartitionedEdgeList.from_edge_list(jel, shards)
    tpe = tt.PartitionedEdgeList.from_edge_list(tel, shards)
    assert tpe.shard_nodes == jpe.shard_nodes
    for d in range(shards):
        eq(tpe.node_meta[d], jpe.node_meta_shards[d])
        eq(tpe.col[d], jpe.tail_shards[d])
    jh = jv2.build_edge_list_partition_hashes(jpe, jel)
    th = tt.build_edge_list_partition_hashes(tpe, tel)
    eq(th[0], np.asarray(jh[0]).view(np.int32))
    eq(th[1], np.asarray(jh[1]).view(np.int32))
    assert th[2] == jh[2]
    eq(tt.build_edge_list_partition_blooms(tpe, tel),
       np.asarray(jv2.build_edge_list_partition_blooms(jpe, jel))
       .view(np.int32))


# --- K13, K14 and K15 against the plain bodies (on the card only) ---------------

# engine: (stream, restart, p, q, saturated filters)
CARD_ENGINES = {
    "K13": ("triples", prng.STREAM_TRIPLES, False, None, None, False),
    "K14_restart": ("edge_list", prng.STREAM_EDGE_UNIFORM, True, None, None,
                    False),
    "K14_absorbing": ("edge_list", prng.STREAM_EDGE_UNIFORM, False, None,
                      None, False),
    "K15_restart": ("edge_list_node2vec", prng.STREAM_EDGE_BIASED, True, 0.5,
                    2.0, False),
    "K15_absorbing_saturated": ("edge_list_node2vec",
                                prng.STREAM_EDGE_BIASED, False, 4.0, 0.25,
                                True),
}
CARD_SHARDS = {"D1": 1, "D2": 2, "D16": 16}
CARD_N = 3000


def card_graphs(nshards, engine, real_pad=False):
    """The power-law graph of 3 000 nodes whose last quarter has no
    out-edge, on the card, as the engine's family, partitioned; with its
    padding (a node of the graph where ``real_pad``) and tables."""
    src, dst = power_law_edges(CARD_N, 6, seed=65)
    pad = REAL_PAD if real_pad else CARD_N
    if engine == "triples":
        rels = (src * 2654435761) % 16
        g = tt.TriplesGraph.from_arrays(np.stack([src, rels, dst], 1),
                                        num_entities=CARD_N, device="cuda")
        return tt.PartitionedTriples.from_triples(g, nshards), pad, None
    g = tt.EdgeListGraph.from_arrays(np.stack([src, dst], 1),
                                     num_nodes=CARD_N, device="cuda")
    pg = tt.PartitionedEdgeList.from_edge_list(g, nshards)
    return pg, pad, (tt.build_edge_list_partition_hashes(pg, g),
                     tt.build_edge_list_partition_blooms(pg, g))


def card_walk(kind, case, schedule, body, walk_length=12):
    engine, stream, restart, p, q, saturated = CARD_ENGINES[kind]
    nshards = CARD_SHARDS.get(case, 8)
    pg, pad, tables = card_graphs(nshards, engine, case == "real_pad")
    walkers = 1024
    cfg = {"carry_pool": tt.RoutedConfig(pair_capacity=3,
                                         carry_capacity=walkers),
           "overflow": tt.RoutedConfig(pair_capacity=2, carry_capacity=5),
           }.get(case)
    length = 1 if case == "L1" else walk_length
    resolved = tt.RoutedConfig.resolve(cfg, walkers, nshards, length)
    routing = None
    if tables is not None and engine == "edge_list_node2vec":
        hashes, blooms = tables
        routing = tv2.node2vec_routing(pg, p, q, 6, hashes,
                                       None if saturated else blooms)
        if cfg is None:
            resolved = tv2._biased_phase_budget(resolved, length, 6)
    t = np.random.default_rng(66).integers(0, CARD_N, walkers)
    t[[1, 100]] = pad
    t = torch.as_tensor(t, dtype=torch.int32, device="cuda")
    return tv2.RoutedWalk(pg, t, length, prng.derive_key(SEED, stream),
                          resolved, schedule, body, node2vec=routing,
                          engine=engine, padding=pad, restart=restart)


def _same_state(a, b):
    a, b = a.state(), b.state()
    assert a.keys() == b.keys()
    for name in a:
        for x, y in zip(a[name] if isinstance(a[name], list) else [a[name]],
                        b[name] if isinstance(b[name], list) else [b[name]],
                        strict=True):
            eq(x, y.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("case", ["D1", "D2", "D8", "D16", "L1", "carry_pool",
                                  "real_pad", "overflow"])
@pytest.mark.parametrize("kind", list(CARD_ENGINES))
def test_family_kernels_equal_plain_body_phase_by_phase(kind, case,
                                                        schedule):
    """K13, K14 (restart and absorbing) and K15 (restart, p=0.5 q=2 with
    Bloom filters; absorbing, p=4 q=0.25 with saturated filters) against
    the plain bodies on the card, the whole state after phase 0 and after
    every phase: D = 1, 2, 8, 16, L = 1, a filling carry pool, the padding
    a node of the graph, targets on the padding, an overflowing pool (both
    raise alike); then the public entry point's walks, info and launches."""
    need_cuda()
    runs = [card_walk(kind, case, schedule, body)
            for body in ("kernel", "plain")]
    for r in runs:
        r.start()
    _same_state(*runs)
    while runs[0].inflight() > 0 and runs[0].phases < runs[0].max_phases:
        assert runs[0].inflight() == runs[1].inflight()
        for r in runs:
            r.phase()
        _same_state(*runs)
    got = []
    for r in runs:
        try:
            got.append(r.result())
        except RuntimeError as err:
            got.append(str(err))
    if case == "overflow":
        assert all(isinstance(x, str) and "incomplete" in x for x in got)
        assert got[0] == got[1]
        return
    (kw, ki), (pw, pi) = got
    eq(kw, pw.cpu().numpy())
    assert ki == pi and ki["terminated"] == 1024
    run = runs[0]
    kernel = bindings.ROUTED_ENGINES[run.engine].kernel
    before = bindings.launch_counts[kernel]
    again = card_walk(kind, case, schedule, "kernel")
    walks, info = again.run()
    eq(walks, kw.cpu().numpy())
    assert info == ki
    pipes = 2 if schedule == "overlapped" else 1  # phase 0: one a pipeline
    k = tv2.PHASES_PER_READ
    assert bindings.launch_counts[kernel] - before == \
        -(-info["phases"] // k) * k + pipes


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("kind", ["K13", "K14_restart", "K15_restart"])
def test_family_batched_loop_equals_one_phase_a_read(monkeypatch, kind,
                                                     schedule):
    """The family legs' final state, info and phase calls with k = 3 and 8
    phases a read, eager, and with k = 4 and 8 replayed as CUDA graphs,
    equal those of the loop that reads after every phase."""
    need_cuda()
    out = {}
    for k, graph in ((1, False), (3, False), (8, False), (4, True), (8, True)):
        monkeypatch.setattr(tv2, "PHASES_PER_READ", k)
        monkeypatch.setattr(tv2, "GRAPH_SCHEDULES",
                            tv2.SCHEDULES if graph else ())
        run = card_walk(kind, "D8", schedule, "kernel")
        kernel = bindings.ROUTED_ENGINES[run.engine].kernel
        before = bindings.launch_counts[kernel]
        info = run.run()[1]
        out[k, graph] = (info, run, run.enqueued,
                         bindings.launch_counts[kernel] - before)
    want, base, _, _ = out[1, False]
    pipes = 2 if schedule == "overlapped" else 1
    for (k, graph), (info, run, enqueued, calls) in out.items():
        assert info == want
        _same_state(run, base)
        assert enqueued == -(-want["phases"] // k) * k
        assert calls == enqueued + pipes


@pytest.mark.cuda
def test_family_phase_kernels_refuse_bad_launches():
    need_cuda()
    run = card_walk("K14_restart", "D2", "serial", "kernel")
    launch = run.pipes[0].launch
    with pytest.raises(ValueError, match="packed for K14, not K13"):
        bindings.routed_triples_phase(launch, 0)
    with pytest.raises(ValueError, match="packed for K14, not K11"):
        bindings.routed_uniform_phase(launch, 0)
    with pytest.raises(RuntimeError, match="launch failed"):  # pool 2
        bindings.routed_edge_list_phase(launch, 2)
    pipe = run.pipes[0]
    shards = [bindings.RoutedShard(
        meta=run.pgraph.node_meta[s], col=run.pgraph.col[s],
        walks=run.walks[s], inbox=pipe.inbox[s], outbox=pipe.outbox[s],
        carry=pipe.carry[s], stage=run._stage[s], code=run._code[s],
        hist=run._hist[s], pool_count=pipe.pool_count[s], hash_table=None,
        bloom=None, salt=0) for s in range(2)]
    with pytest.raises(ValueError, match="stats must be"):  # (D, 3)
        bindings.routed_phase_launch(
            shards, run.stats[:, :3].contiguous(), run.live[0],
            run.live.view(-1), run._counter,
            shard_nodes=run.pgraph.shard_nodes, blk=run.blk,
            walk_length=run.walk_length, cap=run.cap, ccap=run.ccap,
            key=(1, 2), engine="edge_list", padding=CARD_N)
    with pytest.raises(ValueError, match="takes a node2vec routing"):
        bindings.routed_phase_launch(
            shards, run.stats, run.live[0], run.live.view(-1), run._counter,
            shard_nodes=run.pgraph.shard_nodes, blk=run.blk,
            walk_length=run.walk_length, cap=run.cap, ccap=run.ccap,
            key=(1, 2), engine="edge_list_node2vec", padding=CARD_N)
