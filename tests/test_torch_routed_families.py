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


# --- K14's and K15's batch kernel, mirrored on the CPU ------------------------

TILE = bindings.ROUTED_TILE
PIECE = 256 * 4  # exchange.cuh kPieceElems: words a block copies at once


def box_counts(pipe):
    """(D src, D dst) records of each outbox chunk, which stand at its front
    (the batch kernel's flow counts)."""
    live = pipe.outbox[..., 0] != tv2._SENTINEL
    counts = live.sum(-1)
    assert bool((live == (torch.arange(live.shape[-1])
                          < counts[..., None])).all())
    return counts


def mirror_batch(run, n):
    """One launch of the batch kernel on a plain-body walk, step by step in
    its barrier order: before each phase every block reads the live counts
    (nothing in flight: all stop) and the phase counter adds one; (a) the
    exchanged pipeline X copies only the live prefix of each chunk (the
    rest of its inboxes keeps what earlier phases left); (b) the processed
    pipeline Y's body reads only the records its chunks took in, by the
    counts of its exchange; (c) its compaction fills the other carry pool,
    which becomes the live one; under ``overlapped`` the roles then swap.
    The pipelines start as the host passes them (live pools, and X = the
    pipeline ``enqueued % 2``) and are left so; returns (phases run, each
    pipeline's live pool at the end)."""
    d, cap = run.nshards, run.cap
    two = len(run.pipes) == 2
    start = [pipe.parity for pipe in run.pipes]
    y = 1 - run.enqueued % 2 if two else 0
    ran = 0
    while ran < n and int(run.live.sum()) > 0:
        run._counter += 1
        x = 1 - y if two else y
        px, py = run.pipes[x], run.pipes[y]
        box_x, box_y = box_counts(px), box_counts(py)
        for src in range(d):
            for dst in range(d):
                c = int(box_x[src, dst])
                px.inbox[dst, src, :c] = px.outbox[src, dst, :c]
        took = torch.arange(cap) < box_y.T[:, :, None]  # (shard, src, slot)
        run.process(py, took.reshape(-1).nonzero()[:, 0])
        py.carry[:, 1 - py.parity] = py.carry[:, py.parity]
        py.parity ^= 1
        y = x
        ran += 1
    final = [pipe.parity for pipe in run.pipes]
    for pipe, parity in zip(run.pipes, start):
        pipe.parity = parity
    return ran, final


def family_run(world, engine, nshards, length, pad, restart, schedule,
               config, targets, p=None, q=None, blooms=True, graph="kg3"):
    """A plain-body RoutedWalk of a family engine at ``nshards`` shards,
    configured as the entry point resolves ``config``: the edge-list
    engines on ``world``'s edge list, the triples engine on its KG
    ``graph``."""
    targets = torch.as_tensor(targets, dtype=torch.int32)
    cfg = tt.RoutedConfig.resolve(config, targets.shape[0], nshards, length)
    if engine == "triples":
        tpt = (world[graph][1] if nshards == D else
               tt.PartitionedTriples.from_triples(world[graph][3], nshards))
        return tv2.RoutedWalk(tpt, targets, length,
                              prng.derive_key(SEED, prng.STREAM_TRIPLES), cfg,
                              schedule, "plain", engine=engine, padding=pad)
    tel = world["el"][3]
    if nshards == D:
        tpe, (hashes, blm) = world["el"][1], world["el_tables"][1]
    else:
        tpe = tt.PartitionedEdgeList.from_edge_list(tel, nshards)
        hashes = tt.build_edge_list_partition_hashes(tpe, tel)
        blm = tt.build_edge_list_partition_blooms(tpe, tel)
    routing, stream = None, prng.STREAM_EDGE_UNIFORM
    if engine == "edge_list_node2vec":
        if config is None or config.max_phases <= 0:
            cfg = tv2._biased_phase_budget(cfg, length, 6)
        routing = tv2.node2vec_routing(tpe, p, q, 6, hashes,
                                       blm if blooms else None)
        stream = prng.STREAM_EDGE_BIASED
    return tv2.RoutedWalk(tpe, targets, length,
                          prng.derive_key(SEED, stream), cfg, schedule,
                          "plain", node2vec=routing, engine=engine,
                          padding=pad, restart=bool(restart))


def mirrored(run, cap=None):
    """``run`` driven by its own batch loop (``RoutedWalk.run`` and
    ``_run_batch``), each launch the mirror of the batch kernel, with at
    most ``cap`` phases a launch; the pipelines get the kernels' two carry
    pools.  Returns (its result or the error it raised, the launches as
    (phases asked, phases run, live pools after))."""
    for pipe in run.pipes:
        pipe.carry = pipe.carry.repeat(1, 2, 1, 1)
    launches = []

    def launch(n):
        ran, final = mirror_batch(run, n if cap is None else min(n, cap))
        launches.append((n, ran, final))

    run._batch = "mirror"
    run._launch_batch = launch
    try:
        out = run.run()
    except RuntimeError as err:
        out = str(err)
    assert [pipe.parity for pipe in run.pipes] == launches[-1][2]
    assert run.enqueued == sum(ran for _, ran, _ in launches)
    return out, launches


def _same_result(got, want):
    if isinstance(want, str):
        assert got == want
        return
    eq(got[0], np.asarray(want[0]))
    assert got[1] == want[1]


# (run of RUNS, saturated filters, phases a launch at most)
MIRROR_JAX_CASES = [
    ("triples_dead0_serial", False, None),
    ("triples_dead0.3_overlapped", False, 3),
    ("triples_hub_carry_pool", False, 5),
    ("triples_all_absorbed", False, None),
    ("el_restart_serial_target_at_pad", False, None),
    ("el_absorbing_real_pad_overlapped_carry_pool", False, 3),
    ("n2v_pq0.5-2_restart_serial_target_at_pad", False, 5),
    ("n2v_pq0.5-2_restart_serial_target_at_pad", True, None),
    ("n2v_pq4-0.25_absorbing_real_pad_overlapped_carry_pool", False, None),
]


@pytest.mark.parametrize("name,saturated,cap", MIRROR_JAX_CASES,
                         ids=[f"{n}{'_saturated' if s else ''}_n{c or 'all'}"
                              for n, s, c in MIRROR_JAX_CASES])
def test_batch_schedule_mirror_equals_jax(world, jax_runs, name, saturated,
                                          cap):
    """At D = 8 the batch kernel's schedule, mirrored on the plain pieces
    and driven by the walk's own batch loop, gives the JAX routed engine's
    walks and every ``info`` count (triples without and with dead heads, a
    hub whose carry pool fills, every walk absorbed; edge lists with restart
    and absorbing, biased with Bloom filters and saturated; both schedules):
    in one launch for the whole budget, which stops early once nothing is
    in flight, and in launches of 3 and 5 phases, the roles swapping inside
    and across launches."""
    engine, graph, length, pad, restart, schedule, cfg, _, p, q = RUNS[name]
    run = family_run(world, engine, D, length, pad, restart, schedule,
                     _config(cfg, tt.RoutedConfig), _targets(RUNS[name]),
                     p, q, not saturated, graph)
    got, launches = mirrored(run, cap)
    jw, jinfo = jax_runs(name, not saturated)
    _same_result(got, (jw, jinfo))
    asked, ran, _ = launches[-1]
    assert ran < asked  # the last launch stopped once nothing was in flight
    if cap is not None:
        assert len(launches) > 2 and all(r == cap for _, r, _ in
                                          launches[:-1])


# (engine, shards, schedule, restart, saturated filters, phases a launch at
# most, pair capacity and phase budget, or None)
MIRROR_CASES = [
    ("edge_list", 1, "serial", True, False, None, None),
    ("edge_list", 2, "overlapped", False, False, 4, (8, 0)),
    ("edge_list_node2vec", 2, "overlapped", True, False, None, None),
    ("edge_list_node2vec", 1, "serial", True, True, 3, None),
    ("edge_list", 2, "serial", True, False, None, (128, 5)),
    ("edge_list_node2vec", 1, "overlapped", False, False, 2, (128, 9)),
    ("triples", 1, "serial", False, False, None, None),
    ("triples", 2, "overlapped", False, False, 3, None),
    ("triples", 2, "serial", False, False, 2, (128, 5)),
]


@pytest.mark.parametrize(
    "engine,nshards,schedule,restart,saturated,cap,cfg", MIRROR_CASES,
    ids=[f"{e}_D{d}_{s}"
         f"{'' if e == 'triples' else '_restart' if r else '_absorbing'}"
         f"{'_saturated' if f else ''}_n{c or 'all'}"
         f"{'_budget' if g and g[1] else ''}"
         for e, d, s, r, f, c, g in MIRROR_CASES])
def test_batch_schedule_mirror_equals_the_plain_run(world, engine, nshards,
                                                    schedule, restart,
                                                    saturated, cap, cfg):
    """At D = 1 and 2 the mirrored batch schedule gives the plain run's
    walks and every ``info`` count, its state at the end too (the triples
    engine on the KG with dead heads); a budget cut short (5 and 9 phases,
    in launches of 2 and of the whole budget) raises as the plain run
    does."""
    t = targets_for("with_pad")
    config = None if cfg is None else tt.RoutedConfig(
        pair_capacity=cfg[0], max_phases=cfg[1])
    args = (world, engine, nshards, 10, N, restart, schedule, config, t,
            0.5, 2.0, not saturated)
    plain = family_run(*args)
    try:
        want = plain.run()
    except RuntimeError as err:
        want = str(err)
    run = family_run(*args)
    got, launches = mirrored(run, cap)
    _same_result(got, want)
    if cfg is not None and cfg[1]:
        assert isinstance(want, str) and "incomplete" in want
        assert run.phases == cfg[1] * (2 if schedule == "overlapped" else 1)
    a, b = run.state(), plain.state()
    for key in ("walks", "stats", "live"):
        eq(a[key], b[key].numpy())


def block_prefix(values):
    """routed_families.cu block_prefix: [0, v0, v0 + v1, ...]."""
    return np.concatenate([[0], np.cumsum(values)]).astype(np.int64)


def find_segment(off, k):
    """routed_families.cu find_segment: the s with off[s] <= k < off[s + 1],
    by the same bisection."""
    lo, hi = 0, len(off) - 1
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if off[mid] <= k:
            lo = mid
        else:
            hi = mid
    return lo


def tiles(n):
    return -(-n // TILE)


def batch_items(box, carried, width, vec, grid, serial):
    """Every block's items in one phase of the batch kernel, as its
    grid-stride loops take them (routed_batch): the exchange's pieces of
    each chunk's live prefix, the body's tiles of the records each shard
    took in, with the (source, slot) each thread reads, the outbox reset's
    tiles with the (destination, slot) each thread resets, and the
    compaction's stage tiles (at least the keeper) and pool tiles.  ``box``
    is the flow counts (source, destination).  Returns a list of visits."""
    nd = box.shape[0]
    took, out = box.sum(0), box.sum(1)
    work = block_prefix([tiles(i) + tiles(o) for i, o in zip(took, out)])
    comp = block_prefix([max(tiles(i), 1) + tiles(c)
                         for i, c in zip(took, carried)])
    words = int(box.max()) * width
    elems = -(-words // 4) if vec else words
    n_ex = nd * nd * -(-elems // PIECE)
    visits = []
    for b in range(grid):
        first = 0 if serial else n_ex
        steps = ([range(b, n_ex, grid)] if serial else []) + [
            range(b, first + int(work[nd]), grid)]
        for step in steps:
            for v in step:
                if v < first or (serial and step is steps[0]):
                    pair, piece = v % (nd * nd), v // (nd * nd)
                    src, dst = divmod(pair, nd)
                    live = int(box[src, dst]) * width
                    live = -(-live // 4) if vec else live
                    if piece * PIECE < live:
                        visits.append(("exchange", src, dst, piece))
                    continue
                my = find_segment(work, v - first)
                t = v - first - int(work[my])
                if t < tiles(int(took[my])):
                    seg = block_prefix(box[:, my])
                    for k in range(t * TILE, min((t + 1) * TILE,
                                                 int(took[my]))):
                        src = find_segment(seg, k)
                        visits.append(("body", my, src, k - int(seg[src])))
                else:
                    seg = block_prefix(box[my])
                    q0 = (t - tiles(int(took[my]))) * TILE
                    for q in range(q0, min(q0 + TILE, int(out[my]))):
                        d = find_segment(seg, q)
                        visits.append(("reset", my, d, q - int(seg[d])))
        for v in range(b, int(comp[nd]), grid):
            my = find_segment(comp, v)
            t = v - int(comp[my])
            stage = max(tiles(int(took[my])), 1)
            visits.append(("stage", my, t) if t < stage
                          else ("pool", my, t - stage))
    return visits


@pytest.mark.parametrize("grid", [1, 7, 264])
@pytest.mark.parametrize("width,vec,serial", [(4, True, True),
                                              (15, False, False),
                                              (15, True, True)],
                         ids=["K14_serial", "K15_overlapped",
                              "K15_serial_vec"])
def test_batch_grid_stride_visits_each_item_once(grid, width, vec, serial):
    """The batch kernel's grid-stride loops over virtual tiles visit each
    exchange piece of a live prefix, each record a shard took in (as
    source chunk and slot), each outbox slot that was live, and each
    compaction tile (every shard's keeper, its stage tiles and its live
    pool's tiles) exactly once, for grids of 1, 7 and 264 blocks; shards
    with no record in or out, and empty chunks, are passed over."""
    rng = np.random.default_rng(grid + width)
    nd, cap = 8, 300
    box = rng.integers(0, cap + 1, (nd, nd))
    box[rng.random((nd, nd)) < 0.2] = 0
    box[:, 3] = 0  # a shard that takes nothing in
    box[5] = 0  # and one that sent nothing
    carried = rng.integers(0, 700, nd)
    carried[2] = 0
    visits = batch_items(box, carried, width, vec, grid, serial)
    assert len(visits) == len(set(visits))
    want = set()
    for src in range(nd):
        for dst in range(nd):
            live = int(box[src, dst]) * width
            live = -(-live // 4) if vec else live
            want |= {("exchange", src, dst, p)
                     for p in range(-(-live // PIECE))}
            want |= {("body", dst, src, j) for j in range(box[src, dst])}
            want |= {("reset", src, dst, j) for j in range(box[src, dst])}
    for my in range(nd):
        want |= {("stage", my, t) for t in range(max(tiles(box[:, my].sum()),
                                                     1))}
        want |= {("pool", my, t) for t in range(tiles(carried[my]))}
    assert set(visits) == want


@pytest.mark.parametrize("engine", ["triples", "edge_list",
                                    "edge_list_node2vec"])
def test_live_prefix_body_stages_as_every_slot(world, engine):
    """Mid-walk (a carry pool filling, D = 8), a body that reads only each
    inbox chunk's live prefix, staging its departures at the records'
    index, gives the same departures in the same order, the same totals by
    (stream, destination), and through the kernels' tiled compaction (its
    mirror) the same outbox, carry pool and counts as one that reads every
    slot and stages at the slot's index."""
    from test_torch_routed_node2vec import (
        compaction_mirror, pool_histogram, stage_histogram)
    run = family_run(world, engine, D, 10, N, True, "serial",
                     tt.RoutedConfig(pair_capacity=6, carry_capacity=B),
                     targets_for("with_pad"), 0.5, 2.0, graph="kg0")
    run.start()
    for _ in range(3):
        run.phase()
    pipe = run.pipes[0]
    box = box_counts(pipe)
    pipe.exchange()
    nd, cap, width = run.nshards, run.cap, run.width
    streams = len(range(bindings.ROUTED_STREAMS[width]))
    body = getattr(run, f"_{engine}_body")

    def staged(slots):
        """Each slot's departure: (records, codes), -1 for none."""
        run._my = slots // (nd * cap)
        recs = pipe.inbox.view(-1, width)[slots]
        code = torch.full((slots.shape[0],), -1, dtype=torch.int64)
        stage = torch.zeros_like(recs)
        for k, (r, dst, valid) in enumerate(body(recs)):
            assert not bool((valid & (code >= 0)).any())
            code = torch.where(valid, (k << 16) | dst, code)
            stage[valid] = r[valid]
        return stage.numpy().astype(np.int64), code.numpy()

    every = torch.arange(nd * nd * cap)
    took = torch.arange(cap) < box.T[:, :, None]
    prefix = took.reshape(-1).nonzero()[:, 0]
    full_stage, full_code = staged(every)
    live_stage, live_code = staged(prefix)
    pool = pipe.pool.numpy().astype(np.int64)
    carried = pipe.live[:, 1].numpy()
    assert int(carried.sum()) > 0
    ccap = pool.shape[1]
    per_shard = box.sum(0).numpy()
    at = block_prefix(per_shard)
    for my in range(nd):
        fs = full_stage[my * nd * cap:(my + 1) * nd * cap]
        fc = full_code[my * nd * cap:(my + 1) * nd * cap]
        ls, lc = live_stage[at[my]:at[my + 1]], live_code[at[my]:at[my + 1]]
        np.testing.assert_array_equal(fc[fc >= 0], lc[lc >= 0])
        np.testing.assert_array_equal(fs[fc >= 0], ls[lc >= 0])
        fh = stage_histogram(fc, streams, nd)
        lh = stage_histogram(lc, streams, nd)
        np.testing.assert_array_equal(fh.sum(0), lh.sum(0))
        count = pool_histogram(pool[my], int(carried[my]), nd, ccap)
        got = compaction_mirror(pool[my], count, ls, lc, lh, cap, ccap, nd)
        want = compaction_mirror(pool[my], count, fs, fc, fh, cap, ccap, nd)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_routed_entry_points_need_a_card_or_the_cpu(world):
    """Without a card every routed entry point raises unless it is given
    device="cpu"; none falls back to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: the entry points run on it")
    tpe, tpt = world["el"][1], world["kg0"][1]
    th, tb = world["el_tables"][1]
    t = targets_for("random")
    for call in (
            lambda **k: tt.walk_triples_partitioned_routed(tpt, t, 4, N, **k),
            lambda **k: tt.walk_edge_list_partitioned_routed(tpe, t, 4, N,
                                                             **k),
            lambda **k: tt.walk_edge_list_node2vec_partitioned_routed(
                tpe, th, t, 0.5, 2.0, 4, N, blooms=tb, **k)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu")[1]["terminated"] == B


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
# D32: beyond the 16 shards of the other cases; its D * D = 1 024 box counts
# outnumber a block's 256 threads.
CARD_SHARDS = {"D1": 1, "D2": 2, "D16": 16, "D32": 32}
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
           "budget": tt.RoutedConfig(pair_capacity=128, max_phases=7),
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


def _launches(run, info):
    """Calls of the walk's kernel by ``run``: phase 0 a pipeline, then one
    batch launch (K13-K15)."""
    return len(run.pipes) + (1 if info["phases"] else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("case", ["D1", "D2", "D8", "D16", "D32", "L1",
                                  "carry_pool", "real_pad", "overflow",
                                  "budget"])
@pytest.mark.parametrize("kind", list(CARD_ENGINES))
def test_family_kernels_equal_plain_body_phase_by_phase(kind, case,
                                                        schedule):
    """K13, K14 (restart and absorbing) and K15 (restart, p=0.5 q=2 with
    Bloom filters; absorbing, p=4 q=0.25 with saturated filters) against
    the plain bodies on the card, the whole state after phase 0 and after
    every phase (a batch launch of one phase each): D = 1, 2, 8,
    16, 32, L = 1, a filling carry pool, the padding a node of the graph,
    targets on the padding, all on a graph whose last quarter has no
    out-edge; an overflowing pool and a phase budget of 7, which no phase
    count divides (both runs raise alike); then the whole walk through
    ``run`` (one batch launch), its walks, info and launches."""
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
    run = runs[0]
    kernel = bindings.ROUTED_ENGINES[run.engine].kernel
    before = bindings.launch_counts[kernel]
    again = card_walk(kind, case, schedule, "kernel")
    if case in ("overflow", "budget"):
        assert all(isinstance(x, str) and "incomplete" in x for x in got)
        assert got[0] == got[1]
        with pytest.raises(RuntimeError) as err:
            again.run()
        assert str(err.value) == got[0]
        return
    (kw, ki), (pw, pi) = got
    eq(kw, pw.cpu().numpy())
    assert ki == pi and ki["terminated"] == 1024
    walks, info = again.run()
    eq(walks, kw.cpu().numpy())
    assert info == ki
    assert bindings.launch_counts[kernel] - before == _launches(again, info)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("kind", ["K13", "K14_restart", "K15_restart"])
def test_family_batched_loop_equals_one_phase_a_read(monkeypatch, kind,
                                                     schedule):
    """The family legs' final state, info and phase calls with k = 3 and 8
    phases a read, eager, and with k = 4 and 8 replayed as CUDA graphs,
    equal those of the loop that reads after every phase.  K13-K15 run a
    walk as one batch launch whatever k: the same state, info and calls
    each time, and the phases enqueued are the phases run."""
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
    batch = bindings.ROUTED_ENGINES[base.engine].batch
    for (k, graph), (info, run, enqueued, calls) in out.items():
        assert info == want
        _same_state(run, base)
        assert enqueued == (want["phases"] if batch
                            else -(-want["phases"] // k) * k)
        assert calls == _launches(run, info)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("case", ["D8", "D32", "carry_pool", "L1"])
@pytest.mark.parametrize("kind", ["K13", "K14_restart", "K14_absorbing",
                                  "K15_restart", "K15_absorbing_saturated"])
def test_batch_kernel_in_batches_of_n_equals_the_plain_walk(kind, case,
                                                             schedule):
    """K13's, K14's and K15's batch kernel run in launches of n = 1, 3 and 7
    phases (no divisor of the phase count: roles and pools carried from
    one launch to the next; the last launch stops early) and of the whole
    budget: each the plain walk's final state, walks and info; at D = 8
    and at D = 32, whose D * D box counts outnumber a block's threads."""
    need_cuda()
    plain = card_walk(kind, case, schedule, "plain")
    want = plain.run()
    for n in (1, 3, 7, None):
        run = card_walk(kind, case, schedule, "kernel")
        kernel = bindings.ROUTED_ENGINES[run.engine].kernel
        run.start()
        before = bindings.launch_counts[kernel]
        phases, inflight = run._read()
        while inflight > 0 and phases < run.max_phases:
            phases, inflight = run._run_batch(
                run.max_phases - phases if n is None else n)
        launches = bindings.launch_counts[kernel] - before
        _same_state(run, plain)
        walks, info = run.result()
        eq(walks, want[0].cpu().numpy())
        assert info == want[1] and run.enqueued == info["phases"]
        assert launches == (1 if n is None else -(-info["phases"] // n))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["triples", "edge_list",
                                    "edge_list_node2vec"])
def test_batch_engines_at_walk_length_zero_launch_nothing(engine):
    """L = 0 on the card returns the target column and the JAX ``info``
    without a launch, as on the CPU."""
    need_cuda()
    pg, pad, tables = card_graphs(8, engine)
    cpu_pg = type(pg)(
        tuple(m.cpu() for m in pg.node_meta), tuple(c.cpu() for c in pg.col),
        pg.num_nodes, pg.num_shards, pg.shard_nodes)
    t = torch.arange(64, dtype=torch.int32, device="cuda")
    before = dict(bindings.launch_counts)
    if engine == "triples":
        got = tt.walk_triples_partitioned_routed(pg, t, 0, pad)
        want = tt.walk_triples_partitioned_routed(cpu_pg, t.cpu(), 0, pad,
                                                  device="cpu")
    elif engine == "edge_list":
        got = tt.walk_edge_list_partitioned_routed(pg, t, 0, pad)
        want = tt.walk_edge_list_partitioned_routed(cpu_pg, t.cpu(), 0, pad,
                                                    device="cpu")
    else:
        hashes, blooms = tables
        cpu_hashes = (hashes[0].cpu(), hashes[1].cpu(), hashes[2])
        got = tt.walk_edge_list_node2vec_partitioned_routed(
            pg, hashes, t, 0.5, 2.0, 0, pad, blooms=blooms)
        want = tt.walk_edge_list_node2vec_partitioned_routed(
            cpu_pg, cpu_hashes, t.cpu(), 0.5, 2.0, 0, pad,
            blooms=blooms.cpu(), device="cpu")
    assert bindings.launch_counts == before
    eq(got[0], want[0].numpy())
    assert got[1] == want[1] and got[1]["phases"] == 0


@pytest.mark.cuda
def test_family_phase_kernels_refuse_bad_launches(monkeypatch):
    """Launches packed for another engine, bad scalars (a pool of 2, no
    phase, a first pipeline of 2), a grid of no block or of more blocks
    than the card holds resident, a triples batch whose walk rows are too
    narrow for 2L + 1 positions, and a card that holds no block of the
    batch kernel are refused; so are buffers that do not fit.  The
    geometry query answers for the engine's own kernel: K13's, not K14's,
    whose records are as wide."""
    need_cuda()
    run = card_walk("K14_restart", "D2", "serial", "kernel")
    launch = run.pipes[0].launch
    batch = run._batch
    with pytest.raises(ValueError, match="packed for K14, not K13"):
        bindings.routed_triples_batch(batch, 1, [1])
    with pytest.raises(ValueError, match="packed for K14, not K11"):
        bindings.routed_uniform_phase(launch, 0)
    with pytest.raises(ValueError, match="packed for K14, not K15"):
        bindings.routed_edge_list_node2vec_batch(batch, 1, [1])
    resident = batch.geometry["blocks_per_sm"] * batch.geometry["sms"]
    assert batch.grid == batch.batch.resident == resident
    for phases, pools, first, grid in ((1, [2], 0, resident),
                                       (0, [1], 0, resident),
                                       (1, [1], 2, resident), (1, [1], 0, 0),
                                       (1, [1], 0, resident + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            bindings.routed_edge_list_batch(batch._replace(grid=grid), phases,
                                            pools, first)
    assert int(run._counter) == 0  # nothing ran
    triples = card_walk("K13", "D2", "serial", "kernel")
    tb = triples._batch
    tb.batch.pipe[0].walk_cols = triples.walk_length + 2
    with pytest.raises(RuntimeError, match="launch failed"):
        bindings.routed_triples_batch(tb, 1, [1])
    assert int(triples._counter) == 0
    functions = {engine: {bindings.routed_batch_geometry(engine, r, 2)[
        "function"] for r in (False, True)} for engine in (
            "triples", "edge_list", "edge_list_node2vec")}
    assert len(functions["triples"]) == 1
    assert tb.geometry["function"] in functions["triples"]
    assert not functions["triples"] & (functions["edge_list"]
                                       | functions["edge_list_node2vec"])
    assert batch.geometry["function"] in functions["edge_list"]
    monkeypatch.setattr(bindings, "routed_batch_geometry",
                        lambda *a, **k: dict(batch.geometry,
                                             blocks_per_sm=0))
    with pytest.raises(RuntimeError, match="no resident block"):
        bindings.routed_batch_launch([launch])
    monkeypatch.undo()
    with pytest.raises(ValueError, match="runs K13, K14 or K15 launches"):
        bindings.routed_batch_launch([launch, run.pipes[0].launch._replace(
            engine="edge_list_node2vec")])
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
    with pytest.raises(ValueError, match="takes a flow buffer"):
        bindings.routed_phase_launch(
            shards, run.stats, run.live[0], run.live.view(-1), run._counter,
            shard_nodes=run.pgraph.shard_nodes, blk=run.blk,
            walk_length=run.walk_length, cap=run.cap, ccap=run.ccap,
            key=(1, 2), engine="edge_list", padding=CARD_N)
