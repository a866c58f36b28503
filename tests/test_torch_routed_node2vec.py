"""The port's routed node2vec engine, its tables (per-node Bloom filters, the
cuckoo edge set, their per-shard builds) and both schedules of the routed
engines against the JAX package (tolerance 0: ids, bits and counts).

The walks are held against the JAX single-device ``node2vec_walk_csr``
(cheap); the ``info`` of each run against the JAX routed engine
(``exchange="xla"``) on the 8-device virtual mesh, whose runs are shared
through one module fixture because each compiles for seconds.  The
membership test (cuckoo probes or binary search) does not change a walk or a
count, so one JAX run serves both.  K11 and K12 are held against the plain
phase bodies on the card, phase by phase (tests marked ``cuda``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu import native
from torch_random_walk_tpu.graph import bloom as jbloom
from torch_random_walk_tpu.graph.csr import CSRGraph as JCSRGraph
from torch_random_walk_tpu.graph.hashset import EdgeHashSet as JEdgeHashSet
from torch_random_walk_tpu.ops.node2vec import node2vec_walk_csr as j_n2v
from torch_random_walk_tpu.parallel import partition_v2 as jv2
from torch_random_walk_tpu.parallel.mesh import make_mesh
from torch_random_walk_tpu.parallel.partition import (
    PartitionedCSR as JPartitionedCSR,
    build_partition_hashes as j_build_hashes,
)
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.graph import bloom as tbloom
from torch_random_walk_tpu_torch.graph.hashset import EdgeHashSet
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.parallel import partition_v2 as tv2
from torch_random_walk_tpu_torch.utils import prng
from torch_port_util import eq, need_cuda, power_law_edges

N, B, L, D = 1000, 256, 10, 8
SEED = 5


@pytest.fixture(scope="module")
def numpy_cuckoo():
    """The JAX package builds its cuckoo tables with its compiled native
    routine where that is present, which lays keys out unlike its NumPy
    build; the port follows the NumPy build, so the tables are compared
    with that."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "cuckoo_build", lambda *a, **k: None)
        yield


@pytest.fixture(scope="module")
def world(numpy_cuckoo):
    """A power-law graph whose last quarter of nodes has no out-edge, both
    packages' partitions over D shards, their cuckoo tables and Blooms."""
    src, dst = power_law_edges(N, 5, seed=61)
    jg = JCSRGraph.from_edges(src, dst, num_nodes=N)
    tg = tt.CSRGraph.from_edges(src, dst, num_nodes=N, device="cpu")
    jpg = JPartitionedCSR.from_csr(jg, D)
    tpg = tt.PartitionedCSR.from_csr(tg, D)
    return dict(jg=jg, tg=tg, jpg=jpg, tpg=tpg,
                jh=j_build_hashes(jpg, jg), th=tt.build_partition_hashes(tpg, tg),
                jb=jv2.build_partition_blooms(jpg, jg),
                tb=tt.build_partition_blooms(tpg, tg))


def targets_for(case: str) -> np.ndarray:
    if case == "one_shard":  # every walker starts on shard 0's nodes
        return (np.arange(B) % (N // D)).astype(np.int32)
    return np.random.default_rng(62).integers(0, N, B).astype(np.int32)


CARRY_CAP = 2  # records a pair a phase: the walkers queue in the carry pool

# name: (p, q, blooms, schedule, pair_capacity, targets).  Two compiles of
# the JAX engine, each shared by the runs that differ only in their filters
# or targets: the serial schedule in the default configuration, and the
# overlapped one with a pair capacity that queues walkers in both
# pipelines' carry pools.
JAX_RUNS = {
    "pq0.5-2_blooms_serial": (0.5, 2.0, True, "serial", None, "random"),
    "pq0.5-2_saturated_serial": (0.5, 2.0, False, "serial", None, "random"),
    "pq0.5-2_one_shard": (0.5, 2.0, True, "serial", None, "one_shard"),
    "pq4-0.25_blooms_overlapped_carry_pool": (4.0, 0.25, True, "overlapped",
                                              CARRY_CAP, "random"),
    "pq4-0.25_saturated_overlapped_carry_pool": (4.0, 0.25, False,
                                                 "overlapped", CARRY_CAP,
                                                 "random"),
}


def _config(pair_capacity, rc):
    return None if pair_capacity is None else rc(pair_capacity=pair_capacity,
                                                 carry_capacity=B)


@pytest.fixture(scope="module")
def jax_runs(world):
    """Each JAX routed run, made once, on first use."""
    mesh, done = make_mesh(), {}

    def get(name):
        if name not in done:
            p, q, blooms, schedule, cap, tgt = JAX_RUNS[name]
            done[name] = jv2.walk_partitioned_node2vec_routed(
                world["jpg"], world["jh"], jnp.asarray(targets_for(tgt)),
                mesh, p, q, L, seed=SEED,
                config=_config(cap, jv2.RoutedConfig),
                blooms=world["jb"] if blooms else None, exchange="xla",
                schedule=schedule)
        return done[name]

    return get


# The binary search under each schedule with Bloom filters (its answers are
# the cuckoo set's, which every run covers).
ENGINE_CASES = [(name, hashes) for name in JAX_RUNS for hashes in (True, False)
                if hashes or name in ("pq0.5-2_blooms_serial",
                                      "pq4-0.25_blooms_overlapped_carry_pool")]


@pytest.mark.parametrize("name,hashes", ENGINE_CASES,
                         ids=[f"{n}-{'cuckoo' if h else 'search'}"
                              for n, h in ENGINE_CASES])
def test_routed_node2vec_equals_jax(world, jax_runs, name, hashes):
    """Walks equal the single-device rejection walks, and info equals the
    JAX routed engine's, for p, q = (0.5, 2) and (4, 0.25), Bloom filters
    and saturated ones, both schedules, dead ends, a pair capacity that
    sends walkers through the carry pool, all walkers on one shard; with
    the cuckoo tables and with the binary search."""
    p, q, blooms, schedule, cap, tgt = JAX_RUNS[name]
    targets = targets_for(tgt)
    got, info = tt.walk_partitioned_node2vec_routed(
        world["tpg"], world["th"] if hashes else None, targets, p, q, L,
        seed=SEED, config=_config(cap, tt.RoutedConfig),
        blooms=world["tb"] if blooms else None, schedule=schedule,
        device="cpu")
    jw, jinfo = jax_runs(name)
    jg = world["jg"]
    eq(got, j_n2v(jg.row_ptr, jg.col_idx, jnp.asarray(targets), p, q, L,
                  SEED))
    eq(got, jw)
    assert info == jinfo
    assert info["schedule"] == schedule and info["overflow_dropped"] == 0


def test_a_small_pair_capacity_fills_the_carry_pool(world):
    """The carry-pool runs above do queue walkers: after phase 0 every
    shard of both pipelines carries records."""
    run = tv2.RoutedWalk(world["tpg"], torch.from_numpy(targets_for("random")),
                         L, (0, 0), tt.RoutedConfig.resolve(
                             tt.RoutedConfig(pair_capacity=CARRY_CAP,
                                             carry_capacity=B), B, D, L),
                         "overlapped", "plain",
                         node2vec=tv2.node2vec_routing(
                             world["tpg"], 4.0, 0.25, 6, world["th"],
                             world["tb"]))
    run.start()
    assert bool((run.live[:, :, 1] > 0).all())


def test_the_graph_has_dead_ends_and_the_blooms_cut_resolve_trips(world,
                                                                  jax_runs):
    deg = np.diff(np.asarray(world["jg"].row_ptr))
    assert (deg == 0).sum() > N // 5
    with_blooms = jax_runs("pq0.5-2_blooms_serial")[1]
    saturated = jax_runs("pq0.5-2_saturated_serial")[1]
    assert with_blooms["exchanged_records"] < saturated["exchanged_records"]


def test_routed_node2vec_on_the_jax_tables(world, jax_runs):
    """``convert`` carries the JAX package's hashes and Blooms across; a walk
    on them is the JAX walk."""
    jh, jb = world["jh"], world["jb"]
    hashes = convert.partition_hashes_from_numpy(
        np.asarray(jh[0]), np.asarray(jh[1]), jh[2], device="cpu")
    blooms = convert.partition_blooms_from_numpy(np.asarray(jb), device="cpu")
    got, info = tt.walk_partitioned_node2vec_routed(
        world["tpg"], hashes, targets_for("random"), 0.5, 2.0, L, seed=SEED,
        blooms=blooms, device="cpu")
    jw, jinfo = jax_runs("pq0.5-2_blooms_serial")
    eq(got, jw)
    assert info == jinfo
    eq(hashes[0], np.asarray(jh[0]).view(np.int32))
    eq(hashes[1], np.asarray(jh[1]).view(np.int32))
    eq(blooms, np.asarray(jb).view(np.int32))
    with pytest.raises(ValueError, match="blooms must be"):
        convert.partition_blooms_from_numpy(np.zeros((2, 3)), device="cpu")


def test_truncated_phase_budget_raises(world):
    with pytest.raises(RuntimeError, match="routed walk incomplete"):
        tt.walk_partitioned_node2vec_routed(
            world["tpg"], world["th"], targets_for("random"), 0.5, 2.0, L,
            seed=SEED, config=tt.RoutedConfig(pair_capacity=128,
                                              max_phases=5), device="cpu")


BATCH_RUNS = ["pq0.5-2_blooms_serial", "pq4-0.25_blooms_overlapped_carry_pool"]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", BATCH_RUNS, ids=["serial", "overlapped"])
def test_batched_phase_loop_equals_jax(world, jax_runs, monkeypatch, name, k):
    """The loop enqueues k phases between two reads of the phase counter and
    the in-flight count; whatever k, the walks and info (phases included)
    are the JAX routed engine's, under both schedules."""
    monkeypatch.setattr(tv2, "PHASES_PER_READ", k)
    p, q, blooms, schedule, cap, tgt = JAX_RUNS[name]
    got, info = tt.walk_partitioned_node2vec_routed(
        world["tpg"], world["th"], targets_for(tgt), p, q, L, seed=SEED,
        config=_config(cap, tt.RoutedConfig), blooms=world["tb"],
        schedule=schedule, device="cpu")
    jw, jinfo = jax_runs(name)
    eq(got, jw)
    assert info == jinfo


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("schedule", tv2.SCHEDULES)
def test_batched_loop_stops_at_the_phase_budget(world, monkeypatch, schedule,
                                                k):
    """A budget that is no multiple of k still ends where the JAX loop ends
    (no phase is enqueued past it), and the walk raises as incomplete."""
    monkeypatch.setattr(tv2, "PHASES_PER_READ", k)
    cfg = tt.RoutedConfig(pair_capacity=128, max_phases=5)
    run = tv2.RoutedWalk(world["tpg"], torch.from_numpy(targets_for("random")),
                         L, prng.derive_key(SEED, prng.STREAM_CSR_BIASED),
                         cfg, schedule, "plain", node2vec=tv2.node2vec_routing(
                             world["tpg"], 0.5, 2.0, 6, world["th"],
                             world["tb"]))
    with pytest.raises(RuntimeError, match="routed walk incomplete"):
        run.run()
    assert run.phases == run.enqueued == run.max_phases


@pytest.mark.parametrize("schedule", tv2.SCHEDULES)
def test_phases_after_the_end_change_nothing(world, schedule):
    """Once nothing is in flight, a phase changes no buffer of the walk and
    does not count itself: the batched loop's phases past the end are
    no-ops."""
    run = tv2.RoutedWalk(world["tpg"], torch.from_numpy(targets_for("random")),
                         L, prng.derive_key(SEED, prng.STREAM_CSR_BIASED),
                         tt.RoutedConfig.resolve(None, B, D, L), schedule,
                         "plain", node2vec=tv2.node2vec_routing(
                             world["tpg"], 0.5, 2.0, 6, world["th"],
                             world["tb"]))
    walks, info = run.run()
    before = [x.clone() for x in _all_buffers(run)]
    for _ in range(3):
        run.phase()
    assert run.inflight() == 0 and run.phases == info["phases"]
    for x, y in zip(_all_buffers(run), before, strict=True):
        eq(x, y.numpy())
    eq(run.result()[0], walks.numpy())


def _all_buffers(run):
    """Every tensor a routed walk keeps between phases (the kernels' stage,
    code and histograms are scratch, rewritten every phase)."""
    return [run.walks, run.stats, run.live, run._counter] + [
        x for pipe in run.pipes
        for x in (pipe.outbox, pipe.inbox, pipe.carry)
        + ((pipe.pool_count,) if pipe.pool_count is not None else ())]


def test_routed_node2vec_arguments_are_checked(world):
    tpg = world["tpg"]
    with pytest.raises(ValueError, match="divisible"):
        tt.walk_partitioned_node2vec_routed(tpg, None, np.arange(B + 1), 0.5,
                                            2.0, L, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        tt.walk_partitioned_node2vec_routed(tpg, None, np.arange(B), 0.5, 2.0,
                                            L, schedule="eager", device="cpu")
    with pytest.raises(ValueError, match="below 2"):
        tt.walk_partitioned_node2vec_routed(tpg, None, np.arange(B), 0.5, 2.0,
                                            1 << 24, device="cpu")
    with pytest.raises(ValueError, match="hashes must be"):
        th = world["th"]
        tt.walk_partitioned_node2vec_routed(tpg, (th[0][:1], th[1], th[2]),
                                            np.arange(B), 0.5, 2.0, L,
                                            device="cpu")
    with pytest.raises(ValueError, match="CUDA device only"):
        tv2.RoutedWalk(tpg, torch.arange(B, dtype=torch.int32), L, (0, 0),
                       tt.RoutedConfig.for_walk(B, D, L), "serial", "kernel")


def test_routed_config_budget_equals_jax():
    for cfg in (None, tt.RoutedConfig(pair_capacity=4),
                tt.RoutedConfig(pair_capacity=4, max_phases=7)):
        base = tt.RoutedConfig.resolve(cfg, B, D, L)
        if cfg is None or cfg.max_phases <= 0:
            got = tv2._biased_phase_budget(base, L, 6)
        else:
            got = base
        jcfg = None if cfg is None else jv2.RoutedConfig(
            pair_capacity=cfg.pair_capacity, max_phases=cfg.max_phases)
        want = jv2.RoutedConfig.resolve(jcfg, B, D, L)
        if cfg is None or cfg.max_phases <= 0:
            want = jv2._biased_phase_budget(want, L, 6)
        assert got.max_phases == want.max_phases


# --- the tables, bit for bit --------------------------------------------------

def test_node_blooms_and_probe_equal_jax(world):
    jg, tg = world["jg"], world["tg"]
    want = jbloom.build_node_blooms(jg.row_ptr, jg.col_idx)
    got = tbloom.build_node_blooms(tg.row_ptr, tg.col_idx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (N, 4)
    eq(got, want.view(np.int32))
    rng = np.random.default_rng(63)
    rows = want[rng.integers(0, N, 4000)]
    cand = rng.integers(0, N, 4000).astype(np.int32)
    cand[:3] = [0, 2 ** 31 - 1, N - 1]
    maybe = tbloom.bloom_maybe(torch.from_numpy(rows.view(np.int32)),
                               torch.from_numpy(cand))
    eq(maybe, jbloom.bloom_maybe(jnp.asarray(rows), jnp.asarray(cand)))
    assert 0 < float(maybe.float().mean()) < 1


def test_partition_blooms_and_hashes_equal_jax(world):
    eq(world["tb"], np.asarray(world["jb"]).view(np.int32))
    (jt, js, jlog), (tt_, ts, tlog) = world["jh"], world["th"]
    assert tlog == jlog
    eq(tt_, np.asarray(jt).view(np.int32))
    eq(ts, np.asarray(js).view(np.int32))


@pytest.mark.parametrize("n,e", [(40, 8), (300, 2000), (50, 3000)],
                         ids=["sparse", "mid", "multigraph"])
def test_cuckoo_table_equals_jax_numpy_build(numpy_cuckoo, n, e):
    """Same dedup, salts and eviction order as the JAX NumPy build: the same
    table bit for bit; membership equal for edges and non-edges."""
    rng = np.random.default_rng(n + e)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    log_size = int(np.ceil(np.log2(max(4 * e, 16))))
    jt, _, jsalt = JEdgeHashSet._host_build_with_log_size(src, dst, log_size)
    got = EdgeHashSet.from_edges_with_log_size(torch.from_numpy(src),
                                               torch.from_numpy(dst), log_size)
    assert got.salt == jsalt and got.log_size == log_size
    eq(got.table, jt.view(np.int32))
    jset = JEdgeHashSet.from_edges_with_log_size(src, dst, log_size)
    u, v = rng.integers(0, n, 500), rng.integers(0, n, 500)
    k = min(50, e)
    u[:k], v[:k] = src[:k], dst[:k]
    hit = got.contains(torch.from_numpy(u), torch.from_numpy(v))
    assert bool(hit[:k].all())
    eq(hit, jset.contains(jnp.asarray(u), jnp.asarray(v)))


def test_empty_trailing_shards_get_empty_tables(numpy_cuckoo):
    src, dst = power_law_edges(13, 3, seed=64)
    jg = JCSRGraph.from_edges(src, dst, num_nodes=13)
    tg = tt.CSRGraph.from_edges(src, dst, num_nodes=13, device="cpu")
    jpg, tpg = JPartitionedCSR.from_csr(jg, 8), tt.PartitionedCSR.from_csr(tg, 8)
    jt, js, jlog = j_build_hashes(jpg, jg)
    got = tt.build_partition_hashes(tpg, tg)
    assert got[2] == jlog
    eq(got[0], np.asarray(jt).view(np.int32))
    eq(got[1], np.asarray(js).view(np.int32))
    assert bool((got[0][-1] == -1).all())
    eq(tt.build_partition_blooms(tpg, tg),
       np.asarray(jv2.build_partition_blooms(jpg, jg)).view(np.int32))


# --- the kernels' compaction, mirrored ------------------------------------------

TILE = 256  # routed.cuh kTile
WARPS = TILE // 32


def _tile_ranks(keys, valid, nkeys):
    """Each lane's count of its key among the lower lanes of a tile, as the
    kernel adds it up: the lower warps' counts (one per warp and key, set by
    the first lane of each __match_any_sync group, or a ballot's popcount)
    plus its lower lanes of the warp."""
    onehot = np.zeros((TILE, nkeys), np.int64)
    onehot[np.flatnonzero(valid), keys[valid]] = 1
    by_warp = onehot.reshape(WARPS, 32, nkeys)
    below = (np.cumsum(by_warp, 1) - by_warp).reshape(TILE, nkeys)
    wcnt = by_warp.sum(1)
    lower_warps = np.cumsum(wcnt, 0) - wcnt
    lane = np.arange(TILE)
    k = np.where(valid, keys, 0)
    return below[lane, k] + lower_warps[lane // 32, k]


def stage_histogram(code, streams, nshards):
    """The body kernels' histogram (phase 0's histogram launch alike): each
    tile's departures by (stream, destination)."""
    hist = np.zeros((-(-code.size // TILE), streams, nshards), np.int64)
    i = np.flatnonzero(code >= 0)
    np.add.at(hist, (i // TILE, code[i] >> 16, code[i] & 0xFFFF), 1)
    return hist


def pool_histogram(pool, carried, nshards, ccap):
    """A carry pool's counts by (tile, destination) and a last row of
    totals, as the compaction that filled the pool adds them up."""
    tiles = -(-ccap // TILE)
    count = np.zeros((tiles + 1, nshards), np.int64)
    np.add.at(count, (np.arange(carried) // TILE, pool[:carried, -1]), 1)
    count[tiles] = count[:tiles].sum(0)
    return count


def compaction_mirror(pool, pool_count, stage, code, hist, cap, ccap,
                      nshards):
    """K11/K12's tiled compaction (``routed.cuh``, ``routed_compact_kernel``)
    block by block: a block per tile of the live pool (``pool``, its counts
    ``pool_count``), then per stage tile over every stream.  A segment's
    rank base for each destination comes from the histograms (the pool's
    earlier tiles; or the whole pool, the lower streams' totals and the same
    stream's earlier tiles), its carry base is sum_d max(0, base_d - cap),
    and within the tile the ranks follow the warps' counts.  The leftovers
    fill the other pool, which starts as junk beyond what is written, and
    its counts.  Returns (outbox (D, cap, R), next pool, its counts, boxed,
    carried, dropped)."""
    width = stage.shape[1]
    ctiles = pool_count.shape[0] - 1
    outbox = np.zeros((nshards, cap, width), np.int64)
    outbox[..., 0] = -1
    nxt = np.full((ccap, width + 1), 0x5A5A5A, np.int64)
    nxt_count = np.zeros_like(pool_count)
    ptot, totals = pool_count[ctiles], hist.sum(0)

    def place(recs, dest, seg, valid, base):
        rank = base[seg, dest] + _tile_ranks(seg * nshards + dest, valid,
                                             base.size)
        left = valid & (rank >= cap)
        lbase = np.maximum(base - cap, 0).sum(1)
        lrank = lbase[seg] + _tile_ranks(seg, left, base.shape[0])
        for j in np.flatnonzero(valid & ~left):
            outbox[dest[j], rank[j]] = recs[j]
        for j in np.flatnonzero(left & (lrank < ccap)):
            nxt[lrank[j], :width] = recs[j]
            nxt[lrank[j], width] = dest[j]
            nxt_count[[lrank[j] // TILE, ctiles], dest[j]] += 1

    lane = np.arange(TILE)
    zero = np.zeros(TILE, np.int64)
    for c in range(ctiles):
        idx = c * TILE + lane
        valid = idx < ptot.sum()
        if valid.any():
            rows = pool[np.minimum(idx, pool.shape[0] - 1)]
            place(rows[:, :width], np.where(valid, rows[:, width], 0), zero,
                  valid, pool_count[:c].sum(0)[None])
    for t in range(hist.shape[0]):
        idx = np.minimum(t * TILE + lane, code.size - 1)
        c = np.where(t * TILE + lane < code.size, code[idx], -1)
        valid = c >= 0
        if valid.any():
            base = ptot + np.cumsum(totals, 0) - totals + hist[:t].sum(0)
            place(stage[idx], np.where(valid, c & 0xFFFF, 0),
                  np.where(valid, c >> 16, 0), valid, base)
    n = ptot + totals.sum(0)
    left = int(np.maximum(n - cap, 0).sum())
    return (outbox, nxt, nxt_count, int(np.minimum(n, cap).sum()),
            min(left, ccap), max(left - ccap, 0))


def _u32(x):
    return jnp.asarray(np.asarray(x) & 0xFFFFFFFF, jnp.uint32)


def _phase_inputs(rng, slots, width, streams, nshards):
    stage = rng.integers(-2 ** 31, 2 ** 31, (slots, width))
    code = np.where(rng.random(slots) < 0.7,
                    (rng.integers(0, streams, slots) << 16)
                    | rng.integers(0, nshards, slots), -1)
    return stage, code


def _jax_build_outbox(stage, code, streams, carry, carried, nshards, cap,
                      ccap):
    """JAX's _build_outbox of the same candidates as the body's streams.
    Returns (outbox, carry, carried, overflow) as int64 numpy."""
    recs = np.concatenate([stage] * streams)
    dests = np.concatenate([code & 0xFFFF] * streams)
    valid = np.concatenate([(code >= 0) & ((code >> 16) == k)
                            for k in range(streams)])
    outbox, jcarry, jvalid, ovf = jax.jit(
        jv2._build_outbox, static_argnums=(5, 6, 7))(
        _u32(recs), jnp.asarray(dests, jnp.int32), jnp.asarray(valid),
        _u32(carry), jnp.arange(ccap) < carried, nshards, cap, ccap)
    return (np.asarray(outbox).astype(np.int64),
            np.asarray(jcarry).astype(np.int64), int(np.asarray(jvalid).sum()),
            int(ovf))


def _check_mirror(got, want, cap):
    """The mirror's outbox, carry prefix and counts against JAX's."""
    outbox, nxt, nxt_count, boxed, carried, dropped = got
    want_out, jcarry, n_carry, ovf = want
    np.testing.assert_array_equal(outbox & 0xFFFFFFFF, want_out)
    assert (carried, dropped) == (n_carry, ovf)
    np.testing.assert_array_equal(nxt[:n_carry] & 0xFFFFFFFF,
                                  jcarry[:n_carry])
    assert boxed == int((want_out[..., 0] != 0xFFFFFFFF).sum())
    np.testing.assert_array_equal(
        nxt_count, pool_histogram(nxt, n_carry, nxt_count.shape[1],
                                  nxt.shape[0]))


@pytest.mark.parametrize("width,streams,phase0", [
    (3, 2, False), (14, 4, False), (3, 1, True), (14, 1, True)],
    ids=["K11", "K12", "K11_phase0", "K12_phase0"])
@pytest.mark.parametrize("nshards,cap,ccap", [
    (1, 600, 3000), (2, 7, 40), (8, 3, 25), (3, 500, 2000), (16, 40, 64),
    (4, 1, 1000)])
def test_compaction_mirror_equals_jax_build_outbox(width, streams, phase0,
                                                   nshards, cap, ccap):
    """The mirror of the kernels' tiled compaction gives the outbox, the
    carry pool, its counts and the overflow of the JAX package's
    _build_outbox, with several tiles per stream, a live pool of several
    tiles, capacities that fill, and pools that overflow; the port's plain
    build_outbox gives them too.  Phase 0 is one stream into an empty pool,
    of more slots than the D * cap that a phase stages where the walkers a
    shard owns outnumber them."""
    rng = np.random.default_rng(nshards * 100 + cap + width)
    slots = nshards * max(cap, 90)
    carried = 0 if phase0 else min(ccap, 700)
    carry = rng.integers(-2 ** 31, 2 ** 31, (ccap, width + 1))
    carry[:, width] = rng.integers(0, nshards, ccap)
    stage, code = _phase_inputs(rng, slots, width, streams, nshards)
    got = compaction_mirror(carry, pool_histogram(carry, carried, nshards,
                                                  ccap),
                            stage, code, stage_histogram(code, streams,
                                                         nshards),
                            cap, ccap, nshards)
    want = _jax_build_outbox(stage, code, streams, carry, carried, nshards,
                             cap, ccap)
    _check_mirror(got, want, cap)
    want_out, jcarry, n_carry, ovf = want
    # the port's plain version of the same order
    t_out = torch.empty((1, nshards, cap, width), dtype=torch.int32)
    t_carry = torch.from_numpy(carry.astype(np.int64) & 0xFFFFFFFF)
    t_carry = prng.to_i32_bits(t_carry)[None]
    cands = [tv2._carry_candidates(t_carry, torch.tensor([carried]))]
    for k in range(streams):
        keep = (code >= 0) & ((code >> 16) == k)
        cands.append((prng.to_i32_bits(torch.from_numpy(stage[keep] & 0xFFFFFFFF)),
                      torch.from_numpy(code[keep] & 0xFFFF),
                      torch.zeros(int(keep.sum()), dtype=torch.int64)))
    new_carry, p_carried, p_boxed, p_ovf = tv2.build_outbox(cands, t_carry,
                                                            cap, t_out)
    eq(t_out[0], want_out.astype(np.uint32).view(np.int32))
    assert (int(p_carried[0]), int(p_boxed[0]), int(p_ovf[0])) == (
        n_carry, got[3], ovf)
    eq(new_carry[0, :n_carry], jcarry[:n_carry].astype(np.uint32)
       .view(np.int32))


@pytest.mark.parametrize("width,streams,nshards,cap,ccap", [
    (3, 2, 4, 2, 3000), (14, 4, 8, 5, 600), (14, 4, 2, 1, 300)],
    ids=["K11_pool_of_many_tiles", "K12_several_tiles", "K12_overflow"])
def test_compaction_mirror_chains_through_both_pools(width, streams, nshards,
                                                     cap, ccap):
    """Phase 0 (blk > D * cap) and then two phases, each reading the pool
    and its counts that the one before filled, equal three chained
    _build_outbox calls of the JAX package: the double-buffered pools and
    their counts carry the exchange order from phase to phase."""
    rng = np.random.default_rng(width + nshards + ccap)
    pool = np.zeros((ccap, width + 1), np.int64)
    count = pool_histogram(pool, 0, nshards, ccap)
    jcarry, jcarried = pool, 0
    blk = nshards * cap + 777
    for phase in range(3):
        s = 1 if phase == 0 else streams
        slots = blk if phase == 0 else nshards * cap
        stage, code = _phase_inputs(rng, slots, width, s, nshards)
        got = compaction_mirror(pool, count, stage, code,
                                stage_histogram(code, s, nshards), cap, ccap,
                                nshards)
        want = _jax_build_outbox(stage, code, s, jcarry, jcarried, nshards,
                                 cap, ccap)
        _check_mirror(got, want, cap)
        pool, count = got[1], got[2]
        jcarry, jcarried = want[1], want[2]
    assert jcarried > TILE or ccap < TILE or want[3] > 0


# --- K11 and K12 against the plain bodies (on the card only) --------------------

def lockstep(pgraph, targets, walk_length, cfg, schedule, routing=None):
    """Run the kernel body and the plain body on the card side by side,
    comparing their whole state after phase 0 and after every phase; return
    both runs' (walks, info) or the error both raised."""
    dev = pgraph.device
    stream = (prng.STREAM_CSR_UNIFORM if routing is None
              else prng.STREAM_CSR_BIASED)
    key = prng.derive_key(SEED, stream)
    t = torch.as_tensor(targets, dtype=torch.int32, device=dev)
    runs = [tv2.RoutedWalk(pgraph, t, walk_length, key, cfg, schedule, body,
                           node2vec=routing) for body in ("kernel", "plain")]
    for r in runs:
        r.start()
    _same_state(*runs)
    while runs[0].inflight() > 0 and runs[0].phases < runs[0].max_phases:
        assert runs[0].inflight() == runs[1].inflight()
        for r in runs:
            r.phase()
        _same_state(*runs)
    assert runs[1].inflight() == runs[0].inflight()
    out = []
    for r in runs:
        try:
            out.append(r.result())
        except RuntimeError as err:
            out.append(str(err))
    return out


def _same_state(kernel, plain):
    _same_state_dicts(kernel.state(), plain.state())


def _card_graph(nshards, dead_ends=True):
    src, dst = power_law_edges(3000, 6, seed=65, dead_ends=dead_ends)
    g = tt.CSRGraph.from_edges(src, dst, num_nodes=3000, device="cuda")
    return g, tt.PartitionedCSR.from_csr(g, nshards)


# Card cases beside the defaults: (shards, walkers, config).  "tiles": a
# pair capacity that gives each stream two tiles of stage slots and queues
# thousands of walkers, so the live pool spans many tiles.
CARD_SHARDS = {"D1": 1, "D1_cuckoo": 1, "D2": 2, "D2_search": 2, "D16": 16,
               "tiles": 2}


def _card_case(case, walkers=1024):
    if case == "tiles":
        return 8192, tv2.RoutedConfig(pair_capacity=160, carry_capacity=8192)
    return walkers, {
        "carry_pool": tv2.RoutedConfig(pair_capacity=3,
                                       carry_capacity=walkers),
        "overflow": tv2.RoutedConfig(pair_capacity=2, carry_capacity=5),
    }.get(case)


def _launches(phases):
    """Phase calls of a run of ``phases`` phases: the loop enqueues whole
    batches of PHASES_PER_READ, whose phases after the end are no-ops."""
    k = tv2.PHASES_PER_READ
    return -(-phases // k) * k


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("case", ["D1", "D2", "D8", "D16", "L1", "carry_pool",
                                  "tiles", "overflow"])
def test_k11_equals_plain_body_phase_by_phase(case, schedule):
    need_cuda()
    nshards = CARD_SHARDS.get(case, 8)
    g, pg = _card_graph(nshards)
    walkers, cfg = _card_case(case)
    length = 1 if case == "L1" else 12
    cfg = tv2.RoutedConfig.resolve(cfg, walkers, nshards, length)
    t = np.random.default_rng(66).integers(0, g.num_nodes, walkers)
    got = lockstep(pg, t, length, cfg, schedule)
    if case == "overflow":
        assert all(isinstance(x, str) and "incomplete" in x for x in got)
        assert got[0] == got[1]
        return
    (kw, ki), (pw, pi) = got
    eq(kw, pw.cpu().numpy())
    assert ki == pi
    eq(kw, tt.walk(g, target_nodes=t, walk_length=length, seed=SEED).cpu()
       .numpy())
    before = dict(bindings.launch_counts)
    walks, info = tt.walk_partitioned_routed(pg, t, length, seed=SEED,
                                             config=cfg, schedule=schedule)
    eq(walks, kw.cpu().numpy())
    assert info == ki
    pipes = 2 if schedule == "overlapped" else 1  # phase 0: one a pipeline
    assert (bindings.launch_counts["routed_uniform_phase"]
            - before["routed_uniform_phase"]) == _launches(
                info["phases"]) + pipes


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("case", ["D1_cuckoo", "D2_search", "D8_cuckoo",
                                  "D8_search", "D16", "saturated", "L1", "pq4",
                                  "carry_pool", "tiles", "overflow"])
def test_k12_equals_plain_body_phase_by_phase(case, schedule):
    need_cuda()
    nshards = CARD_SHARDS.get(case, 8)
    g, pg = _card_graph(nshards)
    walkers, cfg = _card_case(case)
    length = 1 if case == "L1" else 12
    p, q = (4.0, 0.25) if case == "pq4" else (0.5, 2.0)
    hashes = (None if case.endswith("search")
              else tt.build_partition_hashes(pg, g))
    blooms = None if case == "saturated" else tt.build_partition_blooms(pg, g)
    routing = tv2.node2vec_routing(pg, p, q, 6, hashes, blooms)
    custom = cfg is not None
    cfg = tv2.RoutedConfig.resolve(cfg, walkers, nshards, length)
    if not custom:
        cfg = tv2._biased_phase_budget(cfg, length, 6)
    t = np.random.default_rng(67).integers(0, g.num_nodes, walkers)
    got = lockstep(pg, t, length, cfg, schedule, routing)
    if case == "overflow":
        assert all(isinstance(x, str) and "incomplete" in x for x in got)
        assert got[0] == got[1]
        return
    (kw, ki), (pw, pi) = got
    eq(kw, pw.cpu().numpy())
    assert ki == pi
    eq(kw, tt.walk(g.row_ptr, g.col_idx, t, p=p, q=q, walk_length=length,
                   seed=SEED).cpu().numpy())
    before = bindings.launch_counts["routed_node2vec_phase"]
    walks, info = tt.walk_partitioned_node2vec_routed(
        pg, hashes, t, p, q, length, seed=SEED, blooms=blooms,
        config=cfg if custom else None, schedule=schedule)
    eq(walks, kw.cpu().numpy())
    assert info["phases"] == ki["phases"]
    pipes = 2 if schedule == "overlapped" else 1  # phase 0: one a pipeline
    assert bindings.launch_counts["routed_node2vec_phase"] - before == \
        _launches(info["phases"]) + pipes


def _card_run(case, schedule, node2vec):
    nshards = CARD_SHARDS.get(case, 8)
    g, pg = _card_graph(nshards)
    walkers, cfg = _card_case(case)
    cfg = tv2.RoutedConfig.resolve(cfg, walkers, nshards, 12)
    routing = None
    if node2vec:
        routing = tv2.node2vec_routing(pg, 0.5, 2.0, 6,
                                       tt.build_partition_hashes(pg, g),
                                       tt.build_partition_blooms(pg, g))
        cfg = tv2._biased_phase_budget(cfg, 12, 6)
    key = prng.derive_key(SEED, prng.STREAM_CSR_BIASED if node2vec
                          else prng.STREAM_CSR_UNIFORM)
    t = torch.as_tensor(np.random.default_rng(68).integers(0, 3000, walkers),
                        dtype=torch.int32, device="cuda")
    return tv2.RoutedWalk(pg, t, 12, key, cfg, schedule, "kernel",
                          node2vec=routing)


@pytest.mark.cuda
@pytest.mark.parametrize("node2vec", [False, True], ids=["K11", "K12"])
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
@pytest.mark.parametrize("case", ["D8", "tiles"])
def test_batched_loop_on_the_card_equals_one_phase_a_read(monkeypatch, case,
                                                          schedule, node2vec):
    """The kernel legs' final state, info and phase calls with k = 3 and 8
    phases a read, eager, and with k = 4 and 8 replayed as CUDA graphs,
    equal those of the loop that reads after every phase."""
    need_cuda()
    out = {}
    kernel = "routed_node2vec_phase" if node2vec else "routed_uniform_phase"
    for k, graph in ((1, False), (3, False), (8, False), (4, True), (8, True)):
        monkeypatch.setattr(tv2, "PHASES_PER_READ", k)
        monkeypatch.setattr(tv2, "GRAPH_SCHEDULES",
                            tv2.SCHEDULES if graph else ())
        run = _card_run(case, schedule, node2vec)
        before = bindings.launch_counts[kernel]
        info = run.run()[1]
        out[k, graph] = (info, run.state(), run.enqueued,
                         bindings.launch_counts[kernel] - before)
    want, state, _, _ = out[1, False]
    pipes = 2 if schedule == "overlapped" else 1
    for (k, graph), (info, got, enqueued, calls) in out.items():
        assert info == want
        _same_state_dicts(got, state)
        assert enqueued == -(-want["phases"] // k) * k
        assert calls == enqueued + pipes


@pytest.mark.cuda
@pytest.mark.parametrize("node2vec", [False, True], ids=["K11", "K12"])
@pytest.mark.parametrize("schedule", ["serial", "overlapped"])
def test_kernel_phases_after_the_end_change_nothing(schedule, node2vec):
    """After the end, more K11/K12 phases leave every buffer that a walk
    keeps between phases as it was (the stage, code and histograms are
    scratch) and do not count themselves."""
    need_cuda()
    run = _card_run("tiles", schedule, node2vec)
    walks, info = run.run()
    before = [x.clone() for x in _all_buffers(run)]
    for _ in range(5):
        run.phase()
    assert run.inflight() == 0 and run.phases == info["phases"]
    for x, y in zip(_all_buffers(run), before, strict=True):
        eq(x, y.cpu().numpy())
    eq(run.result()[0], walks.cpu().numpy())


def _same_state_dicts(a, b):
    assert a.keys() == b.keys()
    for name in a:
        for x, y in zip(a[name] if isinstance(a[name], list) else [a[name]],
                        b[name] if isinstance(b[name], list) else [b[name]],
                        strict=True):
            eq(x, y.cpu().numpy())


@pytest.mark.cuda
def test_phase_kernels_refuse_bad_launches():
    need_cuda()
    g, pg = _card_graph(2)
    run = tv2.RoutedWalk(pg, torch.arange(64, dtype=torch.int32,
                                          device="cuda"), 4, (1, 2),
                         tv2.RoutedConfig.for_walk(64, 2, 4), "serial",
                         "kernel")
    launch = run.pipes[0].launch
    with pytest.raises(ValueError, match="packed for K11"):
        bindings.routed_node2vec_phase(launch, 0)
    pipe = run.pipes[0]

    def shards(**bad):
        return [bindings.RoutedShard(**{
            "meta": pg.node_meta[s], "col": pg.col[s], "walks": run.walks[s],
            "inbox": pipe.inbox[s], "outbox": pipe.outbox[s],
            "carry": pipe.carry[s], "stage": run._stage[s],
            "code": run._code[s], "hist": run._hist[s],
            "pool_count": pipe.pool_count[s], "hash_table": None,
            "bloom": None, "salt": 0,
            **{k: v[s] for k, v in bad.items()}}) for s in range(2)]

    def pack(sh, live_all=run.live.view(-1)):
        return bindings.routed_phase_launch(
            sh, run.stats, run.live[0], live_all, run._counter,
            shard_nodes=pg.shard_nodes, blk=32, walk_length=4, cap=run.cap,
            ccap=run.ccap, key=(1, 2))

    pack(shards())
    with pytest.raises(ValueError, match="carry must be"):  # one pool
        pack(shards(carry=pipe.carry[:, :1]))
    with pytest.raises(ValueError, match="hist must be"):
        pack(shards(hist=run._hist[:, :-1]))
    with pytest.raises(ValueError, match="pool_count must be"):
        pack(shards(pool_count=pipe.pool_count[:, :, :-1]))
    with pytest.raises(ValueError, match="live_all must be"):
        pack(shards(), run.live.view(-1).cpu())
    with pytest.raises(RuntimeError, match="launch failed"):  # pool 2
        bindings.routed_uniform_phase(launch, 2)
