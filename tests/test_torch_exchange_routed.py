"""The port's walker exchange and owner-routed uniform engine against the JAX
package with ``exchange="pallas"`` run in interpret mode on the virtual CPU
mesh, as tests/test_pallas_exchange.py runs it, and the overlapped schedule
against JAX's with ``exchange="xla"`` (tolerance 0: integers)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.graph.csr import CSRGraph as JCSRGraph
from torch_random_walk_tpu.parallel.mesh import make_mesh
from torch_random_walk_tpu.parallel.pallas_exchange import pallas_all_to_all
from torch_random_walk_tpu.parallel.partition import PartitionedCSR as JPartitionedCSR
from torch_random_walk_tpu.parallel.partition_v2 import (
    RoutedConfig as JRoutedConfig,
    walk_partitioned_routed as j_walk_routed,
)
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops.common import compact_indices
from torch_random_walk_tpu_torch.ops.uniform import uniform_walk_csr
from torch_random_walk_tpu_torch.parallel.exchange import (
    all_to_all_chunks,
    all_to_all_chunks_plain,
)
from torch_port_util import eq, need_cuda

N, E, B, L = 800, 4000, 128, 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(scope="module")
def graphs(mesh):
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    jg = JCSRGraph.from_edges(src, dst, num_nodes=N)
    tg = tt.CSRGraph.from_edges(src, dst, num_nodes=N, device="cpu")
    d = mesh.devices.size
    return (jg, JPartitionedCSR.from_csr(jg, d), tg,
            tt.PartitionedCSR.from_csr(tg, d))


def test_all_to_all_chunks_equals_pallas_kernel(mesh):
    d = mesh.devices.size
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, (d, d, 32, 3), dtype=np.uint64).astype(np.uint32)

    def via_pallas(xs):
        return pallas_all_to_all(xs[0], "data", d, interpret=True)[None]

    want = jax.jit(jax.shard_map(via_pallas, mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data"), check_vma=False))(
        jnp.asarray(x))
    outboxes = [torch.from_numpy(x[s].view(np.int32).copy()) for s in range(d)]
    inboxes = all_to_all_chunks(outboxes)
    got = torch.stack(inboxes).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(want))
    # written in place into inboxes the caller owns
    mine = [torch.zeros_like(o) for o in outboxes]
    assert all_to_all_chunks(outboxes, mine)[0] is mine[0]
    np.testing.assert_array_equal(torch.stack(mine).numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("capacity", [3, 8, 20])
def test_compact_indices(capacity):
    mask = torch.tensor(np.random.default_rng(1).random(16) < 0.5)
    want = np.flatnonzero(mask.numpy())[:capacity]
    want = np.concatenate([want, np.full(capacity - want.size, 16)])
    eq(compact_indices(mask, capacity), want)


def test_partition_equals_jax(graphs):
    _, jpg, _, tpg = graphs
    eq(torch.stack(tpg.node_meta), jpg.node_meta_shards)
    eq(torch.stack(tpg.col), jpg.col_shards)
    assert (tpg.num_nodes, tpg.num_shards, tpg.shard_nodes) == (
        jpg.num_nodes, jpg.num_shards, jpg.shard_nodes)
    assert len({t.data_ptr() for t in tpg.col + tpg.node_meta}) == 2 * tpg.num_shards


def test_partition_with_ragged_and_empty_shards():
    rng = np.random.default_rng(3)
    n = 13  # 8 shards of 2 nodes: the last shard is ragged, one is empty
    src, dst = rng.integers(0, n, 40), rng.integers(0, n, 40)
    jpg = JPartitionedCSR.from_csr(JCSRGraph.from_edges(src, dst, num_nodes=n), 8)
    tpg = tt.PartitionedCSR.from_csr(
        tt.CSRGraph.from_edges(src, dst, num_nodes=n, device="cpu"), 8)
    eq(torch.stack(tpg.node_meta), jpg.node_meta_shards)
    eq(torch.stack(tpg.col), jpg.col_shards)


def test_convert_partitioned_from_numpy(graphs):
    _, jpg, _, tpg = graphs
    cpg = convert.partitioned_from_numpy(
        np.asarray(jpg.node_meta_shards), np.asarray(jpg.col_shards),
        jpg.num_nodes, jpg.num_shards, jpg.shard_nodes, device="cpu")
    eq(torch.stack(cpg.node_meta), torch.stack(tpg.node_meta).numpy())
    eq(torch.stack(cpg.col), torch.stack(tpg.col).numpy())


def _both_engines(graphs, mesh, cfg_kwargs, seed=3):
    jg, jpg, tg, tpg = graphs
    targets = np.arange(B, dtype=np.int32) % N
    jw, jinfo = j_walk_routed(
        jpg, jnp.asarray(targets), mesh, L, seed=seed,
        config=JRoutedConfig(**cfg_kwargs) if cfg_kwargs else None,
        exchange="pallas", exchange_interpret=True)
    tw, tinfo = tt.walk_partitioned_routed(
        tpg, targets, L, seed=seed,
        config=tt.RoutedConfig(**cfg_kwargs) if cfg_kwargs else None,
        device="cpu")
    return targets, jw, jinfo, tw, tinfo


@pytest.mark.parametrize("cfg_kwargs", [
    dict(pair_capacity=128, log_capacity=128 * 9, max_phases=40),
    None,  # RoutedConfig.for_walk defaults
    # starved: records queue in the carry pool and lag phases
    dict(pair_capacity=4, max_phases=4000, carry_capacity=128),
], ids=["roomy", "default", "starved"])
def test_routed_engine_equals_jax_with_pallas_exchange(graphs, mesh,
                                                       cfg_kwargs):
    targets, jw, jinfo, tw, tinfo = _both_engines(graphs, mesh, cfg_kwargs)
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (B, L + 1)
    eq(tw, jw)
    assert tinfo == jinfo
    assert tinfo["overflow_dropped"] == 0
    assert tinfo["log_entries"] == B * (L + 1)
    if cfg_kwargs and cfg_kwargs["pair_capacity"] == 4:
        assert tinfo["phases"] > 2 * (L + 1)  # provably lagged
    tg = graphs[2]
    eq(tw, uniform_walk_csr(tg.row_ptr, tg.col_idx, targets, L, 3,
                            device="cpu").numpy())


@pytest.mark.parametrize("cfg_kwargs", [
    None,
    dict(pair_capacity=4, max_phases=4000, carry_capacity=128),
], ids=["default", "starved"])
def test_overlapped_schedule_equals_jax(graphs, mesh, cfg_kwargs):
    """The two-pipeline schedule: the same walks as the serial one and as
    the JAX engine's overlapped schedule (exchange="xla"), with its phase
    count, in the default configuration and with walkers queued in the
    carry pools."""
    jg, jpg, tg, tpg = graphs
    targets = np.arange(B, dtype=np.int32) % N
    jw, jinfo = j_walk_routed(
        jpg, jnp.asarray(targets), mesh, L, seed=3,
        config=JRoutedConfig(**cfg_kwargs) if cfg_kwargs else None,
        exchange="xla", schedule="overlapped")
    cfg = tt.RoutedConfig(**cfg_kwargs) if cfg_kwargs else None
    tw, tinfo = tt.walk_partitioned_routed(tpg, targets, L, seed=3,
                                           config=cfg, schedule="overlapped",
                                           device="cpu")
    eq(tw, jw)
    assert tinfo == jinfo and tinfo["schedule"] == "overlapped"
    sw, sinfo = tt.walk_partitioned_routed(tpg, targets, L, seed=3,
                                           config=cfg, device="cpu")
    eq(tw, sw.numpy())
    assert sinfo["schedule"] == "serial"
    assert tinfo["phases"] > sinfo["phases"]
    assert tinfo["exchanged_records"] == sinfo["exchanged_records"]


def test_routed_config_defaults_equal_jax():
    for b, d, l in [(128, 8, 8), (32768, 8, 80), (4096, 3, 5)]:
        j = JRoutedConfig.for_walk(b, d, l)
        t = tt.RoutedConfig.for_walk(b, d, l)
        assert (t.pair_capacity, t.carry, t.max_phases) == (
            j.pair_capacity, j.carry, j.max_phases)


def test_routed_truncated_run_raises(graphs):
    tpg = graphs[3]
    with pytest.raises(RuntimeError, match="routed walk incomplete"):
        tt.walk_partitioned_routed(
            tpg, np.arange(B) % N, L, seed=3, device="cpu",
            config=tt.RoutedConfig(pair_capacity=128, max_phases=3))


def test_routed_walkers_must_divide_by_shards(graphs):
    with pytest.raises(ValueError, match="divisible"):
        tt.walk_partitioned_routed(graphs[3], np.arange(B + 1) % N, L,
                                   device="cpu")


def k4_block_copy(plan, x):
    """Python mirror of K4's block -> (src, dst, range) mapping
    (kernels/exchange.cu::all_to_all_chunks_kernel): block (piece, dst, src)
    copies the words piece * threads * loads + k * threads + t (k < loads,
    t < threads) of chunk (src, dst) below ``elems``, in words of 16 bytes
    where ``plan.vec``.  Applies it to the stacked outboxes ``x`` (D, D, C,
    R) and returns the stacked inboxes, checking that every word is written
    exactly once."""
    d = plan.num_shards
    words = x.reshape(d, d, plan.elems, -1)  # (src, dst, elems, 4 or 1)
    inbox = np.zeros_like(words)
    written = np.zeros((d, d, plan.elems), dtype=np.int64)
    piece, k, t = np.meshgrid(np.arange(plan.pieces), np.arange(plan.loads),
                              np.arange(plan.threads), indexing="ij")
    idx = (piece * plan.threads * plan.loads + k * plan.threads + t).ravel()
    for dst in range(d):
        for src in range(d):
            i = idx[idx < plan.elems]
            inbox[dst, src, i] = words[src, dst, i]
            np.add.at(written[dst, src], i, 1)
    assert (written == 1).all()
    return inbox.reshape(x.shape)


@pytest.mark.parametrize("shards", [1, 2, 8, 16])
@pytest.mark.parametrize("cap,width", [(1, 14), (5, 3), (128, 3), (2048, 3),
                                       (5, 4), (128, 15)])
def test_exchange_block_mapping_mirror_equals_jax_layout(shards, cap, width):
    """K4's mapping, mirrored on the CPU, gives the layout of
    lax.all_to_all(split_axis=0, concat_axis=0) over the stacked shards (the
    function of pallas_all_to_all, to which
    test_all_to_all_chunks_equals_pallas_kernel holds the port)."""
    rng = np.random.default_rng(shards * 1000 + cap)
    x = rng.integers(-2**31, 2**31, (shards, shards, cap, width))
    x = x.astype(np.int32)
    want = np.asarray(jnp.swapaxes(jnp.asarray(x), 0, 1))
    words = cap * width
    for vec in {words % 4 == 0, False}:
        plan = bindings.exchange_plan(shards, words, vec)
        assert plan.elems * (4 if vec else 1) == words
        np.testing.assert_array_equal(k4_block_copy(plan, x), want)


def test_exchange_refuses_more_than_256_shards():
    assert bindings.exchange_plan(256, 12, True).num_shards == 256
    with pytest.raises(ValueError, match="1 to 256 shards"):
        bindings.exchange_plan(257, 12, True)
    boxes = [torch.zeros((257, 1, 3), dtype=torch.int32) for _ in range(257)]
    with pytest.raises(ValueError, match="1 to 256 shards"):
        bindings.chunk_pointer_table(boxes, boxes)


@pytest.mark.cuda
def test_exchange_kernel_equals_plain_version():
    need_cuda()
    rng = np.random.default_rng(5)
    for shards in (1, 2, 8, 16):
        for cap in (1, 5, 128, 2048):
            for width in (3, 14, 4, 15):
                # offset 1: every buffer one word off a 16-byte boundary, so
                # the 4-byte path runs whatever the chunk size
                for offset in (0, 1):
                    x = rng.integers(-2**31, 2**31,
                                     (shards, shards, cap, width))
                    outboxes = []
                    for s in range(shards):
                        buf = torch.empty(x[s].size + offset,
                                          dtype=torch.int32, device="cuda")
                        outboxes.append(buf[offset:].view(x[s].shape).copy_(
                            torch.from_numpy(x[s])))
                    inboxes = [
                        torch.empty(x[s].size + offset, dtype=torch.int32,
                                    device="cuda")[offset:].view(x[s].shape)
                        for s in range(shards)]
                    got = all_to_all_chunks(outboxes, inboxes)
                    want = all_to_all_chunks_plain(outboxes)
                    for g, w in zip(got, want, strict=True):
                        eq(g, w.cpu().numpy())
    big = [torch.zeros((257, 1, 3), dtype=torch.int32, device="cuda")
           for _ in range(257)]
    with pytest.raises(ValueError, match="1 to 256 shards"):
        all_to_all_chunks(big)
