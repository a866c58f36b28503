"""The port's walker exchange and owner-routed uniform engine against the JAX
package with ``exchange="pallas"`` run in interpret mode on the virtual CPU
mesh, as tests/test_pallas_exchange.py runs it (tolerance 0: integers)."""

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


@pytest.mark.cuda
def test_exchange_kernel_equals_plain_version():
    need_cuda()
    rng = np.random.default_rng(5)
    for cap, width in [(128, 3), (5, 3), (256, 14)]:  # 16-byte and 4-byte paths
        x = rng.integers(-2**31, 2**31, (8, 8, cap, width)).astype(np.int32)
        outboxes = [torch.from_numpy(x[s]).cuda() for s in range(8)]
        got = all_to_all_chunks(outboxes)
        want = all_to_all_chunks_plain(outboxes)
        for g, w in zip(got, want, strict=True):
            eq(g, w.cpu().numpy())
