"""Edge-partitioned walks with owner-routed walker exchange (twin of the
uniform engine, serial schedule, of
``torch_random_walk_tpu/parallel/partition_v2.py``).

Each walker is one fixed-width record (wid, step, node) of uint32 words.  The
graph is node-range partitioned (``PartitionedCSR``); every *phase*, every
shard takes the records that arrived in its inbox, draws the next neighbour
for the walkers standing on its nodes (STEP arrivals) or logs a position into
its even share of the walk tensor (LOG arrivals, at the walker's wid-owner),
and compacts the departing records into one capacity-C chunk per destination.
One all-to-all of those chunks (``parallel/exchange.py``, kernel K4 on a CUDA
device) ends the phase.  Departures beyond a chunk's capacity wait in a carry
pool and leave first next phase (FIFO), so walkers lag but never drop.

Where the JAX package runs ``shard_map`` over a device mesh, the port runs D
logical shards on one device: each shard owns its own tensors (node meta,
col, walk shard, outbox, inbox, carry pool), the phase loop runs on the host,
and the in-flight count is read back once per phase for the loop test.
**So far every shard lives on the same card**; shards on separate cards,
exchanging through peer-mapped pointers, are a later step.

Draws use the same (seed, stream, walker id, step) Threefry counters as
``ops/uniform.py``, and the carry/arrival order is the JAX engine's, so the
walks, the phase count and the exchanged-record count all equal JAX's.
"""

from __future__ import annotations

import dataclasses

import torch

from torch_random_walk_tpu_torch.ops.common import as_int32, compact_indices
from torch_random_walk_tpu_torch.parallel import exchange
from torch_random_walk_tpu_torch.parallel.partition import PartitionedCSR
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device

# Record layout (uint32 words, stored as int32 bit patterns): wid, step,
# node.  `step` counts completed steps; `node` is walk[step].
_R_UNIFORM = 3
# An empty record slot: wid word 0xFFFFFFFF, which is -1 as int32.
_SENTINEL = -1
# LOG-hop marker, the top bit of the step word (the sign bit as int32, so it
# is masked off before the step is compared).  A record cycles
# owner(v_s) --draw--> wid-owner (logs walk[s+1], forwards) --> owner(v_s+1).
_LOG_BIT = 1 << 31


@dataclasses.dataclass(frozen=True)
class RoutedConfig:
    """Capacities of the routed exchange.

    pair_capacity: records one shard may send one destination per phase.
    carry_capacity: slots of the shared carry pool for departures beyond
        their destination's pair_capacity.  Every walker is one record, so a
        pool of B slots cannot overflow whatever the skew.
    max_phases: bound of the phase loop (0 = derive it from the capacities).
    log_capacity: accepted and ignored, as in the JAX package.
    """

    pair_capacity: int
    log_capacity: int | None = None
    max_phases: int = 0
    carry_capacity: int | None = None

    @property
    def carry(self) -> int:
        return (self.carry_capacity if self.carry_capacity is not None
                else 4 * self.pair_capacity)

    @classmethod
    def for_walk(cls, num_walkers: int, num_shards: int, walk_length: int,
                 balance: float = 4.0) -> "RoutedConfig":
        """Zero-drop default: pair_capacity ~ balance * B / D^2 rounded up to
        a multiple of 128, a carry pool of B slots, and a phase bound that
        covers a fully skewed step draining at pair_capacity per phase (each
        step is two phases: draw and log)."""
        pair = int(balance * max(num_walkers // max(num_shards ** 2, 1), 1))
        pair = max((pair + 127) // 128 * 128, 128)
        drain = (num_walkers + pair - 1) // pair
        return cls(pair_capacity=pair,
                   max_phases=(2 * walk_length + 4) * max(4, drain),
                   carry_capacity=num_walkers)

    @classmethod
    def resolve(cls, config: "RoutedConfig | None", num_walkers: int,
                num_shards: int, walk_length: int) -> "RoutedConfig":
        """Default config, or a hand-built one with its phase bound filled
        in from its own pair_capacity."""
        if config is None:
            return cls.for_walk(num_walkers, num_shards, walk_length)
        if config.max_phases > 0:
            return config
        drain = (num_walkers + config.pair_capacity - 1) // config.pair_capacity
        return dataclasses.replace(
            config, max_phases=(2 * walk_length + 4) * max(4, drain))


def _empty_carry(ccap: int, width: int, device):
    """Shared carry pool: (ccap, width + 1) int32 records (last column = the
    stored destination) and its validity mask."""
    carry = torch.zeros((ccap, width + 1), dtype=torch.int32, device=device)
    carry[:, 0] = _SENTINEL
    return carry, torch.zeros((ccap,), dtype=torch.bool, device=device)


def _build_outbox(recs, dests, valid, carry, carry_valid, nshards, cap, ccap,
                  outbox):
    """Compact departing records into the per-destination chunks of
    ``outbox`` (D, cap, R), written in place, carried-over records first
    (FIFO: no starvation); departures beyond a destination's ``cap`` go to
    one shared carry pool of ``ccap`` slots for the next phase.

    Returns (carry (ccap, R+1), carry_valid (ccap,), overflow count)."""
    width = recs.shape[-1]
    all_recs = torch.cat([carry[:, :width], recs])
    all_dest = torch.cat([carry[:, width].to(torch.int64), dests])
    all_valid = torch.cat([carry_valid, valid])
    n_all = all_recs.shape[0]
    pad_rec = torch.zeros((1, width), dtype=torch.int32, device=recs.device)
    pad_rec[0, 0] = _SENTINEL
    recs_pad = torch.cat([all_recs, pad_rec])  # row n_all is the empty record
    shipped = torch.zeros((n_all,), dtype=torch.bool, device=recs.device)
    for d in range(nshards):
        want = all_valid & (all_dest == d)
        pos = torch.cumsum(want.to(torch.int64), 0) - 1
        shipped |= want & (pos < cap)
        outbox[d] = recs_pad[compact_indices(want, cap)]
    left = all_valid & ~shipped
    overflow = (left.sum() - ccap).clamp(min=0)
    lidx = compact_indices(left, ccap)
    ok = lidx < n_all
    carry_rec = recs_pad[lidx]
    carry_dest = torch.where(ok, all_dest[lidx.clamp(max=n_all - 1)],
                             torch.zeros_like(lidx)).to(torch.int32)
    return torch.cat([carry_rec, carry_dest[:, None]], dim=1), ok, overflow


def _check_complete(info, num_walkers: int, walk_length: int,
                    cfg: RoutedConfig) -> None:
    """A dropped record or a truncated phase loop silently corrupts walks;
    fail loudly instead (every walker must log exactly L+1 positions)."""
    expected = num_walkers * (walk_length + 1)
    if info["overflow_dropped"] or info["log_entries"] != expected:
        raise RuntimeError(
            f"routed walk incomplete: {info['overflow_dropped']} records "
            f"dropped, {info['log_entries']}/{expected} positions logged "
            f"after {info['phases']} phases — raise RoutedConfig capacities "
            f"(pair_capacity={cfg.pair_capacity}, carry={cfg.carry}, "
            f"max_phases={cfg.max_phases})")


class _Shard:
    """One logical shard's state: its slice of the graph, its even share of
    the walk tensor, its exchange buffers, carry pool and counters."""

    def __init__(self, my, meta, col, targets, nshards, walk_length, cap,
                 ccap):
        dev = col.device
        blk = targets.shape[0]
        self.my, self.meta, self.col, self.blk = my, meta, col, blk
        # Row blk and column L+1 are spare: records that log nothing are
        # scattered there, so the scatter needs no "drop" mode.
        self.walks = torch.zeros((blk + 1, walk_length + 2),
                                 dtype=torch.int32, device=dev)
        self.walks[:blk, 0] = targets
        self.outbox = torch.empty((nshards, cap, _R_UNIFORM),
                                  dtype=torch.int32, device=dev)
        self.inbox = torch.empty_like(self.outbox)
        self.carry, self.carry_valid = _empty_carry(ccap, _R_UNIFORM, dev)
        self.log_n = torch.full((), blk, dtype=torch.int64, device=dev)
        self.sent = torch.zeros((), dtype=torch.int64, device=dev)
        self.overflow = torch.zeros((), dtype=torch.int64, device=dev)

    def inflight(self):
        return ((self.outbox[:, :, 0] != _SENTINEL).sum()
                + self.carry_valid.sum())


def _process(sh: _Shard, key, nshards, shard_nodes, walk_length, cap, ccap):
    """One shard's phase body: log or sample every arrival of ``sh.inbox``,
    then build the next outbox (in place) and carry pool."""
    recs = sh.inbox.reshape(-1, _R_UNIFORM)
    wid = prng.as_u32(recs[:, 0])
    word1 = prng.as_u32(recs[:, 1])
    arrived = recs[:, 0] != _SENTINEL
    is_log = arrived & ((word1 & _LOG_BIT) != 0)
    step = word1 & (_LOG_BIT - 1)
    v = recs[:, 2].to(torch.int64)

    # LOG arrivals: this shard is the walker's wid-owner.  Write
    # walk[step] = v into the local share, then forward the same record to
    # owner(v) for the next draw (unless the walk is finished).
    wrow = torch.where(is_log, wid - sh.my * sh.blk,
                       torch.full_like(wid, sh.blk))
    wcol = torch.where(is_log, step, torch.full_like(step, walk_length + 1))
    sh.walks[wrow, wcol] = recs[:, 2]
    sh.log_n += is_log.sum()
    fwd_log = is_log & (step < walk_length)
    rec_fwd = torch.stack([recs[:, 0], prng.to_i32_bits(step), recs[:, 2]],
                          dim=1)
    dest_fwd = (v // shard_nodes).clamp(0, nshards - 1)

    # STEP arrivals: this shard owns v.  Draw the next neighbour and send the
    # advanced record to the walker's wid-owner to be logged.
    stepping = arrived & ~is_log & (step < walk_length)
    rows = sh.meta[(v - sh.my * shard_nodes).clamp(0, shard_nodes - 1)]
    start, deg = rows[:, 0].to(torch.int64), rows[:, 1].to(torch.int64)
    bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(step + 1))
    off = prng.randint_from_bits(bits, deg.clamp(min=1))
    idx = (start + off).clamp(0, sh.col.shape[0] - 1)
    nxt = torch.where(deg > 0, sh.col[idx], recs[:, 2])
    new_rec = torch.stack(
        [recs[:, 0], prng.to_i32_bits((step + 1) | _LOG_BIT), nxt], dim=1)
    dest_new = (wid // sh.blk).clamp(0, nshards - 1)

    valid_out = torch.cat([fwd_log, stepping])
    sh.carry, sh.carry_valid, ovf = _build_outbox(
        torch.cat([rec_fwd, new_rec]), torch.cat([dest_fwd, dest_new]),
        valid_out, sh.carry, sh.carry_valid, nshards, cap, ccap, sh.outbox)
    sh.sent += valid_out.sum()
    sh.overflow += ovf


def walk_partitioned_routed(pgraph: PartitionedCSR, target_nodes,
                            walk_length: int, seed: int = 0,
                            config: RoutedConfig | None = None, device=None):
    """Uniform CSR walks with owner-routed walker exchange, serial schedule.

    Returns (walks (B, L+1) int32, stats dict with ``log_entries``,
    ``exchanged_records``, ``phases``, ``overflow_dropped``,
    ``exchange_bytes``, ``schedule``).  The walks equal
    ``ops.uniform.uniform_walk_csr`` for the same targets and seed.
    """
    dev = resolve_device(device)
    if pgraph.device != dev:
        raise ValueError(f"partitioned graph lives on {pgraph.device}, walk "
                         f"was asked for {dev}")
    targets = as_int32(target_nodes, dev)
    num_walkers = int(targets.shape[0])
    nshards = pgraph.num_shards
    walk_length = int(walk_length)
    if num_walkers % nshards:
        raise ValueError(
            f"num_walkers ({num_walkers}) must be divisible by the shard "
            f"count ({nshards}); pad the target batch.")
    if walk_length < 0:
        raise ValueError(f"walk_length must be >= 0, got {walk_length}")
    cfg = RoutedConfig.resolve(config, num_walkers, nshards, walk_length)
    cap, ccap = cfg.pair_capacity, cfg.carry
    blk = num_walkers // nshards
    key = prng.derive_key(int(seed), prng.STREAM_CSR_UNIFORM)

    shards = [
        _Shard(d, pgraph.node_meta[d], pgraph.col[d],
               targets[d * blk:(d + 1) * blk], nshards, walk_length, cap, ccap)
        for d in range(nshards)
    ]
    # Phase-0 outbox: route each local target to the owner of its node.
    for sh in shards:
        tgt = sh.walks[:blk, 0]
        wid0 = sh.my * blk + torch.arange(blk, dtype=torch.int64, device=dev)
        rec0 = torch.stack([prng.to_i32_bits(wid0), torch.zeros_like(tgt),
                            tgt], dim=1)
        dest0 = (tgt.to(torch.int64) // pgraph.shard_nodes).clamp(
            0, nshards - 1)
        valid0 = torch.full((blk,), walk_length > 0, dtype=torch.bool,
                            device=dev)
        sh.carry, sh.carry_valid, ovf = _build_outbox(
            rec0, dest0, valid0, sh.carry, sh.carry_valid, nshards, cap, ccap,
            sh.outbox)
        sh.overflow += ovf

    exchange_chunks = exchange.ChunkExchange([sh.outbox for sh in shards],
                                             [sh.inbox for sh in shards])
    phases = 0
    inflight = int(sum(sh.inflight() for sh in shards))
    while inflight > 0 and phases < cfg.max_phases:
        exchange_chunks()
        for sh in shards:
            _process(sh, key, nshards, pgraph.shard_nodes, walk_length, cap,
                     ccap)
        # Records still travelling anywhere, read back for the loop test.
        inflight = int(sum(sh.inflight() for sh in shards))
        phases += 1

    # The wid-sharded shares, in shard order, are the walk tensor.
    walks = torch.cat([sh.walks[:blk, : walk_length + 1] for sh in shards])
    exchanged = int(sum(sh.sent for sh in shards))
    info = {
        "log_entries": int(sum(sh.log_n for sh in shards)),
        "exchanged_records": exchanged,
        "phases": phases,
        "overflow_dropped": int(sum(sh.overflow for sh in shards)),
        "exchange_bytes": exchanged * _R_UNIFORM * 4,
        "schedule": "serial",
    }
    _check_complete(info, num_walkers, walk_length, cfg)
    return walks, info
