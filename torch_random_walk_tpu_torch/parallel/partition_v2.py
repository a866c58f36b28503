"""Edge-partitioned walks with owner-routed walker exchange (twin of the
uniform and node2vec CSR engines of
``torch_random_walk_tpu/parallel/partition_v2.py``).

Each walker is one fixed-width record of uint32 words (int32 bit patterns
here).  The graph is node-range partitioned (``PartitionedCSR``); every
*phase*, every shard takes the records that arrived in its inbox, logs a
position into its even share of the walk tensor (LOG arrivals, at the
walker's wid-owner) or draws for the walkers standing on its nodes, and
compacts the departing records into one capacity-C chunk per destination.
One all-to-all of those chunks (``parallel/exchange.py``, kernel K4 on a
CUDA device) starts the next phase.  Departures beyond a chunk's capacity
wait in a carry pool and leave first next phase (FIFO), so walkers lag but
never drop.

- **Uniform** records are (wid, step, node): STEP at owner(node) draws the
  next node, LOG at the wid-owner writes it.
- **node2vec** records are 14 words (``_R_N2V``): at owner(v) a STEP record
  draws ``spec_rounds`` rejection rounds and decides each draw that does not
  depend on t's neighbourhood, with N(t)'s Bloom filter, carried in the
  record, ruling most of the others out; draws left frozen go to owner(t)
  as a RESOLVE record, whose exact test (the shard's cuckoo edge set, or a
  binary search of t's row) decides them there.

Two schedules, one phase body each (``RoutedWalk.process``): ``serial``
exchanges and then processes one pipeline a phase; ``overlapped`` splits the
walkers into two pipelines by lane parity and, each phase, exchanges one
while it processes the other (the JAX package's ``_overlapped_drive``), so
on the card K4 of one pipeline runs on a second stream beside the phase
kernel of the other.  The phase count is the JAX engine's either way.

Where the JAX package runs ``shard_map`` over a device mesh, the port runs
D logical shards on one device: each shard has its own graph slice (node
meta, col) and its own views of the walk's buffers (walk rows, and per
pipeline its outbox, inbox and carry pool), which the kernels take by base
pointer.  The phase loop runs on the host and enqueues up to
``PHASES_PER_READ`` phases between two reads of the phase counter and the
in-flight count (on the card, a whole batch of the overlapped schedule as
one replay of a CUDA graph).  The counter lives on the device: each phase
adds one to it iff a record was in flight before it (the JAX loop's test),
and once nothing is in flight nothing ever is again, so a phase enqueued
after the end changes nothing; the host never enqueues past the phase
budget.  The phase body is a hand kernel on a CUDA device (K11
``routed_uniform_phase``, K12 ``routed_node2vec_phase``, one call a phase
for all shards: ``kernels/routed.cu``; there each pipeline has two carry
pools, one read and one filled a phase) and plain PyTorch on the CPU (one
pool); the choice is the device's and nothing else's.  **So far every
shard lives on one card.**

Draws use the same (seed, stream, walker id, step, round) Threefry counters
as ``ops/uniform.py`` and ``ops/node2vec.py``, and the carry and arrival
order is the JAX engine's, so the walks, the phase count and the exchanged
record count all equal JAX's.
"""

from __future__ import annotations

import dataclasses

import torch

from torch_random_walk_tpu_torch.graph.bloom import (
    BLOOM_WORDS,
    bloom_maybe,
    build_node_blooms,
)
from torch_random_walk_tpu_torch.graph.hashset import table_contains
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops.common import (
    DEFAULT_MAX_ROUNDS,
    as_int32,
    node2vec_accept_probs,
)
from torch_random_walk_tpu_torch.parallel import exchange
from torch_random_walk_tpu_torch.parallel.partition import PartitionedCSR
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device

# Uniform record (uint32 words): wid, step, node.  `step` counts completed
# steps; `node` is walk[step].
_R_UNIFORM = 3
# An empty record slot: wid word 0xFFFFFFFF, which is -1 as int32.
_SENTINEL = -1
# Uniform LOG-hop marker, the top bit of the step word (the sign bit as
# int32).  A record cycles owner(v_s) --draw--> wid-owner (logs walk[s+1],
# forwards) --> owner(v_s+1).
_LOG_BIT = 1 << 31
# node2vec record: w0 wid | w1 step + flags << 24 | w2 t | w3 v | w4 replay
# round | w5 a_cand | w6 f1_cand | w7 f1_rnd | w8 f2_cand | w9 f2_rnd |
# w10-w13 a 128-bit Bloom filter: N(t) on STEP records, N(v) on RESOLVE ones.
# flags: bit0 RESOLVE mode, bit1 has_a, bit2 overflow (a third frozen draw
# stopped the scan), bits 3-4 frozen draws, bit5 LOG (the record is on its
# wid-owner hop: walk[step] = w3 is written there, then it forwards to
# owner(w3) with its flags cleared).
_R_N2V = 14
_F_MODE, _F_HAS_A, _F_OVF, _F_LOG = 1, 2, 4, 32
_STEP_MASK = (1 << 24) - 1
SCHEDULES = ("serial", "overlapped")
BODIES = ("kernel", "plain")
# Phases the loop enqueues between two reads of the phase counter and the
# in-flight count (chosen from H100 runs of chip_smoke.py, PERF.md §6).
PHASES_PER_READ = 16
# Schedules whose whole batches of phases replay on the card as one CUDA
# graph of the walk's own phase calls, captured once a walk (PERF.md §6:
# the overlapped schedule's two streams cost the host more than a replay;
# a serial batch enqueues as fast as a capture).  A graph needs
# PHASES_PER_READ a multiple of 4, so that a batch leaves the pipelines'
# roles and live pools as it found them.
GRAPH_SCHEDULES = ("overlapped",)


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


def _biased_phase_budget(cfg: RoutedConfig, walk_length: int,
                         spec_rounds: int) -> RoutedConfig:
    """Raise a default config's phase bound for the node2vec engine: a
    replay phase advances only ``spec_rounds`` rounds of a step, so budget
    the single-device engines' round ceiling (the loop ends when nothing is
    in flight, so a generous bound costs nothing)."""
    need = walk_length * (DEFAULT_MAX_ROUNDS // max(spec_rounds, 1) + 2)
    if cfg.max_phases >= need:
        return cfg
    return dataclasses.replace(cfg, max_phases=need)


def build_partition_blooms(pgraph: PartitionedCSR, graph) -> torch.Tensor:
    """(D, S, 4) int32 bit patterns: each node's 128-bit Bloom filter over
    its out-neighbours, node-range sharded like ``pgraph`` (rows past the
    last node are empty), on the partitioned graph's device."""
    dev = pgraph.device
    flat = build_node_blooms(graph.row_ptr.to(dev), graph.col_idx.to(dev))
    s = pgraph.shard_nodes
    padded = torch.zeros((pgraph.num_shards * s, BLOOM_WORDS),
                         dtype=torch.int32, device=dev)
    padded[: flat.shape[0]] = flat
    return padded.view(pgraph.num_shards, s, BLOOM_WORDS)


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


def build_outbox(cands, carry, cap: int, outbox):
    """Compact every shard's departing records into its per-destination
    chunks of ``outbox`` (D, D, cap, R), written in place.  ``cands`` lists
    the valid candidates as segments (records (M, R), destinations (M,),
    shards (M,)): in the order of each shard's own candidates, its carry
    pool's live prefix, then each departure stream in turn.  Destination d
    of shard s takes the first ``cap`` of them; the rest go to the shard's
    carry pool in order, up to ccap, and the excess is counted as overflow.
    Empty slots hold the sentinel record.  This is ``_build_outbox`` of the
    JAX package for every shard at once, and K11 and K12 compact exactly
    so.

    Returns (new carry (D, ccap, R+1), and per shard (D,) int64: records
    carried, boxed and dropped)."""
    nshards, ccap = carry.shape[0], carry.shape[1]
    dev = outbox.device
    recs = torch.cat([r for r, _, _ in cands])
    dest = torch.cat([d for _, d, _ in cands])
    shard = torch.cat([sh for _, _, sh in cands])
    # Each shard's candidates in their order; then each (shard, dest) group.
    order = torch.sort(shard, stable=True).indices
    recs, dest, shard = recs[order], dest[order], shard[order]
    group = shard * nshards + dest
    keys, by_group = torch.sort(group, stable=True)
    rank = torch.empty_like(group)
    rank[by_group] = (torch.arange(group.shape[0], device=dev)
                      - torch.searchsorted(keys, keys))
    shipped = rank < cap
    left = ~shipped
    lrank = torch.empty_like(group)
    lshard = shard[left]
    lrank[left] = (torch.arange(lshard.shape[0], device=dev)
                   - torch.searchsorted(lshard, lshard))
    carried = left & (lrank < ccap)
    outbox.zero_()
    outbox[..., 0] = _SENTINEL
    outbox[shard[shipped], dest[shipped], rank[shipped]] = recs[shipped]
    new_carry = torch.zeros_like(carry)
    new_carry[:, :, 0] = _SENTINEL
    new_carry[shard[carried], lrank[carried]] = torch.cat(
        [recs[carried], dest[carried, None].to(torch.int32)], 1)
    counts = torch.stack([carried, shipped, left & ~carried], 1)
    per_shard = torch.zeros((nshards, 3), dtype=torch.int64, device=dev)
    per_shard.index_add_(0, shard, counts.to(torch.int64))
    return new_carry, per_shard[:, 0], per_shard[:, 1], per_shard[:, 2]


def _carry_candidates(carry, carry_n):
    """The live prefix of every shard's carry pool as build_outbox's first
    segment."""
    width = carry.shape[2] - 1
    live = torch.arange(carry.shape[1], device=carry.device) < carry_n[:, None]
    rows = carry[live]
    return (rows[:, :width], rows[:, width].to(torch.int64),
            live.nonzero()[:, 0])


class _Pipe:
    """One pipeline's exchange state, per shard: an outbox and an inbox (D,
    cap, R), views of (D, D, cap, R) tensors; ``pools`` carry pools (ccap,
    R+1) compacted to the front, of which ``parity`` is the live one (the
    kernels read one and fill the other each phase; the plain body has
    one); and the live counts ``live[s]`` = (records boxed, records
    carried), a row of the engine's (pipelines, D, 2) int64 tensor.  K4
    exchanges the per-shard views."""

    def __init__(self, nshards, cap, ccap, width, dev, live, pools):
        shape = (nshards, nshards, cap, width)
        self.outbox = torch.empty(shape, dtype=torch.int32, device=dev)
        self.inbox = torch.empty(shape, dtype=torch.int32, device=dev)
        self.carry = torch.zeros((nshards, pools, ccap, width + 1),
                                 dtype=torch.int32, device=dev)
        self.parity = 0
        self.live = live
        self.exchange = exchange.ChunkExchange(list(self.outbox),
                                               list(self.inbox))
        self.launch = None  # the phase kernel's packed launch (on the card)
        self.pool_count = None  # the kernels' counts of both pools

    @property
    def pool(self):
        """The live carry pool of every shard, (D, ccap, R+1)."""
        return self.carry[:, self.parity]


class RoutedWalk:
    """One routed walk: its shards' state, the phase body and the two
    schedules' phase loops.  ``walk_partitioned_routed`` and
    ``walk_partitioned_node2vec_routed`` build one and ``run`` it, with the
    phase body that the device takes (``body="kernel"`` on a CUDA device,
    ``"plain"`` on the CPU).  The plain body on the card is what the kernels
    are held against; ``start``, ``phase``, ``inflight``, ``state`` and
    ``result`` step a walk phase by phase for that.  The plain body runs
    every shard at once, on stacked copies of the shards' tables.  The
    phase counter (``phases``) is a device tensor that each phase adds to
    while anything is in flight, on the card in the body kernel and here in
    tensor code."""

    def __init__(self, pgraph: PartitionedCSR, targets, walk_length: int,
                 key, cfg: RoutedConfig, schedule: str, body: str,
                 node2vec=None):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                             f"{schedule!r}")
        if body not in BODIES:
            raise ValueError(f"body must be one of {BODIES}, got {body!r}")
        dev = pgraph.device
        if body == "kernel" and dev.type != "cuda":
            raise ValueError("the phase kernels run on a CUDA device only")
        self.pgraph, self.key, self.cfg = pgraph, key, cfg
        self.schedule, self.body = schedule, body
        self.n2v = node2vec
        self.width = _R_N2V if node2vec is not None else _R_UNIFORM
        self.nshards = d = pgraph.num_shards
        self.num_walkers = int(targets.shape[0])
        self.blk = self.num_walkers // d
        self.walk_length = int(walk_length)
        self.cap, self.ccap = cfg.pair_capacity, cfg.carry
        self.max_phases = cfg.max_phases * (2 if schedule == "overlapped"
                                            else 1)
        # Walk shares (D, blk+1, L+2): row blk and column L+1 are spare, the
        # plain body scatters the records that log nothing there.
        self.walks = torch.zeros((d, self.blk + 1, self.walk_length + 2),
                                 dtype=torch.int32, device=dev)
        self.walks[:, : self.blk, 0] = targets.view(d, self.blk)
        # Per shard: positions logged, records sent, records dropped.
        self.stats = torch.zeros((d, 3), dtype=torch.int64, device=dev)
        self.stats[:, 0] = self.blk
        npipes = 2 if schedule == "overlapped" else 1
        self.live = torch.zeros((npipes, d, 2), dtype=torch.int64, device=dev)
        self._counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.pipes = [_Pipe(d, self.cap, self.ccap, self.width, dev,
                            self.live[p], 2 if body == "kernel" else 1)
                      for p in range(npipes)]
        self.enqueued = 0  # phases enqueued, no-ops after the end included
        self._stream = None
        self._graph = None  # (CUDA graph of a batch, the launches it makes)
        if body == "kernel":
            shapes = bindings.routed_scratch_shapes(d, self.cap, self.ccap,
                                                    self.blk, self.width)
            self._stage, self._code, self._hist = (
                torch.empty((d, *shapes[k]), dtype=torch.int32, device=dev)
                for k in ("stage", "code", "hist"))
            for pipe in self.pipes:
                pipe.pool_count = torch.zeros((d, *shapes["pool_count"]),
                                              dtype=torch.int32, device=dev)
                pipe.launch = self._pack_launch(pipe)
            if npipes == 2:
                self._stream = torch.cuda.Stream(device=dev)
        else:
            self._meta = torch.stack(pgraph.node_meta)
            self._col = torch.stack(pgraph.col)
            self._my = None  # the shard of each record the body holds

    # -- phase 0 --------------------------------------------------------

    def start(self) -> None:
        """Build the phase-0 outboxes: every local target's first record to
        the owner of its node; under ``overlapped`` the even local lanes in
        pipeline A, the odd ones in B (and one exchange of B).  On the card
        the records are staged and the phase kernel's compaction builds the
        outboxes."""
        dev, d, blk = self.pgraph.device, self.nshards, self.blk
        tgt = self.walks[:, :blk, 0].reshape(-1)
        rec0 = torch.zeros((d * blk, self.width), dtype=torch.int32,
                           device=dev)
        rec0[:, 0] = prng.to_i32_bits(torch.arange(d * blk, device=dev))
        rec0[:, 2] = tgt
        if self.n2v is not None:
            rec0[:, 3] = tgt
        dest0 = self._owner(tgt.to(torch.int64))
        shard0 = torch.arange(d, device=dev).repeat_interleave(blk)
        lane = torch.arange(d * blk, device=dev) % blk
        sel = [lane >= 0] if len(self.pipes) == 1 else [lane % 2 == 0,
                                                         lane % 2 == 1]
        if self.walk_length == 0:
            sel = [lane < 0 for _ in sel]
        if self.body == "kernel":
            self._stage[:, :blk] = rec0.view(d, blk, self.width)
        for pipe, keep in zip(self.pipes, sel, strict=True):
            if self.body == "kernel":
                self._code[:, :blk] = torch.where(
                    keep, dest0, -1).view(d, blk).to(torch.int32)
                pipe.outbox.zero_()
                pipe.outbox[..., 0] = _SENTINEL
                pipe.pool_count.zero_()
                bindings.routed_start(pipe.launch)  # pool 0 into pool 1
                pipe.parity = 1
                continue
            carry, carried, boxed, ovf = build_outbox(
                [(rec0[keep], dest0[keep], shard0[keep])], pipe.pool,
                self.cap, pipe.outbox)
            pipe.pool.copy_(carry)
            pipe.live[:, 0] = boxed
            pipe.live[:, 1] = carried
            self.stats[:, 2] += ovf
        if len(self.pipes) == 2:
            self.pipes[1].exchange()

    # -- one phase ------------------------------------------------------

    def phase(self) -> None:
        """One body of the schedule: serial, exchange the pipeline and
        process it; overlapped, exchange pipeline X while processing Y,
        then swap them.  The phase counter adds one if anything was in
        flight before (the kernels' body does it on the card)."""
        if self.body == "plain":
            self._counter += (self.live.sum() > 0).to(torch.int64)
        if len(self.pipes) == 1:
            self.pipes[0].exchange()
            self.process(self.pipes[0])
        else:
            x = self.pipes[self.enqueued % 2]
            y = self.pipes[1 - self.enqueued % 2]
            if self._stream is not None:
                main = torch.cuda.current_stream(self.pgraph.device)
                self._stream.wait_stream(main)
                with torch.cuda.stream(self._stream):
                    x.exchange()
                self.process(y)
                main.wait_stream(self._stream)
            else:
                x.exchange()
                self.process(y)
        self.enqueued += 1

    @property
    def phases(self) -> int:
        """Phases run while anything was in flight (reads the counter)."""
        return int(self._counter)

    def inflight(self) -> int:
        """Records still travelling anywhere: boxed or carried, in every
        pipeline and shard (a record exchanged but not yet processed counts
        under its pipeline's boxed)."""
        return int(self.live.sum())

    def process(self, pipe: _Pipe) -> None:
        """The phase body of every shard for one pipeline: its inbox in, its
        outbox, carry pool and live counts out, walk shares and stats
        updated."""
        if self.body == "kernel":
            if self.n2v is None:
                bindings.routed_uniform_phase(pipe.launch, pipe.parity)
            else:
                bindings.routed_node2vec_phase(pipe.launch, pipe.parity)
            pipe.parity = 1 - pipe.parity
            return
        # Only the arrived records can depart: the body runs on those, in
        # slot order, each with its shard.
        recs = pipe.inbox.view(-1, self.width)
        slot = (recs[:, 0] != _SENTINEL).nonzero()[:, 0]
        recs = recs[slot]
        self._my = slot // (self.nshards * self.cap)
        streams = (self._uniform_body(recs) if self.n2v is None
                   else self._node2vec_body(recs))
        cands = [_carry_candidates(pipe.pool, pipe.live[:, 1])]
        for r, dst, valid in streams:
            cands.append((r[valid], dst[valid], self._my[valid]))
            self.stats[:, 1].index_add_(0, self._my, valid.to(torch.int64))
        carry, carried, boxed, ovf = build_outbox(cands, pipe.pool,
                                                  self.cap, pipe.outbox)
        pipe.pool.copy_(carry)
        pipe.live[:, 0] = boxed
        pipe.live[:, 1] = carried
        self.stats[:, 2] += ovf

    def _owner(self, nodes):
        return (nodes // self.pgraph.shard_nodes).clamp(0, self.nshards - 1)

    def _local(self, nodes):
        """Row of each node in its record's shard, clamped into it."""
        s = self.pgraph.shard_nodes
        return (nodes - self._my * s).clamp(0, s - 1)

    def _col_at(self, idx):
        e_max = self._col.shape[1]
        return self._col[self._my, idx.clamp(0, e_max - 1)].to(torch.int64)

    def _log(self, wid, step, node_word, is_log):
        """LOG arrivals: this shard is the walker's wid-owner; write
        walk[step] into its share (others go to the spare row and column)."""
        wrow = torch.where(is_log, wid - self._my * self.blk,
                           torch.full_like(wid, self.blk))
        wcol = torch.where(is_log, step,
                           torch.full_like(step, self.walk_length + 1))
        self.walks[self._my, wrow, wcol] = node_word
        self.stats[:, 0].index_add_(0, self._my, is_log.to(torch.int64))

    def _uniform_body(self, recs):
        """The uniform shard body (``_routed_uniform_jit``'s ``process``):
        departure streams [forwarded LOG records, drawn records]."""
        wid = prng.as_u32(recs[:, 0])
        word1 = prng.as_u32(recs[:, 1])
        arrived = recs[:, 0] != _SENTINEL
        is_log = arrived & ((word1 & _LOG_BIT) != 0)
        step = word1 & (_LOG_BIT - 1)
        v = recs[:, 2].to(torch.int64)
        self._log(wid, step, recs[:, 2], is_log)
        # Forward a LOG record to owner(v) for the next draw, unless done.
        fwd = is_log & (step < self.walk_length)
        rec_fwd = torch.stack([recs[:, 0], prng.to_i32_bits(step), recs[:, 2]],
                              dim=1)
        # STEP arrivals: this shard owns v; draw and send to the wid-owner.
        stepping = arrived & ~is_log & (step < self.walk_length)
        rows = self._meta[self._my, self._local(v)]
        start, deg = rows[:, 0].to(torch.int64), rows[:, 1].to(torch.int64)
        bits, _ = prng.counter_bits(self.key, wid,
                                    prng.step_round_counter(step + 1))
        off = prng.randint_from_bits(bits, deg.clamp(min=1))
        nxt = torch.where(deg > 0, self._col_at(start + off), v)
        new_rec = torch.stack([recs[:, 0],
                               prng.to_i32_bits((step + 1) | _LOG_BIT),
                               nxt.to(torch.int32)], dim=1)
        dest_new = (wid // self.blk).clamp(0, self.nshards - 1)
        return [(rec_fwd, self._owner(v), fwd), (new_rec, dest_new, stepping)]

    def _contains(self, t, cand):
        """Exact ``cand in N(t)`` at t's owner: the shard's cuckoo edge set,
        or (no hashes) a 32-trip binary search of t's row in the local
        ``col`` slice."""
        n2v = self.n2v
        if n2v.tables is not None:
            return table_contains(n2v.tables, n2v.salts, n2v.log_size, t,
                                  cand, shard=self._my)
        trow = self._meta[self._my, self._local(t)]
        lo = trow[:, 0].to(torch.int64)
        hi = lo + trow[:, 1].to(torch.int64)
        end = hi
        for _ in range(32):
            active = lo < hi
            mid = (lo + hi) >> 1
            go_right = self._col_at(mid) < cand
            lo = torch.where(active & go_right, mid + 1, lo)
            hi = torch.where(active & ~go_right, mid, hi)
        return (lo < end) & (self._col_at(lo) == cand)

    def _node2vec_body(self, recs):
        """The node2vec shard body (``_routed_n2v_jit``'s ``process``):
        departure streams [forwarded LOG records, resolved steps to the
        wid-owner, frozen draws to owner(t), replays to owner(v)]."""
        n2v = self.n2v
        mask = prng.MASK32
        words = prng.as_u32(recs)
        wid = words[:, 0]
        arrived = recs[:, 0] != _SENTINEL
        step = words[:, 1] & _STEP_MASK
        flags = words[:, 1] >> 24
        mode_log = arrived & ((flags & _F_LOG) != 0)
        mode_resolve = arrived & ~mode_log & ((flags & _F_MODE) != 0)
        mode_step = arrived & ~mode_log & ~mode_resolve
        t = recs[:, 2].to(torch.int64)
        v = recs[:, 3].to(torch.int64)
        rnd0 = words[:, 4]
        a_cand, f1c, f2c = (recs[:, i].to(torch.int64) for i in (5, 6, 8))
        f1r, f2r = words[:, 7], words[:, 9]
        rec_bloom = recs[:, 10:14]
        has_a = (flags & _F_HAS_A) != 0
        n_f = flags >> 3
        s1 = step + 1  # the step being taken
        p0, p1, p2, lo_acc, hi_acc = (torch.tensor(x, dtype=torch.float32,
                                                   device=recs.device)
                                      for x in n2v.thresholds)

        # LOG arrivals: log, then forward with the flags cleared.
        self._log(wid, step, recs[:, 3], mode_log)
        fwd = mode_log & (step < self.walk_length)
        rec_fwd = recs.clone()
        rec_fwd[:, 1] = prng.to_i32_bits(step)

        # STEP arrivals: first hop, or the speculative rejection scan.
        local = self._local(v)
        rows = self._meta[self._my, local]
        start, deg = rows[:, 0].to(torch.int64), rows[:, 1].to(torch.int64)
        dead = deg == 0
        bits_first, _ = prng.counter_bits(self.key, wid,
                                          prng.step_round_counter(1))
        first_nxt = torch.where(dead, v, self._col_at(
            start + prng.randint_from_bits(bits_first, deg.clamp(min=1))))
        zero = torch.zeros_like(wid)
        no = torch.zeros_like(dead)
        sc_has_a, sc_ovf, stopped = no, no, dead
        sc_a, sc_f1, sc_f2 = v, v, v
        sc_nf, sc_f1r, sc_f2r, sc_stop3 = zero, zero, zero, zero
        for k in range(n2v.spec_rounds):
            rk = (rnd0 + k) & mask
            b_cand, b_acc = prng.counter_bits(
                self.key, wid, (s1 * prng.MAX_ROUNDS_PER_STEP + rk) & mask)
            cand = torch.where(dead, v, self._col_at(
                start + prng.randint_from_bits(b_cand, deg.clamp(min=1))))
            r = prng.uniform_from_bits(b_acc)
            is_t = cand == t
            maybe = bloom_maybe(rec_bloom, cand)
            acc = torch.where(is_t, r < p0,
                              torch.where(maybe, r < lo_acc, r < p2))
            rej = torch.where(is_t, r >= p0,
                              torch.where(maybe, r >= hi_acc, r >= p2))
            frz = ~stopped & ~acc & ~rej
            new_f1 = frz & (sc_nf == 0)
            new_f2 = frz & (sc_nf == 1)
            new_f3 = frz & (sc_nf == 2)
            sc_f1 = torch.where(new_f1, cand, sc_f1)
            sc_f1r = torch.where(new_f1, rk, sc_f1r)
            sc_f2 = torch.where(new_f2, cand, sc_f2)
            sc_f2r = torch.where(new_f2, rk, sc_f2r)
            sc_nf = sc_nf + (new_f1 | new_f2 | new_f3).to(torch.int64)
            sc_ovf = sc_ovf | new_f3
            sc_stop3 = torch.where(new_f3, rk, sc_stop3)
            new_a = ~stopped & acc
            sc_a = torch.where(new_a, cand, sc_a)
            sc_has_a = sc_has_a | new_a
            stopped = stopped | new_a | new_f3
        active = mode_step & (step < self.walk_length)
        clean = sc_has_a & (sc_nf == 0)
        first = s1 == 1
        step_next = torch.where(first, first_nxt,
                                torch.where(dead, v, sc_a))
        step_done = active & (first | dead | clean)
        pending = active & ~first & ~dead & (sc_nf >= 1)
        allrej = active & ~first & ~dead & ~sc_has_a & (sc_nf == 0)
        replay_rnd = torch.where(sc_ovf, sc_stop3,
                                 (rnd0 + n2v.spec_rounds) & mask)

        # RESOLVE arrivals: answer the frozen draws with the exact test.
        def accept_r(rnd):
            _, b = prng.counter_bits(
                self.key, wid, (s1 * prng.MAX_ROUNDS_PER_STEP + rnd) & mask)
            return prng.uniform_from_bits(b)

        r1, r2 = accept_r(f1r), accept_r(f2r)
        acc1 = mode_resolve & torch.where(self._contains(t, f1c),
                                          r1 < p1, r1 < p2)
        acc2 = (mode_resolve & (n_f >= 2) & ~acc1
                & torch.where(self._contains(t, f2c), r2 < p1, r2 < p2))
        res_ok = acc1 | acc2 | (mode_resolve & has_a)
        res_next = torch.where(acc1, f1c, torch.where(acc2, f2c, a_cand))
        res_fail = mode_resolve & ~res_ok

        # Departures.  A resolved step goes to the wid-owner as a LOG record
        # carrying N(v)'s filter (local on STEP lanes, shipped in on RESOLVE
        # ones); a frozen draw to owner(t) carrying N(v)'s filter; a replay
        # back to owner(v) with N(t)'s (local on RESOLVE lanes).
        res_col = mode_resolve[:, None]
        v_bloom = n2v.blooms[self._my, local]
        fresh = _pack(wid, s1, zero + _F_LOG, v,
                      torch.where(mode_resolve, res_next, step_next),
                      zero, zero, zero, zero, zero, zero,
                      torch.where(res_col, rec_bloom, v_bloom))
        pend_flags = (_F_MODE + _F_HAS_A * sc_has_a.to(torch.int64)
                      + _F_OVF * sc_ovf.to(torch.int64)
                      + (sc_nf.clamp(max=2) << 3))
        pend = _pack(wid, step, pend_flags, t, v, replay_rnd, sc_a, sc_f1,
                     sc_f1r, sc_f2, sc_f2r, v_bloom)
        rep = _pack(wid, step, zero, t, v,
                    torch.where(mode_resolve, rnd0, replay_rnd),
                    zero, zero, zero, zero, zero,
                    torch.where(res_col, n2v.blooms[self._my, self._local(t)],
                                rec_bloom))
        wid_dest = (wid // self.blk).clamp(0, self.nshards - 1)
        return [(rec_fwd, self._owner(v), fwd),
                (fresh, wid_dest, step_done | res_ok),
                (pend, self._owner(t), pending),
                (rep, self._owner(v), allrej | res_fail)]

    # -- the kernels' launch --------------------------------------------

    def _pack_launch(self, pipe: _Pipe):
        pg, n2v = self.pgraph, self.n2v
        tables = n2v.tables if n2v is not None else None
        shards = [bindings.RoutedShard(
            meta=pg.node_meta[s], col=pg.col[s], walks=self.walks[s],
            inbox=pipe.inbox[s], outbox=pipe.outbox[s], carry=pipe.carry[s],
            stage=self._stage[s], code=self._code[s], hist=self._hist[s],
            pool_count=pipe.pool_count[s],
            hash_table=tables[s] if tables is not None else None,
            bloom=n2v.blooms[s] if n2v is not None else None,
            salt=int(n2v.salts[s]) if tables is not None else 0)
            for s in range(self.nshards)]
        return bindings.routed_phase_launch(
            shards, self.stats, pipe.live, self.live.view(-1), self._counter,
            shard_nodes=pg.shard_nodes,
            blk=self.blk, walk_length=self.walk_length, cap=self.cap,
            ccap=self.ccap, key=self.key, node2vec=n2v)

    # -- the phase loop -------------------------------------------------

    def state(self) -> dict:
        """Every pipeline's outboxes, carry pools' live prefixes and live
        counts, the walk shares and the stats (for phase-by-phase
        comparisons)."""
        out = {"walks": self.walks[:, : self.blk, : self.walk_length + 1],
               "stats": self.stats, "live": self.live}
        for p, pipe in enumerate(self.pipes):
            out[f"outbox{p}"] = pipe.outbox
            out[f"carry{p}"] = [c[: int(n)] for c, n in
                                zip(pipe.pool, pipe.live[:, 1].tolist())]
        return out

    def run(self):
        """Phase 0, then bodies while anything is in flight and the budget
        lasts, enqueued PHASES_PER_READ at a time between two reads of the
        phase counter and the in-flight count; a batch never passes the
        budget, and its phases after the end are no-ops.  (The JAX serial
        loop's first test counts the boxed records only: after phase 0
        nothing is carried unless something is boxed.)  Returns (walks (B,
        L+1) int32, info)."""
        self.start()
        phases, inflight = self._read()
        while inflight > 0 and phases < self.max_phases:
            n = min(PHASES_PER_READ, self.max_phases - phases)
            if (n == PHASES_PER_READ and n % 4 == 0 and self.body == "kernel"
                    and self.schedule in GRAPH_SCHEDULES):
                self._replay(n)
            else:
                for _ in range(n):
                    self.phase()
            phases, inflight = self._read()
        return self.result()

    def _replay(self, k: int) -> None:
        """k phases as one replay of a CUDA graph of the walk's phase calls,
        captured at the first batch: every batch starts with the pipelines'
        roles and live pools as the first one did, since k is a multiple of
        4.  The kernels' launch counts take the replay's launches."""
        if self._graph is None:
            before = dict(bindings.launch_counts)
            enqueued = self.enqueued
            parities = [pipe.parity for pipe in self.pipes]
            # Captured on a side stream, without torch.cuda.graph's garbage
            # collection and cache flush, which would cost more than the
            # batch: a walk captures its own graph once.
            graph = torch.cuda.CUDAGraph()
            main = torch.cuda.current_stream(self.pgraph.device)
            side = torch.cuda.Stream(device=self.pgraph.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                graph.capture_begin()
                for _ in range(k):
                    self.phase()
                graph.capture_end()
            main.wait_stream(side)
            made = {n: c - before[n] for n, c in bindings.launch_counts.items()
                    if c != before[n]}
            bindings.launch_counts.update(before)  # captured, not launched
            self.enqueued = enqueued
            assert [pipe.parity for pipe in self.pipes] == parities
            self._graph = (graph, made)
        graph, made = self._graph
        graph.replay()
        for name, count in made.items():
            bindings.launch_counts[name] += count
        self.enqueued += k

    def _read(self) -> tuple[int, int]:
        """(phases, records in flight), in one read from the device."""
        return tuple(torch.cat([self._counter, self.live.sum().view(1)])
                     .tolist())

    def result(self):
        """(walks (B, L+1) int32, info) as the walk stands; raises if a
        record was dropped or a walker has not logged every position."""
        walks = self.walks[:, : self.blk, : self.walk_length + 1].reshape(
            self.num_walkers, self.walk_length + 1)
        log_n, sent, dropped = (int(x) for x in self.stats.sum(0).tolist())
        info = {
            "log_entries": log_n,
            "exchanged_records": sent,
            "phases": self.phases,
            "overflow_dropped": dropped,
            "exchange_bytes": sent * self.width * 4,
        }
        if self.n2v is not None:
            info["collectives_per_step"] = round(
                self.phases / max(self.walk_length, 1), 2)
        info["schedule"] = self.schedule
        _check_complete(info, self.num_walkers, self.walk_length, self.cfg)
        return walks, info


def _pack(wid, step, flags, t, v, rnd, a, f1, f1r, f2, f2r, bloom_rows):
    """(M, 14) int32 node2vec records from uint32 words held as int64 (or
    signed node ids) and (M, 4) int32 filters."""
    word1 = (step | (flags << 24)) & prng.MASK32
    cols = [prng.to_i32_bits(x & prng.MASK32)
            for x in (wid, word1, t, v, rnd, a, f1, f1r, f2, f2r)]
    return torch.cat([torch.stack(cols, dim=1), bloom_rows], dim=1)


@dataclasses.dataclass(frozen=True)
class Node2VecRouting:
    """What the node2vec phase body needs beside the graph: the acceptance
    thresholds (prob_0, prob_1, prob_2, min(prob_1, prob_2), max(prob_1,
    prob_2)), the speculative rounds a STEP record draws, each shard's
    cuckoo table, salt and the shared log_size (``tables`` None: binary
    search instead), and the (D, S, 4) Bloom filters (all ones: saturated)."""

    thresholds: tuple
    spec_rounds: int
    tables: torch.Tensor | None
    salts: torch.Tensor | None
    log_size: int
    blooms: torch.Tensor


def _prepare(pgraph, target_nodes, walk_length, device):
    dev = resolve_device(device)
    if pgraph.device != dev:
        raise ValueError(f"partitioned graph lives on {pgraph.device}, walk "
                         f"was asked for {dev}")
    targets = as_int32(target_nodes, dev)
    num_walkers = int(targets.shape[0])
    if num_walkers % pgraph.num_shards:
        raise ValueError(
            f"num_walkers ({num_walkers}) must be divisible by the shard "
            f"count ({pgraph.num_shards}); pad the target batch.")
    if walk_length < 0:
        raise ValueError(f"walk_length must be >= 0, got {walk_length}")
    return dev, targets, "kernel" if dev.type == "cuda" else "plain"


def walk_partitioned_routed(pgraph: PartitionedCSR, target_nodes,
                            walk_length: int, seed: int = 0,
                            config: RoutedConfig | None = None,
                            schedule: str = "serial", device=None):
    """Uniform CSR walks with owner-routed walker exchange.

    Returns (walks (B, L+1) int32, stats dict with ``log_entries``,
    ``exchanged_records``, ``phases``, ``overflow_dropped``,
    ``exchange_bytes``, ``schedule``).  The walks equal
    ``ops.uniform.uniform_walk_csr`` for the same targets and seed, under
    either ``schedule``; ``overlapped`` takes about twice the phases.
    """
    dev, targets, body = _prepare(pgraph, target_nodes, walk_length, device)
    cfg = RoutedConfig.resolve(config, targets.shape[0], pgraph.num_shards,
                               int(walk_length))
    key = prng.derive_key(int(seed), prng.STREAM_CSR_UNIFORM)
    return RoutedWalk(pgraph, targets, walk_length, key, cfg, schedule,
                      body).run()


def node2vec_routing(pgraph: PartitionedCSR, p: float, q: float,
                     spec_rounds: int = 6, hashes=None,
                     blooms=None) -> Node2VecRouting:
    """Check and gather the node2vec engine's tables: ``hashes`` from
    ``build_partition_hashes`` (or None), ``blooms`` from
    ``build_partition_blooms`` (or None: saturated filters)."""
    dev, d, s = pgraph.device, pgraph.num_shards, pgraph.shard_nodes
    if spec_rounds < 1:
        raise ValueError(f"spec_rounds must be >= 1, got {spec_rounds}")
    tables = salts = None
    log_size = 0
    if hashes is not None:
        tables, salts, log_size = hashes
        if (tables.device != dev or tables.dtype != torch.int32
                or tuple(tables.shape) != (d, 1 << int(log_size), 2)
                or tuple(salts.shape) != (d,)):
            raise ValueError("hashes must be build_partition_hashes of this "
                             "partition, on its device")
        salts = salts.to(torch.int64)
    if blooms is None:
        blooms = torch.full((d, s, BLOOM_WORDS), -1, dtype=torch.int32,
                            device=dev)
    elif (blooms.device != dev or blooms.dtype != torch.int32
          or tuple(blooms.shape) != (d, s, BLOOM_WORDS)):
        raise ValueError("blooms must be build_partition_blooms of this "
                         "partition, on its device")
    p0, p1, p2 = node2vec_accept_probs(float(p), float(q))
    return Node2VecRouting((p0, p1, p2, min(p1, p2), max(p1, p2)),
                           int(spec_rounds), tables, salts, int(log_size),
                           blooms.contiguous())


def walk_partitioned_node2vec_routed(pgraph: PartitionedCSR, hashes,
                                     target_nodes, p: float, q: float,
                                     walk_length: int, seed: int = 0,
                                     config: RoutedConfig | None = None,
                                     spec_rounds: int = 6, blooms=None,
                                     schedule: str = "serial", device=None):
    """node2vec walks with owner-routed walkers.

    At owner(v) a walker draws ``spec_rounds`` rejection rounds and decides
    every draw whose acceptance does not hang on t's neighbourhood; draws
    left frozen travel to owner(t), whose exact test answers them there
    (``hashes`` = ``build_partition_hashes(pgraph, graph)``: cuckoo probes;
    None: a binary search of t's row).  ``blooms`` =
    ``build_partition_blooms(pgraph, graph)`` rules most draws out before
    they travel (None: saturated filters, every such draw travels).

    Returns (walks (B, L+1) int32, info as ``walk_partitioned_routed`` plus
    ``collectives_per_step``).  The walks equal
    ``ops.node2vec.node2vec_walk_csr`` (the rejection sampler) for the same
    targets and seed, whatever the tables and the schedule.
    """
    dev, targets, body = _prepare(pgraph, target_nodes, walk_length, device)
    if walk_length >= 1 << 24:
        raise ValueError(f"walk_length must be below 2^24 (the step field "
                         f"of a record), got {walk_length}")
    num_walkers = int(targets.shape[0])
    cfg = RoutedConfig.resolve(config, num_walkers, pgraph.num_shards,
                               int(walk_length))
    if config is None or config.max_phases <= 0:
        cfg = _biased_phase_budget(cfg, int(walk_length), spec_rounds)
    routing = node2vec_routing(pgraph, p, q, spec_rounds, hashes, blooms)
    key = prng.derive_key(int(seed), prng.STREAM_CSR_BIASED)
    return RoutedWalk(pgraph, targets, walk_length, key, cfg, schedule, body,
                      node2vec=routing).run()
