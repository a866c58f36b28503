"""Edge-partitioned walks with owner-routed walker exchange (twin of the
routed engines of ``torch_random_walk_tpu/parallel/partition_v2.py``: the
uniform and node2vec CSR ones, and the KG-triples, uniform edge-list and
biased edge-list ones).

Each walker is one fixed-width record of uint32 words (int32 bit patterns
here).  The graph is node-range partitioned (``PartitionedCSR``; for the
families, head ranges of the sorted triples or edge list:
``PartitionedTriples``, ``PartitionedEdgeList``); every
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
- **node2vec** records are 14 words: at owner(v) a STEP record
  draws ``spec_rounds`` rejection rounds and decides each draw that does not
  depend on t's neighbourhood, with N(t)'s Bloom filter, carried in the
  record, ruling most of the others out; draws left frozen go to owner(t)
  as a RESOLVE record, whose exact test (the shard's cuckoo edge set, or a
  binary search of t's row) decides them there.
- **The families** (records of 4, 4 and 15 words, layouts below): the
  triples engine logs a (relation, tail) pair a step; the edge-list engines
  follow ``walk_edge_list``'s padding and restart law, the biased one on
  the node2vec machine with the cuckoo sets only.  A walker absorbed by
  padding ends where it is found (its walk row starts as padding), and the
  engines count the walkers that end (``info["terminated"]``).

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
``routed_uniform_phase``, K12 ``routed_node2vec_phase``: ``kernels/routed.cu``;
one call a phase for all shards; there each pipeline has two carry pools,
one read and one filled a phase) and plain PyTorch on the CPU (one pool);
the choice is the device's and nothing else's.  The three family engines
run the loop itself on the card: K13 ``routed_triples_batch``, K14
``routed_edge_list_batch`` and K15 ``routed_edge_list_node2vec_batch``
(``kernels/routed_families.cu``) are one persistent cooperative launch a
walk, whose steps (the exchange, the body, the compaction) are separated
by grid barriers and touch only the records in flight, and the host reads
the counter once after it.  **So far every shard lives on one card.**

Draws use the same (seed, stream, walker id, step, round) Threefry counters
as the single-device walks (``ops/``), and the carry and arrival
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
from torch_random_walk_tpu_torch.parallel.partition import (
    PartitionedCSR,
    shard_hash_tables,
)
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device

# The records (uint32 words; each engine's width is in
# bindings.ROUTED_ENGINES).  Uniform (3 words): wid, step, node.  `step`
# counts completed steps; `node` is walk[step].
# An empty record slot: wid word 0xFFFFFFFF, which is -1 as int32.
_SENTINEL = -1
# Uniform LOG-hop marker, the top bit of the step word (the sign bit as
# int32).  A record cycles owner(v_s) --draw--> wid-owner (logs walk[s+1],
# forwards) --> owner(v_s+1).
_LOG_BIT = 1 << 31
# node2vec (14 words): w0 wid | w1 step + flags << 24 | w2 t | w3 v | w4 replay
# round | w5 a_cand | w6 f1_cand | w7 f1_rnd | w8 f2_cand | w9 f2_rnd |
# w10-w13 a 128-bit Bloom filter: N(t) on STEP records, N(v) on RESOLVE ones.
# flags: bit0 RESOLVE mode, bit1 has_a, bit2 overflow (a third frozen draw
# stopped the scan), bits 3-4 frozen draws, bit5 LOG (the record is on its
# wid-owner hop: walk[step] = w3 is written there, then it forwards to
# owner(w3) with its flags cleared).
_F_MODE, _F_HAS_A, _F_OVF, _F_LOG = 1, 2, 4, 32
_STEP_MASK = (1 << 24) - 1
# KG-triples (4 words): wid, step (| LOG), relation, entity.  At
# owner(entity) a STEP record draws a (relation, tail) transition; at the
# wid-owner a LOG record writes it at columns (2 step - 1, 2 step) of its
# walk row.  Edge list (4 words): wid, step (| LOG | FUSE), node, target.
# The target rides along so that a dead end with restart is resolved where
# it is found: the padding position and the jump back to the target go to
# the wid-owner as one FUSE record, which logs the jump at step + 1
# (position step holds the padding already) and forwards the walker to
# owner(target).  Biased edge list (15 words): the node2vec record with the
# target in word 10 and the Bloom filter in words 11-14.
_FUSE_BIT = 1 << 30
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


def shard_blooms(row_ptr, tails, pgraph) -> torch.Tensor:
    """(D, S, 4) int32 bit patterns: the 128-bit Bloom filter over each
    node's out-neighbours, of a CSR form (``row_ptr``, ``tails``),
    node-range sharded like ``pgraph`` (rows past the last node are empty),
    on the partitioned graph's device."""
    dev = pgraph.device
    flat = build_node_blooms(row_ptr.to(dev), tails.to(dev))
    s = pgraph.shard_nodes
    padded = torch.zeros((pgraph.num_shards * s, BLOOM_WORDS),
                         dtype=torch.int32, device=dev)
    padded[: flat.shape[0]] = flat
    return padded.view(pgraph.num_shards, s, BLOOM_WORDS)


def build_partition_blooms(pgraph: PartitionedCSR, graph) -> torch.Tensor:
    """(D, S, 4) int32 bit patterns: each node's 128-bit Bloom filter over
    its out-neighbours, node-range sharded like ``pgraph``."""
    return shard_blooms(graph.row_ptr, graph.col_idx, pgraph)


def _routed_info(stats, width: int, what: str, num_walkers: int,
                 cfg: RoutedConfig, phases: int) -> dict:
    """The family engines' info from their (D, 4) stats (logged, sent,
    dropped, terminated), and their completeness check: nothing dropped and
    every walker terminated (``_routed_info`` of the JAX package)."""
    logged, sent, dropped, done = (int(x) for x in stats.sum(0).tolist())
    info = {
        "log_entries": logged,
        "exchanged_records": sent,
        "phases": phases,
        "overflow_dropped": dropped,
        "terminated": done,
        "exchange_bytes": sent * width * 4,
    }
    if dropped or done != num_walkers:
        raise RuntimeError(
            f"routed {what} walk incomplete: {dropped} records dropped, "
            f"{done}/{num_walkers} walkers terminated after {phases} phases "
            f"— raise RoutedConfig capacities (pair_capacity="
            f"{cfg.pair_capacity}, carry={cfg.carry}, max_phases="
            f"{cfg.max_phases})")
    return info


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
        self.flow = None  # the batch kernel's outbox counts (K13-K15)

    @property
    def pool(self):
        """The live carry pool of every shard, (D, ccap, R+1)."""
        return self.carry[:, self.parity]


class RoutedWalk:
    """One routed walk: its shards' state, the phase body and the two
    schedules' phase loops.  The entry points (``walk_partitioned_routed``,
    ``walk_partitioned_node2vec_routed`` and the three family engines
    below) build one and ``run`` it, with the phase body that the device
    takes (``body="kernel"`` on a CUDA device, ``"plain"`` on the CPU).
    ``engine`` is a key of ``bindings.ROUTED_ENGINES`` (by default
    ``"uniform"``, or ``"node2vec"`` where ``node2vec`` is given, which
    ``"edge_list_node2vec"`` needs too); the family engines (``"triples"``,
    ``"edge_list"``, ``"edge_list_node2vec"``) take ``padding`` and
    ``restart``, count the walkers that end (a fourth stats column) and
    start from walk rows filled with ``padding``, so that a walker absorbed
    by padding needs no record.  The plain body on the card is what the
    kernels are held against; ``start``, ``phase``, ``inflight``, ``state``
    and ``result`` step a walk phase by phase for that.  The plain body runs
    every shard at once, on stacked copies of the shards' tables.  The
    phase counter (``phases``) is a device tensor that each phase adds to
    while anything is in flight, on the card in the body kernel and here in
    tensor code."""

    def __init__(self, pgraph, targets, walk_length: int, key,
                 cfg: RoutedConfig, schedule: str, body: str,
                 node2vec=None, engine: str | None = None, padding: int = 0,
                 restart: bool = False):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                             f"{schedule!r}")
        if body not in BODIES:
            raise ValueError(f"body must be one of {BODIES}, got {body!r}")
        if engine is None:
            engine = "uniform" if node2vec is None else "node2vec"
        if engine not in bindings.ROUTED_ENGINES:
            raise ValueError(f"engine must be one of "
                             f"{tuple(bindings.ROUTED_ENGINES)}, got "
                             f"{engine!r}")
        dev = pgraph.device
        if body == "kernel" and dev.type != "cuda":
            raise ValueError("the phase kernels run on a CUDA device only")
        self.pgraph, self.key, self.cfg = pgraph, key, cfg
        self.schedule, self.body, self.engine = schedule, body, engine
        self.n2v = node2vec
        spec = bindings.ROUTED_ENGINES[engine]
        self.width, self.family = spec.width, spec.family
        self.padding, self.restart = int(padding), bool(restart)
        self.nshards = d = pgraph.num_shards
        self.num_walkers = int(targets.shape[0])
        self.blk = self.num_walkers // d
        self.walk_length = int(walk_length)
        self.cap, self.ccap = cfg.pair_capacity, cfg.carry
        self.max_phases = cfg.max_phases * (2 if schedule == "overlapped"
                                            else 1)
        # Walk shares (D, blk+1, cols + 1): a walk row has cols = L+1
        # positions (triples: 2L+1, relations between the entities); row blk
        # and the last column are spare.  The family engines' rows start as
        # padding.
        cols = (2 * self.walk_length + 1 if engine == "triples"
                else self.walk_length + 1)
        self.out_cols = cols
        self.walks = torch.full((d, self.blk + 1, cols + 1),
                                self.padding if self.family else 0,
                                dtype=torch.int32, device=dev)
        self.walks[:, : self.blk, 0] = targets.view(d, self.blk)
        # Per shard: positions logged, records sent, records dropped; and the
        # family engines' walkers terminated.
        self.stats = torch.zeros((d, 4 if self.family else 3),
                                 dtype=torch.int64, device=dev)
        if not self.family:
            self.stats[:, 0] = self.blk
        npipes = 2 if schedule == "overlapped" else 1
        self.live = torch.zeros((npipes, d, 2), dtype=torch.int64, device=dev)
        self._counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.pipes = [_Pipe(d, self.cap, self.ccap, self.width, dev,
                            self.live[p], 2 if body == "kernel" else 1)
                      for p in range(npipes)]
        self.enqueued = 0  # phases enqueued, no-ops after the end included
        self._counted = 0  # the phase counter as last read
        self._stream = None
        self._graph = None  # (CUDA graph of a batch, the launches it makes)
        self._batch = None  # the batch kernel's packed launch (K13-K15)
        if body == "kernel":
            shapes = bindings.routed_scratch_shapes(d, self.cap, self.ccap,
                                                    self.blk, self.width)
            self._stage, self._code, self._hist = (
                torch.empty((d, *shapes[k]), dtype=torch.int32, device=dev)
                for k in ("stage", "code", "hist"))
            for pipe in self.pipes:
                pipe.pool_count = torch.zeros((d, *shapes["pool_count"]),
                                              dtype=torch.int32, device=dev)
                if spec.batch:
                    pipe.flow = torch.zeros(
                        (2, bindings.routed_flow_words(d)), dtype=torch.int32,
                        device=dev)
                pipe.launch = self._pack_launch(pipe)
            if spec.batch:
                self._batch = bindings.routed_batch_launch(
                    [pipe.launch for pipe in self.pipes])
            elif npipes == 2:
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
        # The node the walker stands on: word 3 for triples (its entity) and
        # the node2vec records (v), word 2 for the uniform ones; the
        # edge-list records also carry the target (word 3, node2vec's word
        # 10) and node2vec's start with t = v.
        if self.engine != "triples":
            rec0[:, 2] = tgt
        if self.engine != "uniform":
            rec0[:, 3] = tgt
        if self.engine == "edge_list_node2vec":
            rec0[:, 10] = tgt
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
                if pipe.flow is not None:
                    pipe.flow.zero_()
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
        flight before (the kernels' body does it on the card).  K13-K15
        run it as a batch of one phase, which does nothing once nothing is
        in flight."""
        if self._batch is not None:
            self._run_batch(1)
            return
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

    def process(self, pipe: _Pipe, slots=None) -> None:
        """The phase body of every shard for one pipeline: its inbox in, its
        outbox, carry pool and live counts out, walk shares and stats
        updated.  The plain body runs on the inbox ``slots`` (flat indices
        in slot order; by default every slot whose wid is not the
        sentinel)."""
        if self.body == "kernel":
            getattr(bindings, bindings.ROUTED_ENGINES[self.engine].kernel)(
                pipe.launch, pipe.parity)
            pipe.parity = 1 - pipe.parity
            return
        # Only the arrived records can depart: the body runs on those, in
        # slot order, each with its shard.
        recs = pipe.inbox.view(-1, self.width)
        slot = ((recs[:, 0] != _SENTINEL).nonzero()[:, 0] if slots is None
                else slots)
        recs = recs[slot]
        self._my = slot // (self.nshards * self.cap)
        streams = getattr(self, f"_{self.engine}_body")(recs)
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

    def _write(self, wid, col, value, mask):
        """Write ``value`` at column ``col`` of each masked record's walk
        row (this shard is the walker's wid-owner)."""
        my = self._my[mask]
        self.walks[my, wid[mask] - my * self.blk, col[mask]] = \
            value[mask].to(torch.int32)

    def _count(self, column, mask):
        """Add each shard's masked records to its stats ``column``."""
        self.stats[:, column].index_add_(0, self._my, mask.to(torch.int64))

    def _log(self, wid, step, node_word, is_log):
        """LOG arrivals: write walk[step] and count the positions."""
        self._write(wid, step, node_word, is_log)
        self._count(0, is_log)

    def _wid_owner(self, wid):
        return (wid // self.blk).clamp(0, self.nshards - 1)

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
        return [(rec_fwd, self._owner(v), fwd),
                (new_rec, self._wid_owner(wid), stepping)]

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
        return [(rec_fwd, self._owner(v), fwd),
                (fresh, self._wid_owner(wid), step_done | res_ok),
                (pend, self._owner(t), pending),
                (rep, self._owner(v), allrej | res_fail)]

    def _triples_body(self, recs):
        """The triples shard body (``_routed_triples_jit``'s ``process``):
        departure streams [forwarded LOG records, drawn transitions].  A
        walker ends at its wid-owner after its last transition or on
        reaching the padding, and at its draw shard on a head without
        triples or at the padding (its padding positions are written
        already)."""
        wid = prng.as_u32(recs[:, 0])
        word1 = prng.as_u32(recs[:, 1])
        arrived = recs[:, 0] != _SENTINEL
        is_log = arrived & ((word1 & _LOG_BIT) != 0)
        step = word1 & (_LOG_BIT - 1)
        v = recs[:, 3].to(torch.int64)
        pad = self.padding
        # LOG arrivals: (relation, tail) at columns (2 step - 1, 2 step).
        self._write(wid, 2 * step - 1, recs[:, 2], is_log)
        self._log(wid, 2 * step, recs[:, 3], is_log)
        fwd = is_log & (step < self.walk_length) & (v != pad)
        self._count(3, is_log & ~fwd)
        rec_fwd = torch.stack([recs[:, 0], prng.to_i32_bits(step),
                               torch.zeros_like(recs[:, 0]), recs[:, 3]], 1)
        # STEP arrivals: draw a (relation, tail) row of v's triples.
        stepping = arrived & ~is_log & (step < self.walk_length)
        rows = self._meta[self._my, self._local(v)]
        start, cnt = rows[:, 0].to(torch.int64), rows[:, 1].to(torch.int64)
        has = (cnt > 0) & (v != pad)
        bits, _ = prng.counter_bits(self.key, wid,
                                    prng.step_round_counter(step + 1))
        idx = start + prng.randint_from_bits(bits, cnt.clamp(min=1))
        rel_tail = self._col[self._my,
                             idx.clamp(0, self._col.shape[1] - 1)]
        self._count(3, stepping & ~has)
        new_rec = torch.cat([recs[:, :1],
                             prng.to_i32_bits((step + 1) | _LOG_BIT)[:, None],
                             rel_tail], 1)
        return [(rec_fwd, self._owner(v), fwd),
                (new_rec, self._wid_owner(wid), stepping & has)]

    def _edge_list_body(self, recs):
        """The uniform edge-list shard body (``_routed_edge_list_jit``'s
        ``process``): departure streams [forwarded LOG records, drawn
        records].  A dead end draws the padding; with ``restart`` it goes to
        the wid-owner as one FUSE record with the jump back to the target
        (unless it is the last step), without it the walker ends here."""
        wid = prng.as_u32(recs[:, 0])
        word1 = prng.as_u32(recs[:, 1])
        arrived = recs[:, 0] != _SENTINEL
        is_log = arrived & ((word1 & _LOG_BIT) != 0)
        fused = arrived & ((word1 & _FUSE_BIT) != 0)
        step = word1 & (_FUSE_BIT - 1)
        v = recs[:, 2].to(torch.int64)
        tgt = recs[:, 3].to(torch.int64)
        pad = self.padding
        # LOG arrivals: walk[step] = v; a FUSE record walk[step + 1] = target.
        fstep = torch.where(fused, step + 1, step)
        fnode = torch.where(fused, tgt, v)
        self._log(wid, fstep, fnode, is_log)
        fwd = is_log & (fstep < self.walk_length)
        self._count(3, is_log & ~fwd)
        rec_fwd = torch.stack([recs[:, 0], prng.to_i32_bits(fstep),
                               fnode.to(torch.int32), recs[:, 3]], 1)
        # STEP arrivals: the edge-list law (a walker at the padding draws
        # the jump node).
        stepping = arrived & ~is_log & (step < self.walk_length)
        rows = self._meta[self._my, self._local(v)]
        start, cnt = rows[:, 0].to(torch.int64), rows[:, 1].to(torch.int64)
        bits, _ = prng.counter_bits(self.key, wid,
                                    prng.step_round_counter(step + 1))
        nxt = torch.where(cnt > 0, self._col_at(
            start + prng.randint_from_bits(bits, cnt.clamp(min=1))), pad)
        jump = tgt if self.restart else torch.full_like(tgt, pad)
        nxt = torch.where(v == pad, jump, nxt)
        s1 = step + 1
        fuse = (stepping & (nxt == pad) & self.restart
                & (s1 < self.walk_length))
        norm = stepping & (nxt != pad)
        self._count(3, stepping & ~fuse & ~norm)
        flags = torch.where(fuse, _LOG_BIT | _FUSE_BIT, _LOG_BIT)
        new_rec = torch.stack([recs[:, 0], prng.to_i32_bits(s1 | flags),
                               nxt.to(torch.int32), recs[:, 3]], 1)
        return [(rec_fwd, self._owner(fnode), fwd),
                (new_rec, self._wid_owner(wid), fuse | norm)]

    def _edge_list_node2vec_body(self, recs):
        """The biased edge-list shard body (``_routed_edge_list_n2v_jit``'s
        ``process``): ``_node2vec_body``'s streams with the edge-list law.
        A draw at the padding is the jump node (the target with
        ``restart``, else the padding), at a dead end the padding; a
        candidate equal to t or to the padding is decided here at prob_0,
        and an accepted padding moves to the jump node; the exact test is
        the shard's cuckoo edge set.  Without ``restart`` an accepted
        padding ends the walk here."""
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
        tgt = recs[:, 10].to(torch.int64)
        rec_bloom = recs[:, 11:15]
        has_a = (flags & _F_HAS_A) != 0
        n_f = flags >> 3
        s1 = step + 1  # the step being taken
        pad = self.padding
        jump = tgt if self.restart else torch.full_like(tgt, pad)
        p0, p1, p2, lo_acc, hi_acc = (torch.tensor(x, dtype=torch.float32,
                                                   device=recs.device)
                                      for x in n2v.thresholds)

        # LOG arrivals: log, then forward with the flags cleared.
        self._log(wid, step, recs[:, 3], mode_log)
        fwd = mode_log & (step < self.walk_length)
        self._count(3, mode_log & ~fwd)
        rec_fwd = recs.clone()
        rec_fwd[:, 1] = prng.to_i32_bits(step)

        # STEP arrivals: first hop, or the speculative rejection scan.
        local = self._local(v)
        rows = self._meta[self._my, local]
        start, cnt = rows[:, 0].to(torch.int64), rows[:, 1].to(torch.int64)

        def draw(bits):
            nxt = torch.where(cnt > 0, self._col_at(
                start + prng.randint_from_bits(bits, cnt.clamp(min=1))), pad)
            return torch.where(v == pad, jump, nxt)

        bits_first, _ = prng.counter_bits(self.key, wid,
                                          prng.step_round_counter(1))
        first_nxt = draw(bits_first)
        zero = torch.zeros_like(wid)
        no = torch.zeros_like(mode_step)
        sc_has_a, sc_ovf, stopped = no, no, no
        sc_a, sc_f1, sc_f2 = v, v, v
        sc_nf, sc_f1r, sc_f2r, sc_stop3 = zero, zero, zero, zero
        for k in range(n2v.spec_rounds):
            rk = (rnd0 + k) & mask
            b_cand, b_acc = prng.counter_bits(
                self.key, wid, (s1 * prng.MAX_ROUNDS_PER_STEP + rk) & mask)
            cand = draw(b_cand)
            r = prng.uniform_from_bits(b_acc)
            is_t = cand == t
            is_pad = cand == pad
            here = is_t | is_pad
            maybe = bloom_maybe(rec_bloom, cand)
            acc = torch.where(here, r < p0,
                              torch.where(maybe, r < lo_acc, r < p2))
            rej = torch.where(here, r >= p0,
                              torch.where(maybe, r >= hi_acc, r >= p2))
            value = torch.where(is_pad & ~is_t, jump, cand)
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
            sc_a = torch.where(new_a, value, sc_a)
            sc_has_a = sc_has_a | new_a
            stopped = stopped | new_a | new_f3
        active = mode_step & (step < self.walk_length)
        first = s1 == 1
        step_next = torch.where(first, first_nxt, sc_a)
        step_done = active & (first | (sc_has_a & (sc_nf == 0)))
        pending = active & ~first & (sc_nf >= 1)
        allrej = active & ~first & ~sc_has_a & (sc_nf == 0)
        replay_rnd = torch.where(sc_ovf, sc_stop3,
                                 (rnd0 + n2v.spec_rounds) & mask)

        # RESOLVE arrivals: answer the frozen draws with the cuckoo set.
        def accept_r(rnd):
            _, b = prng.counter_bits(
                self.key, wid, (s1 * prng.MAX_ROUNDS_PER_STEP + rnd) & mask)
            return prng.uniform_from_bits(b)

        def contains(cand):
            return table_contains(n2v.tables, n2v.salts, n2v.log_size, t,
                                  cand, shard=self._my)

        r1, r2 = accept_r(f1r), accept_r(f2r)
        acc1 = mode_resolve & torch.where(contains(f1c), r1 < p1, r1 < p2)
        acc2 = (mode_resolve & (n_f >= 2) & ~acc1
                & torch.where(contains(f2c), r2 < p1, r2 < p2))
        res_ok = acc1 | acc2 | (mode_resolve & has_a)
        res_next = torch.where(acc1, f1c, torch.where(acc2, f2c, a_cand))
        res_fail = mode_resolve & ~res_ok

        # A step that advances goes to the wid-owner as a LOG record, unless
        # it was absorbed by the padding (no restart).
        adv_next = torch.where(mode_resolve, res_next, step_next)
        adv_valid = step_done | res_ok
        absorbed = adv_valid & (adv_next == pad) & (not self.restart)
        self._count(3, absorbed)
        res_col = mode_resolve[:, None]
        v_bloom = n2v.blooms[self._my, local]
        fresh = _pack(wid, s1, zero + _F_LOG, v, adv_next, zero, zero, zero,
                      zero, zero, zero,
                      torch.where(res_col, rec_bloom, v_bloom), tgt)
        pend_flags = (_F_MODE + _F_HAS_A * sc_has_a.to(torch.int64)
                      + _F_OVF * sc_ovf.to(torch.int64)
                      + (sc_nf.clamp(max=2) << 3))
        pend = _pack(wid, step, pend_flags, t, v, replay_rnd, sc_a, sc_f1,
                     sc_f1r, sc_f2, sc_f2r, v_bloom, tgt)
        rep = _pack(wid, step, zero, t, v,
                    torch.where(mode_resolve, rnd0, replay_rnd),
                    zero, zero, zero, zero, zero,
                    torch.where(res_col, n2v.blooms[self._my, self._local(t)],
                                rec_bloom), tgt)
        return [(rec_fwd, self._owner(v), fwd),
                (fresh, self._wid_owner(wid), adv_valid & ~absorbed),
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
            ccap=self.ccap, key=self.key, node2vec=n2v, engine=self.engine,
            padding=self.padding, restart=self.restart, flow=pipe.flow)

    # -- K13-K15: phases a launch -----------------------------------------

    def _launch_batch(self, n: int) -> None:
        """One launch of the batch kernel: up to ``n`` phases from the
        walk's state (each pipeline's live pool, and the pipeline the first
        overlapped interval exchanges)."""
        getattr(bindings, bindings.ROUTED_ENGINES[self.engine].kernel)(
            self._batch, n, [pipe.parity for pipe in self.pipes],
            self.enqueued % 2)

    def _run_batch(self, n: int) -> tuple[int, int]:
        """Up to ``n`` phases in one launch, then one read of the phase
        counter and the in-flight count.  The phases that ran (the batch
        stops once nothing is in flight) move the schedule on: each swaps
        the processed pipeline's live pool, and under ``overlapped`` the
        roles.  Returns (phases, records in flight)."""
        before = self._counted
        self._launch_batch(n)
        phases, inflight = self._read()
        ran = phases - before
        for i in range(self.enqueued, self.enqueued + ran):
            self.pipes[1 - i % 2 if len(self.pipes) == 2 else 0].parity ^= 1
        self.enqueued += ran
        return phases, inflight

    # -- the phase loop -------------------------------------------------

    def state(self) -> dict:
        """Every pipeline's outboxes, carry pools' live prefixes and live
        counts, the walk shares and the stats (for phase-by-phase
        comparisons)."""
        out = {"walks": self.walks[:, : self.blk, : self.out_cols],
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
        budget, and its phases after the end are no-ops.  K13-K15 run the
        whole budget in one launch of their batch kernel, which stops
        once nothing is in flight, and the host reads once.  (The JAX serial
        loop's first test counts the boxed records only: after phase 0
        nothing is carried unless something is boxed.)  Returns (walks (B,
        L+1) int32, info)."""
        self.start()
        phases, inflight = self._read()
        while inflight > 0 and phases < self.max_phases:
            if self._batch is not None:
                phases, inflight = self._run_batch(self.max_phases - phases)
                continue
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
        phases, inflight = torch.cat([self._counter,
                                      self.live.sum().view(1)]).tolist()
        self._counted = phases
        return phases, inflight

    def result(self):
        """(walks (B, L+1) int32, or the triples engine's (B, 2L+1), and
        info) as the walk stands; raises if a record was dropped, or a
        walker has not logged every position (the CSR engines) or not
        terminated (the family engines)."""
        walks = self.walks[:, : self.blk, : self.out_cols].reshape(
            self.num_walkers, self.out_cols)
        if self.family:
            info = _routed_info(self.stats, self.width,
                                self.engine.replace("_", "-"),
                                self.num_walkers, self.cfg, self.phases)
        else:
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
        if not self.family:
            info["schedule"] = self.schedule
            _check_complete(info, self.num_walkers, self.walk_length,
                            self.cfg)
        return walks, info


def _pack(wid, step, flags, t, v, rnd, a, f1, f1r, f2, f2r, bloom_rows,
          target=None):
    """(M, 14) int32 node2vec records from uint32 words held as int64 (or
    signed node ids) and (M, 4) int32 filters; with ``target`` the (M, 15)
    biased edge-list records, the target in word 10."""
    word1 = (step | (flags << 24)) & prng.MASK32
    words = [wid, word1, t, v, rnd, a, f1, f1r, f2, f2r]
    if target is not None:
        words.append(target)
    cols = [prng.to_i32_bits(x & prng.MASK32) for x in words]
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
    """Check and gather the node2vec machine's tables: ``hashes`` from
    ``build_partition_hashes`` or ``build_edge_list_partition_hashes`` (or
    None: the CSR engine's binary search), ``blooms`` from
    ``build_partition_blooms`` or ``build_edge_list_partition_blooms`` (or
    None: saturated filters)."""
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


# --- the edge-list and KG-triples families ----------------------------------

def _range_partition(index, payload, n: int, num_shards: int):
    """Split a head-sorted ``payload`` ((E,) tails or (E, 2) [relation,
    tail] rows) and its (N, 2) [start, end-inclusive] range ``index``
    ((-1, -1) for an empty head) into contiguous head-range shards, on the
    payload's device.  Returns (meta: per shard (S, 2) int32 [local start,
    cnt], with the cumulative form's start for an empty head; payload: per
    shard (E_max, ...) int32, zero-padded to the largest shard's rows, at
    least 1; S)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = payload.device
    s = -(-n // num_shards)
    starts = index[:, 0].to(torch.int64)
    cnts = torch.where(starts >= 0, index[:, 1].to(torch.int64) - starts + 1,
                       0)
    gstart = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    gstart[1:] = torch.cumsum(cnts, 0)
    bounds = [min(d * s, n) for d in range(num_shards + 1)]
    edge_bounds = gstart[torch.tensor(bounds, device=dev)].tolist()
    e_max = max(max(b - a for a, b in zip(edge_bounds, edge_bounds[1:])), 1)
    metas, shards = [], []
    for d in range(num_shards):
        lo, hi = bounds[d], bounds[d + 1]
        e_lo, e_hi = edge_bounds[d], edge_bounds[d + 1]
        meta = torch.zeros((s, 2), dtype=torch.int32, device=dev)
        meta[: hi - lo, 0] = gstart[lo:hi] - e_lo
        meta[: hi - lo, 1] = cnts[lo:hi]
        shard = torch.zeros((e_max, *payload.shape[1:]), dtype=torch.int32,
                            device=dev)
        shard[: e_hi - e_lo] = payload[e_lo:e_hi]
        metas.append(meta)
        shards.append(shard)
    return tuple(metas), tuple(shards), s


@dataclasses.dataclass(frozen=True)
class PartitionedTriples:
    """A ``TriplesGraph`` split into contiguous head-entity ranges of
    ``shard_nodes`` ids (twin of the JAX package's ``PartitionedTriples``,
    with ``PartitionedCSR``'s field names): ``node_meta[d]`` (S, 2) int32
    [local start, cnt] of shard d's heads and ``col[d]`` (E_max, 2) int32
    its [relation, tail] rows, one tensor pair a shard."""

    node_meta: tuple[torch.Tensor, ...]
    col: tuple[torch.Tensor, ...]
    num_nodes: int
    num_shards: int
    shard_nodes: int

    @property
    def device(self) -> torch.device:
        return self.col[0].device

    @classmethod
    def from_triples(cls, graph, num_shards: int) -> "PartitionedTriples":
        """Partition on the graph's own device."""
        meta, rel_tail, s = _range_partition(
            graph.relation_tail_index, graph.triples[:, 1:3],
            graph.num_entities, num_shards)
        return cls(node_meta=meta, col=rel_tail, num_nodes=graph.num_entities,
                   num_shards=num_shards, shard_nodes=s)


@dataclasses.dataclass(frozen=True)
class PartitionedEdgeList:
    """An ``EdgeListGraph`` split into contiguous head-node ranges of
    ``shard_nodes`` ids (twin of the JAX package's ``PartitionedEdgeList``,
    with ``PartitionedCSR``'s field names): ``node_meta[d]`` (S, 2) int32
    [local start, cnt] and ``col[d]`` (E_max,) int32 the tails of shard d's
    out-edges, one tensor pair a shard."""

    node_meta: tuple[torch.Tensor, ...]
    col: tuple[torch.Tensor, ...]
    num_nodes: int
    num_shards: int
    shard_nodes: int

    @property
    def device(self) -> torch.device:
        return self.col[0].device

    @classmethod
    def from_edge_list(cls, graph, num_shards: int) -> "PartitionedEdgeList":
        """Partition on the graph's own device."""
        meta, tails, s = _range_partition(graph.node_edge_index, graph.tails,
                                          graph.num_nodes, num_shards)
        return cls(node_meta=meta, col=tails, num_nodes=graph.num_nodes,
                   num_shards=num_shards, shard_nodes=s)


def _edge_list_head_sorted(graph):
    """(row_ptr (N+1,) int64, tails (E,) int32) of the head-sorted edge
    list, the CSR form of the rows that ``_range_partition`` slices."""
    index = graph.node_edge_index
    starts = index[:, 0].to(torch.int64)
    cnts = torch.where(starts >= 0, index[:, 1].to(torch.int64) - starts + 1,
                       0)
    row_ptr = torch.zeros(graph.num_nodes + 1, dtype=torch.int64,
                          device=graph.device)
    row_ptr[1:] = torch.cumsum(cnts, 0)
    return row_ptr, graph.tails


def build_edge_list_partition_hashes(pgraph: PartitionedEdgeList, graph):
    """Per-shard cuckoo edge sets for the routed biased edge-list engine:
    shard d's set holds the edges whose head lies in shard d's range, so
    that owner(t) answers ``cand in N(t)`` alone; built on the partitioned
    graph's device, bit for bit the JAX package's NumPy build.  Returns
    (tables (D, S_h, 2) int32 bit patterns, salts (D,) int32, log_size)."""
    row_ptr, tails = _edge_list_head_sorted(graph)
    return shard_hash_tables(row_ptr, tails, pgraph)


def build_edge_list_partition_blooms(pgraph: PartitionedEdgeList,
                                     graph) -> torch.Tensor:
    """(D, S, 4) int32 bit patterns: each node's 128-bit Bloom filter over
    its out-neighbours, node-range sharded like ``pgraph``."""
    return shard_blooms(*_edge_list_head_sorted(graph), pgraph)


def _family_prepare(pgraph, target_nodes, walk_length, padding_idx, device):
    """The checks of ``_prepare`` and the padding's; returns (targets, body,
    the walk of length 0 with its info, or None)."""
    _, targets, body = _prepare(pgraph, target_nodes, walk_length, device)
    if not -2 ** 31 <= int(padding_idx) < 2 ** 31:
        raise ValueError(f"padding_idx must be an int32 id, got "
                         f"{padding_idx}")
    empty = None
    if walk_length == 0:  # the target column, nothing routed
        num_walkers = int(targets.shape[0])
        empty = (targets.reshape(-1, 1).clone(), {
            "log_entries": 0, "exchanged_records": 0, "phases": 0,
            "overflow_dropped": 0, "terminated": num_walkers,
            "exchange_bytes": 0})
    return targets, body, empty


def walk_triples_partitioned_routed(pgraph: PartitionedTriples, target_nodes,
                                    walk_length: int, padding_idx: int,
                                    seed: int = 0,
                                    config: RoutedConfig | None = None,
                                    schedule: str = "serial", device=None):
    """KG-triples walks over head-range shards with owner-routed walkers.

    Returns (walks (B, 2L+1) int32: entity, relation, entity, ...; info
    with ``log_entries``, ``exchanged_records``, ``phases``,
    ``overflow_dropped``, ``terminated``, ``exchange_bytes``).  A walker
    absorbed by a head without triples or by the padding keeps padding in
    its remaining positions.  Equal to the JAX package's
    ``walk_triples_partitioned_routed`` for the same graph, targets and
    seed, under either ``schedule``.
    """
    targets, body, empty = _family_prepare(
        pgraph, target_nodes, walk_length, padding_idx, device)
    if empty is not None:
        return empty
    cfg = RoutedConfig.resolve(config, targets.shape[0], pgraph.num_shards,
                               int(walk_length))
    key = prng.derive_key(int(seed), prng.STREAM_TRIPLES)
    return RoutedWalk(pgraph, targets, walk_length, key, cfg, schedule, body,
                      engine="triples", padding=padding_idx).run()


def walk_edge_list_partitioned_routed(pgraph: PartitionedEdgeList,
                                      target_nodes, walk_length: int,
                                      padding_idx: int, restart: bool = True,
                                      seed: int = 0,
                                      config: RoutedConfig | None = None,
                                      schedule: str = "serial", device=None):
    """Uniform edge-list walks (padding and restart at dead ends) over
    head-range shards with owner-routed walkers.

    Returns (walks (B, L+1) int32, info as
    ``walk_triples_partitioned_routed``'s).  Equal to the JAX package's
    ``walk_edge_list_partitioned_routed`` for the same graph, targets and
    seed, under either ``schedule``.
    """
    targets, body, empty = _family_prepare(
        pgraph, target_nodes, walk_length, padding_idx, device)
    if empty is not None:
        return empty
    cfg = RoutedConfig.resolve(config, targets.shape[0], pgraph.num_shards,
                               int(walk_length))
    key = prng.derive_key(int(seed), prng.STREAM_EDGE_UNIFORM)
    return RoutedWalk(pgraph, targets, walk_length, key, cfg, schedule, body,
                      engine="edge_list", padding=padding_idx,
                      restart=restart).run()


def walk_edge_list_node2vec_partitioned_routed(
        pgraph: PartitionedEdgeList, hashes, target_nodes, p: float, q: float,
        walk_length: int, padding_idx: int, restart: bool = True,
        seed: int = 0, config: RoutedConfig | None = None,
        spec_rounds: int = 6, blooms=None, schedule: str = "serial",
        device=None):
    """Biased (p/q) edge-list walks over head-range shards with owner-routed
    walkers: the node2vec engine's phase machine with the edge-list law.

    ``hashes`` = ``build_edge_list_partition_hashes(pgraph, graph)`` (the
    exact test at owner(t)); ``blooms`` =
    ``build_edge_list_partition_blooms(pgraph, graph)`` (None: saturated
    filters, every in-band draw travels).  Returns (walks (B, L+1) int32,
    info as ``walk_triples_partitioned_routed``'s plus
    ``collectives_per_step``).  Equal to the JAX package's
    ``walk_edge_list_node2vec_partitioned_routed`` for the same graph,
    targets and seed, whatever the filters and the schedule.
    """
    targets, body, empty = _family_prepare(
        pgraph, target_nodes, walk_length, padding_idx, device)
    if empty is not None:
        return empty
    if walk_length >= 1 << 24:
        raise ValueError(f"walk_length must be below 2^24 (the step field "
                         f"of a record), got {walk_length}")
    if hashes is None:
        raise ValueError("hashes must be build_edge_list_partition_hashes of "
                         "this partition (the engine has no search)")
    num_walkers = int(targets.shape[0])
    cfg = RoutedConfig.resolve(config, num_walkers, pgraph.num_shards,
                               int(walk_length))
    if config is None or config.max_phases <= 0:
        cfg = _biased_phase_budget(cfg, int(walk_length), spec_rounds)
    routing = node2vec_routing(pgraph, p, q, spec_rounds, hashes, blooms)
    key = prng.derive_key(int(seed), prng.STREAM_EDGE_BIASED)
    return RoutedWalk(pgraph, targets, walk_length, key, cfg, schedule, body,
                      node2vec=routing, engine="edge_list_node2vec",
                      padding=padding_idx, restart=restart).run()
