#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, drives the port's main path at the
bench shape through the public entry points (power-law graph of 2 M nodes and
about 36 M directed edges, 131 072 walkers, walk length 80: uniform walks,
node2vec walks by both samplers, skip-gram windows, then the owner-routed
partitioned engines over 8 shards with 32 768 walkers, uniform and node2vec
at p=0.5 q=2 with the per-shard cuckoo edge sets and Bloom filters, their
phases run by K11 and K12), then the training
half of the main path on the same graph: ``Node2Vec`` at the bench
configuration (dim 128, walk length 16, window 5, bfloat16 tables, 256 shared
negatives, 65 536 start nodes a step), one warm step and three chained steps
through ``epoch_step`` and one step with p=0.5, q=2 (K1/K2, K5/K6 and
K18's dense Adam); then the trainer's other modes at the same
configuration (``train_modes``: ``train_mode="windows"`` through K3,
K16/K17 and K18, also one step at p=0.5 q=2; ``update_mode="sparse"``
through the dedup and gathers, K5/K6 on the gathered rows and K18's rows
entry; ``negative_distribution="degree75"``, dense and sparse, with the
alias tables built on the host; ``CBOWModel.train_step`` on
``to_windows_cbow`` of the step's walks through K16/K17's CBOW form and
K18), each case's steps, parts, losses, launches and peak memory, and
K16/K17 (both forms, and both in the one call that the window steps make),
K18 dense and K18 rows against their plain versions on the rows the main
path gave them, K16/K17's launches each timed by the profiler; last, the
edge-list and
KG-triples families derived from the same graph as the JAX package's
``bench.py --families all`` derives them (the edge list (heads, col_idx) and
the triples with 16 pseudo relations; padding N, restart, seed 7):
``walk_edge_list`` through the graph entry and the raw arrays, uniform (K7)
and p=0.5 q=2 (K8), ``walk_triples`` through both entries (K9) and both
triple window generators
at W=5 (K10), on the graph and on a copy whose last quarter of nodes has no
out-edges; and those families routed over the 8 shards with 32 768 walkers
(``walk_edge_list_partitioned_routed`` with restart and absorbing through
K14, ``walk_edge_list_node2vec_partitioned_routed`` at p=0.5 q=2 with the
edge-list cuckoo tables and with Bloom filters and saturated ones through
K15, ``walk_triples_partitioned_routed`` through K13; both schedules; both
copies; K13, K14 and K15 are one persistent cooperative launch a walk
after phase 0); last, the KG-embedding trainer on the same triples (1 000
held out) at the README's configuration (``KGEmbeddingConfig(dim=128)``,
float32, walk length 20, 4 negatives, W = 3, 65 536 start entities a
step): TransE dense and touched-rows, DistMult, RotatE, triple skip-gram
and CBOW, one warm and three chained ``epoch_step``s each through K9, K10,
K19 or K20 and K18, the first step's loss again from the same tables, the
parts of a step, K19 and K20 (both entries, both table types) against
their plain versions on a prefix of the step's own positives or windows
and at the edges (``kge_small_checks``: a relation every item has, and
relation vocabularies just under and just over the shared-memory budget of
the relation rows' sums), each entry's device time by launch, the relation
path it took and its global row adds counted from its inputs (``kge_kernels``
line), and the tail ranking of the held-out triples against all entities
(``phase_kge``); the ``build`` line gives K19's and K20's registers,
spills and atomic instructions. Last, the data axis of the multi-device
layer (``phase_dp``) on a process group of this one process over NCCL: the
three data-parallel walks at the bench shape, ``ShardedNode2Vec`` at the
train configuration (block dense, touched-rows and windows) and
``ShardedKGEmbedding`` at the KGE configuration (TransE dense, skip-gram),
their launches counted from zero, each walk equal to the one-card entry's
and each trainer to the one-card trainer's (the first loss bit for bit;
later losses and the tables within the spread that the gradient kernels'
float atomics give the one-card trainer against itself), their step times
beside the one-card steps and the group's all-reduce of one step's gradients
(``dp`` line); and K3 and K10 at a nonzero ``window_offset`` on the bench
walks against the rows of the offset-0 call and their plain versions
(``dp_window_offsets`` line).  Last, the command-line entry points
(``phase_cli``, ``cli`` line), in this process as a user runs them, with
their launches counted from zero: ``products_shape_graph`` (2 449 029 nodes,
about 127 M edges) drawn on the host, built on the card and written to its
cache, then loaded from it, equal, with K1 and K2 walks on it (131 072
walkers, L = 80, p = 0.5 q = 2, every hop an edge); trw-torch-walk on
``synth:2449029:25`` (about 127 M edges once symmetrized), its ``.npy``
equal to ``walk()`` on the same graph; trw-torch-train on the same spec with
its defaults (dim 128, L = 40, window 5, float32 tables, every node a walk a
step: K1, K5/K6 on float32, K18) for 3 epochs; a run on
``synth:200000:8`` checkpointed after 2 epochs and resumed to 4 against an
uninterrupted 4-epoch run (every epoch's walks equal, losses and tables
within the allowance of the gradient kernels' float atomics); and
trw-torch-train-kg on ``grid:1000`` (1 000 000 entities, about 4 M triples,
every entity a walk a step) for 2 epochs with TransE and a held-out
ranking (K9, K19, K18) and with the skip-gram objective (K9, K10, K20,
K18); each part's times and peak device memory. It checks the results and
measures every kernel at the shape the main path gives it; the two loss
kernels also with float32 tables, each with its tile plan and its device time
by kernel.  The ``build`` line reports each loss kernel's registers and
spills (``-Xptxas -v``) and its tensor-core instructions (``cuobjdump
-sass``), and the run fails unless the bfloat16 K5 and K6 hold some; it
also gives the walk, window and exchange kernels' registers, spills and
stack frames, the instructions of one Threefry call counted in the SASS of a
probe kernel (by pipe; its rotates and xors set the bounds' operation
count), K3's instructions a slot counted the same way in its own SASS, and
the ``walk_geometry`` line K2's threads per block and its resident blocks
per SM.  The ``walk_times`` line times K1 and K2 at the bench shape and with a
half and a quarter of the walkers; the ``windows_times`` and
``exchange_kernel`` lines time K3 and K4 (K4 beside an empty kernel launched
the same way, the floor of a launch, and beside the library call, as device
time and with the host in the way).  The small checks also walk a graph
built with ``build_fat=False``, which must take the rejection sampler with
the graph's own search depth, and hold K3 and K4 against their plain
versions at the edges of their launch plans, and K7-K10 against theirs on
small graphs with dead ends (``family_kernels_small``: K7 and K9 on every
table their entries read, padding -1 and N, restart both ways, targets
outside [0, N), round budgets of 1 and 2, L = 1, 7, 8, 9, 80 and B = 1,
33, 4 097, W = 1, 2, 5, 11, searches cut short,
tables of one and two triples, walks of padding alone, CBOW's launch in
groups), and K16-K18 at D = 1, 7, 128, 130, 512, one window, ids of -1, a
row that every window hits (K17's block-a-row owner pass), a tail of pad
slots and no flagged slot (``train_mode_small_checks``; K16/K17 also
through the fused entry, whose loss must be K16's bits).

With ``--compare NAME=DIR`` (another checkout of the repo, e.g. the parent
commit's ``git archive`` unpacked under the ignored ``build/``; repeatable),
the run ends with a ``kernel_comparison`` line: K7 and K9 through both
entries on the bench graph and on its copy with dead ends, K8 through both
edge-list entries and K10's two generators at the families' bench shape
(CBOW also at W = 1, 2 and 10), and K3 on the bench walks; each checkout's
package imported beside this one and its kernels built from its own sources,
timed in this one process, in turns
(``phase_compare_kernels``); then a ``routed_comparison`` line, the routed
uniform and node2vec serial legs of each checkout the same way, with the
device time of their phase calls; then a ``routed_family_comparison``
line, K13's, K14's and K15's bench legs (triples, uniform with restart,
p=0.5 q=2 with Bloom filters; both schedules) of each checkout the same
way, and each leg's device time a phase and idle share by the profiler;
last a ``train_window_comparison`` line, K16 and K17 (and the fused entry
where a checkout has it) on the bench train step's windows, skip-gram on
bfloat16 and CBOW on float32 tables, and each checkout's windows-mode and
CBOW ``train_step`` from the same tables on the same windows, the same
way; and a ``kge_comparison`` line, K19 (TransE, RotatE) and K20
(skip-gram, CBOW), both entries, and each checkout's KGE ``train_step``
from the same tables on the same batch, the same way; and a
``dp_comparison`` line, ``ShardedNode2Vec``'s dense step of each checkout
that has the data axis (a ``dp_comparison_skipped`` line for each that has
not).  Without arguments it needs one card and nothing else.

Every kernel is held against its plain version on all the rows the main path
gives it.  The routed legs (``phase_routed``) hold K11 and K12 against the
plain phase bodies on the card state by state for the first 8 phases of
each leg and then on the whole leg (walks, phases, exchanged records,
logged positions), time every leg warm (uniform under both schedules,
node2vec under both and with the binary search in place of the cuckoo
probes; each also with 1 to 32 phases a read of the loop, eager and
replayed as a CUDA graph), time the phase calls by CUDA events (the
phases' calls and the no-op calls of the last batch apart) and profile
each kernel leg whole (the compaction's, the bodies' and K4's device time
a phase); only the plain bodies' profiles run at walk length 10, where the
profiler's digest of their hundreds to thousands of launches a phase would
take minutes at full depth.  The small checks hold K11 and K12 against the
plain bodies phase by phase on a 3 000-node graph with dead ends (D = 1, 2,
8, 16, L = 1 and 12, both schedules, a filling carry pool, one of many
tiles and an overflowing one, both membership tests, saturated
filters), and K13-K15 the same way on that graph's families (their batch
kernel a launch of one phase each, and each leg also whole in one
launch).  The routed family legs (``phase_routed_families``) hold
K13-K15 against the plain bodies state by state for the first 8 phases and
whole, each leg against the single-device walks (K7, K8, K9) and every hop
against the graph, then time them as the routed CSR legs; the
``routed_families`` line adds, for K13's, K14's and K15's legs, the
launches and phases a leg, the batch kernel's grid, blocks per SM, registers and
barriers a phase, the warm leg ms, the device us a phase (profiler) and
the idle share, and the serial legs with 1, 2 and every resident block an
SM.

Every phase prints one JSON line.  The line before the last two is
``{"kernels": [...]}`` with, per kernel, its launches on the main path (the
sampling run and the training run, each counted from zero, added up; for
K7-K10 the families' run and for K13-K15 the routed families' run, each
counted from zero; K13's, K14's and K15's are launches a walk, their
phases beside them), its
largest deviation from the plain version (0 for the integer kernels; for the
two float kernels the limits are ``LOSS_REL_LIMIT`` and ``GRAD_REL_LIMIT``
below), its time, the plain version's time,
the least time the card could take (``bound_ms``: bytes over the memory
rate, or integer operations over SMs x 64 INT32 results a clock x the
maximum SM clock that nvidia-smi reports, whichever is larger) and, where
one PyTorch call does the same work, that call's time; K2's rows add their
time over K1's of the same run, and every row its launches in the sampling
and in the training run apart.  Then come the card's name and power
limit as nvidia-smi prints them, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure ends the run with a non-zero exit code; without a CUDA device the
script exits at once with code 1 and prints no result.  It imports only the
port (``torch_random_walk_tpu_torch``), never JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu_torch import cli as trw_cli
from torch_random_walk_tpu_torch.graph import datasets
from torch_random_walk_tpu_torch.kernels import bindings, build
from torch_random_walk_tpu_torch.models import kge, skipgram
from torch_random_walk_tpu_torch.ops import (
    common,
    edge_list_walk,
    node2vec,
    triples_walk,
    uniform,
    windows,
)
from torch_random_walk_tpu_torch.parallel import exchange, partition_v2
from torch_random_walk_tpu_torch.utils import checkpoint, prng
from torch_random_walk_tpu_torch.utils.device import synchronize

# The bench shape of the JAX package's bench.py (its single-chip default and
# its scaling mode's walker count).
NUM_NODES, AVG_DEGREE, GRAPH_SEED = 2_000_000, 16, 0
NUM_WALKERS, WALK_LENGTH, WINDOW = 131_072, 80, 5
P, Q = 0.5, 2.0
NUM_SHARDS, ROUTED_WALKERS = 8, 32_768
WALK_SEED, WINDOW_SEED = 1, 2
PROFILED_WALK_LENGTH = 10
SPEC_ROUNDS = 6  # the routed node2vec engine's default (bench.py's)
ROUTED_CHECKED_PHASES = 8  # phases compared state by state at the bench shape
WALK_REPS = 4  # walk calls queued back to back for their device time

# The edge-list and KG-triples families of the JAX package's bench.py
# (``--families all``): both derived from the bench CSR graph, the edge list
# as (heads, col_idx), the triples with 16 pseudo relations (heads *
# 2654435761 mod 16); padding N, restart, seed 7, the bench's walkers and
# walk length; triple windows of 5.
FAMILY_SEED, NUM_RELATIONS, RELATION_MULT = 7, 16, 2654435761
FAMILY_KERNELS = ("uniform_walk_edge_list", "biased_walk_edge_list",
                  "uniform_walk_triples", "to_windows_triples",
                  "to_windows_triples_cbow")

# The fused train step of the JAX package's bench.py: its Node2VecConfig and
# its 65 536 start nodes a step.
TRAIN_CONFIG = dict(dim=128, walk_length=16, window_size=5, p=1.0, q=1.0,
                    dtype="bfloat16", shared_negatives=256)
TRAIN_WALKERS, TRAIN_STEPS = 65_536, 3
# K5/K6 against their plain version (float32 products and sums on both sides,
# of the same table values; only the order of the sums differs, and K6 adds
# with atomics): the loss within 1e-5 of the plain loss, every gradient entry
# within 1e-4 of the largest entry of its table.
LOSS_REL_LIMIT, GRAD_REL_LIMIT = 1e-5, 1e-4

# The KG-embedding trainer of the README (``KGEmbeddingConfig(dim=128,
# objective="transe")``, walk length 20, 4 negatives, margin 2, lr 1e-2,
# float32; W = 3 for the window objectives) on the bench triples graph
# (family_graphs: 2 M entities, 16 relations, about 36 M triples, fat,
# padding N), KGE_HELD_OUT triples held out for the tail ranking, 65 536
# start entities a step: one warm and three chained epoch steps a case.
KGE_CONFIG = dict(dim=128, walk_length=20, window_size=3, num_negatives=4,
                  margin=2.0, learning_rate=1e-2, dtype="float32")
KGE_WALKERS, KGE_STEPS, KGE_HELD_OUT, KGE_SEED = 65_536, 3, 1_000, 13
KGE_CASES = {
    "transe": dict(objective="transe"),
    "transe_sparse": dict(objective="transe", update_mode="sparse"),
    "distmult": dict(objective="distmult"),
    "rotate": dict(objective="rotate"),
    "skipgram": dict(objective="skipgram"),
    "cbow": dict(objective="cbow"),
}
# Launches a step each case must show (the rest of KGE_KERNELS: 0).
KGE_LAUNCHES = {
    "pair": {"uniform_walk_triples": 1, "kge_pair_loss_and_grads": 1,
             "adam_dense": 2},
    "sparse": {"uniform_walk_triples": 1, "kge_pair_loss_and_grads": 1,
               "adam_rows": 2},
    "skipgram": {"uniform_walk_triples": 1, "to_windows_triples": 1,
                 "kge_windows_loss_and_grads": 1, "adam_dense": 4},
    "cbow": {"uniform_walk_triples": 1, "to_windows_triples_cbow": 1,
             "kge_windows_loss_and_grads": 1, "adam_dense": 4},
}
KGE_KERNELS = ("uniform_walk_triples", "to_windows_triples",
               "to_windows_triples_cbow", "kge_pair_loss",
               "kge_pair_loss_and_grads", "kge_windows_loss",
               "kge_windows_loss_and_grads", "adam_dense", "adam_rows")
KGE_ROWS = ("kge_pair_loss", "kge_pair_loss_and_grads", "kge_windows_loss",
            "kge_windows_loss_and_grads")
# The plain versions of K19 and K20 gather every scored row for autograd
# (about 10 GB for the pair loss at the full 1 310 720 positives): they are
# held against the kernels on this prefix of the step's positives or
# windows, both kernels' entries run on the same prefix.
KGE_CHECK_PREFIX = 262_144
# The most global row adds the redesigned K19 and K20 make an item at the
# bench shape (K = 4; W = 3): a positive's h and t and its 4 negatives' own
# rows; a skip-gram window's 2 in rows, at most 8 distinct positive entity
# rows (each positive's tail is the next one's head) and 12 negative ones,
# its relation rows summed on chip.
KGE_MOST_ADDS_PAIR, KGE_MOST_ADDS_SKIPGRAM = 6, 22

# Peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet): device
# memory rate; dense tensor-core peaks by table type (bfloat16; float32
# tables as TF32).
HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 495e12}
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (K18)
# K18 against its plain version: every stored element within one unit in the
# last place of its type.
ADAM_ULP_LIMIT = 1
# The walk and window kernels' arithmetic is 32-bit integer work (Threefry's
# adds, xors and rotates, index arithmetic).  A Hopper SM retires 64 INT32
# results a clock (half its 128 FP32 lanes), so the card's integer rate is
# SMs x 64 x its maximum SM clock; phase_device() reads the clock from
# nvidia-smi and sets INT_OPS_PER_S.
INT32_RESULTS_PER_SM_CLOCK = 64
INT_OPS_PER_S: float | None = None
# Instructions of one Threefry-2x32 call that only the INT32 pipe executes
# (its rotates and xors), counted by phase_build() in the SASS of a probe
# kernel (threefry_sass_ops()); and of one binary-search trip (compare,
# select, halve, address: an estimate, not counted).
THREEFRY_OPS: int | None = None
SEARCH_TRIP_OPS = 6

KERNEL_FACTS = {
    "uniform_walk_csr": (
        "torch_random_walk_tpu_torch/kernels/uniform_walk.cu",
        "torch_random_walk_tpu/ops/uniform.py:20 (XLA loop, no Pallas "
        "counterpart)"),
    "node2vec_walk_csr_mixture": (
        "torch_random_walk_tpu_torch/kernels/node2vec_walk.cu",
        "torch_random_walk_tpu/ops/node2vec.py:106 (XLA loop, no Pallas "
        "counterpart)"),
    "node2vec_walk_csr_rejection": (
        "torch_random_walk_tpu_torch/kernels/node2vec_walk.cu",
        "torch_random_walk_tpu/ops/node2vec.py:30 (XLA loop, no Pallas "
        "counterpart)"),
    "to_windows": (
        "torch_random_walk_tpu_torch/kernels/windows.cu",
        "torch_random_walk_tpu/ops/windows.py:59 (XLA program, no Pallas "
        "counterpart)"),
    "all_to_all_chunks": (
        "torch_random_walk_tpu_torch/kernels/exchange.cu",
        "torch_random_walk_tpu/parallel/pallas_exchange.py:33"),
    "walk_sgns_loss_fwd": (
        "torch_random_walk_tpu_torch/kernels/sgns_loss.cu",
        "torch_random_walk_tpu/models/skipgram.py:180 (walk_loss_fn and "
        "_blockwise_loss:213, XLA program, no Pallas counterpart)"),
    "walk_sgns_loss_bwd": (
        "torch_random_walk_tpu_torch/kernels/sgns_loss.cu",
        "torch_random_walk_tpu/models/skipgram.py:241 (value_and_grad of "
        "walk_loss_fn, XLA program, no Pallas counterpart)"),
    "sgns_windows_loss_fwd": (
        "torch_random_walk_tpu_torch/kernels/sgns_windows.cu",
        "torch_random_walk_tpu/models/skipgram.py:154 (SkipGramModel.loss_fn;"
        " and models/cbow.py:37, CBOWModel.loss_fn; XLA program, no Pallas "
        "counterpart)"),
    "sgns_windows_loss_bwd": (
        "torch_random_walk_tpu_torch/kernels/sgns_windows.cu",
        "torch_random_walk_tpu/models/skipgram.py:173 (the gradient of "
        "loss_fn, taken by value_and_grad in train_step; and "
        "models/cbow.py:47; XLA program, no Pallas counterpart)"),
    "sgns_windows_loss_and_grads": (
        "torch_random_walk_tpu_torch/kernels/sgns_windows.cu",
        "torch_random_walk_tpu/models/skipgram.py:173 (value_and_grad of "
        "loss_fn in train_step; and models/cbow.py:47; XLA program, no "
        "Pallas counterpart)"),
    "adam_dense": (
        "torch_random_walk_tpu_torch/kernels/adam.cu",
        "torch_random_walk_tpu/models/skipgram.py:238 (optax.adam and "
        "apply_updates in walk_train_step:238-245 and train_step:173; XLA "
        "program, no Pallas counterpart)"),
    "adam_rows": (
        "torch_random_walk_tpu_torch/kernels/adam.cu",
        "torch_random_walk_tpu/models/skipgram.py:257 (the lazy Adam and "
        "scatter_rows of walk_train_step_sparse; XLA program, no Pallas "
        "counterpart)"),
    "kge_pair_loss": (
        "torch_random_walk_tpu_torch/kernels/kge_pair.cu",
        "torch_random_walk_tpu/models/kge.py:186 (KGEModel._pair_loss_tabs "
        "through pair_loss_fn:196; XLA program, no Pallas counterpart)"),
    "kge_pair_loss_and_grads": (
        "torch_random_walk_tpu_torch/kernels/kge_pair.cu",
        "torch_random_walk_tpu/models/kge.py:269 (value_and_grad of "
        "pair_loss_fn in pair_train_step, and of _pair_loss_tabs in "
        "pair_train_step_sparse:350; XLA program, no Pallas counterpart)"),
    "kge_windows_loss": (
        "torch_random_walk_tpu_torch/kernels/kge_windows.cu",
        "torch_random_walk_tpu/models/kge.py:223 (skipgram_loss_fn; and "
        "cbow_loss_fn:245; XLA program, no Pallas counterpart)"),
    "kge_windows_loss_and_grads": (
        "torch_random_walk_tpu_torch/kernels/kge_windows.cu",
        "torch_random_walk_tpu/models/kge.py:377 (value_and_grad of "
        "skipgram_loss_fn in skipgram_train_step; and cbow_train_step:385; "
        "XLA program, no Pallas counterpart)"),
    "uniform_walk_edge_list": (
        "torch_random_walk_tpu_torch/kernels/edge_list_walk.cu",
        "torch_random_walk_tpu/ops/fatwalk.py:1092 (uniform_walk_edge_list_fat"
        "; oracle ops/edge_list_walk.py:28; XLA loop, no Pallas "
        "counterpart)"),
    "biased_walk_edge_list": (
        "torch_random_walk_tpu_torch/kernels/edge_list_walk.cu",
        "torch_random_walk_tpu/ops/fatwalk.py:1362 (node2vec_walk_edge_list_"
        "freerun through node2vec_walk_edge_list_fat:1185; oracle "
        "ops/edge_list_walk.py:51; XLA loop, no Pallas counterpart)"),
    "uniform_walk_triples": (
        "torch_random_walk_tpu_torch/kernels/triples.cu",
        "torch_random_walk_tpu/ops/fatwalk.py:1138 (uniform_walk_triples_fat"
        "; oracle ops/triples_walk.py:25; XLA loop, no Pallas counterpart)"),
    "to_windows_triples": (
        "torch_random_walk_tpu_torch/kernels/triples.cu",
        "torch_random_walk_tpu/ops/windows.py:126 (_triples_targets_and_"
        "windows:91; XLA program, no Pallas counterpart)"),
    "to_windows_triples_cbow": (
        "torch_random_walk_tpu_torch/kernels/triples.cu",
        "torch_random_walk_tpu/ops/windows.py:142 (_triples_targets_and_"
        "windows:91; XLA program, no Pallas counterpart)"),
    "routed_uniform_phase": (
        "torch_random_walk_tpu_torch/kernels/routed.cu",
        "torch_random_walk_tpu/parallel/partition_v2.py:325 (process of "
        "_routed_uniform_jit with _build_outbox:176; XLA program, no Pallas "
        "counterpart)"),
    "routed_node2vec_phase": (
        "torch_random_walk_tpu_torch/kernels/routed.cu",
        "torch_random_walk_tpu/parallel/partition_v2.py:675 (process of "
        "_routed_n2v_jit with _build_outbox:176; XLA program, no Pallas "
        "counterpart)"),
    "routed_triples_batch": (
        "torch_random_walk_tpu_torch/kernels/routed_families.cu",
        "torch_random_walk_tpu/parallel/partition_v2.py:1163 (process of "
        "_routed_triples_jit:1121 with _build_outbox:176; XLA program, no "
        "Pallas counterpart)"),
    "routed_edge_list_batch": (
        "torch_random_walk_tpu_torch/kernels/routed_families.cu",
        "torch_random_walk_tpu/parallel/partition_v2.py:1420 (process of "
        "_routed_edge_list_jit:1388 with _build_outbox:176; XLA program, no "
        "Pallas counterpart)"),
    "routed_edge_list_node2vec_batch": (
        "torch_random_walk_tpu_torch/kernels/routed_families.cu",
        "torch_random_walk_tpu/parallel/partition_v2.py:1774 (process of "
        "_routed_edge_list_n2v_jit:1678 with _build_outbox:176; XLA program, "
        "no Pallas counterpart)"),
}
INTEGER_KERNELS = ("uniform_walk_csr", "node2vec_walk_csr_mixture",
                   "node2vec_walk_csr_rejection", "to_windows",
                   "all_to_all_chunks", "routed_uniform_phase",
                   "routed_node2vec_phase")
ROUTED_KERNELS = ("routed_uniform_phase", "routed_node2vec_phase")
# K13-K15, all three the persistent batch kernel: one cooperative launch a
# walk after phase 0, its phases' steps separated by grid barriers (three a
# serial phase, two an overlapped interval).
ROUTED_FAMILY_KERNELS = ("routed_triples_batch", "routed_edge_list_batch",
                         "routed_edge_list_node2vec_batch")
BATCH_BARRIERS_PER_PHASE = {"serial": 3, "overlapped": 2}
T0 = time.perf_counter()


RUN_PEAK_BYTES = [0]  # the run's peak device memory, as peak_gib folds it


def peak_gib() -> float | None:
    """Peak device memory allocated since the last call, in GiB (None before
    the card is in use); it is folded into the run's peak, and the card's
    peak counter starts again."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    peak = torch.cuda.max_memory_allocated()
    RUN_PEAK_BYTES[0] = max(RUN_PEAK_BYTES[0], peak)
    torch.cuda.reset_peak_memory_stats()
    return round(peak / 2**30, 2)


def emit(phase: str, **fields) -> None:
    """One JSON line; ``peak_gib`` is the peak device memory since the
    previous line, so the line of the phase that sets the run's peak shows
    it."""
    print(json.dumps({"phase": phase,
                      "at_s": round(time.perf_counter() - T0, 1), **fields,
                      "peak_gib": peak_gib()}),
          flush=True)


def time_ms(fn, warmup: int = 1, iters: int = 5) -> float:
    """Median device time of ``fn`` in milliseconds, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn):
    """One run of ``fn`` on the host clock, device work included."""
    synchronize()
    t0 = time.perf_counter()
    out = fn()
    synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def queued_ms(fn, reps: int, iters: int = 5) -> float:
    """Median device time of one call of ``fn`` when ``reps`` calls run back
    to back on the device: they are issued while a long spin kernel holds the
    stream, so the time between the two events holds no wait for the host.
    One call first, alone, so that no first-use cost (an allocation) holds
    up the issue.  A round whose issue outlasted the spin (the host was
    held up) is run again, up to three times."""
    spin_cycles = 60_000_000
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters + 1):
        for _ in range(3):
            before = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before.record()
            torch.cuda._sleep(spin_cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            issue_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            end.synchronize()
            if issue_ms < before.elapsed_time(start):
                break
        require(issue_ms < before.elapsed_time(start),
                "the host issued slower than the spin kernel ran")
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times[1:])


# Captures of torch.profiler on the H100 have come back now and then with no
# device activity at all, for work that launched kernels (CUPTI delivers its
# records apart from the run).  Such a capture is taken again, up to this
# many times in all.
PROFILE_TRIES = 3


def profile_device(fn):
    """Run ``fn`` under torch.profiler (device activity only).  Returns
    (fn's result, wall ms, {kernel name: (launches, device ms)}) of the
    first of up to PROFILE_TRIES captures that saw device time, so ``fn``
    must be safe to run again; ``{}`` if none did.  The callers then keep
    their CUDA-event times and report the profiler's numbers as null."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out, ms = wall_ms(fn)
        kernels = {}
        for avg in prof.key_averages():
            if avg.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(avg, "self_device_time_total", None)
            if us is None:
                us = avg.self_cuda_time_total
            kernels[avg.key] = (avg.count, us / 1e3)
        if sum(v for _, v in kernels.values()) > 0:
            return out, ms, kernels
    return out, ms, {}


def max_abs_err(got, want) -> int:
    """Largest absolute difference over all paired integer outputs."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    worst = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype differ: {g.shape} {g.dtype} "
                                 f"vs {w.shape} {w.dtype}")
        if g.numel():
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64))
                                   .abs().max()))
    return worst


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run_text(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip()


# --- plain versions at given shapes -----------------------------------------

def plain_uniform(graph, targets, seed, walk_length=WALK_LENGTH):
    key = prng.derive_key(seed, prng.STREAM_CSR_UNIFORM)
    return uniform.uniform_walk_csr_plain(graph.row_ptr, graph.col_idx,
                                          targets, walk_length, key)


def sampler_args(graph, mixture: bool) -> tuple:
    """(probs, consts, search_iters) of ``walk``'s mixture (graph) or
    rejection (raw arrays) sampler at P, Q."""
    if mixture:
        return (node2vec.NO_PROBS, node2vec.mixture_consts(P, Q, graph.deg_bits),
                graph.search_iters)
    return (common.node2vec_accept_probs(P, Q), node2vec.NO_CONSTS,
            common.DEFAULT_SEARCH_ITERS)


def plain_biased(graph, targets, seed, mixture: bool, walk_length=WALK_LENGTH,
                 walker_offset=0, max_rounds=common.DEFAULT_MAX_ROUNDS):
    key = prng.derive_key(seed, prng.STREAM_CSR_BIASED)
    return node2vec.node2vec_walk_plain(
        graph.row_ptr, graph.col_idx, targets, walk_length, key, walker_offset,
        mixture, *sampler_args(graph, mixture), max_rounds)


def walk_calls(graph, targets) -> dict:
    """The three walks of the main path through the public entry point:
    uniform (K1), node2vec by the graph's mixture sampler and by the raw
    arrays' rejection sampler (K2)."""
    return {
        "uniform": lambda: tt.walk(graph, target_nodes=targets,
                                   walk_length=WALK_LENGTH, seed=WALK_SEED),
        "mixture": lambda: tt.walk(graph, target_nodes=targets, p=P, q=Q,
                                   walk_length=WALK_LENGTH, seed=WALK_SEED),
        "rejection": lambda: tt.walk(graph.row_ptr, graph.col_idx, targets,
                                     p=P, q=Q, walk_length=WALK_LENGTH,
                                     seed=WALK_SEED),
    }


def walk_digest(walks) -> str:
    """A fingerprint of a walk tensor, to compare runs and builds."""
    return hashlib.sha256(walks.cpu().numpy().tobytes()).hexdigest()[:16]


def plain_windows(walks, num_nodes, seed):
    key = prng.derive_key(seed, prng.STREAM_WINDOWS_SG)
    return windows.to_windows_plain(walks, WINDOW, num_nodes, key)


def random_tables(num_nodes, dim, dtype, device, seed):
    """Two (N, D) tables uniform in +-0.25, from a seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tuple(
        torch.empty((num_nodes, dim), dtype=torch.float32, device=device)
        .uniform_(-0.25, 0.25, generator=gen).to(dtype) for _ in range(2))


def plain_loss_and_grads(in_emb, out_emb, walks, neg_ids, window):
    """The plain version of K5 and K6: the tables read as float32 (exact for
    bfloat16), the gradients by autograd, float32."""
    tables = [t.detach().to(torch.float32, copy=True).requires_grad_(True)
              for t in (in_emb, out_emb)]
    loss = skipgram.walk_loss_plain(*tables, walks, neg_ids, window,
                                    window - 1)
    return loss.detach(), torch.autograd.grad(loss, tables)


def loss_errors(in_emb, out_emb, walks, neg_ids, window):
    """K5 and K6 against the plain version on the same inputs."""
    loss = bindings.walk_sgns_loss_fwd(in_emb, out_emb, walks, neg_ids,
                                       window, window - 1)
    grads = bindings.walk_sgns_loss_bwd(in_emb, out_emb, walks, neg_ids,
                                        window, window - 1,
                                        torch.ones_like(loss))
    (want, want_grads), plain_ms = wall_ms(lambda: plain_loss_and_grads(
        in_emb, out_emb, walks, neg_ids, window))
    require(bool(torch.isfinite(loss)) and bool(torch.isfinite(want)),
            "loss is not finite")
    loss_abs = abs(float(loss) - float(want))
    grad_abs = [float((g - w).abs().max()) for g, w in zip(grads, want_grads)]
    grad_rel = [a / float(w.abs().max()) for a, w in zip(grad_abs, want_grads)]
    return {"loss": float(loss), "plain_loss": float(want),
            "loss_abs_err": loss_abs, "loss_rel_err": loss_abs / abs(float(want)),
            "grad_abs_err": max(grad_abs), "grad_rel_err": max(grad_rel),
            "plain_ms": plain_ms}


# --- bounds ------------------------------------------------------------------

def bound(bytes_moved: float, operations: float,
          ops_per_s: float | None = None) -> tuple[float, str]:
    """(least time in ms, what bounds it) for work that must move
    ``bytes_moved`` and do ``operations`` at the card's peak ``ops_per_s``
    (by default its integer rate, ``INT_OPS_PER_S``)."""
    if ops_per_s is None:
        require(INT_OPS_PER_S is not None and THREEFRY_OPS is not None,
                "phase_device() and phase_build() set the integer rate and "
                "the Threefry count before any bound")
        ops_per_s = INT_OPS_PER_S
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = operations / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def uniform_bound(num_walkers: int, walk_length: int):
    steps = num_walkers * walk_length
    # per step two row_ptr words and one col word read, one word written;
    # targets read once, column 0 written once
    return bound(4 * (3 * steps + steps + 2 * num_walkers),
                 steps * (THREEFRY_OPS + 8))


def biased_bound(graph, walks, rounds, searches, mixture: bool):
    """Least bytes and operations for what this run's data needed, from the
    plain version's per-step ``rounds`` and ``searches``.  Bytes, each word
    counted once per step however often the kernel reads it again: the two
    row_ptr words of the row of each walk position 0..L-1 (t's row at a step
    is v's of the step before), one candidate word for the first hop and one
    per later round (the mixture's rounds that draw the point mass at t read
    none, a few per cent of them), the probed words of one binary search over
    t's row at each step where some round needs it (``searches`` > 0) and,
    for the mixture, of the lower-bound search for t in v's row at every
    step; the targets read and the walks written.  Operations per round,
    the searches per searching round.  Search depth is taken as
    ceil(log2(deg + 1)) of the rows actually visited."""
    deg = (graph.row_ptr[1:] - graph.row_ptr[:-1]).to(torch.float32)
    depth = torch.log2(deg + 1).ceil()
    depth_t = depth[walks[:, :-2].to(torch.int64)]
    num_walkers, length1 = walks.shape
    drawn = float(rounds.sum(dtype=torch.float64))
    search_t_words = float((depth_t * (searches > 0)).sum(dtype=torch.float64))
    search_t_trips = float((depth_t * searches).sum(dtype=torch.float64))
    search_v = (float(depth[walks[:, 1:-1].to(torch.int64)].sum(
        dtype=torch.float64)) if mixture else 0.0)
    words = (2 * num_walkers * (length1 - 1) + num_walkers + drawn
             + search_t_words + search_v + walks.numel() + num_walkers)
    ops = (drawn * (THREEFRY_OPS + 12)
           + SEARCH_TRIP_OPS * (search_t_trips + search_v))
    return bound(4 * words, ops), {
        "words": words, "search_t_words": search_t_words,
        "searched_step_share": float((searches > 0).float().mean()),
        "searching_round_share": float(searches.sum(dtype=torch.float64))
        / drawn}


def windows_bound(num_walks: int, length: int):
    """The walks read once, targets, positives and negatives written once;
    one Threefry call a slot.  The rest of a slot's work (its draw's mulhi,
    the slot counter, the window's index arithmetic) can issue to the FMA
    pipe or is shared by a window's slots, so it is not counted."""
    num_win = num_walks * (length - WINDOW + 1)
    slots = num_win * (WINDOW - 1)
    return bound(4 * (num_walks * length + num_win + 2 * slots),
                 slots * THREEFRY_OPS)


def exchange_bound(num_shards: int, cap: int, width: int):
    return bound(2 * num_shards * num_shards * cap * width * 4, 0)


def sgns_bound(dtype: torch.dtype, backward: bool, walks, neg_ids):
    """K5/K6 on this run's walks.  Bytes, each row counted once however many
    walks share it (on a power-law graph most do share the hub rows): the
    distinct center rows of in_emb and the distinct walk and negative rows of
    out_emb at the table width, the ids, and for K6 the float32 gradient of
    each of those rows (the rows of the dense gradient tables that stay zero
    are not counted, which only makes the bound smaller).  Operations:
    2*B*C*D*(S + 2*hw) forward; backward twice that plus the recompute,
    against the tensor-core peak of the table type."""
    b, length1 = walks.shape
    d, s = TRAIN_CONFIG["dim"], neg_ids.numel()
    hw = TRAIN_CONFIG["window_size"] // 2
    c = length1 - 2 * hw
    wrapped = torch.where(walks < 0, NUM_NODES - 1, walks)  # -1 is row N-1
    in_rows = torch.unique(wrapped[:, hw: length1 - hw]).numel()
    out_rows = torch.unique(torch.cat([wrapped.reshape(-1), neg_ids])).numel()
    elem = torch.empty((), dtype=dtype).element_size()
    moved = (in_rows + out_rows) * d * elem + 4 * (b * length1 + s) + 4
    flops = 2 * b * c * d * (s + 2 * hw)
    if backward:
        moved += (in_rows + out_rows) * d * 4 + 4
        flops *= 3
    return bound(moved, flops, TENSOR_FLOPS_PER_S[dtype]), in_rows, out_rows


# --- phases ------------------------------------------------------------------

def phase_device() -> str:
    global INT_OPS_PER_S
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    max_sm_mhz = float(run_text(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT_OPS_PER_S = sms * INT32_RESULTS_PER_SM_CLOCK * max_sm_mhz * 1e6
    nvcc = run_text([build.find_nvcc(), "--version"]).splitlines()[-1]
    emit("device", name=torch.cuda.get_device_name(0), smi=smi, nvcc=nvcc,
         torch=torch.__version__, cuda=torch.version.cuda, sms=sms,
         max_sm_clock_mhz=max_sm_mhz, int_ops_per_s=INT_OPS_PER_S)
    return smi


# The loss kernels' entry functions in the built library, as ptxas and
# cuobjdump name them, and which must run on the tensor cores.
SGNS_FUNCTIONS = {
    "trw_sgns_loss_fwd_bf16": "K5 bfloat16",
    "trw_sgns_loss_bwd_rows_bf16": "K6 bfloat16, rows pass",
    "trw_sgns_loss_bwd_neg_bf16": "K6 bfloat16, negatives pass",
    "walk_sgns_loss_fwd_kernelIf": "K5 float32",
    "walk_sgns_loss_bwd_kernelIfLi4E": "K6 float32 (D <= 128)",
    "walk_sgns_loss_bwd_kernelIfLi16E": "K6 float32 (D <= 512)",
    # K16/K17 at the trainer's shapes (D <= 128): the per-window pass by
    # table type, form and gradient flag (K17's also places each out slot),
    # the owner passes by source, the out slots' histogram.
    "windows_pass_kernelI13__nv_bfloat16Li8ELi1ELb0ELb0E":
        "K16 bfloat16 skip-gram",
    "windows_pass_kernelI13__nv_bfloat16Li8ELi1ELb0ELb1E":
        "K17 per-window pass, bfloat16 skip-gram",
    "windows_pass_kernelIfLi4ELi1ELb1ELb0E": "K16 float32 CBOW",
    "windows_pass_kernelIfLi4ELi1ELb1ELb1E":
        "K17 per-window pass, float32 CBOW",
    "windows_owner_kernelI13__nv_bfloat16Li8ELi1EE":
        "K17 out-row owner, bfloat16 skip-gram",
    "windows_owner_heavy_kernelI13__nv_bfloat16Li8ELi1EE":
        "K17 heavy out-row owner, bfloat16 skip-gram",
    "windows_owner_kernelIfLi4ELi1EE":
        "K17 out-row owner of float32 rows (CBOW's h, skip-gram's tables)",
    "windows_owner_heavy_kernelIfLi4ELi1EE":
        "K17 heavy out-row owner of float32 rows",
    "windows_hist_kernel": "K17 out-slot histogram",
}
# K17's owner passes, which must hold no atomic instruction.
OWNER_FUNCTIONS = tuple(k for k in SGNS_FUNCTIONS if "owner" in k)
TENSOR_CORE_FUNCTIONS = ("trw_sgns_loss_fwd_bf16",
                         "trw_sgns_loss_bwd_rows_bf16",
                         "trw_sgns_loss_bwd_neg_bf16")


# The walk kernels' entry functions (K2's two instantiations by template
# flag, and K1 beside them for its registers).
WALK_FUNCTIONS = {
    "node2vec_walk_csr_kernelILb1E": "K2 mixture",
    "node2vec_walk_csr_kernelILb0E": "K2 rejection",
    "uniform_walk_csr_kernel": "K1",
}


# K3's two instantiations (W = 5, any other W) and K4's for D <= 8 (the
# routed leg's), by word width.
EXCHANGE_WINDOW_FUNCTIONS = {
    "to_windows_kernelILi4E": "K3 W=5",
    "to_windows_kernelILi0E": "K3 any W",
    "all_to_all_chunks_kernelILi8E5uint4": "K4 D<=8, 16-byte words",
    "all_to_all_chunks_kernelILi8EjE": "K4 D<=8, 4-byte words",
}


# K7-K10's entry functions (K7 by table layout; K8 and K9 by template flag;
# K10 a kernel for each generator).
FAMILY_FUNCTIONS = {
    "uniform_walk_edge_rows_kernel": "K7 packed rows (graph)",
    "uniform_walk_edge_list_kernelILi1E": "K7 tails column (unfit graph)",
    "uniform_walk_edge_list_kernelILi2E": "K7 raw rows",
    "biased_walk_edge_list_kernelILb1E": "K8 fat",
    "biased_walk_edge_list_kernelILb0E": "K8 oracle",
    "uniform_walk_triples_kernelILb1E": "K9 fat, triple_tab",
    "uniform_walk_triples_kernelILb0E": "K9 oracle, raw triples",
    "to_windows_triples_sg_kernel": "K10 skip-gram",
    "to_windows_triples_cbow_kernel": "K10 CBOW",
}


# K11-K15: K11's and K12's body kernels (K12's by membership flag), the
# tiled compaction by record width and streams (one stream: phase 0), phase
# 0's histogram, and the batch kernels: K13's, and K14's and K15's by
# restart flag.
ROUTED_FUNCTIONS = {
    "routed_uniform_body_kernel": "K11 body",
    "routed_compact_kernelILi3ELi2EE": "K11 compaction",
    "routed_compact_kernelILi3ELi1EE": "K11 phase 0 compaction",
    "routed_node2vec_body_kernelILb0E": "K12 body, cuckoo probes",
    "routed_node2vec_body_kernelILb1E": "K12 body, binary search",
    "routed_compact_kernelILi14ELi4EE": "K12 compaction",
    "routed_compact_kernelILi14ELi1EE": "K12 phase 0 compaction",
    "routed_stage_hist_kernel": "phase 0 histogram",
    "routed_compact_kernelILi4ELi1EE": "K13/K14 phase 0 compaction",
    "routed_compact_kernelILi15ELi1EE": "K15 phase 0 compaction",
    "routed_triples_batch_kernel": "K13 batch",
    "routed_edge_list_batch_kernelILb1E": "K14 batch, restart",
    "routed_edge_list_batch_kernelILb0E": "K14 batch, absorbing",
    "routed_edge_list_node2vec_batch_kernelILb1E": "K15 batch, restart",
    "routed_edge_list_node2vec_batch_kernelILb0E": "K15 batch, absorbing",
}
BATCH_FUNCTIONS = tuple(k for k in ROUTED_FUNCTIONS if "batch_kernel" in k)


# K16/K17 (by table type, load width and form) and K18 (dense by table
# type, rows by type and width): every instantiation, by its mangled name.
TRAIN_MODE_FUNCTIONS = {
    "windows_pass_kernel": "K16 (and K17's per-window pass)",
    "windows_owner_kernel": "K17 owner", "windows_owner_heavy_kernel":
    "K17 heavy-row owner", "windows_hist_kernel": "K17 histogram",
    "adam_dense_kernel": "K18 dense", "adam_rows_kernel": "K18 rows"}
# K19's and K20's instantiations on the KGE phase's path (float32 rows of
# 128: V = 4, K = 1), with and without the gradient (the last template
# flag); the build line gives their registers, spills and atomic
# instructions by mangled name.
KGE_FUNCTIONS = {
    "kge_pair_kernelIfLi4ELi1ELi0E": "K19 TransE",
    "kge_pair_kernelIfLi4ELi1ELi1E": "K19 DistMult",
    "kge_pair_kernelIfLi4ELi1ELi2E": "K19 RotatE",
    "kge_windows_kernelIfLi4ELi1ELb0E": "K20 skip-gram",
    "kge_windows_kernelIfLi4ELi1ELb1E": "K20 CBOW"}


def ptxas_instantiations(log: str, families: dict) -> dict:
    """``ptxas_report`` for every entry function whose name holds a key of
    ``families``, keyed by its full (mangled) name."""
    names = [b.split("'", 1)[0]
             for b in log.split("Compiling entry function '")[1:]]
    names = [n for n in names if function_key(n, families)]
    return ptxas_report(log, dict.fromkeys(names, ""))


def function_key(name: str, functions: dict) -> str | None:
    for key in functions:
        if key in name:
            return key
    return None


def ptxas_report(log: str, functions: dict) -> dict:
    """Registers, spill bytes and static shared memory of each function of
    ``functions`` from the ``-Xptxas -v`` report of the build."""
    found = {}
    for block in log.split("Compiling entry function '")[1:]:
        key = function_key(block.split("'", 1)[0], functions)
        if key is None:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        stack = re.search(r"(\d+) bytes stack frame", block)
        smem = re.search(r"(\d+) bytes smem", block)
        found[key] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spill.group(1)) if spill else None,
            "spill_load_bytes": int(spill.group(2)) if spill else None,
            "stack_frame_bytes": int(stack.group(1)) if stack else None,
            "static_smem_bytes": int(smem.group(1)) if smem else 0}
    return found


def library_sass(lib) -> str:
    """``cuobjdump -sass`` of the built library."""
    cuobjdump = str(Path(build.find_nvcc()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=120).stdout


def sass_functions(sass: str) -> dict:
    """Each function's SASS, by the (mangled) name cuobjdump gives it."""
    found = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = block.split("\n", 1)
        found[name.strip()] = body
    return found


def sass_report(functions: dict) -> dict:
    """Per loss kernel, its tensor-core instructions (HMMA/HGMMA) and its
    atomic reductions in the SASS of the built library."""
    found = {}
    for name, block in functions.items():
        key = function_key(name, SGNS_FUNCTIONS)
        if key is None:
            continue
        ops = Counter(
            op + mod for op, mod in re.findall(
                r"\b(HGMMA|HMMA|REDG?|ATOMG?)(?![A-Z])(\.[A-Za-z0-9_.]+)?",
                block))
        found[key] = {
            "tensor_core_instructions": sum(
                n for op, n in ops.items() if op.startswith(("HMMA", "HGMMA"))),
            "atomics": dict(sorted(
                (op, n) for op, n in ops.items()
                if not op.startswith(("HMMA", "HGMMA"))))}
    return found


# Integer opcodes that issue to the INT32 pipe: adds, logic, shifts and
# funnel shifts (one rotate), address arithmetic, compares and selects.
# IMAD (multiply-add, and the IMAD.IADD / IMAD.SHL forms nvcc picks for some
# adds and shifts) issues to the FMA pipe beside it; moves, conversions,
# loads, stores, control flow and the uniform datapath (U*, once a warp) are
# not counted.
INT32_PIPE_OPCODES = ("IADD3", "VIADD", "LOP3", "SHF", "LEA", "ISETP", "SEL",
                      "PRMT", "IABS", "IMNMX", "VIMNMX", "FLO", "POPC",
                      "BMSK", "SGXT")


# Of those, the ones with no FMA-pipe form: funnel shifts (rotates) and
# three-input logic.  An add can issue as IADD3 (INT32 pipe) or IMAD.IADD
# (FMA pipe), as nvcc chooses.
INT32_ONLY_OPCODES = ("SHF", "LOP3")


def pipe_counts(sass: str) -> dict:
    """Of one function's SASS, each instruction counted once where it stands
    (a loop body once): its INT32-pipe instructions, those of them that have
    no FMA-pipe form, its IMAD instructions other than IMAD.MOV, and the
    opcode histogram."""
    ops = Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", sass))

    def count(opcodes):
        return sum(n for op, n in ops.items() if op.split(".")[0] in opcodes)
    return {"int32_pipe_ops": count(INT32_PIPE_OPCODES),
            "int32_only_ops": count(INT32_ONLY_OPCODES),
            "fma_pipe_ops": sum(n for op, n in ops.items()
                                if op.startswith("IMAD")
                                and not op.startswith("IMAD.MOV")),
            "opcodes": dict(sorted(ops.items()))}


def threefry_sass_ops() -> dict:
    """Integer instructions of one Threefry-2x32 call in the SASS that nvcc
    gives for this card, as the walk kernels call it: the key as kernel
    parameters, the counter words from memory.  A funnel shift (one rotate)
    counts as one instruction, as does a three-input add or logic op.
    Returns ``pipe_counts`` of the probe.  Its rotates and xors
    (``int32_only_ops``) run on the INT32 pipe alone; its adds issue as
    IADD3 on that pipe or as IMAD.IADD on the FMA pipe beside it, and there
    are fewer of them than rotates and xors, so the FMA pipe can take them
    all: the rotates and xors bound the time at the INT32 rate.  (Counting
    more gives a bound that kernels beat on the H100: all 68 instructions a
    Threefry-only kernel, the 51 of nvcc's INT32 split K3: PERF.md.)"""
    probe_dir = build.build_dir()
    probe_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = probe_dir / "threefry_probe.cu", probe_dir / "threefry_probe.cubin"
    src.write_text(
        '#include "threefry.cuh"\n'
        'extern "C" __global__ void threefry_probe(uint32_t k0, uint32_t k1,\n'
        '    const uint32_t* c, uint32_t* out) {\n'
        '  trw::U32x2 r = trw::threefry2x32(k0, k1, c[0], c[1]);\n'
        '  out[0] = r.x0;\n  out[1] = r.x1;\n}\n')
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.SOURCE_DIR), "-cubin", "-o", str(cubin),
                    str(src)], check=True, capture_output=True, timeout=120)
    cuobjdump = str(Path(build.find_nvcc()).parent / "cuobjdump")
    return pipe_counts(run_text([cuobjdump, "-sass", str(cubin)]))


def kge_sass_report(functions: dict) -> dict:
    """K19's and K20's instantiations of KGE_FUNCTIONS: their global atomic
    instructions (RED, ATOM: the row adds, in the item loop and the
    relation flush) and shared-memory ones (ATOMS: the relation sums), each
    counted once where it stands in the SASS, by mangled name."""
    found = {}
    for name, block in functions.items():
        if function_key(name, KGE_FUNCTIONS) is None:
            continue
        ops = Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
            r"((?:REDG?|ATOMS|ATOMG?)(?:\.[A-Za-z0-9_]+)*)", block))
        found[name] = {
            "global_atomics": sum(n for op, n in ops.items()
                                  if not op.startswith("ATOMS")),
            "shared_atomics": sum(n for op, n in ops.items()
                                  if op.startswith("ATOMS")),
            "atomics": dict(sorted(ops.items()))}
    return found


def windows_sass_report(functions: dict) -> dict:
    """K3's entry functions: ``pipe_counts`` of each.  The W = 5 function
    does one window of 4 slots a thread, with no loop, so its counts over 4
    are a slot's (``per_slot``)."""
    found = {}
    for name, block in functions.items():
        if "to_windows_kernel" not in name:
            continue
        found[name] = counts = pipe_counts(block)
        if "to_windows_kernelILi4E" in name:
            counts["per_slot"] = {k: counts[k] / 4 for k in (
                "int32_pipe_ops", "int32_only_ops", "fma_pipe_ops")}
    return found


def phase_build() -> None:
    global THREEFRY_OPS
    t0 = time.perf_counter()
    lib = build.build_library(verbose=True)
    bindings.library()
    seconds = time.perf_counter() - t0
    log = build.build_log()
    functions = sass_functions(library_sass(lib))
    ptxas, sass = ptxas_report(log, SGNS_FUNCTIONS), sass_report(functions)
    kernels = {SGNS_FUNCTIONS[k]: {**ptxas.get(k, {}), **sass.get(k, {})}
               for k in SGNS_FUNCTIONS}
    walk_ptxas = ptxas_report(log, WALK_FUNCTIONS)
    k3_k4_ptxas = ptxas_report(log, EXCHANGE_WINDOW_FUNCTIONS)
    family_ptxas = ptxas_report(log, FAMILY_FUNCTIONS)
    routed_ptxas = ptxas_report(log, ROUTED_FUNCTIONS)
    train_mode_ptxas = ptxas_instantiations(log, TRAIN_MODE_FUNCTIONS)
    kge_ptxas = ptxas_instantiations(log, KGE_FUNCTIONS)
    kge_sass = kge_sass_report(functions)
    threefry = threefry_sass_ops()
    THREEFRY_OPS = threefry["int32_only_ops"]
    emit("build", seconds=round(seconds, 2), sources=list(build.SOURCES),
         walk_sgns_loss_kernels=kernels,
         walk_kernels={WALK_FUNCTIONS[k]: v for k, v in walk_ptxas.items()},
         exchange_windows_kernels={EXCHANGE_WINDOW_FUNCTIONS[k]: v
                                   for k, v in k3_k4_ptxas.items()},
         family_kernels={FAMILY_FUNCTIONS[k]: v
                         for k, v in family_ptxas.items()},
         routed_kernels={ROUTED_FUNCTIONS[k]: v
                         for k, v in routed_ptxas.items()},
         train_mode_kernels=train_mode_ptxas,
         kge_kernels={name: {**v, **kge_sass.get(name, {})}
                      for name, v in kge_ptxas.items()},
         threefry_int32_only_ops=THREEFRY_OPS,
         threefry_int32_pipe_ops=threefry["int32_pipe_ops"],
         threefry_fma_pipe_ops=threefry["fma_pipe_ops"],
         threefry_probe_sass=threefry["opcodes"],
         windows_sass=windows_sass_report(functions))
    require(30 <= THREEFRY_OPS <= 200,
            f"Threefry counted as {THREEFRY_OPS} instructions: {threefry}")
    for key in TENSOR_CORE_FUNCTIONS:
        require(sass.get(key, {}).get("tensor_core_instructions", 0) > 0,
                f"{SGNS_FUNCTIONS[key]}: no HMMA/HGMMA instruction in its SASS")
    require(all(ptxas.get(k, {}).get("registers") for k in SGNS_FUNCTIONS),
            f"ptxas reported no registers for a loss kernel: {ptxas}")
    for key in OWNER_FUNCTIONS:
        require(key in sass and not sass[key]["atomics"],
                f"{SGNS_FUNCTIONS[key]}: atomics in its SASS: "
                f"{sass.get(key)}")
    require(all(walk_ptxas.get(k, {}).get("registers")
                for k in WALK_FUNCTIONS),
            f"ptxas reported no registers for a walk kernel: {walk_ptxas}")
    require(all(family_ptxas.get(k, {}).get("registers")
                for k in FAMILY_FUNCTIONS),
            f"ptxas reported no registers for K7-K10: {family_ptxas}")
    require(all(routed_ptxas.get(k, {}).get("registers")
                for k in ROUTED_FUNCTIONS),
            f"ptxas reported no registers for K11-K15: {routed_ptxas}")
    require(all(routed_ptxas[k]["spill_store_bytes"] == 0
                for k in BATCH_FUNCTIONS),
            f"a batch kernel (K13-K15) spills: {routed_ptxas}")
    require(all(any(key in name and v.get("registers")
                    for name, v in train_mode_ptxas.items())
                for key in TRAIN_MODE_FUNCTIONS),
            f"ptxas reported no registers for K16-K18: {train_mode_ptxas}")
    # K2's launch geometry, and how many blocks of 64, 128 and 256 threads
    # one SM holds at its register count.
    emit("walk_geometry", kernel="node2vec_walk_csr", geometry={
        sampler: {"launch": bindings.node2vec_walk_geometry(mixture),
                  "blocks_per_sm_by_threads": {
                      n: bindings.node2vec_walk_geometry(mixture, n)[
                          "blocks_per_sm"] for n in (64, 128, 256)}}
        for sampler, mixture in (("mixture", True), ("rejection", False))})


def phase_small_checks() -> None:
    """Each kernel against its plain version at a small size, exact
    equality, so that a wrong kernel fails before the long phases."""
    graph = tt.synthetic_power_law(20_000, 8, seed=3)
    targets = common.as_int32(
        np.random.default_rng(4).integers(0, graph.num_nodes, 8192),
        graph.device)
    errs = {
        "uniform_walk_csr": max_abs_err(
            tt.walk(graph, target_nodes=targets, walk_length=20,
                    seed=WALK_SEED),
            plain_uniform(graph, targets, WALK_SEED, 20)),
        "node2vec_walk_csr_mixture": max_abs_err(
            tt.walk(graph, target_nodes=targets, p=P, q=Q, walk_length=20,
                    seed=WALK_SEED),
            plain_biased(graph, targets, WALK_SEED, True, 20).walks),
        "node2vec_walk_csr_rejection": max_abs_err(
            tt.walk(graph.row_ptr, graph.col_idx, targets, p=P, q=Q,
                    walk_length=20, seed=WALK_SEED),
            plain_biased(graph, targets, WALK_SEED, False, 20).walks),
    }
    # K2 at its loop's edges, walks and exhausted flags: a budget of 1 and 2
    # rounds (steps that spend it keep v), a walk of 2 steps, an offset.
    for mixture, name in ((True, "node2vec_walk_csr_mixture"),
                          (False, "node2vec_walk_csr_rejection")):
        for walk_length, max_rounds in ((20, 1), (20, 2), (2, 4096)):
            got = node2vec.biased_walk(
                graph.row_ptr, graph.col_idx, targets, walk_length, WALK_SEED,
                5, mixture, *sampler_args(graph, mixture), max_rounds)
            want = plain_biased(graph, targets, WALK_SEED, mixture,
                                walk_length, 5, max_rounds)
            errs[name] = max(errs[name], max_abs_err(
                [got.walks, got.exhausted.to(torch.int32)],
                [want.walks, want.exhausted.to(torch.int32)]))
    # A graph the JAX package leaves without fat tables: walk(graph, p, q)
    # runs the rejection kernel with the graph's own search depth, not the
    # mixture.
    thin = tt.CSRGraph.from_arrays(graph.row_ptr, graph.col_idx,
                                   sort_rows=False, build_fat=False)
    require(graph.fat and not thin.fat, "build_fat=False left fat tables")
    errs["node2vec_walk_csr_rejection"] = max(
        errs["node2vec_walk_csr_rejection"], max_abs_err(
            tt.walk(thin, target_nodes=targets, p=P, q=Q, walk_length=20,
                    seed=WALK_SEED),
            node2vec.biased_walk(
                thin.row_ptr, thin.col_idx, targets, 20, WALK_SEED, 0, False,
                common.node2vec_accept_probs(P, Q), node2vec.NO_CONSTS,
                thin.search_iters, common.DEFAULT_MAX_ROUNDS).walks))
    walks = tt.walk(graph, target_nodes=targets, walk_length=20, seed=5)
    errs["to_windows"] = max_abs_err(
        tt.to_windows(walks, WINDOW, graph.num_nodes, seed=WINDOW_SEED),
        plain_windows(walks, graph.num_nodes, WINDOW_SEED))
    # K3's other instantiation (any W), and windows as long as the walk.
    key = prng.derive_key(WINDOW_SEED, prng.STREAM_WINDOWS_SG)
    for w, length in ((2, 21), (3, 21), (8, 21), (5, 5), (8, 8)):
        part = walks[:, :length].contiguous()
        errs["to_windows"] = max(errs["to_windows"], max_abs_err(
            tt.to_windows(part, w, graph.num_nodes, seed=WINDOW_SEED),
            windows.to_windows_plain(part, w, graph.num_nodes, key)))
    worst = 0
    rng = np.random.default_rng(6)
    # 16- and 4-byte words, 1 to 16 shards, and buffers one word off a
    # 16-byte boundary (4-byte words).
    for shards, cap, width, offset in [
            (8, 128, 3, 0), (8, 5, 3, 0), (8, 256, 14, 0), (1, 2048, 3, 0),
            (2, 1, 14, 0), (16, 128, 3, 0), (8, 2048, 3, 1), (8, 128, 4, 0),
            (8, 256, 15, 0), (8, 5, 15, 1)]:
        x = rng.integers(-2**31, 2**31, (shards, shards, cap, width))
        outboxes = []
        for s in range(shards):
            buf = torch.empty(x[s].size + offset, dtype=torch.int32,
                              device=graph.device)[offset:]
            outboxes.append(buf.view(x[s].shape).copy_(torch.from_numpy(x[s])))
        worst = max(worst, max_abs_err(
            exchange.all_to_all_chunks(outboxes),
            exchange.all_to_all_chunks_plain(outboxes)))
    errs["all_to_all_chunks"] = worst
    errs.update(routed_small_checks(graph.device))
    errs.update(routed_family_small_checks(graph.device))
    # K5/K6: ragged width, a window of one center, -1 ids, both table types,
    # and a shape that takes the negatives in chunks (D > 256).
    float_errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, b, length, num_s, window in (
                (64, 8, 32, 8, 8, 5), (64, 18, 32, 2, 5, 3),
                (500, 300, 64, 40, 300, 5)):
            in_emb, out_emb = random_tables(n, d, dtype, graph.device, seed=d)
            walks = torch.tensor(rng.integers(0, n, (b, length + 1)),
                                 dtype=torch.int32, device=graph.device)
            walks[::7, -1] = -1
            neg_ids = torch.tensor(rng.integers(0, n, num_s),
                                   dtype=torch.int32, device=graph.device)
            err = loss_errors(in_emb, out_emb, walks, neg_ids, window)
            for key in ("loss_rel_err", "grad_rel_err"):
                float_errs[key] = max(float_errs.get(key, 0.0), err[key])
    train_mode_errs = train_mode_small_checks(graph.device)
    torch.cuda.synchronize()
    emit("kernels_small", max_abs_err=errs, tolerance=0,
         walk_sgns_loss=float_errs,
         walk_sgns_loss_limits=[LOSS_REL_LIMIT, GRAD_REL_LIMIT],
         train_mode_kernels=train_mode_errs,
         train_mode_limits=[LOSS_REL_LIMIT, GRAD_REL_LIMIT, ADAM_ULP_LIMIT])
    require(set(errs) == set(INTEGER_KERNELS) | set(ROUTED_FAMILY_KERNELS),
            "a kernel was not held against its plain version")
    require(all(e == 0 for e in errs.values()), f"kernel != plain: {errs}")
    require(float_errs["loss_rel_err"] <= LOSS_REL_LIMIT
            and float_errs["grad_rel_err"] <= GRAD_REL_LIMIT,
            f"loss kernels != plain: {float_errs}")
    require(train_mode_errs["windows_loss_rel_err"] <= LOSS_REL_LIMIT
            and train_mode_errs["windows_grad_rel_err"] <= GRAD_REL_LIMIT
            and train_mode_errs["adam_dense_max_ulps"] <= ADAM_ULP_LIMIT
            and train_mode_errs["adam_rows_max_ulps"] <= ADAM_ULP_LIMIT,
            f"K16-K18 != plain: {train_mode_errs}")


def phase_graph():
    graph, ms = wall_ms(lambda: tt.synthetic_power_law(
        NUM_NODES, AVG_DEGREE, GRAPH_SEED))
    emit("graph", num_nodes=graph.num_nodes, num_edges=graph.num_edges,
         max_degree=graph.max_degree, search_iters=graph.search_iters,
         deg_bits=graph.deg_bits, build_seconds=round(ms / 1e3, 2))
    require(graph.num_nodes == NUM_NODES
            and graph.num_edges == NUM_NODES * (AVG_DEGREE + 2),
            "graph has the wrong size")
    return graph


def bench_targets(dev):
    return (torch.arange(NUM_WALKERS, device=dev) % NUM_NODES).to(torch.int32)


def phase_walk_times(graph) -> tuple[dict, dict]:
    """K1 and K2 alone through the public entry points, each timed at the
    bench shape and with a half and a quarter of the walkers, two ways: the
    entry point's time (CUDA events around one call on an idle stream, which
    holds the host's tens of microseconds of Python before the launch) and
    the device time of calls queued behind a spin kernel (``queued_ms``).
    The device times at the bench shape are the ``ms`` of the kernels' rows.
    All walkers of the bench shape are resident at once, so a time that
    halves with them is bound by the work the card does, one that stays by
    each walker's own chain.  Importing this script and calling
    ``phase_build()`` and then this on ``phase_graph()`` is the quick check
    of a change to a walk kernel."""
    targets = bench_targets(graph.device)
    entry, device = {}, {}
    for part in (1, 2, 4):
        calls = walk_calls(graph, targets[: NUM_WALKERS // part])
        entry[NUM_WALKERS // part] = {
            name: time_ms(fn, iters=9) for name, fn in calls.items()}
        device[NUM_WALKERS // part] = {
            name: queued_ms(fn, WALK_REPS) for name, fn in calls.items()}
    emit("walk_times", ms_by_walkers=entry, device_ms_by_walkers=device,
         timing="entry point: CUDA events, 1 warm-up, median of 9",
         device_timing=f"{WALK_REPS} calls queued behind a spin kernel, "
                       "median of 5, per call")
    return device[NUM_WALKERS], entry[NUM_WALKERS]


def bench_walks(graph):
    """The uniform walks of the bench shape (K1), K3's input on the main
    path."""
    return tt.walk(graph, target_nodes=bench_targets(graph.device),
                   walk_length=WALK_LENGTH, seed=WALK_SEED)


def phase_exchange_windows_times(walks) -> dict:
    """K3 and K4 at the main path's shapes.  K3, ``to_windows`` of the bench
    walks: device time of WALK_REPS calls queued behind a spin kernel
    (``queued_ms``; the row's ``ms``) and the entry point's time (CUDA events
    around one call).  K4, D=8 chunks of the routed leg's capacity and R=3:
    device time of 100 launches queued the same way (the row's ``ms``) and
    the time a launch takes with the host in the way (back-to-back launches
    on an idle stream), beside the plain version, the library call and an
    empty kernel launched through the same path, on K4's grid and on one
    block: the floor of a launch (left out in a tree from before the empty
    kernel).  Importing this script and calling ``phase_device()``,
    ``phase_build()`` and then this on ``bench_walks(phase_graph())`` is the
    quick check of a change to either kernel."""
    def windows_call():
        return tt.to_windows(walks, WINDOW, NUM_NODES, seed=WINDOW_SEED)

    k3 = {"device_ms": queued_ms(windows_call, WALK_REPS),
          "entry_ms": time_ms(windows_call)}
    emit("windows_times", shape=list(walks.shape), window=WINDOW, **k3,
         device_timing=f"{WALK_REPS} calls queued behind a spin kernel, "
                       "median of 5, per call",
         entry_timing="CUDA events around one call, 1 warm-up, median of 5")

    cap = tt.RoutedConfig.for_walk(ROUTED_WALKERS, NUM_SHARDS,
                                   WALK_LENGTH).pair_capacity
    shape = (NUM_SHARDS, cap, 3)
    outboxes = [torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                              device=walks.device) for _ in range(NUM_SHARDS)]
    inboxes = [torch.empty_like(o) for o in outboxes]
    exchange_chunks = exchange.ChunkExchange(outboxes, inboxes)
    stacked = torch.stack(outboxes)
    reps = 100

    def repeat(fn):
        def run():
            for _ in range(reps):
                fn()
        return run

    calls = {
        "kernel": exchange_chunks,
        "plain": lambda: exchange.all_to_all_chunks_plain(outboxes),
        "library": lambda: stacked.transpose(0, 1).contiguous(),
    }
    geometry = None
    if hasattr(bindings, "empty_kernel"):
        plan = exchange_chunks._table.plan
        index = torch.cuda.current_device()
        geometry = {"grid": [plan.pieces, NUM_SHARDS, NUM_SHARDS],
                    "threads": plan.threads, "loads_per_thread": plan.loads,
                    "word_bytes": 16 if plan.vec else 4}
        calls["empty_kernel_k4_grid"] = lambda: bindings.empty_kernel(
            index, (plan.pieces, NUM_SHARDS, NUM_SHARDS), plan.threads)
        calls["empty_kernel_one_block"] = lambda: bindings.empty_kernel(
            index, (1, 1, 1), 32)
    device_ms = {k: queued_ms(fn, reps) for k, fn in calls.items()}
    issued_ms = {k: time_ms(repeat(fn)) / reps for k, fn in calls.items()}
    err = max_abs_err(inboxes, exchange.all_to_all_chunks_plain(outboxes))
    emit("exchange_kernel", shape=shape, launches_per_timing=reps,
         geometry=geometry, max_abs_err=err,
         device_ms_per_launch=device_ms,
         device_ms_method="CUDA events around launches issued while a spin "
                          "kernel holds the stream, median of 5",
         host_bound_ms_per_launch=issued_ms,
         host_bound_ms_method="CUDA events around back-to-back launches on "
                              "an idle stream, median of 5",
         floor_is="empty_kernel_*: a kernel that does nothing, launched "
                  "through the same ctypes path as K4")
    require(err == 0, "the exchange kernel differs from its plain version")
    return {"to_windows": k3, "all_to_all_chunks": {
        "shape": shape, "device_ms": device_ms, "host_bound_ms": issued_ms,
        "max_abs_err": err}}


def routed_tables(graph, pgraph):
    """The routed node2vec engine's cuckoo tables and Bloom filters, built on
    the card, with their build times and sizes."""
    hashes, hash_ms = wall_ms(lambda: tt.build_partition_hashes(pgraph, graph))
    blooms, bloom_ms = wall_ms(lambda: tt.build_partition_blooms(pgraph, graph))
    emit("routed_tables", hash_build_ms=hash_ms, bloom_build_ms=bloom_ms,
         hash_log_size=hashes[2], hash_salts=hashes[1].tolist(),
         hash_bytes=hashes[0].numel() * 4, bloom_bytes=blooms.numel() * 4,
         hash_bytes_per_shard=hashes[0][0].numel() * 4)
    return hashes, blooms


def routed_n2v_call(pgraph, targets, hashes, blooms, schedule="serial",
                    walk_length=WALK_LENGTH):
    return tt.walk_partitioned_node2vec_routed(
        pgraph, hashes, targets, P, Q, walk_length, seed=WALK_SEED,
        spec_rounds=SPEC_ROUNDS, blooms=blooms, schedule=schedule)


def phase_main_path(graph):
    """The main path once through the public entry points, with the launch
    counts set to 0 just before and read just after: the single-device
    walks and windows, then the routed legs (uniform and node2vec, D=8,
    serial schedule)."""
    dev = graph.device
    targets = bench_targets(dev)
    pgraph = tt.PartitionedCSR.from_csr(graph, NUM_SHARDS)
    hashes, blooms = routed_tables(graph, pgraph)
    routed_targets = targets[:ROUTED_WALKERS]
    torch.cuda.synchronize()

    calls = walk_calls(graph, targets)
    bindings.reset_launch_counts()
    out = {}
    out["uniform"], t_u = wall_ms(calls["uniform"])
    out["mixture"], t_m = wall_ms(calls["mixture"])
    out["rejection"], t_r = wall_ms(calls["rejection"])
    out["windows"], t_w = wall_ms(lambda: tt.to_windows(
        out["uniform"], WINDOW, NUM_NODES, seed=WINDOW_SEED))
    (out["routed"], info), t_x = wall_ms(lambda: tt.walk_partitioned_routed(
        pgraph, routed_targets, WALK_LENGTH, seed=WALK_SEED))
    (out["routed_n2v"], n2v_info), t_n = wall_ms(lambda: routed_n2v_call(
        pgraph, routed_targets, hashes, blooms))
    launches = dict(bindings.launch_counts)

    emit("main_path", launches=launches, first_call_ms={
        "walk_uniform": t_u, "walk_mixture": t_m, "walk_rejection": t_r,
        "to_windows": t_w, "walk_partitioned_routed": t_x,
        "walk_partitioned_node2vec_routed": t_n})
    for name in INTEGER_KERNELS:
        require(launches[name] > 0, f"the main path never launched {name}")
    require(launches["all_to_all_chunks"] == routed_calls(info["phases"])
            + routed_calls(n2v_info["phases"]),
            "one exchange launch per enqueued phase expected")
    # One call an enqueued phase and one for phase 0 (one pipeline: serial).
    require(launches["routed_uniform_phase"]
            == routed_calls(info["phases"]) + 1
            and launches["routed_node2vec_phase"]
            == routed_calls(n2v_info["phases"]) + 1,
            "one phase kernel call per enqueued phase and one for phase 0 "
            "expected")

    # Results: shapes, no -1, every hop an edge, routed == single-device.
    num_win = NUM_WALKERS * (WALK_LENGTH + 1 - WINDOW + 1)
    for name in ("uniform", "mixture", "rejection"):
        w = out[name]
        require(tuple(w.shape) == (NUM_WALKERS, WALK_LENGTH + 1)
                and w.dtype == torch.int32, f"{name}: wrong shape or dtype")
        require(bool((w[:, 0] == targets).all()), f"{name}: column 0")
        require(bool(((w >= 0) & (w < NUM_NODES)).all()),
                f"{name}: id out of range or -1")
        sample = w[:: NUM_WALKERS // 2048].to(torch.int64)
        hop_from, hop_to = sample[:, :-1].reshape(-1), sample[:, 1:].reshape(-1)
        require(bool(common.is_neighbor_csr(
            hop_to, hop_from, graph.row_ptr, graph.col_idx,
            graph.search_iters).all()), f"{name}: a hop is not an edge")
    tgt, pos, neg = out["windows"]
    require(tuple(tgt.shape) == (num_win,)
            and tuple(pos.shape) == tuple(neg.shape) == (num_win, WINDOW - 1),
            "windows: wrong shapes")
    require(bool(((neg >= 0) & (neg < NUM_NODES)).all()),
            "windows: negative out of range")
    for name, i in (("routed", info), ("routed node2vec", n2v_info)):
        require(i["overflow_dropped"] == 0, f"{name}: records dropped")
        require(i["log_entries"] == ROUTED_WALKERS * (WALK_LENGTH + 1),
                f"{name}: positions missing")
    require(max_abs_err(out["routed"], out["uniform"][:ROUTED_WALKERS]) == 0,
            "routed walks differ from the single-device kernel's")
    require(max_abs_err(out["routed_n2v"],
                        out["rejection"][:ROUTED_WALKERS]) == 0,
            "routed node2vec walks differ from K2's rejection walks")
    emit("main_path_checks", ok=True, routed=info, routed_node2vec=n2v_info,
         walk_digests={name: walk_digest(out[name])
                       for name in ("uniform", "mixture", "rejection",
                                    "routed_n2v")})
    return (targets, pgraph, (hashes, blooms), out, launches,
            {"uniform": (info, t_x), "node2vec": (n2v_info, t_n)})


def phase_kernels(graph, targets, out, counts, walk_ms, walk_entry_ms):
    """Every kernel at the main path's shape: time (the walks' device time
    from ``phase_walk_times``, with their entry points' time beside it),
    plain version on the same inputs (time and deviation), bound, and
    library call where one exists."""
    rows = []

    def row(name, ms, plain_ms, err, bound_pair, library_ms, launches):
        source, replaces = KERNEL_FACTS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_pair[0],
            "bound_by": bound_pair[1], "library_ms": library_ms})

    plain, plain_ms = wall_ms(lambda: plain_uniform(graph, targets, WALK_SEED))
    k1_ms = walk_ms["uniform"]
    row("uniform_walk_csr", k1_ms, plain_ms, max_abs_err(out["uniform"], plain),
        uniform_bound(NUM_WALKERS, WALK_LENGTH), None,
        counts["uniform_walk_csr"])
    rows[-1]["entry_point_ms"] = walk_entry_ms["uniform"]
    del plain

    for name, key, mixture in (
            ("node2vec_walk_csr_mixture", "mixture", True),
            ("node2vec_walk_csr_rejection", "rejection", False)):
        plain, plain_ms = wall_ms(lambda: plain_biased(
            graph, targets, WALK_SEED, mixture))
        require(not bool(plain.exhausted.any()), f"{name}: budget ran out")
        bound_pair, counted = biased_bound(graph, out[key], plain.rounds,
                                           plain.searches, mixture)
        ms = walk_ms[key]
        row(name, ms, plain_ms, max_abs_err(out[key], plain.walks), bound_pair,
            None, counts[name])
        rows[-1]["entry_point_ms"] = walk_entry_ms[key]
        rows[-1]["ms_over_uniform_walk_csr"] = ms / k1_ms
        drawn = int(plain.rounds.sum(dtype=torch.int64))
        # A lane that draws rounds r and r+1 together (r even) draws one
        # round more than needed at each step that accepts at an even round.
        paired_extra = int(((plain.rounds % 2 == 1)
                            & (plain.rounds < common.DEFAULT_MAX_ROUNDS))
                           .sum(dtype=torch.int64))
        emit("rounds", kernel=name, walker_rounds=drawn,
             rounds_per_step=drawn / plain.rounds.numel(),
             two_rounds_per_iteration_extra_rounds=paired_extra,
             two_rounds_per_iteration_extra_share=paired_extra / drawn,
             bound_counts=counted)
        del plain

    walks = out["uniform"]
    times = phase_exchange_windows_times(walks)
    plain, plain_ms = wall_ms(
        lambda: plain_windows(walks, NUM_NODES, WINDOW_SEED))
    row("to_windows", times["to_windows"]["device_ms"], plain_ms,
        max_abs_err(out["windows"], plain),
        windows_bound(NUM_WALKERS, WALK_LENGTH + 1), None,
        counts["to_windows"])
    rows[-1]["entry_point_ms"] = times["to_windows"]["entry_ms"]
    del plain

    exchange_times = times["all_to_all_chunks"]
    device_ms = exchange_times["device_ms"]
    row("all_to_all_chunks", device_ms["kernel"], device_ms["plain"],
        exchange_times["max_abs_err"], exchange_bound(*exchange_times["shape"]),
        device_ms["library"], counts["all_to_all_chunks"])
    rows[-1]["host_bound_ms"] = exchange_times["host_bound_ms"]["kernel"]

    steps = NUM_WALKERS * WALK_LENGTH
    emit("rates", walkers=NUM_WALKERS, walk_length=WALK_LENGTH,
         timing="device time of calls queued behind a spin kernel (the "
                "walk_times line)",
         node_steps_per_s={r["name"]: steps / (r["ms"] / 1e3)
                           for r in rows[:3]})

    return rows


# --- the routed legs (K11, K12) ----------------------------------------------

def routed_calls(phases: int, k: int | None = None) -> int:
    """Phase calls of a routed leg of ``phases`` phases: the loop enqueues
    whole batches of ``k`` (PHASES_PER_READ) phases, and the phases of the
    last batch after the end are no-ops."""
    k = k or partition_v2.PHASES_PER_READ
    return -(-phases // k) * k


def routed_walk(pgraph, targets, walk_length, schedule, body, tables=None,
                config=None):
    """A ``RoutedWalk`` of the uniform engine (``tables`` None) or of the
    node2vec one at P, Q on ``tables`` = (hashes or None, blooms or None),
    with the phase ``body`` given and the configuration the public entry
    points resolve from ``config``."""
    b, d = int(targets.shape[0]), pgraph.num_shards
    cfg = tt.RoutedConfig.resolve(config, b, d, walk_length)
    routing = None
    if tables is None:
        key = prng.derive_key(WALK_SEED, prng.STREAM_CSR_UNIFORM)
    else:
        if config is None or config.max_phases <= 0:
            cfg = partition_v2._biased_phase_budget(cfg, walk_length,
                                                    SPEC_ROUNDS)
        key = prng.derive_key(WALK_SEED, prng.STREAM_CSR_BIASED)
        routing = partition_v2.node2vec_routing(pgraph, P, Q, SPEC_ROUNDS,
                                                *tables)
    return partition_v2.RoutedWalk(pgraph, targets, walk_length, key, cfg,
                                   schedule, body, node2vec=routing)


def state_err(kernel_run, plain_run) -> int:
    """Largest difference between two runs' whole state: every pipeline's
    outboxes, carry pools (live prefix) and live counts, the walk rows and
    the counters."""
    a, b = kernel_run.state(), plain_run.state()
    require(a.keys() == b.keys(), "the two runs hold different state")
    worst = 0
    for name in a:
        x = a[name] if isinstance(a[name], list) else [a[name]]
        y = b[name] if isinstance(b[name], list) else [b[name]]
        require(len(x) == len(y), f"{name}: different shard counts")
        for u, v in zip(x, y):
            if u.shape != v.shape:  # carry pools of different live lengths
                return max(worst, 2 ** 31)
            worst = max(worst, max_abs_err(u, v))
    return worst


def same_result(a, b) -> bool:
    """Two runs' results ((walks, info), or the errors they raised) agree."""
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return max_abs_err(a[0], b[0]) == 0 and a[1] == b[1]


def routed_lockstep(make, phases=None) -> dict:
    """A kernel run and a plain run (``make(body)``) side by side on the
    card: the whole state compared after phase 0 and after each of the
    first ``phases`` phases (every phase when None).  Without a limit both
    run to the end, and their results are compared too (or the errors they
    raised), and the plain run's is returned as ``plain`` (not for
    printing: it holds the walks)."""
    runs = [make("kernel"), make("plain")]
    for r in runs:
        r.start()
    worst, compared = state_err(*runs), 0
    while runs[0].inflight() > 0 and runs[0].phases < runs[0].max_phases:
        require(runs[0].inflight() == runs[1].inflight(),
                "in-flight counts differ")
        if phases is not None and compared >= phases:
            return {"phases_compared": compared, "max_abs_err": worst}
        for r in runs:
            r.phase()
        worst = max(worst, state_err(*runs))
        compared += 1
    results = []
    for r in runs:
        try:
            results.append(r.result())
        except RuntimeError as err:
            results.append(str(err))
    out = {"phases_compared": compared,
           "max_abs_err": worst if same_result(*results) else max(worst, 1),
           "result": results[0] if isinstance(results[0], str)
           else results[0][1]}
    if phases is None:
        out["plain"] = results[1]
    return out


def whole_leg_err(make, want) -> int:
    """A kernel run (``make("kernel")``) to its end through ``run`` (one
    batch launch after phase 0) against ``want``, the plain run's result
    or the error it raised: 0 if they agree, else 1."""
    try:
        got = make("kernel").run()
    except RuntimeError as err:
        got = str(err)
    return int(not same_result(got, want))


def small_routed_graph(device):
    """A power-law graph of 3 000 nodes whose last quarter has no
    out-edge."""
    rng = np.random.default_rng(8)
    u = rng.random(18_000)
    dst, src = (u * u * 3000).astype(np.int64), rng.integers(0, 3000, 18_000)
    keep = src < 2250
    return tt.CSRGraph.from_edges(src[keep], dst[keep], num_nodes=3000,
                                  device=device)


def phase_call_ms(bindings_module, kernel: str, run_leg):
    """``run_leg()`` with CUDA events around every call of the phase kernel
    ``kernel`` of ``bindings_module`` (this tree's or another checkout's
    bindings).  Returns (its result, device ms of each call in order)."""
    wrapped = getattr(bindings_module, kernel)
    events = []

    def timed_call(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        wrapped(*args)
        ev[1].record()
        events.append(ev)

    setattr(bindings_module, kernel, timed_call)
    try:
        out = run_leg()
    finally:
        setattr(bindings_module, kernel, wrapped)
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in events]


ROUTED_K_SWEEP = (1, 2, 4, 8, 16, 32)


@contextlib.contextmanager
def routed_loop(k: int, graph: bool):
    """Within the block the routed loop enqueues ``k`` phases a read, and
    replays whole batches of every schedule as a CUDA graph if ``graph``,
    of none if not."""
    saved = partition_v2.PHASES_PER_READ, partition_v2.GRAPH_SCHEDULES
    partition_v2.PHASES_PER_READ = k
    partition_v2.GRAPH_SCHEDULES = partition_v2.SCHEDULES if graph else ()
    try:
        yield
    finally:
        partition_v2.PHASES_PER_READ, partition_v2.GRAPH_SCHEDULES = saved


def routed_compact_smem(streams: int) -> int:
    """Dynamic shared memory of a compaction block at D = NUM_SHARDS
    (routed.cuh routed_compact_smem)."""
    return streams * NUM_SHARDS * (8 + 4 + 4 * 8)


def routed_small_checks(device) -> dict:
    """K11 and K12 against the plain bodies phase by phase on a small graph
    with dead ends: D = 1, 2 and 8, L = 1 and 12, both schedules, a pair
    capacity that fills the carry pool and one whose pool overflows (both
    runs must raise alike; no other case may raise), K12 with cuckoo probes
    and the binary search,
    Bloom filters and saturated ones.  Returns the largest difference of
    each kernel."""
    graph = small_routed_graph(device)
    walkers = 1024
    rng = np.random.default_rng(9)
    targets = {n: common.as_int32(rng.integers(0, graph.num_nodes, n), device)
               for n in (walkers, 8 * walkers)}
    pgraphs = {d: tt.PartitionedCSR.from_csr(graph, d) for d in (1, 2, 8, 16)}
    tables = {d: (tt.build_partition_hashes(pg, graph),
                  tt.build_partition_blooms(pg, graph))
              for d, pg in pgraphs.items()}
    carry = tt.RoutedConfig(pair_capacity=16, carry_capacity=walkers)
    overflow = tt.RoutedConfig(pair_capacity=2, carry_capacity=5)
    # Two tiles of stage slots a stream, and a pool of many tiles.
    tiles = tt.RoutedConfig(pair_capacity=160, carry_capacity=8 * walkers)
    # (shards, schedules, walk length, config, node2vec tables by name)
    cases = [
        (8, partition_v2.SCHEDULES, 12, None,
         ("cuckoo", "search", "saturated")),
        (8, ("serial",), 1, None, ("cuckoo",)),
        (8, partition_v2.SCHEDULES, 12, carry, ("cuckoo",)),
        (8, ("serial",), 12, overflow, ("cuckoo",)),
        (1, partition_v2.SCHEDULES, 12, None, ("search",)),
        (2, ("serial",), 12, None, ("cuckoo",)),
        (16, ("overlapped",), 12, None, ("cuckoo",)),
        (2, partition_v2.SCHEDULES, 12, tiles, ("cuckoo",)),
    ]
    errs = dict.fromkeys(ROUTED_KERNELS, 0)  # K11, K12
    for d, schedules, length, cfg, n2v in cases:
        t = targets[8 * walkers if cfg is tiles else walkers]
        hashes, blooms = tables[d]
        kinds = [("routed_uniform_phase", None)] + [
            ("routed_node2vec_phase", {"cuckoo": (hashes, blooms),
                                       "search": (None, blooms),
                                       "saturated": (hashes, None)}[k])
            for k in n2v]
        for schedule in schedules:
            for name, tab in kinds:
                got = routed_lockstep(lambda body: routed_walk(
                    pgraphs[d], t, length, schedule, body, tab, cfg))
                raised = isinstance(got.get("result"), str)
                if cfg is overflow:
                    require(raised and "incomplete" in got["result"],
                            f"{name}: an overflowing pool did not raise")
                else:
                    require(not raised, f"{name} (D={d}, {schedule}, "
                            f"L={length}, {n2v}) raised: {got.get('result')}")
                errs[name] = max(errs[name], got["max_abs_err"])
    return errs


def phase_routed(graph, targets, pgraph, tables, out, launches, main_runs):
    """The routed legs at the bench shape (D=8, ROUTED_WALKERS walkers,
    L=WALK_LENGTH): each kernel held against the plain body on the card,
    state by state for the first ROUTED_CHECKED_PHASES phases and then on
    its whole result (walks, phases, exchanged records, logged positions);
    the uniform leg under both schedules, the node2vec leg under both and
    with hashes=None, each warm on the host clock with its walks held
    against the single-device kernels'; K11's and K12's device time a call
    by CUDA events around every call of one warm leg; the card's launches a
    phase and idle share by torch.profiler over a whole leg (the plain
    body's over a leg of PROFILED_WALK_LENGTH, where the profiler's digest of
    its thousands of launches a phase takes minutes at full depth).
    Returns K11's and K12's rows."""
    hashes, blooms = tables
    t = targets[:ROUTED_WALKERS]
    legs = {
        "uniform_serial": (None, "serial"),
        "uniform_overlapped": (None, "overlapped"),
        "node2vec_serial": ((hashes, blooms), "serial"),
        "node2vec_overlapped": ((hashes, blooms), "overlapped"),
        "node2vec_serial_search": ((None, blooms), "serial"),
    }

    def entry(tab, schedule, walk_length=WALK_LENGTH):
        if tab is None:
            return tt.walk_partitioned_routed(pgraph, t, walk_length,
                                              seed=WALK_SEED,
                                              schedule=schedule)
        return routed_n2v_call(pgraph, t, tab[0], tab[1], schedule,
                               walk_length)

    # Kernel against plain body, state by state, then whole legs.
    checks, plain = {}, {}
    for name, (tab, schedule) in legs.items():
        checks[name] = routed_lockstep(
            lambda body: routed_walk(pgraph, t, WALK_LENGTH, schedule, body,
                                     tab), ROUTED_CHECKED_PHASES)
        (walks, info), ms = wall_ms(lambda: routed_walk(
            pgraph, t, WALK_LENGTH, schedule, "plain", tab).run())
        plain[name] = {"walks": walks, "info": info, "ms": ms}
    emit("routed_checks", lockstep=checks, plain_leg_ms={
        k: v["ms"] for k, v in plain.items()}, plain_info={
        k: v["info"] for k, v in plain.items()})
    require(all(c["max_abs_err"] == 0 for c in checks.values()),
            f"a phase kernel's state differs from the plain body's: {checks}")

    # Warm legs through the entry points, each against the single-device
    # walks and, where the plain body ran it, the plain leg.
    want = {"uniform": out["uniform"][:ROUTED_WALKERS],
            "node2vec": out["rejection"][:ROUTED_WALKERS]}
    timed = {}
    for name, (tab, schedule) in legs.items():
        entry(tab, schedule)  # warm
        runs = [wall_ms(lambda: entry(tab, schedule)) for _ in range(3)]
        (walks, info), _ = runs[0]
        require(max_abs_err(walks, want[name.split("_")[0]]) == 0,
                f"{name}: walks differ from the single-device kernel's")
        if name in plain:
            require(max_abs_err(walks, plain[name]["walks"]) == 0
                    and info == plain[name]["info"],
                    f"{name}: the kernel leg differs from the plain body's")
        ms = [m for _, m in runs]
        timed[name] = {"info": info, "warm_leg_ms": ms,
                       "node_steps_per_s": ROUTED_WALKERS * WALK_LENGTH
                       / (statistics.median(ms) / 1e3)}
    for name, kind in (("uniform_serial", "uniform"),
                       ("node2vec_serial", "node2vec")):
        first = main_runs[kind]
        require(timed[name]["info"] == first[0],
                f"{name}: the leg is not reproducible")
        timed[name]["first_leg_ms"] = first[1]

    # Device time of each phase call over one warm leg, by CUDA events: the
    # phases' calls, and apart from them the no-op calls of the last batch.
    per_call = {}
    for name, kernel in (("uniform_serial", "routed_uniform_phase"),
                         ("node2vec_serial", "routed_node2vec_phase")):
        tab, schedule = legs[name]
        with routed_loop(partition_v2.PHASES_PER_READ, False):
            (_, info), ms = phase_call_ms(bindings, kernel,
                                          lambda: entry(tab, schedule))
        phases = info["phases"]
        require(len(ms) == routed_calls(phases),
                "one call an enqueued phase expected")
        per_call[kernel] = {
            "calls": len(ms), "noop_calls": len(ms) - phases,
            "device_ms_per_call": sum(ms[:phases]) / phases,
            "noop_device_ms_per_call": (sum(ms[phases:])
                                        / max(len(ms) - phases, 1))}

    # Warm legs with k phases a read (the loop's batch), eager and replayed
    # as a CUDA graph (k a multiple of 4), each with its no-op calls:
    # PHASES_PER_READ and GRAPH_SCHEDULES are chosen from these.
    k_sweep = {}
    for name in legs:
        tab, schedule = legs[name]
        for graph, k in [(g, k) for g in (False, True) for k in ROUTED_K_SWEEP
                         if not g or k % 4 == 0]:
            with routed_loop(k, graph):
                entry(tab, schedule)
                runs = [wall_ms(lambda: entry(tab, schedule))
                        for _ in range(3)]
            require(all(r[0][1] == timed[name]["info"] for r in runs),
                    f"{name}: k={k} changed the leg's info")
            require(all(max_abs_err(r[0][0], runs[0][0][0]) == 0
                        for r in runs), f"{name}: k={k} changed the walks")
            k_sweep.setdefault(name, {})[f"{'graph' if graph else 'eager'}"
                                         f"_k{k}"] = {
                "warm_leg_ms": [m for _, m in runs],
                "noop_calls": routed_calls(timed[name]["info"]["phases"], k)
                - timed[name]["info"]["phases"]}

    # The card's share of a leg, by the profiler.
    profiled = {}
    for name, fn, walk_length in (
            ("uniform_serial_kernel", lambda L: entry(None, "serial", L),
             WALK_LENGTH),
            ("uniform_overlapped_kernel",
             lambda L: entry(None, "overlapped", L), WALK_LENGTH),
            ("node2vec_serial_kernel",
             lambda L: entry((hashes, blooms), "serial", L), WALK_LENGTH),
            ("node2vec_overlapped_kernel",
             lambda L: entry((hashes, blooms), "overlapped", L), WALK_LENGTH),
            ("uniform_serial_kernel_short",
             lambda L: entry(None, "serial", L), PROFILED_WALK_LENGTH),
            ("node2vec_serial_kernel_short",
             lambda L: entry((hashes, blooms), "serial", L),
             PROFILED_WALK_LENGTH),
            ("uniform_serial_plain_short", lambda L: routed_walk(
                pgraph, t, L, "serial", "plain").run(),
             PROFILED_WALK_LENGTH),
            ("node2vec_serial_plain_short", lambda L: routed_walk(
                pgraph, t, L, "serial", "plain", (hashes, blooms)).run(),
             PROFILED_WALK_LENGTH)):
        fn(walk_length)  # warm
        (_, info), ms, kernels = profile_device(lambda: fn(walk_length))
        busy = sum(v for _, v in kernels.values())
        n = sum(c for c, _ in kernels.values())
        phases = info["phases"]

        def per_phase(part):
            hits = [v for k, v in kernels.items() if part in k]
            return {"launches": sum(c for c, _ in hits),
                    "device_ms_per_phase": sum(m for _, m in hits) / phases}

        profiled[name] = None if busy <= 0 else {
            "walk_length": walk_length, "phases": phases,
            "leg_ms": ms, "device_launches": n,
            "device_launches_per_phase": n / phases,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / ms,
            "compaction": per_phase("routed_compact_kernel"),
            "body": per_phase("body_kernel"),
            "exchange": per_phase("all_to_all_chunks"),
            "by_kernel": {k: v for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1][1])[:8]}}
    # Device memory an engine holds besides the graph and its tables.
    engine_bytes = {}
    for name, (tab, schedule) in legs.items():
        run = routed_walk(pgraph, t, WALK_LENGTH, schedule, "kernel", tab)
        held = [run.walks, run.stats, run.live, run._counter, run._stage,
                run._code, run._hist] + [
            x for pipe in run.pipes
            for x in (pipe.outbox, pipe.inbox, pipe.carry, pipe.pool_count)]
        engine_bytes[name] = sum(x.numel() * x.element_size() for x in held)
        del run
    emit("routed", walkers=ROUTED_WALKERS, shards=NUM_SHARDS,
         spec_rounds=SPEC_ROUNDS, p=P, q=Q,
         phases_per_read=partition_v2.PHASES_PER_READ,
         cuda_graph_schedules=partition_v2.GRAPH_SCHEDULES,
         compaction_dynamic_smem_bytes={
             "K11": routed_compact_smem(2), "K12": routed_compact_smem(4)},
         legs=timed, per_call=per_call, k_sweep=k_sweep,
         engine_bytes=engine_bytes,
         profiled=profiled, timing="warm legs on the host clock, three "
         "after one warm-up; per_call: CUDA events around every phase call "
         "of one warm leg (the phases' calls; no-op calls apart); k_sweep: "
         "warm legs with k phases a read; profiled: torch.profiler, device "
         "activity only, one warm leg (null if it saw no device time)")

    rows = []
    for kernel, name, width in (("routed_uniform_phase", "uniform_serial", 3),
                                ("routed_node2vec_phase", "node2vec_serial",
                                 14)):
        info = timed[name]["info"]
        phases = info["phases"]
        prof = profiled[f"{name}_kernel"]
        # Bytes a leg needs: every record written once to an outbox and
        # read once on arrival, every position logged, a meta row and a col
        # word a step (node2vec: and a 16-byte filter row a step).
        moved = (2 * info["exchanged_records"] * width * 4
                 + info["log_entries"] * 4
                 + ROUTED_WALKERS * WALK_LENGTH * (12 + (16 if width == 14
                                                         else 0)))
        source, replaces = KERNEL_FACTS[kernel]
        rows.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": checks[name]["max_abs_err"],
            # The call's two kernels' device time a phase; CUDA events around
            # a call (call_ms_events) also hold the host's launch gaps, and
            # stand in where the profiler saw no device time.
            "ms": (per_call[kernel]["device_ms_per_call"] if prof is None
                   else prof["body"]["device_ms_per_phase"]
                   + prof["compaction"]["device_ms_per_phase"]),
            "ms_by": "cuda_events" if prof is None else "profiler",
            "call_ms_events": per_call[kernel]["device_ms_per_call"],
            "plain_ms": plain[name]["ms"] / plain[name]["info"]["phases"],
            "bound_ms": moved / phases / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "leg_ms": statistics.median(timed[name]["warm_leg_ms"]),
            "plain_leg_ms": plain[name]["ms"], "phases": phases})
    return rows


def phase_train(graph):
    """The training half of the main path through ``Node2Vec.epoch_step``:
    one warm step and TRAIN_STEPS chained steps with uniform walks, then one
    step with node2vec walks on the same tables, with the launch counts set to
    0 just before and read just after."""
    dev = graph.device
    targets = torch.arange(TRAIN_WALKERS, dtype=torch.int32, device=dev)
    n2v = tt.Node2Vec(graph, tt.Node2VecConfig(**TRAIN_CONFIG))
    model = n2v.init()
    biased = tt.Node2Vec(graph, tt.Node2VecConfig(**{**TRAIN_CONFIG,
                                                     "p": P, "q": Q}))
    biased.model = model  # the same tables and optimizer state
    window = TRAIN_CONFIG["window_size"]
    torch.cuda.synchronize()
    peak_gib()  # the step's own peak from here on

    bindings.reset_launch_counts()
    losses, events = [], []
    for epoch in range(1 + TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(n2v.epoch_step(targets, epoch))
        end.record()
        events.append((start, end))
    biased_loss = biased.epoch_step(targets, 1 + TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(bindings.launch_counts)
    step_peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    chained_ms = statistics.median(step_ms[1:])
    steps = 1 + TRAIN_STEPS
    emit("train", config=TRAIN_CONFIG, num_nodes=graph.num_nodes,
         walkers=TRAIN_WALKERS, losses=losses, biased_step_loss=float(
             biased_loss), step_ms=step_ms, warm_step_ms=step_ms[0],
         chained_step_ms_median=chained_ms,
         timing="CUDA events around each epoch_step",
         node_steps_per_s=(TRAIN_WALKERS * TRAIN_CONFIG["walk_length"]
                           / (chained_ms / 1e3)),
         launches=launches, launches_per_step={
             "walk (uniform_walk_csr or node2vec_walk_csr_mixture)":
                 (launches["uniform_walk_csr"]
                  + launches["node2vec_walk_csr_mixture"]) / (steps + 1),
             "walk_sgns_loss_fwd": launches["walk_sgns_loss_fwd"] / (steps + 1),
             "walk_sgns_loss_bwd": launches["walk_sgns_loss_bwd"] / (steps + 1),
             "adam_dense": launches["adam_dense"] / (steps + 1)},
         peak_device_gib=step_peak_gib)
    require(launches["uniform_walk_csr"] == steps
            and launches["node2vec_walk_csr_mixture"] == 1
            and launches["walk_sgns_loss_fwd"] == steps + 1
            and launches["walk_sgns_loss_bwd"] == steps + 1
            and launches["adam_dense"] == 2 * (steps + 1),
            f"the train steps did not go through K1/K2, K5, K6 and K18: "
            f"{launches}")
    require(all(np.isfinite(losses)) and np.isfinite(float(biased_loss)),
            "a loss is not finite")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    require(model.count == steps + 1, "Adam's step count is wrong")
    for name, param in model.named_parameters():
        require(param.dtype == torch.bfloat16
                and tuple(param.shape) == (NUM_NODES, TRAIN_CONFIG["dim"])
                and bool(torch.isfinite(param).all()),
                f"{name}: wrong type or shape, or not finite")

    # Equal inputs give equal loss bits: the loss kernel twice on the trained
    # tables, then the first step again from freshly initialised tables.
    walks, neg_ids = n2v.sample(targets, 0)
    with torch.no_grad():
        twice = [model.walk_loss(walks, neg_ids, window, window - 1)
                 for _ in range(2)]
    require(torch.equal(twice[0], twice[1]), "the loss is not repeatable")
    n2v.init()
    again = float(n2v.epoch_step(targets, 0))
    require(again == losses[0], "the first step is not repeatable: "
            f"{again} vs {losses[0]}")
    emit("train_checks", ok=True, loss_on_first_batch_after_training=float(
        twice[0]), first_step_again=again)
    return launches


def phase_sgns_kernels(graph, counts):
    """K5 and K6 at the train shape with random tables, bfloat16 and float32:
    deviation from the plain version, time, bound; and the parts of a step."""
    dev = graph.device
    cfg = tt.Node2VecConfig(**TRAIN_CONFIG)
    window = cfg.window_size
    targets = torch.arange(TRAIN_WALKERS, dtype=torch.int32, device=dev)
    walks = tt.walk(graph, target_nodes=targets, walk_length=cfg.walk_length,
                    seed=WALK_SEED)
    neg_ids = skipgram.shared_negative_ids(WALK_SEED, cfg.shared_negatives,
                                           NUM_NODES)
    one = torch.ones((), dtype=torch.float32, device=dev)
    found = {}
    for dtype in (torch.bfloat16, torch.float32):
        in_emb, out_emb = random_tables(NUM_NODES, cfg.dim, dtype, dev, seed=7)
        err = {"plan": bindings.walk_sgns_plan(in_emb, walks, neg_ids, window)}
        err.update(loss_errors(in_emb, out_emb, walks, neg_ids, window))
        err["fwd_ms"] = time_ms(lambda: bindings.walk_sgns_loss_fwd(
            in_emb, out_emb, walks, neg_ids, window, window - 1))
        err["bwd_ms"] = time_ms(lambda: bindings.walk_sgns_loss_bwd(
            in_emb, out_emb, walks, neg_ids, window, window - 1, one))
        err["fwd_bound"], in_rows, out_rows = sgns_bound(
            dtype, False, walks, neg_ids)
        err["bwd_bound"], _, _ = sgns_bound(dtype, True, walks, neg_ids)
        # K5's and K6's device ms per launch by kernel (K6: the zero-fill of
        # the gradient tables, its rows pass and its negatives pass), over
        # two calls: the profiler may drop the first kernel it sees.
        for key, call in (
                ("fwd_device_ms_by_kernel", lambda: bindings.walk_sgns_loss_fwd(
                    in_emb, out_emb, walks, neg_ids, window, window - 1)),
                ("bwd_device_ms_by_kernel", lambda: bindings.walk_sgns_loss_bwd(
                    in_emb, out_emb, walks, neg_ids, window, window - 1, one))):
            err[key] = {name: ms / n for name, (n, ms) in profile_device(
                lambda: (call(), call()))[2].items()} or None
        if dtype == torch.bfloat16:
            centers = walks[:, window // 2: walks.shape[1] - window // 2]
            u = in_emb[centers.reshape(-1).long()]
            v_neg = out_emb[neg_ids.long()]
            matmul_ms = time_ms(lambda: torch.matmul(u, v_neg.T))
            del u
            # K6's scatter alone through the library: every center row's du
            # and every walk row's do added into the dense float32 tables.
            rows = torch.where(walks < 0, NUM_NODES - 1, walks).long()
            in_rows = rows[:, window // 2: walks.shape[1] - window // 2]
            in_rows, out_rows = in_rows.reshape(-1), rows.reshape(-1)
            grad = torch.zeros((NUM_NODES, cfg.dim), dtype=torch.float32,
                               device=dev)
            du = torch.ones((in_rows.numel(), cfg.dim), device=dev)
            do = torch.ones((out_rows.numel(), cfg.dim), device=dev)
            scatter_ms = time_ms(lambda: (grad.index_add_(0, in_rows, du),
                                          grad.index_add_(0, out_rows, do)))
            del rows, in_rows, out_rows, grad, du, do
        found[str(dtype)] = err
        del in_emb, out_emb
    emit("walk_sgns_loss_kernels", shape={
        "walks": list(walks.shape), "tables": [NUM_NODES, cfg.dim],
        "shared_negatives": cfg.shared_negatives, "window_size": window,
        "distinct_in_emb_rows": in_rows, "distinct_out_emb_rows": out_rows,
        "gathered_row_slots": TRAIN_WALKERS * (2 * (cfg.walk_length + 1)
                                               - 2 * (window // 2))
        + cfg.shared_negatives},
        limits={"loss_rel_err": LOSS_REL_LIMIT, "grad_rel_err": GRAD_REL_LIMIT},
        results=found,
        bwd_ms_includes="the zero-fill of the two (N, D) float32 gradient "
                        "tables",
        negative_product_matmul_ms_bfloat16=matmul_ms,
        row_scatter_index_add_ms=scatter_ms,
        row_scatter_index_add_is="two index_add_ calls, as context: the B*C "
        "du rows and B*(L+1) do rows of K6 added into a dense (N, D) float32 "
        "table, as K6's rows pass adds them with float4 atomics",
        negative_product_matmul_is="torch.matmul of the gathered (B*C, D) "
        "centers with the (D, S) negatives alone, as context; it writes the "
        "(B*C, S) logits that K5 never stores")
    for name, err in found.items():
        require(err["loss_rel_err"] <= LOSS_REL_LIMIT
                and err["grad_rel_err"] <= GRAD_REL_LIMIT,
                f"loss kernels != plain at the train shape ({name}): {err}")

    # The parts of one step at this shape (bfloat16 tables).
    model = tt.SkipGramModel(NUM_NODES, cfg.dim, dtype=cfg.dtype,
                             learning_rate=cfg.learning_rate)
    shape = (NUM_NODES, cfg.dim)

    def zero_grads():
        return {k: torch.zeros(shape, dtype=torch.float32, device=dev)
                for k in ("in_emb", "out_emb")}

    def train_walk():
        return tt.walk(graph, target_nodes=targets,
                       walk_length=cfg.walk_length, seed=WALK_SEED)

    spent = zero_grads()  # K18 reads the gradients and leaves them as they are

    emit("train_step_parts", timing="CUDA events, 1 warm-up, median of 5",
         walk_ms=time_ms(train_walk),
         walk_device_ms=queued_ms(train_walk, WALK_REPS),
         shared_negatives_ms=time_ms(lambda: skipgram.shared_negative_ids(
             WALK_SEED, cfg.shared_negatives, NUM_NODES)),
         loss_fwd_ms=found["torch.bfloat16"]["fwd_ms"],
         loss_bwd_ms=found["torch.bfloat16"]["bwd_ms"],
         zero_fill_ms=time_ms(zero_grads),
         adam_and_zero_fill_ms=time_ms(lambda: model.adam_update(zero_grads())),
         adam_ms=time_ms(lambda: model.adam_update(spent)),
         walk_train_step_ms=time_ms(lambda: model.walk_train_step(
             walks, neg_ids, window, window - 1)))

    main = found["torch.bfloat16"]
    rows = []
    for name, ms, err, bound_pair in (
            ("walk_sgns_loss_fwd", main["fwd_ms"], "loss_abs_err",
             main["fwd_bound"]),
            ("walk_sgns_loss_bwd", main["bwd_ms"], "grad_abs_err",
             main["bwd_bound"])):
        source, replaces = KERNEL_FACTS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(f[err] for f in found.values()),
            "ms": ms, "plain_ms": main["plain_ms"], "bound_ms": bound_pair[0],
            "bound_by": bound_pair[1], "library_ms": None})
    return rows


# --- the trainer modes (K16-K18) ---------------------------------------------

def ulp_distance(got, want) -> torch.Tensor:
    """Per element, units in the last place of the tensors' type between
    ``got`` and ``want`` (bit patterns in sign-magnitude order: -0 is +0)."""
    bits, mag = {torch.float32: (torch.int32, 0x7FFFFFFF),
                 torch.bfloat16: (torch.int16, 0x7FFF)}[got.dtype]

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mag), i)

    return (ordered(got) - ordered(want)).abs()


def plain_windows_loss_and_grads(in_emb, out_emb, in_ids, pos, neg):
    """The plain version of K16 and K17: the tables read as float32 (exact
    for bfloat16), the gradients by autograd, float32."""
    tables = [t.detach().to(torch.float32, copy=True).requires_grad_(True)
              for t in (in_emb, out_emb)]
    loss = skipgram.windows_loss_plain(*tables, in_ids, pos, neg)
    return loss.detach(), torch.autograd.grad(loss, tables)


def windows_errors(in_emb, out_emb, in_ids, pos, neg, cbow: bool) -> dict:
    """K16, K17 and the fused entry (both in one call) against the plain
    version on the same inputs; K16 run twice must give the same bits, and
    the fused loss K16's bits.  ``grad_*`` the worse of K17's and the fused
    entry's gradient errors, ``k17_grad_abs_err`` and
    ``fused_grad_abs_err`` each one's."""
    loss = bindings.sgns_windows_loss_fwd(in_emb, out_emb, in_ids, pos, neg,
                                          cbow)
    again = bindings.sgns_windows_loss_fwd(in_emb, out_emb, in_ids, pos, neg,
                                           cbow)
    grads = bindings.sgns_windows_loss_bwd(in_emb, out_emb, in_ids, pos, neg,
                                           torch.ones_like(loss), cbow)
    fused_loss, *fused = bindings.sgns_windows_loss_and_grads(
        in_emb, out_emb, in_ids, pos, neg, cbow)
    (want, want_grads), plain_ms = wall_ms(lambda: plain_windows_loss_and_grads(
        in_emb, out_emb, in_ids, pos, neg))
    require(bool(torch.isfinite(loss)) and bool(torch.isfinite(want)),
            "window loss is not finite")
    require(torch.equal(loss, again), "K16 is not repeatable")
    require(torch.equal(fused_loss, loss),
            f"the fused loss {float(fused_loss)!r} is not K16's "
            f"{float(loss)!r} bit for bit")
    loss_abs = abs(float(loss) - float(want))
    grad_abs = [float((g - w).abs().max()) for got in (grads, fused)
                for g, w in zip(got, want_grads)]
    grad_rel = [a / max(float(w.abs().max()), 1e-30)
                for a, w in zip(grad_abs, want_grads * 2)]
    del grads, fused
    return {"loss": float(loss), "plain_loss": float(want),
            "fused_loss_equals_k16": True,
            "loss_abs_err": loss_abs,
            "loss_rel_err": loss_abs / max(abs(float(want)), 1e-30),
            "grad_abs_err": max(grad_abs), "grad_rel_err": max(grad_rel),
            "k17_grad_abs_err": max(grad_abs[:2]),
            "fused_grad_abs_err": max(grad_abs[2:]),
            "plain_ms": plain_ms}


def launch_ms(fn, calls: int = 3) -> dict:
    """Device ms a launch of each kernel that ``fn`` launches, by kernel
    name: ``calls`` warm calls under the profiler, each kernel's device time
    over its launches (the profiler may drop the first kernel of a
    capture)."""
    _, _, kernels = profile_device(lambda: [fn() for _ in range(calls)])
    return {name: ms / count for name, (count, ms) in kernels.items()}


def adam_hyper(model, sparse: bool) -> tuple:
    """(lr, b1, b2, eps, bc1, bc2) of the model's next step: the bias
    corrections cast to the moments' type (dense) or float32 (rows)."""
    count = model.count + 1
    bc = [skipgram.sparse_bias_correction(b, count) for b in (model.b1,
                                                              model.b2)]
    if not sparse:
        bc = [float(torch.tensor(x).to(model.dtype)) for x in bc]
    return (model.learning_rate, model.b1, model.b2, model.eps, *bc)


def adam_errors(kernel, plain, state, args, hyper) -> dict:
    """A K18 entry (``bindings.adam_dense`` or ``adam_rows``) against its
    plain version, each on its own copy of ``state`` (param, mu, nu) with
    the same ``args`` (gradient; for rows also ids and flag): how many
    stored elements differ and by how many ulps, over whole tables (so the
    rows entry's untouched rows must stay bitwise)."""
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    kernel(*got, *args, *hyper)
    _, plain_ms = wall_ms(lambda: plain(
        *want, *[a.clone() if i == 0 else a for i, a in enumerate(args)],
        *hyper))
    out = {"plain_ms": plain_ms}
    for name, g, w in zip(("param", "mu", "nu"), got, want):
        ulps = ulp_distance(g, w)
        out[name] = {"max_ulps": int(ulps.max()),
                     "elements_differing": int((ulps > 0).sum()),
                     "max_abs_err": float((g.float() - w.float()).abs().max())}
    del got, want
    return out


def adam_dense_errors(param, mu, nu, grad, hyper) -> dict:
    return adam_errors(bindings.adam_dense, skipgram.adam_dense_plain,
                       (param, mu, nu), (grad,), hyper)


def adam_rows_errors(param, mu, nu, grad, ids, flag, hyper) -> dict:
    return adam_errors(bindings.adam_rows, skipgram.adam_rows_plain,
                       (param, mu, nu), (grad, ids, flag), hyper)


def worst_adam(errs: dict) -> tuple[int, float]:
    """(max ulps, max abs error) over param, mu and nu."""
    parts = [errs[k] for k in ("param", "mu", "nu")]
    return (max(p["max_ulps"] for p in parts),
            max(p["max_abs_err"] for p in parts))


def train_mode_small_checks(device) -> dict:
    """K16/K17 (and the fused entry) in both forms and both table types, and
    both K18 entries, at the edges: D = 1, 7, 128, 130, 512; one window; ids
    of -1 in every kind of row; a row that every window hits (more slots
    than a group of lanes takes); a slot tail of pads; no flagged slot."""
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    worst = {"windows_loss_rel_err": 0.0, "windows_grad_rel_err": 0.0,
             "adam_dense_max_ulps": 0, "adam_rows_max_ulps": 0}
    n = 700
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 7, 128, 130, 512):
            in_emb, out_emb = random_tables(n, d, dtype, device, seed=d)
            for b, c, hot in ((1, 4, False), (1000, 4, False),
                              (333, 1, False), (1000, 4, True)):
                for cbow in (False, True):
                    def ids(*shape):
                        return torch.randint(-1, n, shape, device=device,
                                             generator=gen, dtype=torch.int32)
                    args = ((ids(b, c), ids(b, 1), ids(b, 1)) if cbow
                            else (ids(b, 1), ids(b, c), ids(b, c)))
                    if hot:  # every window's first positive and context id
                        args[1][:, 0] = 5
                        args[0][:, 0] = 5
                    err = windows_errors(in_emb, out_emb, *args, cbow)
                    worst["windows_loss_rel_err"] = max(
                        worst["windows_loss_rel_err"], err["loss_rel_err"])
                    worst["windows_grad_rel_err"] = max(
                        worst["windows_grad_rel_err"], err["grad_rel_err"])
            grad = torch.randn((n, d), device=device, generator=gen)
            mu = (0.01 * torch.randn((n, d), device=device,
                                     generator=gen)).to(dtype)
            nu = (1e-4 * torch.rand((n, d), device=device,
                                    generator=gen)).to(dtype)
            # the bias corrections of step 3, cast to the moments' type as
            # the model casts them
            bc = [float(torch.tensor(1 - b ** 3).to(dtype))
                  for b in (0.9, 0.999)]
            for numel in (n * d, n * d - 3, 1):
                e = adam_dense_errors(in_emb.reshape(-1)[:numel].clone(),
                                      mu.reshape(-1)[:numel].clone(),
                                      nu.reshape(-1)[:numel].clone(),
                                      grad.reshape(-1)[:numel].clone(),
                                      (1e-2, 0.9, 0.999, 1e-8, *bc))
                worst["adam_dense_max_ulps"] = max(
                    worst["adam_dense_max_ulps"], worst_adam(e)[0])
            m = 96
            slot_ids = torch.sort(torch.randperm(
                n - 1, device=device, generator=gen)[:m]).values
            slot_ids = slot_ids.to(torch.int32)
            slot_ids[0] = -1
            slot_grad = torch.randn((m, d), device=device, generator=gen)
            mu32, nu32 = mu.float(), nu.float()
            for case in ("flag", "none", "pad_tail", "no_flagged_slot"):
                use = slot_ids.clone()
                flag = None
                if case == "pad_tail":
                    use[m // 2:] = n
                if case in ("flag", "no_flagged_slot"):
                    flag = (torch.arange(m, device=device) % 3 != 0).to(
                        torch.uint8) * int(case == "flag")
                e = adam_rows_errors(in_emb, mu32, nu32, slot_grad, use, flag,
                                     (1e-2, 0.9, 0.999, 1e-8, 0.271, 0.00299))
                worst["adam_rows_max_ulps"] = max(
                    worst["adam_rows_max_ulps"], worst_adam(e)[0])
    return worst


def sgns_windows_bound(dtype, backward: bool, in_ids, pos, neg, num_nodes):
    """K16/K17 on these windows.  Bytes, each row counted once however many
    windows share it: the distinct in rows and out rows at the table width,
    the ids, and for K17 (and the fused call, whose loss comes from the
    same reads) the two dense (N, D) float32 gradient tables written once,
    as the timed call writes them.  Operations: 2 D (CI + 2 CO) a window
    forward, twice that more backward, against the tensor-core peak of the
    table type."""
    b = in_ids.shape[0]
    wrap = lambda t: torch.where(t < 0, t + num_nodes, t)
    in_rows = torch.unique(wrap(in_ids)).numel()
    out_rows = torch.unique(torch.cat([wrap(pos).reshape(-1),
                                       wrap(neg).reshape(-1)])).numel()
    d = TRAIN_CONFIG["dim"]
    elem = torch.empty((), dtype=dtype).element_size()
    rows_per_window = in_ids.shape[1] + 2 * pos.shape[1]
    moved = (in_rows + out_rows) * d * elem + 4 * b * rows_per_window + 4
    flops = 2 * b * d * rows_per_window
    if backward:
        moved += 2 * num_nodes * d * 4
        flops *= 3
    return bound(moved, flops, TENSOR_FLOPS_PER_S[dtype])


def adam_dense_bound(numel: int, elem: int):
    """K18 dense: the float32 gradient, the parameter and both moments read
    once, parameter and moments written once; about 12 float32 operations an
    element against the CUDA cores' float32 rate."""
    return bound(numel * (4 + 6 * elem), 12 * numel, FP32_FLOPS_PER_S)


def adam_rows_bound(writes: int, dim: int, elem: int, slots: int):
    """K18 rows on this step's slots: ids (and flags) of every slot read;
    for each slot that writes, its float32 gradient row, the parameter row
    and the float32 moment rows read and written once."""
    return bound(5 * slots + writes * dim * (4 + 2 * elem + 16),
                 12 * writes * dim, FP32_FLOPS_PER_S)


def fused_adam_ms(params, grads, mus, nus, lr) -> tuple[float | None, str]:
    """The library yardstick of K18 dense: ``torch._fused_adam_`` (the call
    behind ``torch.optim.Adam(fused=True)``) over the same tables, on
    copies, with gradients of the tables' type.  Timed here only; the port
    never calls it."""
    try:
        params = [p.clone() for p in params]
        grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        mus = [m.clone() for m in mus]
        nus = [v.clone() for v in nus]
        steps = [torch.ones((), dtype=torch.float32, device=p.device)
                 for p in params]

        def call():
            torch._fused_adam_(params, grads, mus, nus, [], steps, lr=lr,
                               beta1=0.9, beta2=0.999, weight_decay=0.0,
                               eps=1e-8, amsgrad=False, maximize=False)
        return time_ms(call, iters=5), "torch._fused_adam_"
    except Exception as exc:  # the yardstick only: its absence is recorded
        return None, f"torch._fused_adam_ unavailable: {exc!r}"[:300]


def step_events(fn, steps: int):
    """``fn(i)`` for i < steps, CUDA events around each: (results, ms)."""
    out, events = [], []
    for i in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(fn(i))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [float(x) for x in out], [a.elapsed_time(b) for a, b in events]


TRAIN_MODE_CASES = {
    "windows": dict(train_mode="windows"),
    "sparse": dict(update_mode="sparse"),
    "degree75": dict(negative_distribution="degree75"),
    "degree75_sparse": dict(negative_distribution="degree75",
                            update_mode="sparse"),
    "cbow": None,
}
# Launches a step each case must show (the rest of TRAIN_MODE_KERNELS: 0).
TRAIN_MODE_LAUNCHES = {
    "windows": {"uniform_walk_csr": 1, "to_windows": 1,
                "sgns_windows_loss_and_grads": 1, "adam_dense": 2},
    "sparse": {"uniform_walk_csr": 1, "walk_sgns_loss_fwd": 1,
               "walk_sgns_loss_bwd": 1, "adam_rows": 2},
    "degree75": {"uniform_walk_csr": 1, "walk_sgns_loss_fwd": 1,
                 "walk_sgns_loss_bwd": 1, "adam_dense": 2},
    "degree75_sparse": {"uniform_walk_csr": 1, "walk_sgns_loss_fwd": 1,
                        "walk_sgns_loss_bwd": 1, "adam_rows": 2},
    "cbow": {"uniform_walk_csr": 1, "sgns_windows_loss_and_grads": 1,
             "adam_dense": 2},
}
TRAIN_MODE_KERNELS = ("uniform_walk_csr", "node2vec_walk_csr_mixture",
                      "to_windows", "walk_sgns_loss_fwd",
                      "walk_sgns_loss_bwd", "sgns_windows_loss_fwd",
                      "sgns_windows_loss_bwd", "sgns_windows_loss_and_grads",
                      "adam_dense", "adam_rows")


def phase_train_modes(graph) -> tuple[list[dict], dict]:
    """Node2Vec's window, touched-rows and degree^0.75 modes and the CBOW
    trainer at TRAIN_CONFIG on the bench graph, through ``epoch_step`` (CBOW:
    ``CBOWModel.train_step`` on ``to_windows_cbow`` of the step's walks):
    per case one warm step and TRAIN_STEPS chained steps with CUDA events
    around each (windows mode also one step at p=0.5 q=2 on the same
    tables; windows mode and CBOW then the autograd entry, ``loss_fn`` of
    the next step's windows and ``backward``, which runs K16 and K17 on
    their own where the steps run them in one call), the launch counts set
    to 0 just before each case and read just after, the losses (finite and falling), peak memory, and the step's
    parts timed alone on the step's own inputs.  Then K16/K17 (both forms),
    K18 dense and K18 rows against their plain versions on the full rows
    the main path gave them, and the kernels' rows."""
    dev = graph.device
    targets = torch.arange(TRAIN_WALKERS, dtype=torch.int32, device=dev)
    window = TRAIN_CONFIG["window_size"]
    steps = 1 + TRAIN_STEPS
    totals = dict.fromkeys(("sgns_windows_loss_fwd", "sgns_windows_loss_bwd",
                            "sgns_windows_loss_and_grads", "adam_dense",
                            "adam_rows"), 0)
    cases, checks, times = {}, {}, {}
    for case, kw in TRAIN_MODE_CASES.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        peak_gib()
        if kw is None:
            n2v = tt.Node2Vec(graph, tt.Node2VecConfig(**TRAIN_CONFIG))
            model = tt.CBOWModel(NUM_NODES, TRAIN_CONFIG["dim"])
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            model.reset_parameters(gen)

            def step(i):
                walks = n2v.walks(targets, i)
                return model.train_step(*tt.to_windows_cbow(
                    walks, window, NUM_NODES, n2v.step_seed(i)))
            alias_ms = None
        else:
            n2v, alias_ms = wall_ms(lambda: tt.Node2Vec(
                graph, tt.Node2VecConfig(**TRAIN_CONFIG, **kw)))
            if n2v.neg_tabs is None:
                alias_ms = None
            model = n2v.init()

            def step(i):
                return n2v.epoch_step(targets, i)
        torch.cuda.synchronize()
        bindings.reset_launch_counts()
        losses, step_ms = step_events(step, steps)
        launches = {k: bindings.launch_counts[k] for k in TRAIN_MODE_KERNELS}
        extra, taken = {}, steps
        if case == "windows":  # one more step at p, q on the same tables
            biased = tt.Node2Vec(graph, tt.Node2VecConfig(
                **{**TRAIN_CONFIG, **kw, "p": P, "q": Q}))
            biased.model = model
            loss, ms = step_events(lambda i: biased.epoch_step(targets, steps),
                                   1)
            extra = {"biased_step_loss": loss[0], "biased_step_ms": ms[0]}
            launches = {k: bindings.launch_counts[k]
                        for k in TRAIN_MODE_KERNELS}
            taken += 1
            del biased
        if case in ("windows", "cbow"):  # the autograd entry
            walks = n2v.walks(targets, steps)
            win = (tt.to_windows_cbow(walks, window, NUM_NODES,
                                      n2v.step_seed(steps))
                   if kw is None else n2v.windows(walks, steps))
            loss = model.loss_fn(*win)
            loss.backward()
            require(bool(torch.isfinite(loss)) and all(
                p.grad is not None and bool(torch.isfinite(p.grad).all())
                for p in model.parameters()),
                f"{case}: the autograd entry's loss or gradients are not "
                "finite")
            extra["autograd_loss"] = float(loss.detach())
            model.zero_grad(set_to_none=True)
            launches = {k: bindings.launch_counts[k]
                        for k in TRAIN_MODE_KERNELS}
            del walks, win, loss
        torch.cuda.synchronize()
        case_peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: v * taken for k, v in TRAIN_MODE_LAUNCHES[case].items()}
        if case == "windows":  # the biased step walks through K2, not K1
            want["uniform_walk_csr"] -= 1
            want["node2vec_walk_csr_mixture"] = 1
        if case in ("windows", "cbow"):  # the autograd entry's walk, windows
            want["uniform_walk_csr"] += 1  # and K16 and K17 on their own
            want["to_windows"] = want.get("to_windows", 0) + (
                case == "windows")
            want["sgns_windows_loss_fwd"] = want["sgns_windows_loss_bwd"] = 1
        require(launches == {k: want.get(k, 0) for k in TRAIN_MODE_KERNELS},
                f"{case}: the steps did not go through their kernels: "
                f"{launches}, wanted {want}")
        for k in totals:
            totals[k] += launches[k]
        require(all(np.isfinite(losses)) and all(
            np.isfinite(v) for k, v in extra.items() if k.endswith("loss")),
            f"{case}: a loss is not finite: {losses}")
        require(losses[-1] < losses[0], f"{case}: the loss did not fall: "
                f"{losses}")
        for name, param in model.named_parameters():
            require(bool(torch.isfinite(param).all()),
                    f"{case}: {name} is not finite")

        # The parts of one step, each alone on the step's own inputs.
        i = steps + 1
        walks = n2v.walks(targets, i)
        parts = {"walk_ms": time_ms(lambda: n2v.walks(targets, i), iters=3)}
        if case in ("windows", "cbow"):
            cbow = case == "cbow"
            make = ((lambda: tt.to_windows_cbow(walks, window, NUM_NODES,
                                                n2v.step_seed(i)))
                    if cbow else (lambda: n2v.windows(walks, i)))
            parts["windows_ms"] = time_ms(make, iters=3)
            win = make()
            ids = model._window_ids(*win)
            loss = bindings.sgns_windows_loss_fwd(model.in_emb, model.out_emb,
                                                  *ids, cbow)
            parts["loss_fwd_ms"] = time_ms(
                lambda: bindings.sgns_windows_loss_fwd(
                    model.in_emb, model.out_emb, *ids, cbow), iters=3)
            one = torch.ones_like(loss)
            calls = {
                "fwd": lambda: bindings.sgns_windows_loss_fwd(
                    model.in_emb, model.out_emb, *ids, cbow),
                "bwd": lambda: bindings.sgns_windows_loss_bwd(
                    model.in_emb, model.out_emb, *ids, one, cbow),
                "fused": lambda: bindings.sgns_windows_loss_and_grads(
                    model.in_emb, model.out_emb, *ids, cbow)}
            parts["loss_bwd_ms"] = time_ms(calls["bwd"], iters=3)
            parts["loss_and_grads_ms"] = time_ms(calls["fused"], iters=3)
            grads = calls["bwd"]()
            checks[case] = windows_errors(model.in_emb, model.out_emb, *ids,
                                          cbow)
            grad_bound = sgns_windows_bound(model.dtype, True, *ids,
                                            NUM_NODES)
            times[case] = {"fwd": (parts["loss_fwd_ms"], sgns_windows_bound(
                model.dtype, False, *ids, NUM_NODES)),
                "bwd": (parts["loss_bwd_ms"], grad_bound),
                "fused": (parts["loss_and_grads_ms"], grad_bound),
                # device ms a launch of each kernel of a warm call, by name
                "sub_launch_ms": {k: launch_ms(fn) for k, fn in
                                  calls.items()}}
            del win, loss, calls
        else:
            neg_ids = n2v.negatives(i)
            parts["negatives_ms"] = time_ms(lambda: n2v.negatives(i), iters=3)
            if "sparse" in case:
                parts["dedup_and_gathers_ms"] = time_ms(
                    lambda: model.gather_touched_rows(walks, neg_ids),
                    iters=3)
                ids, out_loc, neg_loc, in_sub, out_sub = (
                    model.gather_touched_rows(walks, neg_ids))
                tabs, loss_walks, loss_neg = (in_sub, out_sub), out_loc, neg_loc
            else:
                tabs = (model.in_emb.detach(), model.out_emb.detach())
                loss_walks, loss_neg = walks, neg_ids
            parts["loss_fwd_ms"] = time_ms(
                lambda: bindings.walk_sgns_loss_fwd(
                    *tabs, loss_walks, loss_neg, window, window - 1), iters=3)
            one = torch.ones((), dtype=torch.float32, device=dev)
            parts["loss_bwd_ms"] = time_ms(
                lambda: bindings.walk_sgns_loss_bwd(
                    *tabs, loss_walks, loss_neg, window, window - 1, one),
                iters=3)
            grads = bindings.walk_sgns_loss_bwd(*tabs, loss_walks, loss_neg,
                                                window, window - 1, one)
        if "sparse" in case:
            hyper = adam_hyper(model, sparse=True)
            (rows_in, center), (rows_out, _) = model.touched_row_writes(
                ids, out_loc, window)
            upd = [(model.in_emb.data, model.mu["in_emb"], model.nu["in_emb"],
                    grads[0], rows_in, center),
                   (model.out_emb.data, model.mu["out_emb"],
                    model.nu["out_emb"], grads[1], rows_out, None)]
            parts["adam_ms"] = time_ms(lambda: [
                bindings.adam_rows(*u, *hyper) for u in upd], iters=3)
            if case == "sparse":
                writes = (int(((rows_in < NUM_NODES) & (center > 0)).sum())
                          + int((rows_out < NUM_NODES).sum()))
                checks["adam_rows"] = {
                    name: adam_rows_errors(*u, hyper)
                    for name, u in zip(("in_emb", "out_emb"), upd)}
                times["adam_rows"] = (parts["adam_ms"], adam_rows_bound(
                    writes, TRAIN_CONFIG["dim"], model.in_emb.element_size(),
                    2 * ids.numel()))
                checks["adam_rows"]["writing_slots"] = writes
        else:
            hyper = adam_hyper(model, sparse=False)
            upd = [(p.data, model.mu[n], model.nu[n], g) for (n, p), g in
                   zip(model.named_parameters(), grads)]
            parts["adam_ms"] = time_ms(lambda: [
                bindings.adam_dense(*u, *hyper) for u in upd], iters=3)
            if case == "windows":
                checks["adam_dense"] = {
                    name: adam_dense_errors(*u, hyper)
                    for name, u in zip(("in_emb", "out_emb"), upd)}
                numel = sum(u[0].numel() for u in upd)
                lib_ms, lib_what = fused_adam_ms(
                    [u[0] for u in upd], [u[3] for u in upd],
                    [u[1] for u in upd], [u[2] for u in upd],
                    model.learning_rate)
                times["adam_dense"] = (parts["adam_ms"], adam_dense_bound(
                    numel, model.in_emb.element_size()), lib_ms, lib_what)
        cases[case] = {
            "losses": losses, "step_ms": step_ms, "warm_step_ms": step_ms[0],
            "chained_step_ms_median": statistics.median(step_ms[1:]),
            "parts_ms": parts, "alias_build_ms": alias_ms,
            "launches": launches, "peak_device_gib": case_peak, **extra}
        del n2v, model, grads, upd, walks
    torch.cuda.synchronize()
    emit("train_modes", config=TRAIN_CONFIG, num_nodes=NUM_NODES,
         walkers=TRAIN_WALKERS, cases=cases,
         timing="CUDA events around each step; parts: CUDA events, 1 "
                "warm-up, median of 3",
         alias_build_is="wall ms of Node2Vec.__init__ (the host Vose loop "
                        "over 2 M degree^0.75 weights, and the tables' copy "
                        "to the card)")
    limits = {"loss_rel_err": LOSS_REL_LIMIT, "grad_rel_err": GRAD_REL_LIMIT,
              "adam_max_ulps": ADAM_ULP_LIMIT}
    emit("train_mode_kernels", limits=limits, checks=checks)
    for case in ("windows", "cbow"):
        e = checks[case]
        require(e["loss_rel_err"] <= LOSS_REL_LIMIT
                and e["grad_rel_err"] <= GRAD_REL_LIMIT,
                f"K16/K17 != plain at the main path's shape ({case}): {e}")
    for key in ("adam_dense", "adam_rows"):
        for name in ("in_emb", "out_emb"):
            require(worst_adam(checks[key][name])[0] <= ADAM_ULP_LIMIT,
                    f"{key} != plain at the main path's shape ({name}): "
                    f"{checks[key][name]}")

    # K16 and K17 on their own (the autograd entry), and the two in one call
    # (the train steps' entry, its bound K17's), skip-gram on bfloat16 and
    # CBOW on float32 tables.
    rows = []
    for name, part, err_keys in (
            ("sgns_windows_loss_fwd", "fwd", ("loss_abs_err",)),
            ("sgns_windows_loss_bwd", "bwd", ("k17_grad_abs_err",)),
            ("sgns_windows_loss_and_grads", "fused",
             ("loss_abs_err", "fused_grad_abs_err"))):
        ms, bound_pair = times["windows"][part]
        source, replaces = KERNEL_FACTS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": totals[name],
            "max_abs_err": max(checks[c][k] for c in ("windows", "cbow")
                               for k in err_keys),
            "ms": ms, "plain_ms": checks["windows"]["plain_ms"],
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
            "library_ms": None,
            "cbow_ms": times["cbow"][part][0],
            "cbow_bound_ms": times["cbow"][part][1][0],
            "cbow_plain_ms": checks["cbow"]["plain_ms"],
            # device ms a launch of each kernel of a warm call, by name
            "sub_launch_ms": {c: times[c]["sub_launch_ms"][part]
                              for c in ("windows", "cbow")}})
    ms, bound_pair, lib_ms, lib_what = times["adam_dense"]
    source, replaces = KERNEL_FACTS["adam_dense"]
    rows.append({
        "name": "adam_dense", "route": "cuda", "source": source,
        "replaces": replaces, "launches": totals["adam_dense"],
        "max_abs_err": max(worst_adam(checks["adam_dense"][n])[1]
                           for n in ("in_emb", "out_emb")),
        "ms": ms, "plain_ms": sum(checks["adam_dense"][n]["plain_ms"]
                                  for n in ("in_emb", "out_emb")),
        "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
        "library_ms": lib_ms, "library_call": lib_what})
    ms, bound_pair = times["adam_rows"]
    source, replaces = KERNEL_FACTS["adam_rows"]
    rows.append({
        "name": "adam_rows", "route": "cuda", "source": source,
        "replaces": replaces, "launches": totals["adam_rows"],
        "max_abs_err": max(worst_adam(checks["adam_rows"][n])[1]
                           for n in ("in_emb", "out_emb")),
        "ms": ms, "plain_ms": sum(checks["adam_rows"][n]["plain_ms"]
                                  for n in ("in_emb", "out_emb")),
        "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
        "library_ms": None})
    return rows, totals


# --- the edge-list and KG-triples families (K7-K10) --------------------------

def family_graphs(graph, dead_quarter: bool = False):
    """The bench families derived from a CSR graph as the JAX package's
    bench.py derives them: the edge list (heads, col_idx) and the triples
    (heads, heads * 2654435761 mod 16, col_idx).  With ``dead_quarter`` the
    last quarter of the nodes loses its out-edges (dead ends, padding moves
    and restarts)."""
    n = graph.num_nodes
    heads = torch.repeat_interleave(
        torch.arange(n, device=graph.device),
        (graph.row_ptr[1:] - graph.row_ptr[:-1]).to(torch.int64))
    tails = graph.col_idx.to(torch.int64)
    if dead_quarter:
        keep = heads < (3 * n) // 4
        heads, tails = heads[keep], tails[keep]
    el = tt.EdgeListGraph.from_arrays(torch.stack([heads, tails], dim=1),
                                      num_nodes=n)
    rels = heads * RELATION_MULT % NUM_RELATIONS
    tg = tt.TriplesGraph.from_arrays(torch.stack([heads, rels, tails], dim=1),
                                     num_entities=n)
    return el, tg


def family_walk_calls(el, tg, targets, pad: int) -> dict:
    """The family walks of the main path through the public entry points:
    both edge-list entries, uniform (K7) and p=0.5 q=2 (K8, the graph's fat
    semantics and the raw arrays' oracle), and both triples entries (K9, the
    graph's fat semantics and the raw arrays' oracle)."""
    kw = dict(walk_length=WALK_LENGTH, seed=FAMILY_SEED, padding_idx=pad,
              restart=True)
    raw = (el.edge_list, el.node_edge_index, targets)
    return {
        "edge_uniform": lambda: tt.walk_edge_list(el, target_nodes=targets,
                                                  **kw),
        "edge_biased": lambda: tt.walk_edge_list(el, target_nodes=targets,
                                                 p=P, q=Q, **kw),
        "edge_uniform_raw": lambda: tt.walk_edge_list(*raw, **kw),
        "edge_biased_raw": lambda: tt.walk_edge_list(*raw, p=P, q=Q, **kw),
        "triples": lambda: tt.walk_triples(
            tg, target_nodes=targets, walk_length=WALK_LENGTH,
            seed=FAMILY_SEED, padding_idx=pad),
        "triples_raw": lambda: tt.walk_triples(
            tg.triples, tg.relation_tail_index, targets,
            walk_length=WALK_LENGTH, seed=FAMILY_SEED, padding_idx=pad),
    }


def family_window_calls(tg, walks, pad: int) -> dict:
    """K10 on the triples walks, both generators, W = WINDOW."""
    return {
        "windows_sg": lambda: tt.to_windows_triples(
            walks, WINDOW, tg.num_entities, pad, tg.triples, seed=WINDOW_SEED),
        "windows_cbow": lambda: tt.to_windows_triples_cbow(
            walks, WINDOW, tg.num_entities, pad, tg.triples, seed=WINDOW_SEED),
    }


def plain_edge_uniform(el, targets, pad, restart=True, seed=FAMILY_SEED,
                       walk_length=WALK_LENGTH, walker_offset=0):
    key = prng.derive_key(seed, prng.STREAM_EDGE_UNIFORM)
    return edge_list_walk.uniform_walk_edge_list_plain(
        el.edge_list, el.node_edge_index, targets, walk_length, key, pad,
        restart, walker_offset)


def plain_edge_biased(el, targets, pad, fat: bool, restart=True,
                      seed=FAMILY_SEED, walk_length=WALK_LENGTH,
                      max_rounds=common.DEFAULT_MAX_ROUNDS, walker_offset=0,
                      search_iters=None):
    """Plain K8 with the search depth of the entry that takes these
    semantics (the graph's for ``fat``, the raw arrays' otherwise) unless
    ``search_iters`` is given."""
    key = prng.derive_key(seed, prng.STREAM_EDGE_BIASED)
    if search_iters is None:
        search_iters = el.search_iters if fat else common.DEFAULT_SEARCH_ITERS
    return edge_list_walk.biased_walk_edge_list_plain(
        el.edge_list, el.node_edge_index, targets, walk_length, key, pad,
        restart, common.node2vec_accept_probs(P, Q), search_iters, max_rounds,
        fat, walker_offset)


def plain_triples(tg, targets, pad, fat: bool, seed=FAMILY_SEED,
                  walk_length=WALK_LENGTH, walker_offset=0):
    key = prng.derive_key(seed, prng.STREAM_TRIPLES)
    return triples_walk.uniform_walk_triples_plain(
        tg.triples, tg.relation_tail_index, targets, walk_length, key, pad,
        fat, walker_offset)


def plain_triple_windows(tg, walks, pad, cbow: bool, window=WINDOW,
                         table=None, seed=WINDOW_SEED):
    stream = (prng.STREAM_WINDOWS_TRIPLES_CBOW if cbow
              else prng.STREAM_WINDOWS_TRIPLES_SG)
    return windows.to_windows_triples_plain(
        walks, window, pad, tg.triples if table is None else table,
        prng.derive_key(seed, stream), cbow)


def phase_family_small_checks() -> None:
    """K7-K10 against their plain versions at small sizes, tolerance 0: a
    power-law graph whose last quarter of nodes has no out-edges and the
    grid-world KG, K7 on the raw rows and on the graph's packed rows and
    tails column, K9 on the raw triples (both semantics) and on the graph's
    ``triple_tab`` (fat), padding -1 and N, restart both ways, targets outside
    [0, N), round budgets of 1 and 2, searches cut short (K8 with 1 and 2
    trips), L = 1, 7, 8, 9, 80 and B = 1, 33, 4 097, windows of 1, 2, 5 and
    11 (and tables of one and two triples, where CBOW's draws collide; at
    W = 11 a warp's CBOW rows are staged in three pieces); K10
    also with walks of padding alone and with K10 CBOW's launch cut into
    groups of 999 windows, whose odd bases put every other group's rows off
    a 16-byte boundary."""
    base = tt.synthetic_power_law(20_000, 8, seed=3)
    el, tg = family_graphs(base, dead_quarter=True)
    grid = tt.synthetic_grid_kg(60, seed=2)[0]
    n = base.num_nodes
    dev = base.device
    rng = np.random.default_rng(11)

    def targets(num, high):
        return torch.tensor(rng.integers(-3, high + 3, num), dtype=torch.int32,
                            device=dev)

    errs = dict.fromkeys(FAMILY_KERNELS, 0)
    cases = 0
    edge_key = prng.derive_key(FAMILY_SEED, prng.STREAM_EDGE_UNIFORM)
    for length in (1, 7, 8, 9, 80):
        for num in (1, 33, 4097):
            t = targets(num, n)
            for pad, restart in ((-1, True), (n, False)):
                want = plain_edge_uniform(el, t, pad, restart,
                                          walk_length=length, walker_offset=5)
                got = [edge_list_walk.uniform_walk_edge_list(
                    el.edge_list, el.node_edge_index, t, length, FAMILY_SEED,
                    pad, restart, walker_offset=5)]
                got += [bindings.uniform_walk_edge_list(
                    table, el.node_edge_index, t, length, edge_key, pad,
                    restart, 5, layout=layout, bits=el.packed_bits)
                    for layout, table in (("packed", el.edge_tab),
                                          ("tails", el.tails))]
                errs["uniform_walk_edge_list"] = max(
                    errs["uniform_walk_edge_list"],
                    max_abs_err(got, [want] * len(got)))
                cases += len(got)
    for fat in (True, False):
        for length, num, rounds, pad, restart, iters in (
                (20, 4097, 1, -1, True, None), (20, 4097, 2, n, False, None),
                (9, 4097, 4096, -1, False, None), (8, 33, 4096, n, True, None),
                (7, 1, 4096, -1, True, None), (1, 4097, 4096, n, True, None),
                (80, 4097, 4096, n, True, None), (20, 4097, 4096, n, True, 1),
                (20, 4097, 4096, -1, False, 2)):
            t = targets(num, n)
            if iters is None:
                iters = (el.search_iters if fat
                         else common.DEFAULT_SEARCH_ITERS)
            got = edge_list_walk.biased_walk(
                el.edge_list, el.node_edge_index, t, P, Q, length,
                FAMILY_SEED, pad, restart, iters, rounds, fat,
                walker_offset=5, tails=el.tails if fat else None)
            want = plain_edge_biased(el, t, pad, fat, restart,
                                     walk_length=length, max_rounds=rounds,
                                     walker_offset=5, search_iters=iters)
            errs["biased_walk_edge_list"] = max(
                errs["biased_walk_edge_list"], max_abs_err(
                    [got.walks, got.exhausted.to(torch.int32)],
                    [want.walks, want.exhausted.to(torch.int32)]))
            cases += 1
    triple_walks = {}
    for graph in (tg, grid):
        for fat in (True, False):
            for length in (1, 7, 8, 9, 80):
                for num in (1, 33, 4097):
                    t = targets(num, graph.num_entities)
                    pad = graph.num_entities if num == 33 else -1
                    want = plain_triples(graph, t, pad, fat,
                                         walk_length=length, walker_offset=5)
                    walks_by_table = [triples_walk.uniform_walk_triples(
                        graph.triples, graph.relation_tail_index, t, length,
                        pad, True, FAMILY_SEED, walker_offset=5, fat=fat)]
                    if fat:  # the graph's own triple_tab
                        walks_by_table.append(
                            triples_walk.uniform_walk_triples_graph(
                                graph, t, length, pad, FAMILY_SEED,
                                walker_offset=5))
                    got = walks_by_table[0]
                    errs["uniform_walk_triples"] = max(
                        errs["uniform_walk_triples"],
                        max_abs_err(walks_by_table,
                                    [want] * len(walks_by_table)))
                    cases += len(walks_by_table)
                    if fat and num == 4097 and length in (9, 80):
                        triple_walks[graph is grid, pad] = (graph, got)
    for (_, pad), (graph, walks) in triple_walks.items():
        tables = (graph.triples, graph.triples[:2].contiguous(),
                  graph.triples[:1].contiguous())
        padded = torch.full_like(walks[:5], pad)
        for window in (1, 2, 5, 11):
            for cbow in (False, True):
                name = "to_windows_triples_cbow" if cbow else "to_windows_triples"
                stream = (prng.STREAM_WINDOWS_TRIPLES_CBOW if cbow
                          else prng.STREAM_WINDOWS_TRIPLES_SG)
                key = prng.derive_key(WINDOW_SEED, stream)
                for table, w, groups in (
                        *((tab, walks, bindings.TRIPLE_WINDOW_GROUP)
                          for tab in tables),
                        (graph.triples, walks, 999),
                        (graph.triples, padded, bindings.TRIPLE_WINDOW_GROUP)):
                    got = bindings.to_windows_triples(w, window, pad, table,
                                                      key, cbow, groups)
                    want = plain_triple_windows(graph, w, pad, cbow, window,
                                                table)
                    errs[name] = max(errs[name], max_abs_err(got, want))
                    cases += 1
    torch.cuda.synchronize()
    emit("family_kernels_small", max_abs_err=errs, tolerance=0, cases=cases)
    require(all(e == 0 for e in errs.values()), f"K7-K10 != plain: {errs}")


def edge_hops_ok(el, walks, targets, pad: int, restart: bool = True) -> bool:
    """Every hop of every 64th walk is an edge, or, from padding or a node
    without out-edges, a move to the jump node or to padding."""
    sample = walks[::64].to(torch.int64)
    a, b = sample[:, :-1].reshape(-1), sample[:, 1:].reshape(-1)
    jump = (targets[::64].to(torch.int64)[:, None].expand(-1, walks.shape[1] - 1)
            .reshape(-1) if restart else torch.full_like(a, pad))
    _, _, has = common.edge_ranges(el.node_edge_index, a)
    has &= a != pad
    edge = common.is_neighbor_edge(b, a, el.edge_list, el.node_edge_index, pad,
                                   el.search_iters)
    return bool(torch.where(has, edge, (b == jump) | (b == pad)).all())


def triple_hops_ok(tg, walks, pad: int) -> bool:
    """Every (head, relation, tail) step of every 64th walk is a triple of
    the graph, or (padding, padding) after padding or a head without
    triples."""
    n, r = tg.num_entities, tg.num_relations
    trip = tg.triples.to(torch.int64)
    keys = (trip[:, 0] * r + trip[:, 1]) * n + trip[:, 2]  # sorted
    w = walks[::64].to(torch.int64)
    h, rel, tail = (w[:, 0:-1:2].reshape(-1), w[:, 1::2].reshape(-1),
                    w[:, 2::2].reshape(-1))
    _, _, has = common.edge_ranges(tg.relation_tail_index, h)
    has &= (h != pad) & (h >= 0) & (h < n)
    q = (h * r + rel) * n + tail
    at = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    found = keys[at] == q
    return bool(torch.where(has, found, (rel == pad) & (tail == pad)).all())


def family_bound_walks(steps_words: int, num_walkers: int, walk_length: int,
                       row_words: int):
    """Least bytes of a family walk: ``steps_words`` words read a step, the
    targets read, the walks of ``row_words`` words written; one Threefry
    call a step."""
    steps = num_walkers * walk_length
    return bound(4 * (steps_words * steps + num_walkers
                      + num_walkers * row_words),
                 steps * THREEFRY_OPS)


def edge_biased_bound(el, walks, rounds, searches):
    """K8's least bytes and operations for what this run's data needed (as
    ``biased_bound`` counts K2's): the 2-word range of each walk position
    0..L-1, one tail word for the first hop and one a later round, the
    probed tails of one binary search over t's range at each step where
    some round needs it, the targets read and the walks written; one
    Threefry call and the acceptance a round, the search trips."""
    index = el.node_edge_index.to(torch.int64)
    deg = torch.where(index[:, 0] >= 0, index[:, 1] - index[:, 0] + 1,
                      0).to(torch.float32)
    depth = torch.log2(deg + 1).ceil()
    t_nodes = walks[:, :-2].to(torch.int64).clamp(0, el.num_nodes - 1)
    depth_t = depth[t_nodes]
    num_walkers, length1 = walks.shape
    drawn = float(rounds.sum(dtype=torch.float64))
    search_words = float((depth_t * (searches > 0)).sum(dtype=torch.float64))
    search_trips = float((depth_t * searches).sum(dtype=torch.float64))
    words = (2 * num_walkers * (length1 - 1) + num_walkers + drawn
             + search_words + walks.numel())
    return bound(4 * words, drawn * (THREEFRY_OPS + 12)
                 + SEARCH_TRIP_OPS * search_trips), {
        "walker_rounds": drawn, "rounds_per_step": drawn / rounds.numel(),
        "search_t_words": search_words,
        "searched_step_share": float((searches > 0).float().mean())}


def triple_windows_bound(tg, walks, cbow: bool):
    """K10's least bytes: the walks read once, the outputs written once,
    and each distinct triple row that the needed draws touch (12 bytes a
    row, counted once however many draws share it); one Threefry call a
    needed draw.  Skip-gram needs all 2W draws a window; CBOW needs its
    draws up to the first that differs from the target triple (all four
    where each collides)."""
    num_walks, width = walks.shape
    per_walk = (width - 1) // 2
    num_win = num_walks * per_walk
    draws = windows.CBOW_TRIPLE_ROUNDS if cbow else 2 * WINDOW
    key = prng.derive_key(WINDOW_SEED, prng.STREAM_WINDOWS_TRIPLES_CBOW if cbow
                          else prng.STREAM_WINDOWS_TRIPLES_SG)
    idx = prng.randint_from_bits(
        windows._neg_bits(key, num_win * draws, walks.device),
        tg.num_triples).view(num_win, draws)
    if cbow:
        rel_pos = 1 + 2 * torch.arange(per_walk, device=walks.device)
        target = torch.stack([walks[:, rel_pos - 1], walks[:, rel_pos],
                              walks[:, rel_pos + 1]], dim=-1).reshape(-1, 1, 3)
        collides = (tg.triples[idx] == target).all(dim=-1)
        # draw k is needed where draws 0..k-1 all collided
        needed = torch.cat([torch.ones_like(collides[:, :1]),
                            collides[:, :-1].cummin(dim=1).values], dim=1)
        idx = idx[needed]
        del target, collides, needed
    used = idx.numel()
    rows = torch.unique(idx).numel()
    del idx
    out_words = num_win * (3 + 6 * WINDOW + (3 if cbow else 6 * WINDOW))
    return bound(4 * (walks.numel() + out_words) + 12 * rows,
                 used * THREEFRY_OPS), rows, used


def check_family_outputs(el, tg, out, targets, pad, label: str) -> dict:
    """Shapes, the -1 mark absent, every hop an edge or a padding move,
    every output equal to its plain version (tolerance 0); returns the
    plain versions' host-clock times and K8's bound counts."""
    plain_ms, errs = {}, {}
    want_u, plain_ms["uniform_walk_edge_list"] = wall_ms(
        lambda: plain_edge_uniform(el, targets, pad))
    errs["uniform_walk_edge_list"] = max_abs_err(
        [out["edge_uniform"], out["edge_uniform_raw"]], [want_u, want_u])
    del want_u
    # With padding N and targets in [0, N), no walker ever holds an id
    # outside [0, N), so the fat and the oracle membership tests agree and
    # one plain run is the plain version of both entries (the small checks
    # hold both semantics apart).
    want_b, plain_ms["biased_walk_edge_list"] = wall_ms(
        lambda: plain_edge_biased(el, targets, pad, True))
    require(not bool(want_b.exhausted.any()), f"{label}: K8 budget ran out")
    errs["biased_walk_edge_list"] = max_abs_err(
        [out["edge_biased"], out["edge_biased_raw"]],
        [want_b.walks, want_b.walks])
    k8_bound = edge_biased_bound(el, want_b.walks, want_b.rounds,
                                 want_b.searches)
    del want_b
    # The two triples entries differ in semantics (the graph's fat, the raw
    # arrays' oracle), so each has its own plain run.
    want_t, plain_ms["uniform_walk_triples"] = wall_ms(
        lambda: plain_triples(tg, targets, pad, tg.fat))
    want_raw = plain_triples(tg, targets, pad, False)
    errs["uniform_walk_triples"] = max_abs_err(
        [out["triples"], out["triples_raw"]], [want_t, want_raw])
    del want_t, want_raw
    for name, key, cbow in (("to_windows_triples", "windows_sg", False),
                            ("to_windows_triples_cbow", "windows_cbow", True)):
        want, plain_ms[name] = wall_ms(lambda: plain_triple_windows(
            tg, out["triples"], pad, cbow))
        errs[name] = max_abs_err(out[key], want)
        del want
    num_win = NUM_WALKERS * WALK_LENGTH
    for name in ("edge_uniform", "edge_biased", "edge_uniform_raw",
                 "edge_biased_raw"):
        w = out[name]
        require(tuple(w.shape) == (NUM_WALKERS, WALK_LENGTH + 1)
                and w.dtype == torch.int32, f"{label} {name}: wrong shape")
        require(bool((w[:, 0] == targets).all()), f"{label} {name}: column 0")
        require(bool(((w >= 0) & (w <= pad)).all()),
                f"{label} {name}: id out of range or -1")
        require(edge_hops_ok(el, w, targets, pad),
                f"{label} {name}: a hop is neither an edge nor a padding move")
    for name in ("triples", "triples_raw"):
        w = out[name]
        require(tuple(w.shape) == (NUM_WALKERS, 2 * WALK_LENGTH + 1)
                and bool(((w >= 0) & (w <= pad)).all()),
                f"{label} {name}: wrong shape or id out of range")
        require(triple_hops_ok(tg, w, pad), f"{label} {name}: a step is not "
                "a triple of the graph nor a padding move")
    tgt, win, neg = out["windows_sg"]
    require(tuple(tgt.shape) == (num_win, 3)
            and tuple(win.shape) == tuple(neg.shape) == (num_win, 2 * WINDOW, 3),
            f"{label} windows: wrong shapes")
    _, neg_c, win_c = out["windows_cbow"]
    require(tuple(neg_c.shape) == (num_win, 3) and torch.equal(win_c, win),
            f"{label} CBOW windows: wrong shape or windows")
    emit("family_checks", graph=label, max_abs_err=errs, tolerance=0,
         plain_ms=plain_ms,
         padding_share={name: float((out[name][:, 1:] == pad).float().mean())
                        for name in ("edge_uniform", "edge_biased",
                                     "triples", "triples_raw")})
    require(all(e == 0 for e in errs.values()),
            f"{label}: a family kernel != its plain version: {errs}")
    return {"plain_ms": plain_ms, "errs": errs, "k8_bound": k8_bound}


def run_family_main_path(el, tg, targets, pad: int):
    """The family entry points once, each on the host clock."""
    out, first_ms = {}, {}
    for name, fn in family_walk_calls(el, tg, targets, pad).items():
        out[name], first_ms[name] = wall_ms(fn)
    for name, fn in family_window_calls(tg, out["triples"], pad).items():
        out[name], first_ms[name] = wall_ms(fn)
    return out, first_ms


def phase_family_main_path(graph):
    """The families' main path at the bench shape through the public entry
    points, with the launch counts set to 0 just before and read just
    after; then every output held against its plain version and checked;
    then the same on the copy of the graph whose last quarter of nodes has
    no out-edges."""
    targets = bench_targets(graph.device)
    pad = graph.num_nodes
    (el, tg), build_ms = wall_ms(lambda: family_graphs(graph))
    emit("family_graphs", edges=el.num_edges, triples=tg.num_triples,
         relations=tg.num_relations, max_degree=el.max_degree,
         search_iters=el.search_iters, fat=[el.fat, tg.fat],
         build_ms=build_ms, padding_idx=pad, column_bytes={
             name: t.numel() * t.element_size()
             for name, t in (("tails", el.tails), ("edge_tab", el.edge_tab),
                             ("triple_tab", tg.triple_tab))})
    torch.cuda.synchronize()
    bindings.reset_launch_counts()
    out, first_ms = run_family_main_path(el, tg, targets, pad)
    launches = {k: bindings.launch_counts[k] for k in FAMILY_KERNELS}
    emit("family_main_path", launches=launches, first_call_ms=first_ms)
    for name in FAMILY_KERNELS:
        require(launches[name] > 0, f"the families' path never launched "
                f"{name}")
    checked = check_family_outputs(el, tg, out, targets, pad, "bench")
    del out
    dead_el, dead_tg = family_graphs(graph, dead_quarter=True)
    dead_out, _ = run_family_main_path(dead_el, dead_tg, targets, pad)
    check_family_outputs(dead_el, dead_tg, dead_out, targets, pad,
                         "last_quarter_dead")
    require(bool((dead_out["edge_uniform"] == pad).any())
            and bool((dead_out["triples"] == pad).any()),
            "the dead-end copy never reached padding")
    del dead_out, dead_el, dead_tg
    return el, tg, targets, launches, checked


def phase_family_kernels(el, tg, targets, launches, checked) -> list[dict]:
    """K7-K10 timed at the bench shape: the device time of WALK_REPS calls of
    each entry point queued behind a spin kernel (``queued_ms``; the rows'
    ``ms``), the entry point's time (CUDA events around one call), node-
    steps/s; with bounds, plain versions' times and launch counts, one row a
    kernel."""
    pad = tg.num_entities
    calls = family_walk_calls(el, tg, targets, pad)
    walks = calls["triples"]()
    calls.update(family_window_calls(tg, walks, pad))
    device = {name: queued_ms(fn, WALK_REPS) for name, fn in calls.items()}
    entry = {name: time_ms(fn) for name, fn in calls.items()}
    steps = NUM_WALKERS * WALK_LENGTH
    emit("family_times", device_ms=device, entry_ms=entry,
         node_steps_per_s={name: steps / (device[name] / 1e3)
                           for name in ("edge_uniform", "edge_biased",
                                        "edge_uniform_raw", "edge_biased_raw",
                                        "triples", "triples_raw")},
         windows=NUM_WALKERS * WALK_LENGTH,
         device_timing=f"{WALK_REPS} calls queued behind a spin kernel, "
                       "median of 5, per call",
         entry_timing="CUDA events around one call, 1 warm-up, median of 5")
    k8_bound, k8_counts = checked["k8_bound"]
    sg_bound, sg_rows, sg_draws = triple_windows_bound(tg, walks, False)
    cb_bound, cb_rows, cb_draws = triple_windows_bound(tg, walks, True)
    emit("family_bounds", k8=k8_counts, windows_sg={
        "needed_draws": sg_draws, "distinct_triple_rows": sg_rows},
        windows_cbow={"needed_draws": cb_draws,
                      "distinct_triple_rows": cb_rows})
    specs = (
        ("uniform_walk_edge_list", "edge_uniform", "edge_uniform_raw",
         family_bound_walks(3, NUM_WALKERS, WALK_LENGTH, WALK_LENGTH + 1)),
        ("biased_walk_edge_list", "edge_biased", "edge_biased_raw", k8_bound),
        ("uniform_walk_triples", "triples", "triples_raw",
         family_bound_walks(4, NUM_WALKERS, WALK_LENGTH,
                            2 * WALK_LENGTH + 1)),
        ("to_windows_triples", "windows_sg", None, sg_bound),
        ("to_windows_triples_cbow", "windows_cbow", None, cb_bound),
    )
    rows = []
    for name, key, raw_key, bound_pair in specs:
        source, replaces = KERNEL_FACTS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": checked["errs"][name], "ms": device[key],
            "plain_ms": checked["plain_ms"][name], "bound_ms": bound_pair[0],
            "bound_by": bound_pair[1], "library_ms": None,
            "entry_point_ms": entry[key]})
        if raw_key:
            rows[-1]["raw_arrays_ms"] = device[raw_key]
            rows[-1]["raw_arrays_entry_point_ms"] = entry[raw_key]
    return rows


# --- the routed edge-list and KG-triples engines (K13-K15) -------------------

# leg: (engine, restart, filters of the biased engine).  All at the families'
# bench setting: padding N, seed 7, the bench targets' first ROUTED_WALKERS.
ROUTED_FAMILY_LEGS = {
    "edge_uniform_restart": ("edge_list", True, None),
    "edge_uniform_absorbing": ("edge_list", False, None),
    "edge_n2v": ("edge_list_node2vec", True, "blooms"),
    "edge_n2v_saturated": ("edge_list_node2vec", True, "saturated"),
    "triples": ("triples", True, None),
}
ROUTED_FAMILY_STREAMS = {"triples": prng.STREAM_TRIPLES,
                         "edge_list": prng.STREAM_EDGE_UNIFORM,
                         "edge_list_node2vec": prng.STREAM_EDGE_BIASED}
# The leg each family kernel's row is measured on (serial schedule).
ROUTED_FAMILY_ROW_LEGS = {"routed_triples_batch": "triples",
                          "routed_edge_list_batch": "edge_uniform_restart",
                          "routed_edge_list_node2vec_batch": "edge_n2v"}


def routed_family_parts(el, tg, shards=NUM_SHARDS):
    """Both families partitioned over ``shards`` and the edge list's cuckoo
    tables and Bloom filters, built on the card; with build times and
    sizes."""
    parts, part_ms = wall_ms(lambda: {
        "edge": tt.PartitionedEdgeList.from_edge_list(el, shards),
        "triples": tt.PartitionedTriples.from_triples(tg, shards)})
    hashes, hash_ms = wall_ms(
        lambda: tt.build_edge_list_partition_hashes(parts["edge"], el))
    blooms, bloom_ms = wall_ms(
        lambda: tt.build_edge_list_partition_blooms(parts["edge"], el))
    parts["tables"] = (hashes, blooms)
    return parts, {
        "partition_ms": part_ms, "hash_build_ms": hash_ms,
        "bloom_build_ms": bloom_ms, "hash_log_size": hashes[2],
        "hash_bytes": hashes[0].numel() * 4, "bloom_bytes": blooms.numel() * 4,
        "tails_bytes": sum(c.numel() * 4 for c in parts["edge"].col),
        "rel_tail_bytes": sum(c.numel() * 4 for c in parts["triples"].col)}


def routed_family_call(leg, parts, targets, schedule="serial",
                       walk_length=WALK_LENGTH):
    """The leg once through its public entry point."""
    engine, restart, filters = ROUTED_FAMILY_LEGS[leg]
    kw = dict(seed=FAMILY_SEED, schedule=schedule)
    if engine == "triples":
        return tt.walk_triples_partitioned_routed(
            parts["triples"], targets, walk_length, NUM_NODES, **kw)
    if engine == "edge_list":
        return tt.walk_edge_list_partitioned_routed(
            parts["edge"], targets, walk_length, NUM_NODES, restart=restart,
            **kw)
    hashes, blooms = parts["tables"]
    return tt.walk_edge_list_node2vec_partitioned_routed(
        parts["edge"], hashes, targets, P, Q, walk_length, NUM_NODES,
        restart=restart, spec_rounds=SPEC_ROUNDS,
        blooms=blooms if filters == "blooms" else None, **kw)


def routed_family_walk(leg, parts, targets, schedule, body, config=None,
                       walk_length=WALK_LENGTH, pad=NUM_NODES):
    """A ``RoutedWalk`` of the leg with the phase ``body`` given, configured
    as its entry point resolves ``config``, with padding ``pad``."""
    engine, restart, filters = ROUTED_FAMILY_LEGS[leg]
    pg = parts["triples" if engine == "triples" else "edge"]
    cfg = tt.RoutedConfig.resolve(config, int(targets.shape[0]),
                                  pg.num_shards, walk_length)
    routing = None
    if engine == "edge_list_node2vec":
        if config is None or config.max_phases <= 0:
            cfg = partition_v2._biased_phase_budget(cfg, walk_length,
                                                    SPEC_ROUNDS)
        hashes, blooms = parts["tables"]
        routing = partition_v2.node2vec_routing(
            pg, P, Q, SPEC_ROUNDS, hashes,
            blooms if filters == "blooms" else None)
    key = prng.derive_key(FAMILY_SEED, ROUTED_FAMILY_STREAMS[engine])
    return partition_v2.RoutedWalk(pg, targets, walk_length, key, cfg,
                                   schedule, body, node2vec=routing,
                                   engine=engine, padding=pad,
                                   restart=restart)


def batch_leg_launches(leg, parts, targets, schedule) -> dict:
    """One warm leg of a family engine through its entry point, with the
    launch counts set to 0 just before and read just after: its kernel's
    calls (phase 0 a pipeline and the batch launches) and K4's."""
    kernel = bindings.ROUTED_ENGINES[ROUTED_FAMILY_LEGS[leg][0]].kernel
    torch.cuda.synchronize()
    bindings.reset_launch_counts()
    routed_family_call(leg, parts, targets, schedule)
    torch.cuda.synchronize()
    counts = dict(bindings.launch_counts)
    return {"launches": counts[kernel],
            "exchange_launches": counts["all_to_all_chunks"],
            "other_launches": sum(v for k, v in counts.items()
                                  if k not in (kernel, "all_to_all_chunks"))}


def batch_leg_split_ms(leg, parts, targets, schedule) -> dict:
    """Where a warm family leg's host time goes, as ``RoutedWalk.run``
    spends it: the walk's set-up (configuration, buffers, packed launches,
    the occupancy query), phase 0 (``start``: tensor code, its launches and,
    overlapped, K4), the batch launch up to the read of the phase counter,
    and the result's gather; host clock, the device synchronized at each
    boundary."""
    torch.cuda.synchronize()
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    run = routed_family_walk(leg, parts, targets, schedule, "kernel")
    mark()
    run.start()
    phases, inflight = run._read()
    mark()
    while inflight > 0 and phases < run.max_phases:
        phases, inflight = run._run_batch(run.max_phases - phases)
    mark()
    run.result()
    mark()
    spans = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return dict(zip(("set_up", "phase0", "batch", "result"), spans))


def single_device_family_walk(leg, el, tg, targets):
    """The single-device walk the leg equals (padding N, targets in
    [0, N)): K7, K8 or K9 through the graph entry."""
    engine, restart, _ = ROUTED_FAMILY_LEGS[leg]
    if engine == "triples":
        return tt.walk_triples(tg, target_nodes=targets,
                               walk_length=WALK_LENGTH, seed=FAMILY_SEED,
                               padding_idx=NUM_NODES)
    pq = (P, Q) if engine == "edge_list_node2vec" else (1.0, 1.0)
    return tt.walk_edge_list(el, target_nodes=targets, p=pq[0], q=pq[1],
                             walk_length=WALK_LENGTH, seed=FAMILY_SEED,
                             padding_idx=NUM_NODES, restart=restart)


def routed_family_small_checks(device) -> dict:
    """K13, K14 (restart and absorbing) and K15 (Bloom filters and saturated
    ones) against the plain bodies phase by phase on the small graph with
    dead ends: every leg at D = 8 under both schedules, and one leg of each
    kernel at L = 1, D = 1 and 16, with a pair capacity that fills the
    carry pool and one of many tiles, and at D = 32, where the D * D box
    counts outnumber a block's threads; K14 with one whose pool overflows
    (both runs must raise alike; no other case may raise).  Every leg also
    runs whole, one batch launch, against the plain run.  Returns the
    largest difference of each kernel."""
    graph = small_routed_graph(device)
    el, tg = family_graphs(graph)
    walkers = 1024
    rng = np.random.default_rng(10)
    targets = {n: common.as_int32(rng.integers(0, graph.num_nodes, n), device)
               for n in (walkers, 8 * walkers)}
    parts = {d: routed_family_parts(el, tg, d)[0] for d in (1, 2, 8, 16, 32)}
    t0 = time.perf_counter()
    carry = tt.RoutedConfig(pair_capacity=16, carry_capacity=walkers)
    overflow = tt.RoutedConfig(pair_capacity=2, carry_capacity=5)
    tiles = tt.RoutedConfig(pair_capacity=160, carry_capacity=8 * walkers)
    every = tuple(ROUTED_FAMILY_LEGS)
    one_each = ("triples", "edge_uniform_restart", "edge_n2v")
    # (shards, schedules, walk length, config, legs)
    cases = [(8, partition_v2.SCHEDULES, 12, None, every),
             (8, ("serial",), 1, None, one_each),
             (8, partition_v2.SCHEDULES, 12, carry, one_each),
             (8, ("serial",), 12, overflow, ("edge_uniform_restart",)),
             (1, ("serial",), 12, None, one_each),
             (16, ("overlapped",), 12, None, one_each),
             (32, ("serial",), 12, None, one_each),
             (2, ("serial",), 12, tiles, one_each)]
    errs = dict.fromkeys(ROUTED_FAMILY_KERNELS, 0)
    for d, schedules, length, cfg, legs in cases:
        t = targets[8 * walkers if cfg is tiles else walkers]
        for schedule in schedules:
            for leg in legs:
                kernel = bindings.ROUTED_ENGINES[
                    ROUTED_FAMILY_LEGS[leg][0]].kernel
                make = (lambda body: routed_family_walk(
                    leg, parts[d], t, schedule, body, cfg, length,
                    graph.num_nodes))
                got = routed_lockstep(make)
                got["max_abs_err"] = max(got["max_abs_err"],
                                         whole_leg_err(make, got["plain"]))
                raised = isinstance(got.get("result"), str)
                if cfg is overflow:
                    require(raised and "incomplete" in got["result"],
                            f"{leg}: an overflowing pool did not raise")
                else:
                    require(not raised, f"{leg} (D={d}, {schedule}, "
                            f"L={length}) raised: {got.get('result')}")
                errs[kernel] = max(errs[kernel], got["max_abs_err"])
    emit("routed_family_small", seconds=time.perf_counter() - t0,
         max_abs_err=errs)
    return errs


def phase_routed_families_main_path(graph):
    """The routed family legs once through the public entry points (serial
    schedule, D=NUM_SHARDS, ROUTED_WALKERS walkers, L=WALK_LENGTH), with the
    launch counts set to 0 just before and read just after."""
    targets = bench_targets(graph.device)[:ROUTED_WALKERS]
    el, tg = family_graphs(graph)
    parts, facts = routed_family_parts(el, tg)
    emit("routed_family_tables", **facts)
    torch.cuda.synchronize()
    bindings.reset_launch_counts()
    out, first_ms = {}, {}
    for leg in ROUTED_FAMILY_LEGS:
        out[leg], first_ms[leg] = wall_ms(
            lambda: routed_family_call(leg, parts, targets))
    launches = dict(bindings.launch_counts)
    emit("routed_family_main_path", launches={
        k: launches[k] for k in (*ROUTED_FAMILY_KERNELS, "all_to_all_chunks")},
        first_call_ms=first_ms)
    # K13-K15: one call for phase 0 and one batch launch a leg, which
    # exchanges itself (no K4 launch on a serial leg).
    calls = Counter(bindings.ROUTED_ENGINES[engine].kernel
                    for engine, _, _ in ROUTED_FAMILY_LEGS.values())
    for name in ROUTED_FAMILY_KERNELS:
        require(launches[name] == 2 * calls[name] > 0,
                f"{name}: {2 * calls[name]} calls expected (phase 0 and one "
                f"batch a leg), got {launches[name]}")
    require(launches["all_to_all_chunks"] == 0,
            "no exchange launch expected on the family main path")
    return el, tg, parts, targets, out, launches


def check_routed_family_legs(el, tg, parts, targets, out, label) -> dict:
    """Each leg's walks (serial, through the entry point): shape, ids in
    [0, N], every walker terminated and nothing dropped, every hop an edge,
    a triple or a padding move, equal to the single-device walk (K7, K8,
    K9) where the restart legs' setting makes them equal; then the kernel
    against the plain body on the card state by state for the first
    ROUTED_CHECKED_PHASES phases of each leg and schedule, the whole plain
    leg (serial) against the kernel leg, and the overlapped kernel leg
    against the serial one.  Returns the checks and plain legs' times."""
    checks, plain = {}, {}
    for leg, (engine, restart, _) in ROUTED_FAMILY_LEGS.items():
        walks, info = out[leg]
        cols = 2 * WALK_LENGTH + 1 if engine == "triples" else WALK_LENGTH + 1
        require(tuple(walks.shape) == (ROUTED_WALKERS, cols)
                and bool(((walks >= 0) & (walks <= NUM_NODES)).all()),
                f"{label} {leg}: wrong shape or id out of range")
        require(info["terminated"] == ROUTED_WALKERS
                and info["overflow_dropped"] == 0,
                f"{label} {leg}: walkers lost: {info}")
        hops = (triple_hops_ok(tg, walks, NUM_NODES) if engine == "triples"
                else edge_hops_ok(el, walks, targets, NUM_NODES, restart))
        require(hops, f"{label} {leg}: a hop is neither an edge, a triple "
                "nor a padding move")
        same = max_abs_err(walks, single_device_family_walk(leg, el, tg,
                                                            targets))
        require(same == 0, f"{label} {leg}: the routed walks differ from "
                "the single-device kernel's")
        lock = {}
        for schedule in partition_v2.SCHEDULES:
            lock[schedule] = routed_lockstep(
                lambda body: routed_family_walk(leg, parts, targets,
                                                schedule, body),
                ROUTED_CHECKED_PHASES)
        (pw, pinfo), ms = wall_ms(lambda: routed_family_walk(
            leg, parts, targets, "serial", "plain").run())
        over_w, over_info = routed_family_call(leg, parts, targets,
                                               "overlapped")
        # The overlapped schedule takes its own phase count.
        same_counts = {k: v for k, v in over_info.items()
                       if k not in ("phases", "collectives_per_step")} == {
            k: v for k, v in info.items()
            if k not in ("phases", "collectives_per_step")}
        leg_err = max(max_abs_err(walks, pw), int(pinfo != info),
                      max_abs_err(over_w, walks), int(not same_counts))
        plain[leg] = {"ms": ms, "phases": pinfo["phases"]}
        checks[leg] = {"lockstep": lock, "whole_leg_err": leg_err,
                       "overlapped_phases": over_info["phases"],
                       "max_abs_err": max(leg_err, *(
                           c["max_abs_err"] for c in lock.values()))}
    emit("routed_family_checks", graph=label, checks=checks, plain_leg_ms={
        k: v["ms"] for k, v in plain.items()}, tolerance=0,
        padding_share={leg: float((out[leg][0][:, 1:] == NUM_NODES)
                                  .float().mean()) for leg in out})
    require(all(c["max_abs_err"] == 0 for c in checks.values()),
            f"{label}: a family phase kernel differs from the plain body: "
            f"{checks}")
    return {"checks": checks, "plain": plain}


def phase_routed_families(graph) -> list[dict]:
    """The routed edge-list and KG-triples legs at the bench shape (D=8,
    ROUTED_WALKERS walkers, L=WALK_LENGTH, padding N, seed 7): the main path
    through the entry points, every leg checked (``check_routed_family_legs``)
    on the bench families and on the copy whose last quarter of nodes has no
    out-edges; each leg warm under both schedules (host clock, three after
    one warm-up); device time by CUDA events around the batch launch of one
    warm serial leg; the card's launches, idle share and the batch kernel's
    device time a phase by torch.profiler over one warm leg a schedule; the
    serial legs at one and at every resident block an SM.  Returns K13-K15's
    rows."""
    el, tg, parts, targets, out, launches = \
        phase_routed_families_main_path(graph)
    checked = check_routed_family_legs(el, tg, parts, targets, out, "bench")

    timed = {}
    for leg in ROUTED_FAMILY_LEGS:
        for schedule in partition_v2.SCHEDULES:
            routed_family_call(leg, parts, targets, schedule)  # warm
            runs = [wall_ms(lambda: routed_family_call(leg, parts, targets,
                                                       schedule))
                    for _ in range(3)]
            info = runs[0][0][1]
            ms = [m for _, m in runs]
            timed[f"{leg}_{schedule}"] = {
                "info": info, "warm_leg_ms": ms,
                "node_steps_per_s": ROUTED_WALKERS * WALK_LENGTH
                / (statistics.median(ms) / 1e3),
                "exchange_bytes_per_step": info["exchange_bytes"]
                / max(info["log_entries"], 1)}
            require(all(r[0][1] == info for r in runs)
                    and all(max_abs_err(r[0][0], out[leg][0]) == 0
                            for r in runs),
                    f"{leg} {schedule}: the warm legs differ")
    per_call, profiled = {}, {}
    for kernel, leg in ROUTED_FAMILY_ROW_LEGS.items():
        (_, info), ms = phase_call_ms(
            bindings, kernel, lambda: routed_family_call(leg, parts, targets))
        phases = info["phases"]
        # One batch launch of the whole walk (phase 0 is routed_start's,
        # not timed here).
        require(len(ms) == 1, f"{kernel}: {len(ms)} calls for {phases} "
                f"phases")
        per_call[kernel] = {"calls": len(ms),
                            "device_ms_per_phase": ms[0] / phases}
        for schedule in partition_v2.SCHEDULES:
            (_, info), leg_ms, kernels = profile_device(
                lambda: routed_family_call(leg, parts, targets, schedule))
            busy = sum(v for _, v in kernels.values())
            n = sum(c for c, _ in kernels.values())
            phases = info["phases"]

            def per_phase(*parts):
                hits = [v for k, v in kernels.items()
                        if any(part in k for part in parts)]
                return {"launches": sum(c for c, _ in hits),
                        "device_ms_per_phase": sum(m for _, m in hits)
                        / phases}

            profiled[f"{kernel}_{schedule}"] = None if busy <= 0 else {
                "leg": leg, "schedule": schedule, "phases": phases,
                "leg_ms": leg_ms, "device_launches": n,
                "device_launches_per_phase": n / phases,
                "device_busy_ms": busy,
                "device_idle_share": 1 - busy / leg_ms,
                "batch": per_phase("batch_kernel"),
                "exchange": per_phase("all_to_all_chunks"),
                "phase0": per_phase("routed_stage_hist_kernel",
                                    "routed_compact_kernel")}
    # The batch kernels' serial legs warm with one block an SM and with every
    # resident block: the grid barriers' cost against the blocks' share of
    # the work.
    sweep = {}
    for leg in ROUTED_FAMILY_ROW_LEGS.values():
        for per_sm in (1, None):
            def leg_run():
                run = routed_family_walk(leg, parts, targets, "serial",
                                         "kernel")
                if per_sm is not None:
                    run._batch = run._batch._replace(
                        grid=per_sm * run._batch.geometry["sms"])
                return run.run()
            leg_run()  # warm
            runs = [wall_ms(leg_run) for _ in range(3)]
            require(all(r[0][1] == out[leg][1]
                        and max_abs_err(r[0][0], out[leg][0]) == 0
                        for r in runs),
                    f"{leg}: {per_sm} blocks an SM changed the walks")
            sweep.setdefault(leg, {})[per_sm or "resident"] = [
                m for _, m in runs]
    # What the batch kernels launch with, a leg by schedule: the launches
    # counted over one warm leg (a serial walk is phase 0 and one batch; an
    # overlapped one phase 0 twice, one K4 and one batch), and its host time
    # by part, median of three warm legs.
    batch_legs = {}
    for kernel, leg in ROUTED_FAMILY_ROW_LEGS.items():
        run = routed_family_walk(leg, parts, targets, "serial", "kernel")
        geometry = dict(run._batch.geometry, grid=run._batch.grid)
        del run, geometry["function"]
        for schedule in partition_v2.SCHEDULES:
            prof = profiled[f"{kernel}_{schedule}"]
            counted = batch_leg_launches(leg, parts, targets, schedule)
            want = ({"launches": 2, "exchange_launches": 0}
                    if schedule == "serial" else
                    {"launches": 3, "exchange_launches": 1})
            require({k: counted[k] for k in want} == want,
                    f"{leg} {schedule}: {want} launches expected (phase 0 "
                    f"a pipeline, one batch, K4 once when overlapped), "
                    f"counted {counted}")
            batch_leg_split_ms(leg, parts, targets, schedule)  # warm
            splits = [batch_leg_split_ms(leg, parts, targets, schedule)
                      for _ in range(3)]
            batch_legs[f"{leg}_{schedule}"] = {
                "kernel": kernel, "launches_a_leg": counted["launches"],
                "exchange_launches_a_leg": counted["exchange_launches"],
                "phases": timed[f"{leg}_{schedule}"]["info"]["phases"],
                **geometry,
                "barriers_a_phase": BATCH_BARRIERS_PER_PHASE[schedule],
                "warm_leg_ms": timed[f"{leg}_{schedule}"]["warm_leg_ms"],
                "split_ms": {k: statistics.median(x[k] for x in splits)
                             for k in splits[0]},
                # null where the profiler saw no device time
                "exchange_device_launches_a_leg":
                    prof and prof["exchange"]["launches"],
                "batch_kernel_device_ms": prof and (
                    prof["batch"]["device_ms_per_phase"] * prof["phases"]),
                "device_us_a_phase":
                    prof and prof["batch"]["device_ms_per_phase"] * 1e3,
                "device_idle_share": prof and prof["device_idle_share"]}
    emit("routed_families", walkers=ROUTED_WALKERS, shards=NUM_SHARDS,
         walk_length=WALK_LENGTH, padding_idx=NUM_NODES, seed=FAMILY_SEED,
         spec_rounds=SPEC_ROUNDS, p=P, q=Q, legs=timed, per_call=per_call,
         profiled=profiled, batch_legs=batch_legs,
         batch_blocks_per_sm_warm_leg_ms=sweep,
         timing="warm legs on the host clock, three after one warm-up; "
         "per_call: CUDA events around every call of one warm serial leg "
         "(one batch a leg); profiled: "
         "torch.profiler, device activity only, one warm leg a schedule "
         "(null if it saw no device time); "
         "batch_legs: launches counted over one warm leg, split_ms on the "
         "host clock with the device synchronized between the parts, "
         "median of three, barriers_a_phase the kernel's steps (not "
         "counted)")

    dead_el, dead_tg = family_graphs(graph, dead_quarter=True)
    dead_parts, _ = routed_family_parts(dead_el, dead_tg)
    dead_out = {leg: routed_family_call(leg, dead_parts, targets)
                for leg in ROUTED_FAMILY_LEGS}
    dead = check_routed_family_legs(dead_el, dead_tg, dead_parts, targets,
                                    dead_out, "last_quarter_dead")
    # (The biased law moves an accepted padding on to the target at once.)
    require(all(bool((dead_out[leg][0] == NUM_NODES).any()) for leg in (
        "edge_uniform_restart", "edge_uniform_absorbing", "triples")),
            "the dead-end copy never reached padding")
    del dead_out, dead_parts, dead_el, dead_tg

    rows = []
    for kernel, leg in ROUTED_FAMILY_ROW_LEGS.items():
        engine = ROUTED_FAMILY_LEGS[leg][0]
        width = bindings.ROUTED_ENGINES[engine].width
        info = out[leg][1]
        phases = info["phases"]
        prof = profiled[f"{kernel}_serial"]
        # Bytes a leg needs: every record written once to an outbox and
        # read once on arrival, every position logged (triples: a relation
        # and an entity), and a step's meta row, payload row (triples: 8 B,
        # edge list: a 4-byte tail) and, biased, its 16-byte filter.
        logged = info["log_entries"] * (2 if engine == "triples" else 1)
        per_step = {"triples": 16, "edge_list": 12,
                    "edge_list_node2vec": 28}[engine]
        moved = (2 * info["exchanged_records"] * width * 4 + logged * 4
                 + info["log_entries"] * per_step)
        errs = [checked["checks"][name]["max_abs_err"]
                for name, (e, _, _) in ROUTED_FAMILY_LEGS.items()
                if e == engine]
        errs += [dead["checks"][name]["max_abs_err"]
                 for name, (e, _, _) in ROUTED_FAMILY_LEGS.items()
                 if e == engine]
        source, replaces = KERNEL_FACTS[kernel]
        rows.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": max(errs),
            # The batch kernel's device time a phase; CUDA events around
            # its launch stand in where the profiler saw no device time.
            "ms": (per_call[kernel]["device_ms_per_phase"] if prof is None
                   else prof["batch"]["device_ms_per_phase"]),
            "ms_by": "cuda_events" if prof is None else "profiler",
            "call_ms_events": per_call[kernel]["device_ms_per_phase"],
            "plain_ms": checked["plain"][leg]["ms"]
            / checked["plain"][leg]["phases"],
            "bound_ms": moved / phases / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "leg_ms": statistics.median(timed[f"{leg}_serial"]["warm_leg_ms"]),
            "plain_leg_ms": checked["plain"][leg]["ms"], "phases": phases,
            "launches_by_run": {"routed_families": launches[kernel]}})
    return rows


# --- the KG-embedding trainer (K19, K20) -------------------------------------

def plain_kge_grads(fn, tables):
    """(loss, float32 gradients) of a plain KGE loss ``fn(leaves,
    rounding)`` on float32 copies of ``tables`` (exact for bfloat16) that
    round where an operation on tables of their own type rounds: the
    kernels' arithmetic, with float32 gradient sums."""
    leaves = [t.detach().to(torch.float32, copy=True).requires_grad_(True)
              for t in tables]
    loss = fn(leaves, tables[0].dtype)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def kge_errors(loss_fn, grads_fn, plain_fn, tables) -> dict:
    """A KGE kernel's two entries against its plain version on the same
    inputs: the loss-only launch twice (the same bits), the value-and-grad
    call (its loss the loss-only bits), and the plain loss and gradients."""
    loss, again = loss_fn(), loss_fn()
    fused_loss, grads = grads_fn()
    (want, want_grads), plain_ms = wall_ms(lambda: plain_kge_grads(plain_fn,
                                                                   tables))
    require(bool(torch.isfinite(loss)) and bool(torch.isfinite(want)),
            "KGE loss is not finite")
    require(torch.equal(loss, again), "the KGE loss is not repeatable")
    require(torch.equal(fused_loss, loss),
            f"the value-and-grad loss {float(fused_loss)!r} is not the "
            f"loss-only launch's {float(loss)!r} bit for bit")
    loss_abs = abs(float(loss) - float(want))
    # JAX's TransE gradient is NaN where ||d|| = 0 (bfloat16 tables meet it
    # at small D): the kernel's NaN entries must be the plain version's.
    grad_abs, grad_rel, nans = [], [], 0
    for g, w in zip(grads, want_grads):
        nan = torch.isnan(w)
        require(torch.equal(torch.isnan(g), nan), "the KGE gradient's NaN "
                "entries are not the plain version's")
        nans += int(nan.sum())
        diff, ref = (g - w).abs()[~nan], w.abs()[~nan]
        grad_abs.append(float(diff.max()) if diff.numel() else 0.0)
        grad_rel.append(grad_abs[-1] / max(
            float(ref.max()) if ref.numel() else 0.0, 1e-30))
    del grads, want_grads
    return {"loss": float(loss), "plain_loss": float(want),
            "loss_abs_err": loss_abs,
            "loss_rel_err": loss_abs / max(abs(float(want)), 1e-30),
            "grad_abs_err": max(grad_abs), "grad_rel_err": max(grad_rel),
            "grad_nan_entries": nans, "plain_ms": plain_ms}


def kge_pair_calls(tables, pos, neg, valid, objective, margin):
    """K19's two entries and its plain version on these inputs, as
    ``kge_errors`` takes them."""
    args = (*tables, pos, neg, valid, objective, margin)
    return (lambda: bindings.kge_pair_loss(*args),
            lambda: (lambda out: (out[0], out[1:]))(
                bindings.kge_pair_loss_and_grads(*args)),
            lambda leaves, rounding: kge.pair_loss_plain(
                objective, margin, *leaves, pos, neg, valid, rounding))


def kge_windows_calls(tables, batch, pad, cbow):
    """K20's two entries and its plain version on these windows."""
    return (lambda: bindings.kge_windows_loss(tables, *batch, pad, cbow),
            lambda: bindings.kge_windows_loss_and_grads(tables, *batch, pad,
                                                        cbow),
            lambda leaves, rounding: kge.windows_loss_plain(
                leaves, *batch, pad, cbow, rounding))


def worse(worst: dict, err: dict) -> None:
    for key in ("loss_rel_err", "grad_rel_err"):
        worst[key] = max(worst[key], err[key])
    worst["grad_nan_entries"] += err["grad_nan_entries"]


def kge_budget_relations(width: int, dtype, tables: int) -> int:
    """The most relation rows of ``width`` elements of ``dtype`` (in fresh,
    aligned tables) whose gradient sums fit the shared budget."""
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    vec = wide if width % wide == 0 else 1
    return bindings.KGE_REL_SHARED_BYTES // bindings.kge_rel_shared_bytes(
        1, width, vec, tables)


def kge_small_checks(device) -> dict:
    """K19 and K20, both entries and both table types, against their plain
    versions at the edges: D = 1, 7, 128, 130, 512 (RotatE: 2, 128, 130,
    512); one positive, K = 1, 4 and 33; a hub entity every positive hits;
    a relation every positive (window slot) has; an all-padding batch; W =
    1, 3 and 11; a window of padding only, padded and out-of-range
    components, a hub entity in every window; and at D = 128 and 130 the
    relation vocabularies just under the shared budget (the relation sums in
    shared memory) and just over it (global row adds): the paths each case
    took are counted."""
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    n, r = 500, 7
    pad = n
    worst = {fam: {"loss_rel_err": 0.0, "grad_rel_err": 0.0,
                   "grad_nan_entries": 0, "paths": {}}
             for fam in ("pair", "windows")}

    def ints(low, high, *shape):
        return torch.randint(low, high, shape, device=device, generator=gen,
                             dtype=torch.int32)

    def check(fam, calls, tables):
        worse(worst[fam], kge_errors(*calls, tables))
        path = bindings.kge_plan(tables)["relation_path"]
        worst[fam]["paths"][path] = worst[fam]["paths"].get(path, 0) + 1
        return path

    for dtype in (torch.float32, torch.bfloat16):
        for objective in kge.PAIR_OBJECTIVES:
            dims = ((2, 128, 130, 512) if objective == "rotate"
                    else (1, 7, 128, 130, 512))
            for d in dims:
                width = d // 2 if objective == "rotate" else d
                vocab = [(r, None)]
                if d in (128, 130):
                    edge = kge_budget_relations(width, dtype, 1)
                    vocab += [(edge, "shared"),
                              (edge + 1, "shared and global")]
                for nr, want in vocab:
                    ent = random_tables(n, d, torch.float32, device, d)[0]
                    rel = random_tables(max(nr, n), d, torch.float32, device,
                                        d + 1)[0]
                    ent, rel = ent.to(dtype), rel[:nr, :width].contiguous(
                        ).to(dtype)
                    cases = ((1, 1, "one"), (700, 4, "plain"),
                             (300, 33, "wide"), (700, 4, "hub"),
                             (700, 4, "hot_relation"), (200, 4, "all_pad"))
                    for b, k, case in (cases if want is None else
                                       (cases[1], cases[4])):
                        pos = torch.stack([ints(0, n, b), ints(0, nr, b),
                                           ints(0, n, b)], 1)
                        if case == "hub":
                            pos[:, 0] = 5
                        if case == "hot_relation":
                            pos[:, 1] = nr - 1
                        neg = tt.corrupt_triples(pos.contiguous(), n, k, 9, 1)
                        valid = (ints(0, 5, b) > 0).to(torch.uint8)
                        if case == "all_pad":
                            valid.zero_()
                        path = check("pair", kge_pair_calls(
                            (ent, rel), pos.contiguous(), neg, valid,
                            objective, 2.0), (ent, rel))
                        require(want is None or path == want,
                                f"K19 took the {path} relation path with "
                                f"{nr} relations at D = {d}")
        for cbow in (False, True):
            for d in (1, 7, 128, 130, 512):
                vocab = [(r, None)]
                if d in (128, 130):
                    edge = kge_budget_relations(d, dtype, 2)
                    vocab += [(edge, "shared"),
                              (edge + 1, "shared and global")]
                for nr, want in vocab:
                    tabs = [t.to(dtype) for t in (
                        *random_tables(max(nr, n), d, torch.float32, device,
                                       d),
                        *random_tables(max(nr, n), d, torch.float32, device,
                                       d + 1))]
                    tabs = [t[:n if i % 2 == 0 else nr].contiguous()
                            for i, t in enumerate(tabs)]
                    sizes = ((1, 1), (600, 1), (600, 3), (400, 11))
                    for b, w in sizes if want is None else sizes[2:3]:
                        def trips(*shape):
                            x = torch.stack([ints(-1, n + 2, *shape),
                                             ints(0, nr, *shape),
                                             ints(0, n, *shape)], -1)
                            x[ints(0, 5, *shape) == 0] = pad
                            return x.contiguous()
                        for hot in (False, True):
                            many = trips(b, 2 * w)
                            many[0] = pad  # a window of padding only
                            many[:, 0, 0] = 5  # a hub entity
                            if hot:  # one relation in every unmasked slot
                                many[..., 1] = torch.where(
                                    many[..., 1] == pad, pad, nr - 1)
                            batch = ((trips(b), trips(b), many) if cbow
                                     else (trips(b), many, trips(b, 2 * w)))
                            path = check("windows", kge_windows_calls(
                                tabs, batch, pad, cbow), tabs)
                            require(want is None or path == want,
                                    f"K20 took the {path} relation path "
                                    f"with {nr} relations at D = {d}")
    return worst


def kge_pair_bound(tables, pos, neg, valid, grads: bool):
    """K19 on these positives.  Bytes, each row counted once however many
    triples share it: the distinct entity and relation rows at the table
    width, the ids and weights, and with the gradient the two dense float32
    gradient tables written once, as the timed call writes them.
    Operations: about 8 float32 operations an element of a scored triple
    (RotatE's sines and cosines not counted), three times that with the
    gradient, against the CUDA cores' float32 rate."""
    ent, rel = tables
    ent_rows = torch.unique(torch.cat([
        pos[:, 0], pos[:, 2], neg[..., 0].reshape(-1),
        neg[..., 2].reshape(-1)])).numel()
    rel_rows = torch.unique(torch.cat([pos[:, 1],
                                       neg[..., 1].reshape(-1)])).numel()
    moved = (ent_rows * ent.shape[1] * ent.element_size()
             + rel_rows * rel.shape[1] * rel.element_size()
             + 4 * (pos.numel() + neg.numel()) + valid.numel() + 4)
    flops = 8 * (pos.shape[0] + neg.shape[0] * neg.shape[1]) * ent.shape[1]
    if grads:
        moved += 4 * (ent.numel() + rel.numel())
        flops *= 3
    return bound(moved, flops, FP32_FLOPS_PER_S), {
        "entity_rows": ent_rows, "relation_rows": rel_rows}


def kge_windows_bound(tables, batch, pad, cbow: bool, grads: bool):
    """K20 on these windows.  Bytes: the distinct rows of the components in
    range of the slots it reads (windows of weight 1: skip-gram's target,
    unmasked positives and every negative; CBOW's positive, negative and
    unmasked context slots), each counted once at the table width, every id
    read once, and with the gradient the four dense float32 gradient tables
    written once.  Operations: 4 D a composed slot (two adds and the dot
    product), three times that with the gradient."""
    if cbow:
        pos, neg, ctx = batch
        ok = pos[:, 1] != pad
        ins, ctx = [pos[ok], neg[ok]], ctx[ok]
        outs = [ctx[ctx[..., 1] != pad]]
    else:
        tgt, pw, nw = batch
        ok = tgt[:, 1] != pad
        pw = pw[ok]
        ins, outs = [tgt[ok]], [pw[pw[..., 1] != pad], nw[ok].reshape(-1, 3)]
    ne, dim = tables[0].shape
    nr = tables[1].shape[0]

    def distinct(trips, cols, n):
        ids = torch.cat([t[..., c].reshape(-1) for t in trips for c in cols])
        return torch.unique(ids[(ids >= 0) & (ids < n)]).numel()

    rows = (distinct(ins, (0, 2), ne) + distinct(ins, (1,), nr)
            + distinct(outs, (0, 2), ne) + distinct(outs, (1,), nr))
    slots = sum(t.reshape(-1, 3).shape[0] for t in ins + outs)
    moved = (rows * dim * tables[0].element_size()
             + 4 * sum(t.numel() for t in batch) + 4)
    flops = 4 * dim * slots
    if grads:
        moved += 4 * sum(t.numel() for t in tables)
        flops *= 3
    return bound(moved, flops, FP32_FLOPS_PER_S), {"rows": rows,
                                                   "slots": slots}


def kge_row_adds(tabs, ids, pad, objective: str) -> dict:
    """The global row adds of one K19 or K20 value-and-grad call on these
    inputs, counted from them by the kernels' rules (``bindings.kge_plan``
    for the lanes and the relation rows summed on chip): in the item loop
    (K19: a positive's h and t, once where h == t, each negative's own
    rows, and its relation rows past the shared ones; K20: the entity and,
    past the shared rows, relation entries of ``kge.merged_row_adds`` of
    each window's rounds), at most those of the blocks' relation flushes
    (grid times the shared rows of each table), and the count of the
    kernels' first design on the same inputs, a row add a source row of
    each scored triple (K19: 3 a positive and a negative's differing rows;
    K20: one a composed component in range).  Per item: the weighted
    windows (K20) or the positives (K19)."""
    plan = bindings.kge_plan(tabs)
    shared = plan["shared_relation_rows"]
    if objective in kge.PAIR_OBJECTIVES:
        pos, neg, _ = ids
        differ = neg != pos[:, None]
        hot = (neg[..., 1] >= shared) & differ[..., 1]
        per_item = (2 - (pos[:, 0] == pos[:, 2]).long()
                    + differ[..., 0].sum(1) + differ[..., 2].sum(1)
                    + (pos[:, 1] >= shared).long() + hot.sum(1))
        rel = int((pos[:, 1] >= shared).sum()) + int(hot.sum())
        items, tables = pos.shape[0], 1
        first = 3 * pos.shape[0] + int(differ.sum())
        grid = bindings.library().trw_kge_pair_grid(items, plan["vec"])
    else:
        rows = kge.window_slot_rows(ids, pad, objective == "cbow",
                                    tabs[0].shape[0], tabs[1].shape[0])
        rel = 0
        per_item = torch.zeros(ids[0].shape[0], dtype=torch.long,
                               device=ids[0].device)
        for side in ("in", "out"):
            merged = kge.merged_row_adds(
                rows[side], torch.ones(rows[side].shape[:2],
                                       device=ids[0].device), plan["lanes"])
            past = merged["relation"][1] >= shared
            rel += int(past.sum())
            for window in (merged["entity"][0], merged["relation"][0][past]):
                per_item += torch.bincount(window, minlength=len(per_item))
        first = sum(int((r >= 0).sum()) for r in rows.values())
        weighted = ids[0][:, 1] != pad
        items, tables = int(weighted.sum()), 2
        per_item = per_item[weighted]
        grid = bindings.library().trw_kge_windows_grid(ids[0].shape[0],
                                                       plan["vec"])
    loop = int(per_item.sum())
    return {**plan, "grid": grid, "items": items,
            "item_loop_row_adds": loop,
            "relation_row_adds_in_item_loop": rel,
            "flush_row_adds_at_most": grid * tables * shared,
            "per_item": loop / max(items, 1),
            "most_in_an_item": int(per_item.max()) if items else 0,
            "first_version_row_adds": first,
            "first_version_per_item": first / max(items, 1)}


def kge_owner_floor(tabs, ids, pad) -> dict:
    """What an owner-computed gradient of K20 skip-gram's out entity rows
    (K17's design) would at least cost on these windows: its owner pass
    sums, for each row, coef times the window's u over the row's merged
    entries (``kge.merged_row_adds``), which a library call does alone:
    ``F.embedding_bag`` (sum, per-sample weights) of the windows' u rows,
    the entries sorted by row, one bag a row; CUDA events, median of 5.  Not
    counted: the histogram, the placement and the pass that writes u."""
    rows = kge.window_slot_rows(ids, pad, False, tabs[0].shape[0],
                                tabs[1].shape[0])["out"]
    window, row, coef = kge.merged_row_adds(
        rows, torch.ones(rows.shape[:2], device=rows.device),
        bindings.kge_plan(tabs)["lanes"])["entity"]
    u = kge.compose_plain(tabs[0], tabs[1], ids[0])
    order = torch.argsort(row, stable=True)
    window, coef = window[order], coef[order]
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=u.device),
                         torch.cumsum(torch.bincount(
                             row, minlength=tabs[0].shape[0]), 0)[:-1]])
    ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        window, u, offsets, mode="sum", per_sample_weights=coef))
    return {"entries": len(window), "u_bytes_read": len(window) * u.shape[1]
            * 4, "embedding_bag_ms": ms}


def kge_step_parts(emb, targets, i) -> tuple[dict, dict]:
    """The parts of one step, each alone on the step's own inputs: the walk
    (K9), the batch (targets and negatives, or K10's windows), the dedup
    and gathers (touched-rows step), K19 or K20 alone and in its one call,
    and K18 on the tables.  Returns (parts, what the kernel checks need)."""
    model, pad = emb.model, emb.padding_idx
    objective = emb.config.objective
    walks = emb.walks(targets, i)
    parts = {"walk_ms": time_ms(lambda: emb.walks(targets, i), iters=3),
             "batch_ms": time_ms(lambda: emb.batch(walks, i), iters=3)}
    batch = emb.batch(walks, i)
    del walks
    sparse = emb.config.update_mode == "sparse"
    if model.pair:
        pos, neg, valid = model._pair_batch(*batch, pad)
        if sparse:
            parts["dedup_and_gathers_ms"] = time_ms(
                lambda: model.gather_touched_rows(pos, neg), iters=3)
            ent_ids, rel_ids, pos_l, neg_l, *tabs = model.gather_touched_rows(
                pos, neg)
            ids = (pos_l, neg_l, valid)
        else:
            tabs, ids = [model.ent.detach(), model.rel.detach()], (pos, neg,
                                                                   valid)
        calls = kge_pair_calls(tabs, *ids, objective, model.margin)
    else:
        tabs, ids = [p.detach() for p in model.parameters()], model._as_ids(
            *batch)
        calls = kge_windows_calls(tabs, ids, pad, objective == "cbow")
    parts["loss_ms"] = time_ms(calls[0], iters=3)
    parts["loss_and_grads_ms"] = time_ms(calls[1], iters=3)
    grads = calls[1]()[1]
    if sparse:
        hyper = adam_hyper(model, sparse=True)
        upd = [(getattr(model, n).data, model.mu[n], model.nu[n], g, rows,
                None) for n, g, rows in zip(kge.PAIR_TABLES, grads,
                                            (ent_ids, rel_ids))]
        parts["adam_ms"] = time_ms(lambda: [
            bindings.adam_rows(*u, *hyper) for u in upd], iters=3)
    else:
        hyper = adam_hyper(model, sparse=False)
        upd = [(p.data, model.mu[n], model.nu[n], g) for (n, p), g in
               zip(model.named_parameters(), grads)]
        parts["adam_ms"] = time_ms(lambda: [
            bindings.adam_dense(*u, *hyper) for u in upd], iters=3)
    del grads, upd
    return parts, {"tabs": tabs, "ids": ids, "calls": calls}


def phase_kge(graph) -> list[dict]:
    """The KG-embedding trainer on the bench triples graph (family_graphs,
    KGE_HELD_OUT triples held out) at KGE_CONFIG, through ``epoch_step``:
    per case (TransE dense and touched-rows, DistMult, RotatE, triple
    skip-gram and CBOW) one warm step and KGE_STEPS chained steps with CUDA
    events around each, the launch counts set to 0 just before and read
    just after, the first step's loss again from the same tables (the same
    bits), the autograd entry once for K19 and once for K20, the losses
    (finite), peak memory and the step's parts; K19 or K20, both entries and
    both table types, against the plain version on the step's own inputs
    (their first KGE_CHECK_PREFIX positives or windows); the tail ranking
    of the held-out triples against all entities by the pair models; one
    step on every entity, ``train()``'s default batch (dense cases); and
    the kernels' rows."""
    dev = graph.device
    small = kge_small_checks(dev)
    limits = {"loss_rel_err": LOSS_REL_LIMIT, "grad_rel_err": GRAD_REL_LIMIT}
    emit("kge_small_checks", limits=limits, worst=small)
    for fam, e in small.items():
        require(e["loss_rel_err"] <= LOSS_REL_LIMIT
                and e["grad_rel_err"] <= GRAD_REL_LIMIT,
                f"{fam} KGE kernel != plain at the edges: {e}")
        require(set(e["paths"]) == {"shared", "shared and global"},
                f"{fam}: the small checks did not take both relation "
                f"paths: {e['paths']}")
    _, tg = family_graphs(graph)
    gen = torch.Generator(device=dev)
    gen.manual_seed(KGE_SEED)
    held = torch.randperm(tg.num_triples, device=dev,
                          generator=gen)[:KGE_HELD_OUT]
    keep = torch.ones(tg.num_triples, dtype=torch.bool, device=dev)
    keep[held] = False
    test = tg.triples[held].cpu().numpy()
    train, build_ms = wall_ms(lambda: tt.TriplesGraph.from_arrays(
        tg.triples[keep], num_entities=tg.num_entities,
        num_relations=tg.num_relations))
    del tg, keep, held
    require(train.fat, "the KGE graph has no fat table")
    targets = torch.arange(KGE_WALKERS, dtype=torch.int32, device=dev)
    steps = 1 + KGE_STEPS
    totals = dict.fromkeys(KGE_ROWS, 0)
    cases, checks, times = {}, {}, {}
    for case, kw in KGE_CASES.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        peak_gib()
        emb = tt.KGEmbedding(train, tt.KGEmbeddingConfig(**KGE_CONFIG, **kw))
        model = emb.init()
        cfg, pad = emb.config, emb.padding_idx
        torch.cuda.synchronize()
        bindings.reset_launch_counts()
        losses, step_ms = step_events(lambda i: emb.epoch_step(targets, i),
                                      steps)
        emb.init()  # the same tables again
        again = float(emb.epoch_step(targets, 0))
        require(again == losses[0], f"{case}: the first step's loss "
                f"{again!r} is not {losses[0]!r} from the same tables")
        extra = {}
        if case in ("transe", "skipgram"):  # the autograd entry
            batch = emb.batch(emb.walks(targets, steps), steps)
            fn = (model.pair_loss_fn if model.pair
                  else model.skipgram_loss_fn)
            loss = fn(*batch, pad)
            loss.backward()
            require(bool(torch.isfinite(loss)) and all(
                p.grad is not None and bool(torch.isfinite(p.grad).all())
                for p in model.parameters()),
                f"{case}: the autograd entry is not finite")
            extra["autograd_loss"] = float(loss.detach())
            model.zero_grad(set_to_none=True)
            del batch, loss
        launches = {k: bindings.launch_counts[k] for k in KGE_KERNELS}
        kind = ("sparse" if cfg.update_mode == "sparse"
                else "pair" if model.pair else cfg.objective)
        want = {k: v * (steps + 1) for k, v in KGE_LAUNCHES[kind].items()}
        if case == "transe":
            want["uniform_walk_triples"] += 1
            want["kge_pair_loss"] = 1
            want["kge_pair_loss_and_grads"] += 1
        if case == "skipgram":
            want["uniform_walk_triples"] += 1
            want["to_windows_triples"] += 1
            want["kge_windows_loss"] = 1
            want["kge_windows_loss_and_grads"] += 1
        require(launches == {k: want.get(k, 0) for k in KGE_KERNELS},
                f"{case}: the steps did not go through their kernels: "
                f"{launches}, wanted {want}")
        for k in totals:
            totals[k] += launches[k]
        require(all(np.isfinite(losses)), f"{case}: a loss is not finite: "
                f"{losses}")
        for name, param in model.named_parameters():
            require(bool(torch.isfinite(param).all()),
                    f"{case}: {name} is not finite")
        torch.cuda.synchronize()
        case_peak = torch.cuda.max_memory_allocated() / 2**30
        parts, made = kge_step_parts(emb, targets, steps + 1)
        tabs, ids, calls = made["tabs"], made["ids"], made["calls"]
        bound_fn = (kge_pair_bound if model.pair else
                    lambda t, *b, grads: kge_windows_bound(
                        t, b, pad, cfg.objective == "cbow", grads))
        (fwd_bound, counted), (grad_bound, _) = (
            bound_fn(tabs, *ids, grads=False), bound_fn(tabs, *ids,
                                                        grads=True))
        times[case] = {"loss": (parts["loss_ms"], fwd_bound),
                       "grads": (parts["loss_and_grads_ms"], grad_bound),
                       "sub_launch_ms": {"loss": launch_ms(calls[0]),
                                         "grads": launch_ms(calls[1])},
                       "bound_counted": counted,
                       "row_adds": kge_row_adds(tabs, ids, pad,
                                                cfg.objective)}
        if case == "skipgram":
            times[case]["owner_floor"] = kge_owner_floor(tabs, ids, pad)
        if cfg.update_mode == "dense":  # the sparse step runs the same K19
            checks[case] = {}
            pre = [x[:KGE_CHECK_PREFIX].contiguous() for x in ids]
            for dtype in (torch.float32, torch.bfloat16):
                ctabs = [t.to(dtype) for t in tabs]
                made_calls = (kge_pair_calls(ctabs, *pre, cfg.objective,
                                             model.margin) if model.pair
                              else kge_windows_calls(
                                  ctabs, pre, pad, cfg.objective == "cbow"))
                checks[case][str(dtype).split(".")[1]] = kge_errors(
                    *made_calls, ctabs)
                del ctabs
        ranking = None
        if model.pair:
            metrics, rank_ms = wall_ms(lambda: tt.kg_tail_ranking_metrics(
                model.entity_embeddings(), model.relation_embeddings(), test,
                score=cfg.objective))
            ranking = {"held_out_triples": len(test), "candidates":
                       train.num_entities, "ms": rank_ms, **metrics}
        slots = (2 * (1 + cfg.num_negatives) * train.num_entities
                 * cfg.walk_length)
        full = (f"skipped: the touched-rows step's static-size sub-table, "
                f"as JAX's, would hold {slots} rows of {4 * cfg.dim} B")
        if cfg.update_mode == "dense":  # one step on train()'s default batch
            every = torch.arange(train.num_entities, dtype=torch.int32,
                                 device=dev)
            peak_gib()
            loss_full, ms_full = step_events(
                lambda i: emb.epoch_step(every, steps + 2), 1)
            require(np.isfinite(loss_full[0]),
                    f"{case}: the full-batch step's loss is not finite")
            full_items = train.num_entities * cfg.walk_length
            full = {"start_entities": train.num_entities,
                    "items": full_items, "ms": ms_full[0],
                    "items_per_s": full_items / (ms_full[0] / 1e3),
                    "loss": loss_full[0],
                    "peak_device_gib": torch.cuda.max_memory_allocated()
                    / 2**30}
            del every
        count = ids[0].shape[0]
        chained = statistics.median(step_ms[1:])
        cases[case] = {
            "losses": losses, "first_step_again": again, "step_ms": step_ms,
            "warm_step_ms": step_ms[0], "chained_step_ms_median": chained,
            "items_per_step": count,
            "items_per_s": count / (chained / 1e3),
            "parts_ms": parts, "launches": launches,
            "peak_device_gib": case_peak, "tail_ranking": ranking,
            "full_batch_step": full, **extra}
        del emb, model, tabs, ids, calls, made
    torch.cuda.synchronize()
    emit("kge", config=KGE_CONFIG, walkers=KGE_WALKERS,
         entities=train.num_entities, relations=train.num_relations,
         triples=train.num_triples, graph_build_ms=build_ms, cases=cases,
         items="positives a step (pair objectives) or windows (skip-gram, "
               "CBOW)",
         timing="CUDA events around each step; parts: CUDA events, 1 "
                "warm-up, median of 3; tail ranking: host clock, raw ranks")
    emit("kge_kernels", limits=limits, checked_prefix=KGE_CHECK_PREFIX,
         checks=checks,
         bounds={c: t["bound_counted"] for c, t in times.items()},
         device_ms_by_launch={c: t["sub_launch_ms"] for c, t in
                              times.items()},
         row_adds={c: t["row_adds"] for c, t in times.items()},
         owner_floor=times["skipgram"]["owner_floor"])
    for case, t in times.items():
        adds = t["row_adds"]
        require(adds["relation_row_adds_in_item_loop"] == 0,
                f"{case}: the bench shape's relation rows did not go on "
                f"chip: {adds}")
        most = {"skipgram": KGE_MOST_ADDS_SKIPGRAM}.get(
            case, KGE_MOST_ADDS_PAIR if case.startswith(
                ("transe", "distmult", "rotate")) else None)
        require(most is None or adds["most_in_an_item"] <= most,
                f"{case}: {adds['most_in_an_item']} global row adds in one "
                f"item, more than {most}")
    for case, by_type in checks.items():
        for dtype, e in by_type.items():
            require(e["loss_rel_err"] <= LOSS_REL_LIMIT
                    and e["grad_rel_err"] <= GRAD_REL_LIMIT,
                    f"KGE kernel != plain at the main path's shape ({case}, "
                    f"{dtype}): {e}")
    rows = []
    for name, part, main, family, err_key in (
            ("kge_pair_loss", "loss", "transe",
             ("transe", "distmult", "rotate"), "loss_abs_err"),
            ("kge_pair_loss_and_grads", "grads", "transe",
             ("transe", "distmult", "rotate"), "grad_abs_err"),
            ("kge_windows_loss", "loss", "skipgram", ("skipgram", "cbow"),
             "loss_abs_err"),
            ("kge_windows_loss_and_grads", "grads", "skipgram",
             ("skipgram", "cbow"), "grad_abs_err")):
        ms, bound_pair = times[main][part]
        source, replaces = KERNEL_FACTS[name]
        by_case = [c for c in times if (c in family or c == "transe_sparse"
                                        and main == "transe")]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": totals[name],
            "max_abs_err": max(checks[c][t][err_key] for c in family
                               for t in checks[c]),
            "ms": ms, "plain_ms": checks[main]["float32"]["plain_ms"],
            "plain_ms_is": f"the first {KGE_CHECK_PREFIX} of the step's "
                           "items, loss and autograd gradients",
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
            "bound_counted": times[main]["bound_counted"],
            "library_ms": None,
            "ms_by_case": {c: times[c][part][0] for c in by_case},
            "bound_ms_by_case": {c: times[c][part][1][0] for c in by_case},
            "sub_launch_ms": {c: times[c]["sub_launch_ms"][part]
                              for c in by_case}})
    return rows


# --- the data axis: parallel/mesh.py, walk_dp.py, trainer.py, kge_trainer.py

# The data-parallel trainers at the one-card trainers' configurations on a
# process group of one over NCCL (the machine has one card; NCCL refuses two
# ranks on one device): ShardedNode2Vec at TRAIN_CONFIG in these modes, and
# ShardedKGEmbedding at KGE_CONFIG for these objectives.
DP_TRAIN_MODES = {"dense": {}, "sparse": dict(update_mode="sparse"),
                  "windows": dict(train_mode="windows")}
DP_KGE_CASES = {"transe": dict(objective="transe"),
                "skipgram": dict(objective="skipgram")}
# The kernels the data-parallel run must launch.
DP_KERNELS = ("uniform_walk_csr", "node2vec_walk_csr_mixture", "to_windows",
              "uniform_walk_edge_list", "biased_walk_edge_list",
              "uniform_walk_triples", "to_windows_triples",
              "walk_sgns_loss_fwd", "walk_sgns_loss_bwd",
              "sgns_windows_loss_and_grads", "adam_dense", "adam_rows",
              "kge_pair_loss_and_grads", "kge_windows_loss_and_grads")
# Window offsets of the K3 and K10 checks: a rank's chunk starting at walk
# DP_SPLIT_WALK of the bench walks, and an offset whose draw counters wrap
# 2^32 about DP_WRAP_DRAWS draws into the call.
DP_SPLIT_WALK = NUM_WALKERS // 2
DP_WRAP_DRAWS = 1000


def dp_wrap_offset(draws: int) -> int:
    """The window offset whose first draw counter is about DP_WRAP_DRAWS
    below 2^32, for ``draws`` draws a window."""
    return (2 ** 32 - DP_WRAP_DRAWS) // draws


@contextlib.contextmanager
def nccl_group_of_one(dev):
    """The default process group as this process alone over NCCL (an
    in-memory store, no launcher), destroyed on the way out."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def dp_walk_calls(graph, el, tg, pad: int) -> dict:
    """name -> (data-parallel entry, one-card entry, graph, arguments): the
    CSR walks of the main path (uniform, p=0.5 q=2) and the families'."""
    par = tt.parallel
    csr = dict(walk_length=WALK_LENGTH, seed=WALK_SEED)
    fam = dict(walk_length=WALK_LENGTH, seed=FAMILY_SEED, padding_idx=pad)
    return {
        "csr_uniform": (par.walk_data_parallel, tt.walk, graph, csr),
        "csr_node2vec": (par.walk_data_parallel, tt.walk, graph,
                         dict(csr, p=P, q=Q)),
        "edge_uniform": (par.walk_edge_list_data_parallel, tt.walk_edge_list,
                         el, dict(fam, restart=True)),
        "edge_biased": (par.walk_edge_list_data_parallel, tt.walk_edge_list,
                        el, dict(fam, p=P, q=Q, restart=True)),
        "triples": (par.walk_triples_data_parallel, tt.walk_triples, tg,
                    fam)}


def dp_gradient_buffers(trainer, kge: bool, mode: str) -> tuple:
    """float32 tensors shaped as one step's gradients, which the trainer
    sums over the group (dense and windows: the whole tables; touched-rows:
    the two sub-tables of the batch's M = B (L + 1) + S slots), and the int32
    walks a touched-rows step gathers."""
    dev = trainer.device
    if kge or mode != "sparse":
        return [torch.empty(p.shape, dtype=torch.float32, device=dev)
                for p in trainer.model.parameters()], None
    cfg = trainer.config
    width = cfg.walk_length + 1
    rows = TRAIN_WALKERS * width + cfg.shared_negatives
    return ([torch.empty((rows, cfg.dim), dtype=torch.float32, device=dev)
             for _ in range(2)],
            torch.empty((TRAIN_WALKERS, width), dtype=torch.int32,
                        device=dev))


def phase_dp(graph, smi: str) -> dict:
    """The data axis on the card, over NCCL at world size 1 (the group made
    in this process), at the bench shapes: ``walk_data_parallel`` (uniform
    and p=0.5 q=2), ``walk_edge_list_data_parallel`` (uniform and biased,
    restart) and ``walk_triples_data_parallel`` on the bench graph and its
    families, then ShardedNode2Vec (DP_TRAIN_MODES) and ShardedKGEmbedding
    (DP_KGE_CASES), one warm and TRAIN_STEPS (KGE_STEPS) chained steps each
    with CUDA events around each, the launch counts set to 0 just before
    that run and read just after.  Then, outside the count: each walk
    against the one-card entry (tolerance 0), each trainer against the
    one-card trainer's ``epoch_step`` from the same tables (as below),
    one-card step times in the same process, the
    group's all-reduce of one step's gradient bytes (and the touched-rows
    step's gather of the walks) by CUDA events; and K3 and K10 (both
    generators) at a nonzero ``window_offset`` on the bench walks against the
    rows of the offset-0 call and against their plain versions, with their
    device times at offset 0 and at the offset. The gradient kernels (K6,
    K17's in rows, K19, K20) add rows with float atomics, so the one-card
    trainer's own tables differ between two runs from the same tables after
    the first step: the first loss must be the one-card trainer's bit for
    bit, the later ones within LOSS_REL_LIMIT, the tables within
    ``dp_table_diff``'s allowance; the one-card trainer runs twice to show
    its own spread, and NCCL's sum over the one rank must leave a buffer bit
    for bit. Two processes on the one card over gloo are not run: gloo has
    no CUDA ``all_gather``, so the touched-rows step would need host staging
    in the package. Returns the run's launch counts."""
    par = tt.parallel
    dev = graph.device
    pad = graph.num_nodes
    el, tg = family_graphs(graph)
    targets = bench_targets(dev)
    train_targets = torch.arange(TRAIN_WALKERS, dtype=torch.int32, device=dev)
    kge_targets = torch.arange(KGE_WALKERS, dtype=torch.int32, device=dev)
    calls = dp_walk_calls(graph, el, tg, pad)
    runs = {}
    with nccl_group_of_one(dev) as dist:
        mesh = par.make_mesh()
        shard = par.data_sharding(mesh)
        require(dist.get_backend() == "nccl" and mesh.device_type == "cuda"
                and (shard.rank, shard.size) == (0, 1),
                "the data axis is not one NCCL rank on the card")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        peak_gib()
        bindings.reset_launch_counts()
        walks = {name: dp(g, targets, mesh, **kw)
                 for name, (dp, _, g, kw) in calls.items()}
        trainers = (
            [(f"node2vec_{m}", False, m, lambda kw=kw: par.ShardedNode2Vec(
                graph, mesh, par.ShardedNode2VecConfig(**TRAIN_CONFIG, **kw)))
             for m, kw in DP_TRAIN_MODES.items()]
            + [(f"kge_{c}", True, c, lambda kw=kw: par.ShardedKGEmbedding(
                tg, mesh, par.ShardedKGEmbeddingConfig(**KGE_CONFIG, **kw)))
               for c, kw in DP_KGE_CASES.items()])
        for name, kge_run, mode, make in trainers:
            trainer = make()
            trainer.init()
            batch = kge_targets if kge_run else train_targets
            steps = 1 + (KGE_STEPS if kge_run else TRAIN_STEPS)
            losses, ms = step_events(
                lambda i: trainer.train_step(batch, i), steps)
            runs[name] = {"kge": kge_run, "mode": mode, "losses": losses,
                          "step_ms": ms, "tables": {
                              n: p.detach().clone() for n, p in
                              trainer.model.named_parameters()},
                          "buffers": dp_gradient_buffers(trainer, kge_run,
                                                         mode),
                          "profile": dp_step_profile(
                              lambda: trainer.train_step(batch, steps))}
            del trainer
        torch.cuda.synchronize()
        launches = dict(bindings.launch_counts)
        dp_peak = torch.cuda.max_memory_allocated() / 2**30
        require(all(launches[k] > 0 for k in DP_KERNELS),
                f"the data-parallel run missed a kernel: {launches}")
        probe = torch.randn(1 << 20, device=dev)
        summed = probe.clone()
        shard.all_reduce_(summed)
        exact_sum = bool(torch.equal(summed, probe))
        require(exact_sum, "NCCL's sum over one rank changed the buffer")
        del probe, summed
        collectives = {}
        for name, run in runs.items():
            bufs, gathered = run.pop("buffers")
            collectives[name] = {
                "all_reduce_ms": time_ms(lambda: shard.all_reduce_(*bufs)),
                "all_reduce_bytes": sum(b.numel() * 4 for b in bufs),
                # the gradients and the loss (at world size 1 the KGE
                # trainer reduces no count: its scale is left out)
                "all_reduce_calls_a_step": len(bufs) + 1}
            if gathered is not None:
                collectives[name].update(
                    all_gather_ms=time_ms(
                        lambda: shard.all_gather_rows(gathered)),
                    all_gather_bytes=gathered.numel() * 4)
            del bufs, gathered
    walk_errs = {name: max_abs_err(walks[name], single(
        g, target_nodes=targets, **kw))
        for name, (_, single, g, kw) in calls.items()}
    require(all(e == 0 for e in walk_errs.values()),
            f"a data-parallel walk != the one-card walk: {walk_errs}")
    cases = {}
    for name, run in runs.items():
        mode = run["mode"]
        if run["kge"]:
            one = tt.KGEmbedding(tg, tt.KGEmbeddingConfig(
                **KGE_CONFIG, **DP_KGE_CASES[mode]))
            batch, lr = kge_targets, KGE_CONFIG["learning_rate"]
        else:
            one = tt.Node2Vec(graph, tt.Node2VecConfig(
                **TRAIN_CONFIG, **DP_TRAIN_MODES[mode]))
            batch, lr = train_targets, 1e-2  # Node2VecConfig's default
        steps = len(run["losses"])
        tables, one_runs = run.pop("tables"), []
        for _ in range(2):  # twice: the one-card trainer against itself
            one.init()
            want, want_ms = step_events(lambda i: one.epoch_step(batch, i),
                                        steps)
            one_runs.append((want, want_ms, {
                n: p.detach().clone()
                for n, p in one.model.named_parameters()}))
        (want, want_ms, first), (again, _, second) = one_runs
        one_profile = dp_step_profile(lambda: one.epoch_step(batch, steps))
        require(all(np.isfinite(run["losses"])), f"{name}: a loss is not "
                "finite")
        require(run["losses"][0] == want[0] == again[0],
                f"{name}: the first step's loss differs from the one-card "
                f"trainer's: {run['losses'][0]!r} vs {want[0]!r}")
        require(np.allclose(run["losses"], want, rtol=LOSS_REL_LIMIT, atol=0),
                f"{name}: the losses differ from the one-card trainer's: "
                f"{run['losses']} vs {want}")
        tables_vs_one = {n: dp_table_diff(t, first[n], lr, steps)
                         for n, t in tables.items()}
        one_vs_one = {n: dp_table_diff(second[n], first[n], lr, steps)
                      for n in first}
        for n, d in tables_vs_one.items():
            require(d["within"], f"{name}: table {n} is farther from the "
                    f"one-card trainer's than its allowance: {d}")
        chained = statistics.median(run["step_ms"][1:])
        one_chained = statistics.median(want_ms[1:])
        cases[name] = {"losses": run["losses"], "one_card_losses": want,
                       "one_card_losses_again": again,
                       "losses_bit_for_bit": run["losses"] == want,
                       "tables_vs_one_card": tables_vs_one,
                       "one_card_vs_itself": one_vs_one,
                       "step_ms": run["step_ms"],
                       "chained_step_ms_median": chained,
                       "one_card_step_ms": want_ms,
                       "one_card_chained_step_ms_median": one_chained,
                       "step_ms_over_one_card": chained / one_chained,
                       "profiled_step": run["profile"],
                       "one_card_profiled_step": one_profile,
                       **collectives[name]}
        del one, tables, one_runs, first, second
    del runs
    offsets = dp_window_offsets(walks["csr_uniform"], walks["triples"], tg,
                                pad)
    del walks
    emit("dp", card=smi, world_size=1, backend="nccl",
         walkers=NUM_WALKERS, train_walkers=TRAIN_WALKERS,
         kge_walkers=KGE_WALKERS, train_config=TRAIN_CONFIG,
         kge_config=KGE_CONFIG, walk_max_abs_err=walk_errs, cases=cases,
         launches={k: launches[k] for k in launches if launches[k]},
         run_peak_device_gib=dp_peak,
         nccl_sum_of_one_rank_is_exact=exact_sum,
         against_one_card="the first loss bit for bit, every loss within "
                          f"{LOSS_REL_LIMIT} relative, every table within "
                          "dp_table_diff's allowance; the one-card trainer "
                          "twice from the same tables for its own spread",
         timing="steps: CUDA events around each call, the data-parallel "
                "run first, then the one-card one; collectives: CUDA "
                "events, 1 warm-up, median of 5, on buffers shaped as one "
                "step's; profiled_step: one more step under torch.profiler, "
                "host clock and device activity")
    emit("dp_window_offsets", card=smi, **offsets)
    return launches


def dp_step_profile(step) -> dict:
    """One more step under ``torch.profiler`` (device activity only): its
    wall ms (host clock, synchronised), the device ms of its kernels, the
    device's idle share of the wall time, and the collectives' device ms
    (NCCL's kernels); the device numbers null if the profiler saw no
    device time."""
    _, wall, kernels = profile_device(step)
    if not kernels:
        return {"wall_ms": wall, "device_ms": None, "idle_share": None,
                "nccl_device_ms": None, "launches": None}
    busy = sum(ms for _, ms in kernels.values())
    nccl = sum(ms for k, (_, ms) in kernels.items() if "nccl" in k.lower())
    return {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
            "nccl_device_ms": nccl, "launches": sum(
                n for n, _ in kernels.values())}


def dp_table_diff(got, want, lr: float, steps: int) -> dict:
    """How far a table after ``steps`` Adam steps lies from another run's:
    the elements that differ at all, those beyond the elementwise limit
    (bfloat16: 4 ulps of the table's largest entry; float32: 1e-4 of the
    element and 1e-6 of the largest entry), and the largest difference.
    ``within``: at most 2 % of the elements beyond the limit, none by more
    than 2 lr a step (the tests' ``close_after_adam``: Adam turns a
    gradient that nearly cancels into a step of about lr either way, and
    the gradient kernels sum rows with float atomics, in a run's own
    order)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    scale = float(w.abs().max())
    if got.dtype == torch.bfloat16:
        limit = 4 * 2.0 ** -8 * scale
    else:
        limit = 1e-4 * w.abs() + 1e-6 * scale
    off = int((diff > limit).sum())
    worst = float(diff.max())
    return {"elements": w.numel(), "differ": int((diff != 0).sum()),
            "beyond_limit": off, "max_abs_diff": worst,
            "within": off <= w.numel() // 50 and worst <= 2 * lr * steps}


def dp_window_offsets(node_walks, triple_walks, tg, pad: int) -> dict:
    """K3 and K10 (both generators) with ``window_offset`` on the bench
    walks: the chunk of walks from DP_SPLIT_WALK at its windows' offset
    against those rows of the offset-0 call, and the whole call at
    ``dp_wrap_offset`` (its counters wrap 2^32) against the plain version;
    the device time at offset 0 and at the wrapping offset
    (``queued_ms``)."""
    out = {}
    node_key = prng.derive_key(WINDOW_SEED, prng.STREAM_WINDOWS_SG)
    cases = {
        "to_windows": (
            node_walks, node_walks.shape[1] - WINDOW + 1, WINDOW - 1,
            lambda w, off: bindings.to_windows(w, WINDOW, NUM_NODES, node_key,
                                               window_offset=off),
            lambda w, off: windows.to_windows_plain(w, WINDOW, NUM_NODES,
                                                    node_key, off))}
    for name, cbow, stream in (
            ("to_windows_triples", False, prng.STREAM_WINDOWS_TRIPLES_SG),
            ("to_windows_triples_cbow", True,
             prng.STREAM_WINDOWS_TRIPLES_CBOW)):
        key = prng.derive_key(WINDOW_SEED, stream)
        cases[name] = (
            triple_walks, (triple_walks.shape[1] - 1) // 2,
            bindings.TRIPLE_CBOW_ROUNDS if cbow else 2 * WINDOW,
            lambda w, off, key=key, cbow=cbow: bindings.to_windows_triples(
                w, WINDOW, pad, tg.triples, key, cbow, window_offset=off),
            lambda w, off, key=key, cbow=cbow:
            windows.to_windows_triples_plain(w, WINDOW, pad, tg.triples, key,
                                             cbow, off))
    for name, (walks, per, draws, kernel, plain) in cases.items():
        first, wrap = DP_SPLIT_WALK * per, dp_wrap_offset(draws)
        whole = kernel(walks, 0)
        part = kernel(walks[DP_SPLIT_WALK:].contiguous(), first)
        split_err = max_abs_err(part, [x[first:] for x in whole])
        del whole, part
        wrap_err = max_abs_err(kernel(walks, wrap), plain(walks, wrap))
        require(split_err == 0 and wrap_err == 0,
                f"{name} at a window offset: {split_err}, {wrap_err}")
        out[name] = {
            "windows": walks.shape[0] * per, "draws_a_window": draws,
            "split_walk": DP_SPLIT_WALK, "split_max_abs_err": split_err,
            "wrap_offset": wrap, "first_counter": wrap * draws % 2 ** 32,
            "wrap_max_abs_err": wrap_err,
            "device_ms_offset_0": queued_ms(lambda: kernel(walks, 0),
                                            WALK_REPS),
            "device_ms_at_wrap_offset": queued_ms(
                lambda: kernel(walks, wrap), WALK_REPS)}
        torch.cuda.empty_cache()
    out["timing"] = (f"{WALK_REPS} calls queued behind a spin kernel, "
                     "median of 5, per call")
    return out


# --- the command-line entry points (phase_cli) -------------------------------

# trw-torch-walk and trw-torch-train at the ogbn-products size (BASELINE.json
# config 4: 2 449 029 nodes, about 127 M directed edges once symmetrized),
# every node a walk a step in training; the resume at a size whose
# checkpoints (6 tables of 200 000 x 128 float32) stay small; trw-torch-
# train-kg at every entity of a 1 000 x 1 000 grid KG.
CLI_SPEC = "synth:2449029:25"
CLI_WALKERS, CLI_WALK_LENGTH = 131_072, 80
CLI_TRAIN_EPOCHS = 3
CLI_RESUME_SPEC, CLI_RESUME_EPOCHS = "synth:200000:8", (2, 4)
CLI_KG_SPEC, CLI_KG_EPOCHS, CLI_KG_HOLDOUT = "grid:1000", 2, 0.00025
# the card's held-out MRR against float64 on the CPU: two formulas for the
# distance, whose rounding (about 1e-13 of a distance) may swap a candidate
# that ties the target within it
RANKING_REL_LIMIT = 1e-6
CLI_KERNELS = ("uniform_walk_csr", "node2vec_walk_csr_mixture",
               "walk_sgns_loss_fwd", "walk_sgns_loss_bwd", "adam_dense",
               "uniform_walk_triples", "kge_pair_loss_and_grads",
               "to_windows_triples", "kge_windows_loss_and_grads")


@contextlib.contextmanager
def timed_calls(owner, name: str, times: list, record=None):
    """``owner.name`` replaced, inside the block, by a wrapper that appends
    each call's seconds (host clock, device synchronised before and after)
    to ``times``, and ``record(result, *args)`` if given."""
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        synchronize()
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        synchronize()
        times.append(time.perf_counter() - t0)
        if record is not None:
            record(out, *args)
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def call_peaks(owner, name: str, dev, peaks: list):
    """``owner.name`` replaced, inside the block, by a wrapper that appends
    each call's own peak device memory to ``peaks`` (GiB above what was
    allocated when it was called).  The card's peak counter is reset for
    the call; the peak before it is folded into the run's (peak_gib) and
    into ``peaks``' entry ``"before"``, so that a caller can still report
    the peak of its whole block."""
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        if dev.type != "cuda":
            return original(*args, **kwargs)
        held = torch.cuda.max_memory_allocated()
        RUN_PEAK_BYTES[0] = max(RUN_PEAK_BYTES[0], held)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = original(*args, **kwargs)
        peaks.append({"call_gib": (torch.cuda.max_memory_allocated() - base)
                      / 2**30, "before_gib": held / 2**30})
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, original)


def csr_hops_ok(graph, walks, targets) -> bool:
    """Column 0 the targets, ids in [0, N), every hop of every walk an
    edge."""
    w = walks.to(torch.int64)
    if not (bool((w[:, 0] == targets).all())
            and bool(((w >= 0) & (w < graph.num_nodes)).all())):
        return False
    a, b = w[:, :-1].reshape(-1), w[:, 1:].reshape(-1)
    return bool(common.is_neighbor_csr(b, a, graph.row_ptr, graph.col_idx,
                                       graph.search_iters).all())


def metrics_lines(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_products_graph(dev, tmp: str) -> dict:
    """products_shape_graph twice into ``tmp``: the host draws, the device
    build and the cache write timed apart, then the load; the loaded CSR
    must equal the built one.  K1 and K2 walks on it, every hop an edge."""
    draws, saves = [], []
    peak_gib()
    with timed_calls(datasets, "power_law_edges", draws), \
            timed_calls(datasets, "_save_csr_cache", saves):
        built, total_ms = wall_ms(lambda: datasets.products_shape_graph(
            root=tmp, device=dev))
    build_peak = peak_gib()
    loaded, load_ms = wall_ms(lambda: datasets.products_shape_graph(
        root=tmp, device=dev))
    require(len(draws) == len(saves) == 1, "products_shape_graph did not "
            "draw and save once on its first call")
    require(torch.equal(built.row_ptr, loaded.row_ptr)
            and torch.equal(built.col_idx, loaded.col_idx)
            and loaded.fat == built.fat,
            "the products-shape cache did not load as the built graph")
    del built
    targets = (torch.arange(CLI_WALKERS, dtype=torch.int32, device=dev)
               % loaded.num_nodes)
    walk_ms = {}
    for name, pq in (("uniform", (1.0, 1.0)), ("mixture", (P, Q))):
        walks, walk_ms[name] = wall_ms(lambda pq=pq: tt.walk(
            loaded, target_nodes=targets, p=pq[0], q=pq[1],
            walk_length=CLI_WALK_LENGTH, seed=WALK_SEED, device=dev))
        require(tuple(walks.shape) == (CLI_WALKERS, CLI_WALK_LENGTH + 1)
                and csr_hops_ok(loaded, walks, targets),
                f"products-shape {name} walk: a hop is not an edge")
        del walks
    return {"nodes": loaded.num_nodes, "edges": loaded.num_edges,
            "max_degree": loaded.max_degree, "fat": loaded.fat,
            "host_draws_s": draws[0], "cache_write_s": saves[0],
            "first_call_s": total_ms / 1e3,
            "device_build_s": total_ms / 1e3 - draws[0] - saves[0],
            "cache_load_s": load_ms / 1e3, "cache_equal": True,
            "build_peak_gib": build_peak, "walks_peak_gib": peak_gib(),
            "walk_ms": walk_ms,
            "walkers": CLI_WALKERS, "walk_length": CLI_WALK_LENGTH,
            "hops_checked": "every hop of every walk"}


def cli_walk(tmp: str, want, device_args: list) -> dict:
    """trw-torch-walk on CLI_SPEC (p=0.5 q=2): its .npy must equal
    ``want``, ``walk()`` on the same graph."""
    out = os.path.join(tmp, "walks.npy")
    loads, walk_s = [], []
    peak_gib()
    with timed_calls(trw_cli, "_load_graph", loads), \
            timed_calls(trw_cli, "walk", walk_s):
        _, total_ms = wall_ms(lambda: trw_cli.walk_main(
            [CLI_SPEC, "-o", out, "--walkers", str(CLI_WALKERS),
             "--walk-length", str(CLI_WALK_LENGTH), "-p", str(P), "-q", str(Q)]
            + device_args))
    peak = peak_gib()
    got = np.load(out)
    require(got.shape == tuple(want.shape)
            and np.array_equal(got, want.cpu().numpy()),
            "trw-torch-walk's walks != walk() on the same graph")
    return {"spec": CLI_SPEC, "walkers": CLI_WALKERS,
            "walk_length": CLI_WALK_LENGTH, "p": P, "q": Q,
            "equal_to_walk": True, "load_s": loads[0], "walk_s": walk_s[0],
            "copy_and_save_s": total_ms / 1e3 - loads[0] - walk_s[0],
            "total_s": total_ms / 1e3, "peak_gib": peak}


def cli_train(tmp: str, device_args: list) -> dict:
    """trw-torch-train on CLI_SPEC with the defaults (dim 128, L = 40,
    window 5, float32, every node a walk a step): finite losses, the
    embeddings' shape, each epoch's time."""
    out, metrics = os.path.join(tmp, "emb.npy"), os.path.join(tmp, "m.jsonl")
    loads, epochs = [], []
    peak_gib()
    with timed_calls(trw_cli, "_load_graph", loads), \
            timed_calls(tt.Node2Vec, "epoch_step", epochs):
        _, total_ms = wall_ms(lambda: trw_cli.train_main(
            [CLI_SPEC, "-o", out, "--epochs", str(CLI_TRAIN_EPOCHS),
             "--metrics", metrics] + device_args))
    peak = peak_gib()
    lines = metrics_lines(metrics)
    losses = [x["loss"] for x in lines]
    emb = np.load(out, mmap_mode="r")
    nodes = int(CLI_SPEC.split(":")[1])
    require([x["epoch"] for x in lines] == list(range(CLI_TRAIN_EPOCHS))
            and all(np.isfinite(losses)), f"trw-torch-train losses: {losses}")
    require(emb.shape == (nodes, 128) and emb.dtype == np.float32,
            f"trw-torch-train embeddings {emb.shape} {emb.dtype}")
    return {"spec": CLI_SPEC, "epochs": CLI_TRAIN_EPOCHS,
            "walks_a_step": nodes, "dim": 128, "walk_length": 40,
            "dtype": "float32", "losses": losses,
            "epoch_ms": [s * 1e3 for s in epochs],
            "load_s": loads[0], "total_s": total_ms / 1e3, "peak_gib": peak}


def cli_resume(tmp: str, device_args: list) -> dict:
    """trw-torch-train on CLI_RESUME_SPEC at dim 128: two epochs into a
    checkpoint directory, then four into the same one (it must resume after
    epoch 2), against an uninterrupted four-epoch run: each epoch's walks
    equal, the losses within LOSS_REL_LIMIT, the final tables within
    ``dp_table_diff``'s allowance (the gradient kernels' float atomics make
    two runs' tables differ)."""
    first, last = CLI_RESUME_EPOCHS
    digests: dict = {}
    runs = {}
    for name, ckpt, epochs in (("first", "resumed", first),
                               ("resumed", "resumed", last),
                               ("uninterrupted", "whole", last)):
        metrics = os.path.join(tmp, f"{name}.jsonl")
        times: list = []
        seen = digests.setdefault(name, {})
        with timed_calls(tt.Node2Vec, "walks", times,
                         record=lambda w, self, targets, epoch, *a:
                         seen.__setitem__(epoch, walk_digest(w))):
            _, ms = wall_ms(lambda: trw_cli.train_main(
                [CLI_RESUME_SPEC, "-o", os.path.join(tmp, f"{name}.npy"),
                 "--epochs", str(epochs), "--checkpoint-dir",
                 os.path.join(tmp, ckpt), "--checkpoint-every", "1",
                 "--metrics", metrics] + device_args))
        runs[name] = {"lines": metrics_lines(metrics), "s": ms / 1e3}
    resumed_epochs = [x["epoch"] for x in runs["resumed"]["lines"]]
    require(resumed_epochs == list(range(first, last)),
            f"the second run did not resume after epoch {first}: "
            f"{resumed_epochs}")
    whole = digests["uninterrupted"]
    require(sorted(whole) == list(range(last))
            and all(digests["first"][e] == whole[e] for e in range(first))
            and all(digests["resumed"][e] == whole[e]
                    for e in range(first, last)),
            f"an epoch's walks differ: {digests}")
    got = [x["loss"] for x in runs["resumed"]["lines"]]
    want = [x["loss"] for x in runs["uninterrupted"]["lines"]][first:]
    require(np.allclose(got, want, rtol=LOSS_REL_LIMIT, atol=0),
            f"resumed losses {got} vs uninterrupted {want}")
    payloads = [torch.load(
        checkpoint.payload_path(os.path.join(tmp, d), last),
        weights_only=True) for d in ("resumed", "whole")]
    tables = {n: dp_table_diff(payloads[0][n], payloads[1][n], 1e-2, last)
              for n in ("in_emb", "out_emb")}
    require(all(d["within"] for d in tables.values()),
            f"resumed tables beyond the allowance: {tables}")
    counts = [p["_extra_state"]["count"] for p in payloads]
    require(counts == [last, last], f"Adam step counts {counts}")
    return {"spec": CLI_RESUME_SPEC, "dim": 128, "epochs": [first, last],
            "resumed_epochs": resumed_epochs, "walks_equal": True,
            "losses": got, "uninterrupted_losses": want,
            "tables_vs_uninterrupted": tables,
            "run_s": {k: v["s"] for k, v in runs.items()}}


def transe_ranking_plain(ent, rel, test, triples, chunk: int = 64) -> dict:
    """The filtered TransE tail ranking of ``test`` (numpy (T, 3)) over the
    tables ``ent`` and ``rel``, plainly on the CPU in float64, to hold the
    card's ranking against: squared distances ||q||^2 + ||e||^2 - 2 q.e (the
    card takes cdist's distances, in the same order up to float64
    rounding), the other known tails of each (h, r) found by sorting
    ``triples`` on (h, r), a rank 1 + the closer candidates + half the
    ties.  Returns {"mrr", "hits@1", "hits@10"}."""
    ent = torch.from_numpy(np.asarray(ent, np.float64))
    rel = torch.from_numpy(np.asarray(rel, np.float64))
    e2 = (ent * ent).sum(1)
    num_rel = rel.shape[0]
    key = triples[:, 0].astype(np.int64) * num_rel + triples[:, 1]
    order = np.argsort(key, kind="stable")
    keys, tails = key[order], triples[order, 2].astype(np.int64)
    ranks = []
    for c0 in range(0, len(test), chunk):
        part = np.asarray(test[c0: c0 + chunk], np.int64)
        h, r, t = (torch.from_numpy(part[:, i]) for i in range(3))
        q = ent[h] + rel[r]
        d = (q * q).sum(1, keepdim=True) + e2[None] - 2.0 * (q @ ent.T)
        rows = torch.arange(len(part))
        true_d = d[rows, t].clone()
        want = part[:, 0] * num_rel + part[:, 1]
        lo = np.searchsorted(keys, want, "left")
        hi = np.searchsorted(keys, want, "right")
        for i in range(len(part)):
            d[i, torch.from_numpy(tails[lo[i]:hi[i]])] = torch.inf
        d[rows, t] = true_d  # never filter the target
        closer = (d < true_d[:, None]).sum(1)
        ties = (d == true_d[:, None]).sum(1) - 1
        ranks.append(1 + closer.to(torch.float64) + ties / 2.0)
    ranks = torch.cat(ranks).numpy()
    return {"mrr": float((1.0 / ranks).mean()),
            "hits@1": float((ranks <= 1).mean()),
            "hits@10": float((ranks <= 10).mean())}


def cli_kg(dev, tmp: str, device_args: list) -> dict:
    """trw-torch-train-kg on CLI_KG_SPEC, every entity a walk a step: TransE
    with --eval-holdout (the filtered ranking printed, and held against
    ``transe_ranking_plain`` on the saved tables, the run's held-out triples
    and the whole grid: the MRR within RANKING_REL_LIMIT, the hits equal)
    and the skip-gram objective; each run's losses, ms a step and peak
    memory."""
    out = {}
    for name, extra in (("transe", ["--eval-holdout", str(CLI_KG_HOLDOUT)]),
                        ("skipgram", ["--objective", "skipgram"])):
        metrics = os.path.join(tmp, f"kg_{name}.jsonl")
        emb = os.path.join(tmp, f"kg_{name}.npz")
        steps: list = []
        negatives: list = []
        ranking_s: list = []
        ranked: list = []
        printed = io.StringIO()
        peak_gib()
        with timed_calls(tt.KGEmbedding, "epoch_step", steps), \
                call_peaks(kge, "corrupt_triples", dev, negatives), \
                timed_calls(trw_cli, "kg_tail_ranking_metrics", ranking_s,
                            record=lambda m, ent, rel, test:
                            ranked.append((m, test))), \
                contextlib.redirect_stdout(printed):
            _, ms = wall_ms(lambda: trw_cli.kg_train_main(
                [CLI_KG_SPEC, "-o", emb, "--epochs", str(CLI_KG_EPOCHS),
                 "--metrics", metrics] + extra + device_args))
        peak = peak_gib()
        if peak is not None and negatives:
            peak = max(peak, *(round(x["before_gib"], 2) for x in negatives))
        losses = [x["loss"] for x in metrics_lines(metrics)]
        side = int(CLI_KG_SPEC.split(":")[1])
        with np.load(emb) as data:
            tables = data["entities"], data["relations"]
        shapes = [t.shape for t in tables]
        require(len(losses) == CLI_KG_EPOCHS and all(np.isfinite(losses))
                and shapes == [(side * side, 128), (4, 128)],
                f"trw-torch-train-kg {name}: losses {losses}, {shapes}")
        out[name] = {"losses": losses, "step_ms": [s * 1e3 for s in steps],
                     "total_s": ms / 1e3, "peak_gib": peak,
                     "entities": side * side}
        if negatives:  # the pair objective's corrupted negatives
            out[name]["corrupt_triples_peak_gib"] = [
                x["call_gib"] for x in negatives]
        if name == "transe":
            require(len(ranked) == 1, f"{len(ranked)} rankings")
            (got, test), = ranked
            printed_line = json.loads(
                printed.getvalue().strip().splitlines()[-1])
            t0 = time.perf_counter()
            want = transe_ranking_plain(*tables, test,
                                        datasets.grid_kg_triples(side)[0])
            plain_s = time.perf_counter() - t0
            require(printed_line == {"filtered_" + k: round(v, 4)
                                     for k, v in got.items()}
                    and set(got) == set(want)
                    and abs(got["mrr"] - want["mrr"])
                    <= RANKING_REL_LIMIT * want["mrr"]
                    and all(got[k] == want[k] for k in ("hits@1", "hits@10")),
                    f"the card's filtered ranking {got} (printed "
                    f"{printed_line}) vs float64 on the CPU {want}")
            out[name]["filtered_ranking"] = got
            out[name]["plain_ranking"] = want
            out[name]["ranking_s"] = ranking_s[0]
            out[name]["plain_ranking_s"] = plain_s
            out[name]["held_out"] = len(test)
    return out


def cli_runs(dev) -> tuple[dict, dict]:
    """The phase's runs on ``dev`` with the launch counts set to 0 just
    before them: (fields of the cli line, launch counts).  The commands run
    on their default device, the card, for a card's ``dev``, and with
    ``--device cpu`` for the CPU's.  The reference walks of the
    trw-torch-walk check are taken before the count."""
    with tempfile.TemporaryDirectory(prefix="trw_cli_") as tmp:
        graph = trw_cli._load_graph(CLI_SPEC, dev)
        targets = (torch.arange(CLI_WALKERS, dtype=torch.int32, device=dev)
                   % graph.num_nodes)
        want = tt.walk(graph, target_nodes=targets, p=P, q=Q,
                       walk_length=CLI_WALK_LENGTH, seed=0, device=dev)
        del graph, targets
        synchronize()
        bindings.reset_launch_counts()
        args = [] if dev.type == "cuda" else ["--device", "cpu"]
        fields = {"products_shape": cli_products_graph(dev, tmp),
                  "walk": cli_walk(tmp, want, args)}
        del want
        fields["train"] = cli_train(tmp, args)
        fields["resume"] = cli_resume(tmp, args)
        fields["kg"] = cli_kg(dev, tmp, args)
        synchronize()
        launches = dict(bindings.launch_counts)
    return fields, launches


def phase_cli(smi: str) -> dict:
    """The command-line entry points on the card, in this process, through
    ``torch_random_walk_tpu_torch.cli`` as a user runs them (no --device:
    the card): ``products_shape_graph`` built and loaded again from its
    cache, with K1 and K2 walks on it; trw-torch-walk, trw-torch-train, the
    resume, and trw-torch-train-kg twice (``cli_runs``).  Returns the run's
    launch counts; each of CLI_KERNELS must have launched."""
    t0 = time.perf_counter()
    fields, launches = cli_runs(torch.device("cuda",
                                             torch.cuda.current_device()))
    require(all(launches[k] > 0 for k in CLI_KERNELS),
            f"the cli run missed a kernel: {launches}")
    emit("cli", card=smi, **fields,
         launches={k: v for k, v in launches.items() if v},
         seconds=round(time.perf_counter() - t0, 1),
         timing="host clock, the device synchronised around each timed "
                "call; peak_gib: peak device memory of the sub-run")
    return launches


def compare_dp(graph, pkgs: dict) -> None:
    """ShardedNode2Vec's dense block step (TRAIN_CONFIG) of each package of
    ``pkgs`` that has the data axis, on one NCCL group of this process, in
    turns A B ... B A from the same tables; a package without it is said so
    on its own line."""
    have = {}
    for name, pkg in pkgs.items():
        if hasattr(getattr(pkg, "parallel", None), "ShardedNode2Vec"):
            have[name] = pkg
        else:
            emit("dp_comparison_skipped", checkout=name,
                 reason="its package has no parallel.ShardedNode2Vec")
    if list(have) == ["this_tree"]:
        return
    dev = graph.device
    targets = torch.arange(TRAIN_WALKERS, dtype=torch.int32, device=dev)
    times = {name: [] for name in have}
    with nccl_group_of_one(dev):
        trainers = {}
        for name, pkg in have.items():
            par = pkg.parallel
            trainers[name] = par.ShardedNode2Vec(
                graph, par.make_mesh(), par.ShardedNode2VecConfig(
                    **TRAIN_CONFIG))
            trainers[name].init()
        losses = {name: [] for name in have}
        order = list(have) + list(reversed(have))
        for i, name in enumerate(order):
            out, ms = step_events(
                lambda j, t=trainers[name]: t.train_step(targets, j), 3)
            losses[name].append(out)
            times[name].append(statistics.median(ms[1:]))
        del trainers
    emit("dp_comparison", step_ms=times, order=order, losses=losses,
         timing="CUDA events around each step, median of the last 2 of 3")


# --- K7-K10 beside other checkouts' builds, in one process ---------------

PACKAGE = "torch_random_walk_tpu_torch"
COMPARE_CBOW_WINDOWS = (1, 2, 5, 10)


def checkout_package(root: str):
    """The port's package of another checkout of the repo (``root``, e.g. a
    ``git archive`` of the parent commit unpacked under ``build/``),
    imported beside this one: its modules are taken out of ``sys.modules``
    again, and its functions keep their own.  Its kernels build at first
    use into its own checkout's ``build/``."""
    def loaded():
        return [k for k in sys.modules
                if k == PACKAGE or k.startswith(PACKAGE + ".")]
    saved = {k: sys.modules.pop(k) for k in loaded()}
    sys.path.insert(0, str(Path(root).resolve()))
    try:
        pkg = importlib.import_module(PACKAGE)
        build_module = importlib.import_module(PACKAGE + ".kernels.build")
    finally:
        sys.path.pop(0)
        for k in loaded():
            del sys.modules[k]
        sys.modules.update(saved)
    require(Path(pkg.__file__).resolve().is_relative_to(Path(root).resolve()),
            f"{root}: its package was not the one imported")
    return pkg, build_module


def compare_calls(pkg, families: dict, num_nodes: int, walks, triples,
                  targets, pad: int, node_walks) -> dict:
    """By the public entry points of ``pkg``, on its own graph objects built
    from ``families`` (label -> (edge list, triples); the bench graph and
    its copy with dead ends): K7 and K9 through both entries on each graph;
    on the bench graph also K8 through both edge-list entries, K10
    through both generators (CBOW at each of COMPARE_CBOW_WINDOWS) on
    ``walks`` and K3 on the bench CSR walks ``node_walks``.  Keys are
    "label/call"."""
    walk_kw = dict(walk_length=WALK_LENGTH, seed=FAMILY_SEED, padding_idx=pad)
    kw = dict(walk_kw, restart=True)
    calls = {}
    for label, (edge_list, table) in families.items():
        el = pkg.EdgeListGraph.from_arrays(edge_list, num_nodes=num_nodes)
        tg = pkg.TriplesGraph.from_arrays(table, num_entities=num_nodes)
        calls.update({
            f"{label}/edge_uniform": lambda el=el: pkg.walk_edge_list(
                el, target_nodes=targets, **kw),
            f"{label}/edge_uniform_raw": lambda el=el: pkg.walk_edge_list(
                el.edge_list, el.node_edge_index, targets, **kw),
            f"{label}/triples": lambda tg=tg: pkg.walk_triples(
                tg, target_nodes=targets, **walk_kw),
            f"{label}/triples_raw": lambda tg=tg: pkg.walk_triples(
                tg.triples, tg.relation_tail_index, targets, **walk_kw)})
        if label != "bench":
            continue
        calls.update({
            "bench/edge_biased": lambda el=el: pkg.walk_edge_list(
                el, target_nodes=targets, p=P, q=Q, **kw),
            "bench/edge_biased_raw": lambda el=el: pkg.walk_edge_list(
                el.edge_list, el.node_edge_index, targets, p=P, q=Q, **kw),
            "bench/windows_sg": lambda: pkg.to_windows_triples(
                walks, WINDOW, num_nodes, pad, triples, seed=WINDOW_SEED),
            "bench/to_windows": lambda: pkg.to_windows(
                node_walks, WINDOW, num_nodes, seed=WINDOW_SEED)})
        for w in COMPARE_CBOW_WINDOWS:
            calls[f"bench/windows_cbow_w{w}"] = (
                lambda w=w: pkg.to_windows_triples_cbow(
                    walks, w, num_nodes, pad, triples, seed=WINDOW_SEED))
    return calls


def phase_compare_kernels(graph, checkouts: dict) -> dict:
    """K7 and K9 (both entries, on the bench graph and on its copy with dead
    ends), K8 (both entries), K10 (both generators, CBOW at W = 1, 2, 5,
    10) and K3 (the bench walks' skip-gram windows) of this tree beside the
    same entry points of other checkouts (``checkouts``: name -> root, e.g.
    the parent commit), each checkout's
    kernels built from its own sources, all in this one process.  Every
    output must equal this tree's entry point's (tolerance 0).  Device time
    of WALK_REPS
    calls queued behind a spin kernel, median of 5, as ``queued_ms``; the
    checkouts timed in turns, A B ... B A, so that each has two timings."""
    pad = graph.num_nodes
    families = {}
    for label, dead in (("bench", False), ("last_quarter_dead", True)):
        el, tg = family_graphs(graph, dead_quarter=dead)
        families[label] = (el.edge_list, tg.triples)
        if label == "bench":
            bench_tg = tg
        del el, tg
    targets = bench_targets(graph.device)
    walks = tt.walk_triples(bench_tg, target_nodes=targets,
                            walk_length=WALK_LENGTH, seed=FAMILY_SEED,
                            padding_idx=pad)
    node_walks = tt.walk(graph, target_nodes=targets,
                         walk_length=WALK_LENGTH, seed=WALK_SEED)
    args = (families, graph.num_nodes, walks, bench_tg.triples, targets, pad,
            node_walks)
    builds = {"this_tree": compare_calls(tt, *args)}
    registers, pkgs = {}, {"this_tree": tt}
    for name, root in checkouts.items():
        pkg, pkg_build = checkout_package(root)
        pkgs[name] = pkg
        builds[name] = compare_calls(pkg, *args)
        builds[name]["bench/edge_biased"]()  # builds its kernels
        log = pkg_build.build_log()
        names = {f: f for f in re.findall(r"Compiling entry function '(\w+)'",
                                          log)
                 if "edge_list" in f or "triples" in f or "edge_rows" in f}
        registers[name] = {f: v["registers"]
                           for f, v in ptxas_report(log, names).items()}
    want = {k: fn() for k, fn in builds["this_tree"].items()}
    errs, times = {}, {name: {} for name in builds}
    order = list(builds) + list(reversed(builds))
    for name in order:
        calls = builds[name]
        if name not in errs:
            errs[name] = {k: max_abs_err(fn(), want[k])
                          for k, fn in calls.items()}
        for k, fn in calls.items():
            times[name].setdefault(k, []).append(queued_ms(fn, WALK_REPS))
    del want
    emit("kernel_comparison", device_ms=times, max_abs_err=errs,
         registers=registers, order=order, checkouts=checkouts,
         timing=f"{WALK_REPS} calls queued behind a spin kernel, median of "
                "5, per call; each checkout twice, A B ... B A")
    require(all(e == 0 for v in errs.values() for e in v.values()),
            f"a compared checkout's outputs differ from this tree's: {errs}")
    del builds, walks, bench_tg, families, args, node_walks
    compare_routed(graph, targets[:ROUTED_WALKERS], pkgs)
    compare_routed_families(graph, targets[:ROUTED_WALKERS], pkgs)
    compare_train_windows(graph, pkgs)
    compare_kge(graph, pkgs)
    compare_dp(graph, pkgs)
    return times


def compare_train_windows(graph, pkgs: dict) -> None:
    """K16 and K17 (skip-gram on bfloat16 tables, CBOW on float32 tables, at
    TRAIN_CONFIG) and the windows-mode and CBOW train steps of each package
    of ``pkgs`` (this tree's first), in this one process, the packages in
    turns A B ... B A.  The windows are this tree's, of the bench train
    step's walks (``to_windows`` and ``to_windows_cbow``, one set a step).
    Kernels: each package's own bindings on the same tables and windows
    (K16, K17 with a unit gradient, and the fused entry where the package
    has it), CUDA events, median of 5.  Steps: each package's
    ``SkipGramModel`` (bfloat16) and ``CBOWModel`` from the same seeded
    tables, ``train_step`` on the same windows, one warm and TRAIN_STEPS
    chained steps with CUDA events around each.  Every package's loss must
    equal this tree's within LOSS_REL_LIMIT and its gradients within
    GRAD_REL_LIMIT of the largest entry.  The ``train_window_comparison``
    line."""
    dev = graph.device
    targets = torch.arange(TRAIN_WALKERS, dtype=torch.int32, device=dev)
    n2v = tt.Node2Vec(graph, tt.Node2VecConfig(**TRAIN_CONFIG,
                                               train_mode="windows"))
    steps = 1 + TRAIN_STEPS
    sg_windows, cbow_windows = [], []
    for i in range(steps):
        walks = n2v.walks(targets, i)
        sg_windows.append(n2v.windows(walks, i))
        cbow_windows.append(tt.to_windows_cbow(
            walks, TRAIN_CONFIG["window_size"], NUM_NODES, n2v.step_seed(i)))
    del n2v, walks
    forms = {"skip_gram": (False, torch.bfloat16, sg_windows[0]),
             "cbow": (True, torch.float32, cbow_windows[0])}
    kernel_calls, want = {name: {} for name in pkgs}, {}
    for form, (cbow, dtype, win) in forms.items():
        tabs = random_tables(NUM_NODES, TRAIN_CONFIG["dim"], dtype, dev,
                             seed=3)
        ids = ((win[2], win[0].reshape(-1, 1), win[1].reshape(-1, 1)) if cbow
               else (win[0].reshape(-1, 1), win[1], win[2]))
        ids = tuple(x.to(torch.int32).contiguous() for x in ids)
        one = torch.ones((), dtype=torch.float32, device=dev)
        for name, pkg in pkgs.items():
            b = pkg.kernels.bindings
            calls = {"fwd": lambda b=b, tabs=tabs, ids=ids, cbow=cbow:
                     b.sgns_windows_loss_fwd(*tabs, *ids, cbow),
                     "bwd": lambda b=b, tabs=tabs, ids=ids, cbow=cbow:
                     b.sgns_windows_loss_bwd(*tabs, *ids, one, cbow)}
            if hasattr(b, "sgns_windows_loss_and_grads"):
                calls["fused"] = (lambda b=b, tabs=tabs, ids=ids, cbow=cbow:
                                  b.sgns_windows_loss_and_grads(*tabs, *ids,
                                                                cbow))
            kernel_calls[name].update({f"{form}/{k}": fn
                                       for k, fn in calls.items()})
        want[form] = (bindings.sgns_windows_loss_fwd(*tabs, *ids, cbow),
                      plain_windows_loss_and_grads(*tabs, *ids)[1])
        del tabs
    errs = {}
    for name, calls in kernel_calls.items():
        for key, fn in calls.items():
            form, part = key.split("/")
            out = fn()
            if part == "fwd":
                e = abs(float(out) - float(want[form][0])) / abs(
                    float(want[form][0]))
                ok = e <= LOSS_REL_LIMIT
            else:
                grads = out if part == "bwd" else out[1:]
                e = max(float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(grads, want[form][1]))
                ok = e <= GRAD_REL_LIMIT
            errs.setdefault(name, {})[key] = e
            require(ok, f"{name} {key} differs from the plain version: {e}")
            del out
    del want
    order = list(pkgs) + list(reversed(pkgs))
    times = {name: {} for name in pkgs}
    for name in order:
        for key, fn in kernel_calls[name].items():
            times[name].setdefault(key, []).append(time_ms(fn))
    del kernel_calls
    step_ms, losses = {name: {} for name in pkgs}, {name: {} for name in pkgs}
    for name in order:
        pkg = pkgs[name]
        for form in forms:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            if form == "cbow":
                model = pkg.CBOWModel(NUM_NODES, TRAIN_CONFIG["dim"])
                sets = cbow_windows
            else:
                model = pkg.SkipGramModel(NUM_NODES, TRAIN_CONFIG["dim"],
                                          dtype=TRAIN_CONFIG["dtype"])
                sets = sg_windows
            model.reset_parameters(gen)
            got, ms = step_events(lambda i: model.train_step(*sets[i]),
                                  steps)
            step_ms[name].setdefault(form, []).append(ms)
            losses[name][form] = got
            del model
            torch.cuda.empty_cache()
    first = {form: losses[next(iter(pkgs))][form][0] for form in forms}
    for name in pkgs:
        for form in forms:
            e = abs(losses[name][form][0] - first[form]) / abs(first[form])
            errs[name][f"{form}/first_step_loss"] = e
            require(e <= LOSS_REL_LIMIT, f"{name} {form}: first step loss "
                    f"{losses[name][form][0]} against {first[form]}")
    emit("train_window_comparison", kernel_ms=times, step_ms=step_ms,
         losses=losses, rel_err=errs, order=order,
         timing="kernels: CUDA events, median of 5 (1 warm-up), each "
                "package's call in turns A B ... B A; steps: CUDA events "
                f"around one warm and {TRAIN_STEPS} chained train_step "
                "calls a turn, windows precomputed")


# The KGE cases of ``kge_comparison``: K19 through TransE and RotatE, K20
# through both forms.
KGE_COMPARE_CASES = ("transe", "rotate", "skipgram", "cbow")


def compare_kge(graph, pkgs: dict) -> None:
    """K19 and K20, both entries, and the KGE ``train_step`` of each package
    of ``pkgs`` (this tree's first), in this one process, the packages in
    turns A B ... B A, at KGE_CONFIG on the bench triples graph: per case of
    KGE_COMPARE_CASES one batch of this tree's second step (KGE_WALKERS
    start entities) and this tree's tables after its first (the out tables
    start at zero).  Kernels: each package's own bindings on the same
    tables and ids, CUDA events, median of 5.  Steps: each package's
    ``KGEmbedding`` on its own graph from the same triples, its model's
    tables set to those tables, one warm and
    KGE_STEPS chained ``train_step`` calls on the batch with CUDA events
    around each.  Every package's losses must equal this tree's within
    LOSS_REL_LIMIT and its gradients within GRAD_REL_LIMIT of the largest
    entry.  The ``kge_comparison`` line."""
    dev = graph.device
    _, tg = family_graphs(graph)
    targets = torch.arange(KGE_WALKERS, dtype=torch.int32, device=dev)
    graphs = {name: pkg.TriplesGraph.from_arrays(
        tg.triples, num_entities=tg.num_entities,
        num_relations=tg.num_relations) for name, pkg in pkgs.items()}
    del tg
    order = list(pkgs) + list(reversed(pkgs))
    kernel_ms = {name: {} for name in pkgs}
    step_ms = {name: {} for name in pkgs}
    errs = {name: {} for name in pkgs}
    for case in KGE_COMPARE_CASES:
        cfg = dict(KGE_CONFIG, objective=case)
        emb = tt.KGEmbedding(graphs["this_tree"], tt.KGEmbeddingConfig(**cfg))
        model = emb.init()
        emb.epoch_step(targets, 0)  # out tables start at zero
        pad = emb.padding_idx
        batch = emb.batch(emb.walks(targets, 1), 1)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        tabs = list(init.values())
        if model.pair:
            ids = model._pair_batch(*batch, pad)
            args = (*tabs, *ids, case, model.margin)
            entries = {
                "loss": lambda b, a=args: b.kge_pair_loss(*a),
                "loss_and_grads": lambda b, a=args: (
                    lambda out: (out[0], list(out[1:])))(
                        b.kge_pair_loss_and_grads(*a))}
        else:
            ids = model._as_ids(*batch)
            cbow = case == "cbow"
            entries = {
                "loss": lambda b, i=ids, c=cbow: b.kge_windows_loss(
                    tabs, *i, pad, c),
                "loss_and_grads": lambda b, i=ids, c=cbow:
                    b.kge_windows_loss_and_grads(tabs, *i, pad, c)}
        del emb, model
        want_loss, want_grads = entries["loss_and_grads"](bindings)
        for name in order:
            b = pkgs[name].kernels.bindings
            if case not in errs[name]:
                loss, grads = entries["loss_and_grads"](b)
                errs[name][case] = {
                    "loss": abs(float(loss) - float(want_loss))
                    / abs(float(want_loss)),
                    "grads": max(float((g - w).abs().max() / w.abs().max())
                                 for g, w in zip(grads, want_grads))}
                del grads
                require(errs[name][case]["loss"] <= LOSS_REL_LIMIT
                        and errs[name][case]["grads"] <= GRAD_REL_LIMIT,
                        f"{name} {case}: K19/K20 differ from this tree's: "
                        f"{errs[name][case]}")
            for entry, fn in entries.items():
                kernel_ms[name].setdefault(f"{case}/{entry}", []).append(
                    time_ms(lambda: fn(b)))
        del want_grads
        first = None
        for name in order:
            pkg = pkgs[name]
            emb = pkg.KGEmbedding(graphs[name], pkg.KGEmbeddingConfig(**cfg))
            model = emb.init()
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
            losses, ms = step_events(lambda i: emb.train_step(batch),
                                     1 + KGE_STEPS)
            step_ms[name].setdefault(case, []).append(ms)
            first = losses[0] if first is None else first
            e = abs(losses[0] - first) / abs(first)
            errs[name][case]["first_step_loss"] = e
            require(e <= LOSS_REL_LIMIT, f"{name} {case}: first step loss "
                    f"{losses[0]} against {first}")
            del emb, model
            torch.cuda.empty_cache()
        del init, tabs, ids, batch, entries
    emit("kge_comparison", kernel_ms=kernel_ms, step_ms=step_ms,
         rel_err=errs, order=order, config=KGE_CONFIG, walkers=KGE_WALKERS,
         timing="kernels: CUDA events, median of 5 (1 warm-up), each "
                "package's call in turns A B ... B A; steps: CUDA events "
                f"around one warm and {KGE_STEPS} chained train_step calls "
                "a turn on the same batch, from the same tables")


def compare_routed(graph, targets, pkgs: dict) -> None:
    """The routed uniform and node2vec serial legs (D = NUM_SHARDS, p=P
    q=Q, hashes and Blooms) of each package of ``pkgs`` (this tree's first)
    through its own public entry points, on its own partition and tables
    built from the bench graph: warm legs on the host clock, three a turn,
    the packages in turns A B ... B A, and the device time of each phase
    call (CUDA events, the phases' calls) of one leg each.  Walks and info
    must equal this tree's.  The ``routed_comparison`` line."""
    legs = {}
    for name, pkg in pkgs.items():
        g = pkg.CSRGraph.from_arrays(graph.row_ptr, graph.col_idx,
                                     sort_rows=False, build_fat=False)
        pg = pkg.PartitionedCSR.from_csr(g, NUM_SHARDS)
        hashes = pkg.build_partition_hashes(pg, g)
        blooms = pkg.build_partition_blooms(pg, g)
        legs[name] = {
            "uniform_serial": (lambda pkg=pkg, pg=pg: pkg.walk_partitioned_routed(
                pg, targets, WALK_LENGTH, seed=WALK_SEED)),
            "node2vec_serial": (
                lambda pkg=pkg, pg=pg, h=hashes, b=blooms:
                pkg.walk_partitioned_node2vec_routed(
                    pg, h, targets, P, Q, WALK_LENGTH, seed=WALK_SEED,
                    spec_rounds=SPEC_ROUNDS, blooms=b))}
    want = {leg: fn() for leg, fn in legs["this_tree"].items()}
    errs, times, calls = {}, {name: {} for name in legs}, {}
    order = list(legs) + list(reversed(legs))
    for name in order:
        for leg, fn in legs[name].items():
            walks, info = fn()  # warm
            if name not in errs or leg not in errs[name]:
                errs.setdefault(name, {})[leg] = (
                    max_abs_err(walks, want[leg][0])
                    if info == want[leg][1] else -1)
            times[name].setdefault(leg, []).extend(
                wall_ms(fn)[1] for _ in range(3))
    for name, pkg in pkgs.items():
        for leg, kernel in (("uniform_serial", "routed_uniform_phase"),
                            ("node2vec_serial", "routed_node2vec_phase")):
            (_, info), ms = phase_call_ms(pkg.kernels.bindings, kernel,
                                          legs[name][leg])
            calls.setdefault(name, {})[leg] = {
                "calls": len(ms), "phases": info["phases"],
                "device_ms_per_call": sum(ms[:info["phases"]])
                / info["phases"]}
    emit("routed_comparison", warm_leg_ms=times, phase_calls=calls,
         max_abs_err=errs, order=order,
         timing="warm legs on the host clock, three a turn, A B ... B A; "
         "phase calls: CUDA events around each call of one leg, the "
         "phases' calls")
    require(all(e == 0 for v in errs.values() for e in v.values()),
            f"a compared checkout's routed legs differ from this tree's: "
            f"{errs}")


def compare_routed_families(graph, targets, pkgs: dict) -> None:
    """K13's, K14's and K15's bench legs (the triples, the uniform edge
    list with restart, and p=P q=Q with Bloom filters; D = NUM_SHARDS,
    padding N, seed 7; both schedules) of each package of ``pkgs`` (this
    tree's first) through its own public entry points, on its own triples
    and edge-list graphs, partitions and tables built from the bench graph:
    warm legs on the host clock, three a turn, the packages in turns A B
    ... B A; then one warm leg of each by the profiler (all device time
    over the phases, and the idle share).  Walks and info must equal this
    tree's.  The ``routed_family_comparison`` line."""
    n = graph.num_nodes
    heads = torch.repeat_interleave(
        torch.arange(n, device=graph.device),
        (graph.row_ptr[1:] - graph.row_ptr[:-1]).to(torch.int64))
    tails = graph.col_idx.to(torch.int64)
    edge_list = torch.stack([heads, tails], dim=1)
    triples = torch.stack([heads, heads * RELATION_MULT % NUM_RELATIONS,
                           tails], dim=1)
    del heads, tails
    legs = {}
    for name, pkg in pkgs.items():
        tg = pkg.TriplesGraph.from_arrays(triples, num_entities=n)
        pt = pkg.PartitionedTriples.from_triples(tg, NUM_SHARDS)
        el = pkg.EdgeListGraph.from_arrays(edge_list, num_nodes=n)
        pe = pkg.PartitionedEdgeList.from_edge_list(el, NUM_SHARDS)
        hashes = pkg.build_edge_list_partition_hashes(pe, el)
        blooms = pkg.build_edge_list_partition_blooms(pe, el)
        del el, tg
        legs[name] = {}
        for schedule in partition_v2.SCHEDULES:
            legs[name][f"triples_{schedule}"] = (
                lambda pkg=pkg, pt=pt, schedule=schedule:
                pkg.walk_triples_partitioned_routed(
                    pt, targets, WALK_LENGTH, n, seed=FAMILY_SEED,
                    schedule=schedule))
            legs[name][f"edge_uniform_restart_{schedule}"] = (
                lambda pkg=pkg, pe=pe, schedule=schedule:
                pkg.walk_edge_list_partitioned_routed(
                    pe, targets, WALK_LENGTH, n, restart=True,
                    seed=FAMILY_SEED, schedule=schedule))
            legs[name][f"edge_n2v_{schedule}"] = (
                lambda pkg=pkg, pe=pe, h=hashes, b=blooms, schedule=schedule:
                pkg.walk_edge_list_node2vec_partitioned_routed(
                    pe, h, targets, P, Q, WALK_LENGTH, n, restart=True,
                    seed=FAMILY_SEED, spec_rounds=SPEC_ROUNDS, blooms=b,
                    schedule=schedule))
    del edge_list, triples
    want = {leg: fn() for leg, fn in legs["this_tree"].items()}
    errs, times = {}, {name: {} for name in legs}
    order = list(legs) + list(reversed(legs))
    for name in order:
        for leg, fn in legs[name].items():
            walks, info = fn()  # warm
            if leg not in errs.setdefault(name, {}):
                errs[name][leg] = (max_abs_err(walks, want[leg][0])
                                   if info == want[leg][1] else -1)
            times[name].setdefault(leg, []).extend(
                wall_ms(fn)[1] for _ in range(3))
    profiled = {}
    for name in legs:
        for leg, fn in legs[name].items():
            (_, info), ms, kernels = profile_device(fn)
            busy = sum(v for _, v in kernels.values())
            profiled.setdefault(name, {})[leg] = None if busy <= 0 else {
                "phases": info["phases"], "leg_ms": ms,
                "device_launches": sum(c for c, _ in kernels.values()),
                "device_us_a_phase": busy / info["phases"] * 1e3,
                "device_idle_share": 1 - busy / ms}
    emit("routed_family_comparison", warm_leg_ms=times, profiled=profiled,
         max_abs_err=errs, order=order,
         timing="warm legs on the host clock, three a turn, A B ... B A; "
         "profiled: torch.profiler, device activity only, one warm leg "
         "(null if it saw no device time)")
    require(all(e == 0 for v in errs.values() for e in v.values()),
            f"a compared checkout's routed family legs differ from this "
            f"tree's: {errs}")


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--compare", metavar="NAME=DIR", action="append", default=[],
        help="another checkout of the repo (e.g. the parent commit's "
             "git archive under build/): time its K7-K10 entry points, "
             "routed CSR legs, K13-K15 legs, K16/K17 and window train "
             "steps, K19/K20 and KGE train steps beside this tree's in one "
             "process (kernel_comparison, routed_comparison, "
             "routed_family_comparison, train_window_comparison and "
             "kge_comparison lines)")
    args = parser.parse_args(argv)
    args.compare = dict(v.split("=", 1) for v in args.compare)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    phase_small_checks()
    phase_family_small_checks()
    graph = phase_graph()
    (targets, pgraph, tables, out, launches,
     main_runs) = phase_main_path(graph)
    walk_ms, walk_entry_ms = phase_walk_times(graph)
    train_launches = phase_train(graph)
    by_run = {name: {"sampling": launches[name], "train": train_launches[name]}
              for name in launches}
    for name in launches:  # both runs of the main path, added up
        launches[name] += train_launches[name]
    rows = phase_kernels(graph, targets, out, launches, walk_ms,
                         walk_entry_ms)
    rows += phase_routed(graph, targets, pgraph, tables, out, launches,
                         main_runs)
    for r in rows:
        require(r["max_abs_err"] == 0, f"{r['name']} != its plain version at "
                "the main path's shape")
    del pgraph, tables, out
    rows += phase_sgns_kernels(graph, launches)
    for r in rows:
        r["launches_by_run"] = by_run[r["name"]]
    mode_rows, mode_launches = phase_train_modes(graph)
    for r in mode_rows:
        r["launches_by_run"] = {"train": train_launches[r["name"]],
                                "train_modes": mode_launches[r["name"]]}
        r["launches"] = sum(r["launches_by_run"].values())
    rows += mode_rows
    require([r["name"] for r in rows] == [
        "uniform_walk_csr", "node2vec_walk_csr_mixture",
        "node2vec_walk_csr_rejection", "to_windows", "all_to_all_chunks",
        "routed_uniform_phase", "routed_node2vec_phase",
        "walk_sgns_loss_fwd", "walk_sgns_loss_bwd", "sgns_windows_loss_fwd",
        "sgns_windows_loss_bwd", "sgns_windows_loss_and_grads", "adam_dense",
        "adam_rows"],
        "a kernel row is missing")
    require(all(r["launches"] > 0 for r in rows),
            "a kernel was never launched on the main path")
    require(by_run["uniform_walk_csr"] == {"sampling": 1,
                                           "train": 1 + TRAIN_STEPS},
            "K1: one launch in sampling and one a train step expected")
    el, tg, targets, family_launches, checked = phase_family_main_path(graph)
    family_rows = phase_family_kernels(el, tg, targets, family_launches,
                                       checked)
    del el, tg
    for r in family_rows:
        r["launches_by_run"] = {"families": r["launches"]}
    rows += family_rows
    require([r["name"] for r in family_rows] == list(FAMILY_KERNELS)
            and all(r["launches"] > 0 and r["max_abs_err"] == 0
                    for r in family_rows), "a family kernel row is wrong")
    routed_family_rows = phase_routed_families(graph)
    rows += routed_family_rows
    require([r["name"] for r in routed_family_rows]
            == list(ROUTED_FAMILY_KERNELS)
            and all(r["launches"] > 0 and r["max_abs_err"] == 0
                    for r in routed_family_rows),
            "a routed family kernel row is wrong")
    kge_rows = phase_kge(graph)
    for r in kge_rows:
        r["launches_by_run"] = {"kge": r["launches"]}
    rows += kge_rows
    require([r["name"] for r in kge_rows] == list(KGE_ROWS)
            and all(r["launches"] > 0 for r in kge_rows),
            "a KGE kernel row is missing or was never launched")
    dp_launches = phase_dp(graph, smi)
    cli_launches = phase_cli(smi)
    for run, counts in (("dp", dp_launches), ("cli", cli_launches)):
        for r in rows:  # each run counted from zero
            if counts[r["name"]]:
                r.setdefault("launches_by_run", {})[run] = counts[r["name"]]
                r["launches"] += counts[r["name"]]
    require(set(CLI_KERNELS) <= {r["name"] for r in rows}
            and all(r["launches_by_run"].get("cli", 0) > 0 for r in rows
                    if r["name"] in CLI_KERNELS),
            "a cli kernel row is missing or shows no launch of the cli run")
    if args.compare:
        phase_compare_kernels(graph, args.compare)
    torch.cuda.synchronize()
    peak_gib()
    emit("done", seconds=round(time.perf_counter() - t0, 1),
         peak_device_gib=round(RUN_PEAK_BYTES[0] / 2**30, 2))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
