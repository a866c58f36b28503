"""End-to-end node2vec/DeepWalk pipeline: walk -> blockwise SGNS training
(twin of ``torch_random_walk_tpu/models/node2vec.py``).

One ``epoch_step`` samples walks from a batch of start nodes and takes one
fused train step on them (``SkipGramModel.walk_train_step``); the walks stay
on the device.  The whole run is a pure function of (config.seed, epoch,
targets) and the initial tables: walks and shared negatives equal the JAX
package's value for value.

Ported: ``train_mode="block"`` with ``update_mode="dense"`` and
``negative_distribution="uniform"``.  ``train_mode="windows"``,
``update_mode="sparse"`` and ``negative_distribution="degree75"`` raise
``NotImplementedError`` (``ROADMAP.md`` queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.models.skipgram import (
    SkipGramModel,
    not_ported,
    shared_negative_ids,
)
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.ops.walk import walk
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device

_EPOCH_STRIDE = 0x9E3779B1


@dataclasses.dataclass(frozen=True)
class Node2VecConfig:
    dim: int = 128
    walk_length: int = 40
    window_size: int = 5
    walks_per_node: int = 1
    p: float = 1.0
    q: float = 1.0
    learning_rate: float = 1e-2
    seed: int = 0
    dtype: str = "float32"  # "bfloat16" halves the tables
    # "block" = blockwise SGNS on whole walks with batch-shared negatives;
    # "windows" = materialised to_windows batches (not ported yet).
    train_mode: str = "block"
    # Shared negatives per step in "block" mode.
    shared_negatives: int = 256
    # "dense" = Adam over the full tables each step; "sparse" = touched-rows
    # Adam (not ported yet).
    update_mode: str = "dense"
    # "uniform" or "degree75" (not ported yet).
    negative_distribution: str = "uniform"


class Node2Vec:
    """node2vec embedding trainer over a ``CSRGraph``.  ``device=None`` means
    the card; the graph must live on the same device."""

    def __init__(self, graph: CSRGraph,
                 config: Node2VecConfig = Node2VecConfig(), device=None):
        self.graph = graph
        self.config = config
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, the trainer was "
                             f"asked for {self.device}")
        if config.update_mode not in ("dense", "sparse"):
            raise ValueError(f"unknown update_mode {config.update_mode!r}")
        if config.update_mode == "sparse" and config.train_mode != "block":
            raise ValueError("update_mode='sparse' requires "
                             "train_mode='block'")
        if config.negative_distribution not in ("uniform", "degree75"):
            raise ValueError("unknown negative_distribution "
                             f"{config.negative_distribution!r}")
        if (config.negative_distribution != "uniform"
                and config.train_mode != "block"):
            raise ValueError("negative_distribution='degree75' requires "
                             "train_mode='block' (windows-mode negatives "
                             "are reference-parity uniform)")
        if config.update_mode == "sparse":
            raise not_ported("update_mode='sparse' (touched-rows Adam)")
        if config.negative_distribution == "degree75":
            raise not_ported("negative_distribution='degree75' (alias "
                              "negatives)")
        if config.train_mode != "block":
            raise not_ported(f"train_mode={config.train_mode!r}")
        self.model = SkipGramModel(
            graph.num_nodes, config.dim, dtype=config.dtype,
            learning_rate=config.learning_rate, device=self.device)

    def init(self) -> SkipGramModel:
        """Fresh tables from ``config.seed`` (through ``torch.Generator``, so
        not the JAX package's numbers) and zero optimizer state."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(self.config.seed))
        self.model.reset_parameters(generator)
        return self.model

    def step_seed(self, epoch: int) -> int:
        """uint32(seed) + uint32(epoch) * 0x9E3779B1, wrapping: the seed of
        the epoch's walks and of its shared negatives."""
        return ((int(self.config.seed) & prng.MASK32)
                + (int(epoch) & prng.MASK32) * _EPOCH_STRIDE) & prng.MASK32

    def sample(self, targets, epoch: int):
        """The walks and shared negatives of one epoch step.  The walks go
        through ``walk(graph, ...)``, so their sampler follows ``graph.fat``
        as the JAX ``epoch_step`` follows ``edge_tab``: the mixture of the
        fat engine, or ``node2vec_walk_csr`` with ``graph.search_iters``."""
        cfg = self.config
        seed = self.step_seed(epoch)
        walks = walk(self.graph, target_nodes=targets, p=cfg.p, q=cfg.q,
                     walk_length=cfg.walk_length, seed=seed,
                     device=self.device)
        neg_ids = shared_negative_ids(seed, cfg.shared_negatives,
                                      self.graph.num_nodes, self.device)
        return walks, neg_ids

    def epoch_step(self, targets, epoch: int) -> torch.Tensor:
        """One fused sample+train step over a batch of start nodes; updates
        the model in place and returns the loss (before the update)."""
        walks, neg_ids = self.sample(targets, epoch)
        return self.model.walk_train_step(
            walks, neg_ids, self.config.window_size,
            self.config.window_size - 1)

    def train(self, num_epochs: int, batch_nodes=None, log_every: int = 0):
        """Simple training loop from fresh tables; returns (model, losses)."""
        self.init()
        if batch_nodes is None:
            batch_nodes = torch.arange(self.graph.num_nodes,
                                       dtype=torch.int32, device=self.device)
        batch_nodes = common.as_int32(batch_nodes, self.device).repeat(
            self.config.walks_per_node)
        losses = []
        for epoch in range(num_epochs):
            losses.append(float(self.epoch_step(batch_nodes, epoch)))
            if log_every and epoch % log_every == 0:
                print(f"epoch {epoch}: loss {losses[-1]:.4f}")
        return self.model, np.array(losses)

    def embeddings(self) -> torch.Tensor:
        return self.model.embeddings()
