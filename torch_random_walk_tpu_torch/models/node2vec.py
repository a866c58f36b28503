"""End-to-end node2vec/DeepWalk pipeline: walk -> (windows ->) SGNS training
(twin of ``torch_random_walk_tpu/models/node2vec.py``).

One ``epoch_step`` samples walks from a batch of start nodes and takes one
train step on them; the walks stay on the device.  The whole run is a pure
function of (config.seed, epoch, targets) and the initial tables: walks,
windows and shared negatives equal the JAX package's value for value.

Every mode of the JAX trainer is ported:

- ``train_mode="block"``: the fused blockwise step on whole walks with S
  batch-shared negatives (``SkipGramModel.walk_train_step``: K5/K6, then
  K18's dense Adam on the card); ``"windows"``: ``to_windows`` of the walks
  (K3) and the per-window step (``SkipGramModel.train_step``: K16/K17, then
  K18).
- ``update_mode="dense"`` (Adam over the whole tables) or ``"sparse"`` (the
  touched-rows step ``walk_train_step_sparse``: K5/K6 on the gathered rows,
  then K18's rows entry; block mode only).
- ``negative_distribution="uniform"`` or ``"degree75"``: word2vec's
  deg^0.75 table, drawn through alias tables built once on the host from
  ``graph.row_ptr`` (``utils/alias.py``; block mode only).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.models.skipgram import (
    SkipGramModel,
    shared_negative_ids,
)
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.ops.walk import walk
from torch_random_walk_tpu_torch.ops.windows import to_windows
from torch_random_walk_tpu_torch.utils import alias, prng
from torch_random_walk_tpu_torch.utils.device import resolve_device


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
    # "windows" = materialised to_windows batches with per-window negatives.
    train_mode: str = "block"
    # Shared negatives per step in "block" mode.
    shared_negatives: int = 256
    # "dense" = Adam over the full tables each step; "sparse" = touched-rows
    # (lazy) Adam, "block" train_mode only.
    update_mode: str = "dense"
    # Shared negatives in "block" mode: "uniform" or "degree75" (deg^0.75
    # through alias tables).
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
        # (prob, alias) of the degree^0.75 negatives, built once on the host
        # and moved to the device; None for uniform negatives.
        self.neg_tabs = None
        if config.negative_distribution == "degree75":
            self.neg_tabs = alias.build_alias(
                alias.degree75_weights(graph.row_ptr), self.device)
        self.model = SkipGramModel(
            graph.num_nodes, config.dim, dtype=config.dtype,
            learning_rate=config.learning_rate, device=self.device)

    def init(self) -> SkipGramModel:
        """Fresh tables from ``config.seed`` (through ``torch.Generator``, so
        not the JAX package's numbers) and zero optimizer state (float32
        moments for ``update_mode="sparse"``)."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(self.config.seed))
        self.model.reset_parameters(generator)
        if self.config.update_mode == "sparse":
            self.model.init_sparse_opt_state()
        return self.model

    def step_seed(self, epoch: int) -> int:
        """uint32(seed) + uint32(epoch) * 0x9E3779B1, wrapping: the seed of
        the epoch's walks and of its shared negatives."""
        return prng.epoch_seed(self.config.seed, epoch)

    def walks(self, targets, epoch: int) -> torch.Tensor:
        """The walks of one epoch step.  They go through ``walk(graph,
        ...)``, so their sampler follows ``graph.fat`` as the JAX
        ``epoch_step`` follows ``edge_tab``: the mixture of the fat engine,
        or ``node2vec_walk_csr`` with ``graph.search_iters``."""
        cfg = self.config
        return walk(self.graph, target_nodes=targets, p=cfg.p, q=cfg.q,
                    walk_length=cfg.walk_length, seed=self.step_seed(epoch),
                    device=self.device)

    def negatives(self, epoch: int) -> torch.Tensor:
        """The S shared negatives of one block-mode epoch step: uniform, or
        drawn from the degree^0.75 alias tables."""
        cfg, seed = self.config, self.step_seed(epoch)
        if self.neg_tabs is not None:
            return alias.shared_negative_ids_alias(
                seed, cfg.shared_negatives, *self.neg_tabs)
        return shared_negative_ids(seed, cfg.shared_negatives,
                                   self.graph.num_nodes, self.device)

    def sample(self, targets, epoch: int):
        """The walks and shared negatives of one block-mode epoch step."""
        return self.walks(targets, epoch), self.negatives(epoch)

    def windows(self, walks, epoch: int):
        """The (targets, pos, neg) skip-gram windows of the epoch's walks, as
        the JAX ``epoch_step`` makes them in ``train_mode="windows"``."""
        return to_windows(walks, self.config.window_size,
                          self.graph.num_nodes, self.step_seed(epoch),
                          device=self.device)

    def epoch_step(self, targets, epoch: int) -> torch.Tensor:
        """One sample+train step over a batch of start nodes; updates the
        model in place and returns the loss (before the update)."""
        cfg = self.config
        walks = self.walks(targets, epoch)
        if cfg.train_mode != "block":
            return self.model.train_step(*self.windows(walks, epoch))
        step = (self.model.walk_train_step_sparse
                if cfg.update_mode == "sparse"
                else self.model.walk_train_step)
        return step(walks, self.negatives(epoch), cfg.window_size,
                    cfg.window_size - 1)

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
