"""Embedding trainers of the port: the SGNS model (blockwise and per-window
losses, dense and touched-rows Adam), the CBOW model and the node2vec
pipeline around them."""

from torch_random_walk_tpu_torch.models.cbow import CBOWModel
from torch_random_walk_tpu_torch.models.node2vec import Node2Vec, Node2VecConfig
from torch_random_walk_tpu_torch.models.skipgram import (
    SkipGramModel,
    WalkSGNSLoss,
    WindowsSGNSLoss,
    scatter_rows,
    shared_negative_ids,
    sorted_unique_with_locations,
    walk_loss_plain,
    windows_loss_plain,
)

__all__ = [
    "CBOWModel",
    "Node2Vec",
    "Node2VecConfig",
    "SkipGramModel",
    "WalkSGNSLoss",
    "WindowsSGNSLoss",
    "scatter_rows",
    "shared_negative_ids",
    "sorted_unique_with_locations",
    "walk_loss_plain",
    "windows_loss_plain",
]
