"""Embedding trainers of the port: the blockwise SGNS model and the
node2vec pipeline around it."""

from torch_random_walk_tpu_torch.models.node2vec import Node2Vec, Node2VecConfig
from torch_random_walk_tpu_torch.models.skipgram import (
    SkipGramModel,
    WalkSGNSLoss,
    shared_negative_ids,
    walk_loss_plain,
)

__all__ = [
    "Node2Vec",
    "Node2VecConfig",
    "SkipGramModel",
    "WalkSGNSLoss",
    "shared_negative_ids",
    "walk_loss_plain",
]
