"""Embedding trainers of the port: the SGNS model (blockwise and per-window
losses, dense and touched-rows Adam), the CBOW model and the node2vec
pipeline around them, the KG-embedding model and trainer (TransE,
DistMult, RotatE, triple skip-gram and CBOW), and the quality evaluations
(link prediction, node classification, KG tail ranking)."""

from torch_random_walk_tpu_torch.models.cbow import CBOWModel
from torch_random_walk_tpu_torch.models.eval import (
    kg_tail_ranking_metrics,
    link_prediction_auc,
    link_prediction_auc_trained,
    node_classification_accuracy,
    sample_negative_edges,
    sbm_oracle_auc,
)
from torch_random_walk_tpu_torch.models.kge import (
    KGEmbedding,
    KGEmbeddingConfig,
    KGEModel,
    KGEPairLoss,
    KGEWindowsLoss,
    corrupt_triples,
)
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
    "KGEModel",
    "KGEPairLoss",
    "KGEWindowsLoss",
    "KGEmbedding",
    "KGEmbeddingConfig",
    "Node2Vec",
    "Node2VecConfig",
    "SkipGramModel",
    "WalkSGNSLoss",
    "WindowsSGNSLoss",
    "corrupt_triples",
    "kg_tail_ranking_metrics",
    "link_prediction_auc",
    "link_prediction_auc_trained",
    "node_classification_accuracy",
    "sample_negative_edges",
    "sbm_oracle_auc",
    "scatter_rows",
    "shared_negative_ids",
    "sorted_unique_with_locations",
    "walk_loss_plain",
    "windows_loss_plain",
]
