"""CBOW embedding trainer with one negative per window (twin of
``torch_random_walk_tpu/models/cbow.py``).

Consumes the (pos_nodes, neg_nodes, context) batches of ``to_windows_cbow``:
the center node is predicted from the mean of the W-1 context rows of
``in_emb``, contrasted against the negative node's row of ``out_emb``.  The
tables are float32, and the optimizer is dense Adam at 1e-3 (optax's
``adam(1e-3)``) or a custom factory, as ``SkipGramModel``'s.  On a CUDA tensor
the loss is the CBOW form of K16, its gradient K17's
(``kernels/sgns_windows.cu``: ``du / (W-1)`` to each context row; each out
row summed by its owner, ``sgns_windows_owner.cu``), both from one call in
the train step, and the update K18's dense entry; ``windows_loss_plain`` and
``adam_dense_plain`` are their plain versions.
"""

from __future__ import annotations

from torch_random_walk_tpu_torch.models.skipgram import EmbeddingTables


class CBOWModel(EmbeddingTables):
    """CBOW tables (float32) with their optimizer state.  ``device=None``
    means the card."""

    def __init__(self, num_nodes: int, dim: int = 128, optimizer=None,
                 device=None):
        super().__init__(num_nodes, dim, optimizer=optimizer,
                         dtype="float32", device=device)

    def _window_ids(self, pos_nodes, neg_nodes, context):
        pos_nodes, neg_nodes, context = self._as_ids(pos_nodes, neg_nodes,
                                                     context)
        return context, pos_nodes.reshape(-1, 1), neg_nodes.reshape(-1, 1)

    def loss_fn(self, pos_nodes, neg_nodes, context):
        """JAX's ``loss_fn``: -(log σ(h·v⁺) + log σ(-h·v⁻)) averaged over
        the windows, h the mean of a window's context rows; ``pos_nodes`` and
        ``neg_nodes`` (B,), ``context`` (B, W-1).  Differentiable with respect
        to the tables."""
        return self._windows_loss(
            *self._window_ids(pos_nodes, neg_nodes, context), True)

    def train_step(self, pos_nodes, neg_nodes, context):
        """One train step: the loss and its float32 gradients (K16/K17 on the
        card), then the optimizer, in place.  Returns the loss before the
        update."""
        return self._windows_step(
            *self._window_ids(pos_nodes, neg_nodes, context), True)
