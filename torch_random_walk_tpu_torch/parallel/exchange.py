"""Walker-record exchange between shards (counterpart of
``torch_random_walk_tpu/parallel/pallas_exchange.py``).

``all_to_all_chunks`` is the all-to-all of per-destination record chunks of
the routed engines: shard ``src``'s outbox chunk ``dst`` lands in shard
``dst``'s inbox chunk ``src``, the semantics of
``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`` and of the JAX
package's Pallas remote-DMA kernel.  Every shard owns its own (D, C, R) int32
outbox and inbox (uint32 records, stored as their int32 bit patterns).

On a CUDA device the copy is the hand-written kernel K4
(``kernels/exchange.cu``), one launch for all D*D chunks, reading one base
pointer per shard.  **K4 has so far run only with every shard's buffers on
one card**; passing pointers that are peer-mapped from other cards is a later
step.  ``all_to_all_chunks_plain`` is the plain PyTorch version, used on the
CPU and to check the kernel.
"""

from __future__ import annotations

import torch

from torch_random_walk_tpu_torch.kernels import bindings


def all_to_all_chunks_plain(outboxes):
    """Plain version: stack, swap the (src, dst) axes, split per shard."""
    swapped = torch.stack(list(outboxes)).transpose(0, 1).contiguous()
    return list(swapped.unbind(0))


class ChunkExchange:
    """The exchange of one fixed set of buffers: D per-shard (D, C, R) int32
    outboxes and as many inboxes, which must not alias them.  Calling it
    copies every outbox chunk into its inbox as the buffers stand then, and
    returns the inboxes.  The routed engine builds one per walk and calls it
    once per phase."""

    def __init__(self, outboxes, inboxes):
        self.outboxes, self.inboxes = list(outboxes), list(inboxes)
        self._on_card = self.outboxes[0].is_cuda
        if self._on_card:
            self._table = bindings.chunk_pointer_table(self.outboxes,
                                                       self.inboxes)

    def __call__(self):
        if self._on_card:
            bindings.all_to_all_chunks(self._table)
        else:
            for inbox, got in zip(self.inboxes,
                                  all_to_all_chunks_plain(self.outboxes),
                                  strict=True):
                inbox.copy_(got)
        return self.inboxes


def all_to_all_chunks(outboxes, inboxes=None):
    """Exchange D per-shard (D, C, R) int32 outboxes once; returns the D
    inboxes, written in place when given, else allocated."""
    outboxes = list(outboxes)
    if inboxes is None:
        inboxes = [torch.empty_like(o) for o in outboxes]
    return ChunkExchange(outboxes, inboxes)()
