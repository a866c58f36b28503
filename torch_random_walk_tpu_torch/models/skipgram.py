"""Skip-gram with negative sampling over whole walks (twin of the block path
of ``torch_random_walk_tpu/models/skipgram.py``).

The loss is the JAX package's ``SkipGramModel.walk_loss_fn``: centers at walk
positions hw .. L-hw (hw = window_size // 2), contexts at offsets +-1..+-hw,
and ``num_neg`` negatives per center estimated with S batch-shared uniform
negatives scaled by num_neg / S.  Logits and the loss are float32 whatever
the tables' type.  A node id of -1 (the graph entry's mark of a walk that ran
out of rounds) addresses the last row, as ``table[walks]`` does in JAX.

On a CUDA tensor the loss is the hand-written kernel K5 and its gradient K6
(``kernels/sgns_loss.cu``); ``walk_loss_plain`` (differentiated by autograd)
is their plain PyTorch version, used on the CPU and to check the kernels.

The optimizer is dense Adam with optax's arithmetic (``optax.adam``:
``scale_by_adam`` with ``eps_root = 0``, then ``scale(-lr)``): every row gets
the update every step, also rows with a zero gradient.  The moments ``mu`` and
``nu`` are kept in the tables' type, as optax keeps them.  Where the port
rounds, for tables narrower than float32: the gradient is rounded to the
tables' type once (JAX's gradient of a bfloat16 table is bfloat16; the
kernels accumulate it in float32 first), each moment is updated in float32
from its stored value and rounded once when stored, the step is computed in
float32 from the stored moments, and the parameter is rounded once after the
step is added.  optax rounds after every elementwise operation instead, so
bfloat16 runs agree loosely and float32 runs tightly.  All updates are in
place.

Not in this slice (``ROADMAP.md`` queue 1 item 5, each raises
``NotImplementedError``): the window-mode ``loss_fn``/``train_step``, the
touched-rows step ``walk_train_step_sparse`` with
``sorted_unique_with_locations`` and ``scatter_rows``, and a custom
optimizer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item 5 (remaining "
        "trainers)")


def shared_negative_ids(seed, num: int, num_nodes: int, device=None):
    """``num`` uniform negative node ids from the (seed, STREAM_TRAIN)
    Threefry stream, (num,) int32: a pure function of ``seed``, equal to the
    JAX package's value for value."""
    dev = resolve_device(device)
    key = prng.derive_key(seed, prng.STREAM_TRAIN)
    ids = torch.arange(num, dtype=torch.int64, device=dev)
    bits, _ = prng.counter_bits(key, ids, torch.zeros_like(ids))
    return prng.randint_from_bits(bits, int(num_nodes)).to(torch.int32)


def blockwise_loss_plain(u, out_rows, v_neg, hw: int, num_neg: int):
    """Plain version of the blockwise loss on gathered rows: u (B, C, D)
    center rows, out_rows (B, L+1, D), v_neg (S, D)."""
    length1 = out_rows.shape[1]
    u = u.float()
    out_rows = out_rows.float()
    pos_ls = torch.zeros(u.shape[:2], dtype=torch.float32, device=u.device)
    for off in range(-hw, hw + 1):
        if off == 0:
            continue
        v = out_rows[:, hw + off: length1 - hw + off]
        pos_ls = pos_ls + F.logsigmoid((u * v).sum(-1))
    neg_logit = u @ v_neg.float().T
    neg_w = num_neg / v_neg.shape[0]
    loss = -(pos_ls + neg_w * F.logsigmoid(-neg_logit).sum(-1))
    return loss.mean()


def walk_loss_plain(in_emb, out_emb, walks, neg_ids, window_size: int,
                    num_neg: int):
    """Plain version of K5 (and, through autograd, of K6)."""
    length1 = walks.shape[1]
    hw = window_size // 2
    walks = walks.long()
    u = in_emb[walks[:, hw: length1 - hw]]
    out_rows = out_emb[walks]
    v_neg = out_emb[neg_ids.long()]
    return blockwise_loss_plain(u, out_rows, v_neg, hw, num_neg)


class WalkSGNSLoss(torch.autograd.Function):
    """The loss of CUDA tables through K5, its gradient through K6 (which
    recomputes the logits from the saved inputs).

    It serves callers who differentiate ``walk_loss`` themselves, and so it
    hands autograd gradients of the tables' own type.  The train step does
    not come this way: ``walk_loss_and_grads`` launches the same two kernels
    and keeps K6's float32 tables, without a second (N, D) copy of each."""

    @staticmethod
    def forward(ctx, in_emb, out_emb, walks, neg_ids, window_size, num_neg):
        ctx.save_for_backward(in_emb, out_emb, walks, neg_ids)
        ctx.window_size, ctx.num_neg = window_size, num_neg
        return bindings.walk_sgns_loss_fwd(in_emb, out_emb, walks, neg_ids,
                                           window_size, num_neg)

    @staticmethod
    def backward(ctx, grad_loss):
        in_emb, out_emb, walks, neg_ids = ctx.saved_tensors
        grad_in, grad_out = bindings.walk_sgns_loss_bwd(
            in_emb, out_emb, walks, neg_ids, ctx.window_size, ctx.num_neg,
            grad_loss.to(torch.float32).contiguous())
        return (grad_in.to(in_emb.dtype), grad_out.to(out_emb.dtype), None,
                None, None, None)


class SkipGramModel(nn.Module):
    """SGNS embedding tables with their dense-Adam state.

    ``in_emb`` and ``out_emb`` are (num_nodes, dim) parameters in ``dtype``
    ("float32" or "bfloat16").  ``device=None`` means the card.
    """

    def __init__(self, num_nodes: int, dim: int = 128, optimizer=None,
                 dtype="float32", learning_rate: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 device=None):
        super().__init__()
        if optimizer is not None:
            raise not_ported("a custom optimizer")
        if isinstance(dtype, str):
            if dtype not in _DTYPES:
                raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                                 f"got {dtype!r}")
            dtype = _DTYPES[dtype]
        if dtype not in _DTYPES.values():
            raise ValueError(f"dtype {dtype} is not supported")
        dev = resolve_device(device)
        self.num_nodes, self.dim, self.dtype = int(num_nodes), int(dim), dtype
        self.learning_rate = 1e-3 if learning_rate is None else learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        shape = (self.num_nodes, self.dim)
        self.in_emb = nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev))
        self.out_emb = nn.Parameter(torch.zeros(shape, dtype=dtype,
                                                device=dev))
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        """Zero moments and step count (optax's ``init``)."""
        self.mu = {n: torch.zeros_like(p) for n, p in self.named_parameters()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.named_parameters()}
        self.count = 0

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``in_emb`` uniform in +-1/sqrt(dim), drawn in float32 from
        ``generator`` (which lives on the tables' device), ``out_emb`` zero;
        the optimizer state is reset too.  Not the numbers ``jax.random``
        gives for the same seed."""
        scale = 1.0 / self.dim ** 0.5
        draw = torch.empty(self.in_emb.shape, dtype=torch.float32,
                           device=self.in_emb.device)
        draw.uniform_(-scale, scale, generator=generator)
        with torch.no_grad():
            self.in_emb.copy_(draw)
            self.out_emb.zero_()
        self.reset_optimizer()

    def _ids(self, walks, neg_ids):
        dev = self.in_emb.device
        return common.as_int32(walks, dev), common.as_int32(neg_ids, dev)

    def walk_loss(self, walks, neg_ids, window_size: int, num_neg: int):
        """The blockwise loss of (B, L+1) walks, differentiable with respect
        to the tables."""
        walks, neg_ids = self._ids(walks, neg_ids)
        if self.in_emb.is_cuda:
            return WalkSGNSLoss.apply(self.in_emb, self.out_emb, walks,
                                      neg_ids, int(window_size), int(num_neg))
        return walk_loss_plain(self.in_emb, self.out_emb, walks, neg_ids,
                               int(window_size), int(num_neg))

    def walk_loss_and_grads(self, walks, neg_ids, window_size: int,
                            num_neg: int):
        """(loss, {name: float32 gradient}) of the two tables.  On the card
        K5 and K6 are launched directly, so that the loss and its gradient
        allocate nothing of size (N, D) but the two float32 gradient tables
        (through autograd they would be cast to the tables' type)."""
        walks, neg_ids = self._ids(walks, neg_ids)
        window_size, num_neg = int(window_size), int(num_neg)
        if self.in_emb.is_cuda:
            with torch.no_grad():
                loss = bindings.walk_sgns_loss_fwd(
                    self.in_emb, self.out_emb, walks, neg_ids, window_size,
                    num_neg)
                grads = bindings.walk_sgns_loss_bwd(
                    self.in_emb, self.out_emb, walks, neg_ids, window_size,
                    num_neg, torch.ones_like(loss))
        else:
            loss = walk_loss_plain(self.in_emb, self.out_emb, walks, neg_ids,
                                   window_size, num_neg)
            grads = torch.autograd.grad(loss, [self.in_emb, self.out_emb])
            loss = loss.detach()
            grads = [g.float() for g in grads]
        return loss, dict(zip(("in_emb", "out_emb"), grads))

    def walk_train_step(self, walks, neg_ids, window_size: int, num_neg: int):
        """One fused blockwise train step on (B, L+1) walks: loss, gradients,
        dense Adam, in place.  Returns the loss before the update (float32
        scalar on the tables' device)."""
        loss, grads = self.walk_loss_and_grads(walks, neg_ids, window_size,
                                               num_neg)
        self.adam_update(grads)
        return loss

    @torch.no_grad()
    def adam_update(self, grads: dict) -> None:
        """Dense Adam over both tables from float32 gradients (consumed: they
        serve as scratch).  See the module docstring for where it rounds."""
        self.count += 1
        for name, param in self.named_parameters():
            g, mu, nu = grads[name], self.mu[name], self.nu[name]
            narrow = param.dtype != torch.float32
            if narrow:
                g.copy_(g.to(param.dtype))
            for moment, decay, squared in ((mu, self.b1, False),
                                           (nu, self.b2, True)):
                new = moment.float() if narrow else moment
                new.mul_(decay)
                if squared:
                    new.addcmul_(g, g, value=1.0 - decay)
                else:
                    new.add_(g, alpha=1.0 - decay)
                if narrow:
                    moment.copy_(new)
            # The gradient is spent; its buffer holds sqrt(nu_hat) + eps.
            denom = g.copy_(nu).div_(self._bias_correction(self.b2))
            denom.sqrt_().add_(self.eps)
            step = mu.float() if narrow else mu.clone()
            step.div_(self._bias_correction(self.b1)).div_(denom)
            param.copy_(step.mul_(-self.learning_rate).add_(param))

    def _bias_correction(self, decay: float) -> float:
        """optax's ``1 - decay ** count``, computed in float32 and then cast
        to the moments' type."""
        bc = np.float32(1) - np.float32(decay) ** np.float32(self.count)
        return float(torch.tensor(float(bc)).to(self.dtype))

    def embeddings(self) -> torch.Tensor:
        return self.in_emb.detach()

    # --- not in this slice ----------------------------------------------------

    def loss_fn(self, *args, **kwargs):
        raise not_ported("the window-mode loss_fn")

    def train_step(self, *args, **kwargs):
        raise not_ported("the window-mode train_step")

    def walk_train_step_sparse(self, *args, **kwargs):
        raise not_ported("the touched-rows step walk_train_step_sparse")


def sorted_unique_with_locations(*args, **kwargs):
    raise not_ported("sorted_unique_with_locations")


def scatter_rows(*args, **kwargs):
    raise not_ported("scatter_rows")
