"""Skip-gram with negative sampling (twin of
``torch_random_walk_tpu/models/skipgram.py``).

Two losses over the same (target, positive-context) pairs:

- the blockwise loss over whole walks (``walk_loss``, the JAX
  ``walk_loss_fn``): centers at walk positions hw .. L-hw (hw =
  window_size // 2), contexts at offsets +-1..+-hw, and ``num_neg``
  negatives per center estimated with S batch-shared negatives scaled by
  num_neg / S.  On a CUDA tensor it is the hand-written kernel K5 and its
  gradient K6 (``kernels/sgns_loss.cu``); ``walk_loss_plain``
  (differentiated by autograd) is their plain version.
- the per-window loss (``loss_fn``, the JAX ``loss_fn``) on the (targets,
  pos, neg) windows of ``to_windows``.  On a CUDA tensor it is K16 and its
  gradient K17 (``kernels/sgns_windows.cu``, ``sgns_windows_owner.cu``), and
  the train step takes both from one call (one pass over the windows' rows,
  as JAX's ``value_and_grad``); ``windows_loss_plain`` is their plain
  version, and ``windows_grads_plain`` mirrors K17's passes (the per-window
  pass, the bucketing of the out slots by row and the owner sums).

Logits and losses are float32 whatever the tables' type.  A node id of -1
(the graph entry's mark of a walk that ran out of rounds) addresses the last
row, as ``table[ids]`` does in JAX.

The optimizer is dense Adam with optax's arithmetic (``optax.adam``:
``scale_by_adam`` with ``eps_root = 0``, then ``scale(-lr)``): every row gets
the update every step, also rows with a zero gradient.  The moments ``mu``
and ``nu`` are kept in the tables' type, as optax keeps them.  On a CUDA
tensor the update is the hand-written kernel K18's dense entry
(``kernels/adam.cu``); ``adam_dense_plain`` is its plain version.  Where the
port rounds, for tables narrower than float32: the gradient is rounded to the
tables' type once (JAX's gradient of a bfloat16 table is bfloat16; the
kernels accumulate it in float32 first), each moment is updated in float32
from its stored value and rounded once when stored, the step is computed in
float32 from the stored moments, and the parameter is rounded once after the
step is added.  optax rounds after every elementwise operation instead, so
bfloat16 runs agree loosely and float32 runs tightly.  All updates are in
place.

``optimizer=`` takes a factory, ``params -> torch.optim.Optimizer`` (PyTorch
has no optax): the dense steps hand it gradients in the tables' type through
``.grad`` and call ``step()``.

The touched-rows step ``walk_train_step_sparse`` (after
``init_sparse_opt_state``: float32 moments whatever the tables' type, and a
global step count) is JAX's lazy Adam: the rows of ``walks ++ neg_ids`` are
deduplicated once (``sorted_unique_with_locations``), both tables are
gathered at those rows, the blockwise loss runs on the two sub-tables (K5/K6
on the card, so its float32 gradient is (M, D), not (N, D)), and only the
in-table rows that occur as centers and the out-table rows that occur at all
are updated, with moments and parameters written back through K18's rows
entry (``adam_rows_plain`` on the CPU).  Every center is a walk position, so
the in-table's rows are a subset of the out-table's and one dedup serves
both.  The grouped narrow-row form of ``scatter_rows`` is not ported
(``ROADMAP.md`` queue 1 item 8): it is a plain row scatter.
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

SPARSE_CUSTOM_OPTIMIZER_ERROR = (
    "walk_train_step_sparse uses the model's Adam hyperparameters, which "
    "cannot be read out of a custom optax optimizer; pass learning_rate= "
    "(and b1/b2/eps if non-default) explicitly to SkipGramModel alongside it")


def shared_negative_ids(seed, num: int, num_nodes: int, device=None):
    """``num`` uniform negative node ids from the (seed, STREAM_TRAIN)
    Threefry stream, (num,) int32: a pure function of ``seed``, equal to the
    JAX package's value for value."""
    dev = resolve_device(device)
    key = prng.derive_key(seed, prng.STREAM_TRAIN)
    ids = torch.arange(num, dtype=torch.int64, device=dev)
    bits, _ = prng.counter_bits(key, ids, torch.zeros_like(ids))
    return prng.randint_from_bits(bits, int(num_nodes)).to(torch.int32)


def sorted_unique_with_locations(x_flat, oob: int):
    """One sort -> (sorted unique ids padded with ``oob`` at the tail, the
    location of every element in them), equal to the JAX function value for
    value.  The size stays k = ``x_flat.numel()`` (no count is read back to
    the host, as ``torch.unique`` would): ``uids`` (k,) of ``x_flat``'s type,
    ``loc`` (k,) int32, with ``uids[loc] == x_flat``."""
    x = x_flat.reshape(-1)
    k = x.shape[0]
    sx, order = torch.sort(x, stable=True)
    first = torch.ones(k, dtype=torch.bool, device=x.device)
    first[1:] = sx[1:] != sx[:-1]
    upos = torch.cumsum(first, 0, dtype=torch.int64) - 1
    loc = torch.empty(k, dtype=torch.int32, device=x.device)
    loc[order] = upos.to(torch.int32)
    # Duplicate writes land the same value.
    uids = torch.full((k,), oob, dtype=x.dtype, device=x.device)
    uids[upos] = sx
    return uids, loc


def scatter_rows(table, ids, rows, group: bool = True):
    """``table.at[ids].set(rows, mode="drop")`` of the JAX package, in place
    (returns ``table``): a negative id wraps once, ids outside the table
    after that are dropped, and of two slots that land on one row the later
    wins, as JAX's scatter on the CPU gives it.  ``group`` is accepted for
    the JAX signature; the grouped narrow-row form is not ported (a plain row
    scatter gives the same table either way)."""
    n = table.shape[0]
    ids = ids.reshape(-1).to(torch.int64)
    wrapped = torch.where(ids < 0, ids + n, ids)
    valid = (wrapped >= 0) & (wrapped < n)
    key = torch.where(valid, wrapped, n)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    last = torch.ones_like(valid)
    last[:-1] = sk[:-1] != sk[1:]
    keep = torch.zeros_like(valid)
    keep[order] = last
    keep &= valid
    table.index_copy_(0, wrapped[keep], rows[keep].to(table.dtype))
    return table


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


def windows_loss_plain(in_emb, out_emb, in_ids, pos, neg):
    """Plain version of K16 (and, through autograd, of K17): ``in_ids`` (B,
    CI), ``pos``/``neg`` (B, CO); h is the mean of a window's CI in rows (the
    target for skip-gram, CI = 1; the context for CBOW, CO = 1), and the loss
    the mean over windows of -(sum logsig(h . pos) + sum logsig(-h . neg))."""
    h = in_emb[in_ids.long()].float().mean(1)                # (B, D)
    pos_logit = (h[:, None] * out_emb[pos.long()].float()).sum(-1)
    neg_logit = (h[:, None] * out_emb[neg.long()].float()).sum(-1)
    loss = -(F.logsigmoid(pos_logit).sum(-1)
             + F.logsigmoid(-neg_logit).sum(-1))
    return loss.mean()


def table_rows(ids, num_nodes: int):
    """Node ids -> the table rows the kernels read (``table_row``): a
    negative id wraps once, then the row is clamped into [0, N); int64."""
    ids = ids.long()
    return torch.where(ids < 0, ids + num_nodes, ids).clamp(0, num_nodes - 1)


def window_terms_plain(in_emb, out_emb, in_ids, pos, neg, grad_loss=1.0):
    """Plain mirror of K17's per-window pass (K16's body with its gradient
    outputs): (the loss; g (B, 2 CO), each out slot's dloss/dlogit times
    ``grad_loss`` / B, the positives first; h (B, D), the mean of a window's
    in rows; dh (B, D), the gradient of each of its in rows: the sum of g *
    out row over its slots, divided by CI).  float32 whatever the tables'
    type."""
    n, b, co = in_emb.shape[0], in_ids.shape[0], pos.shape[1]
    h = in_emb[table_rows(in_ids, n)].float().mean(1)
    rows = out_emb[table_rows(torch.cat([pos, neg], 1), n)].float()
    x = (h[:, None] * rows).sum(-1)                            # (B, 2 CO)
    loss = -(F.logsigmoid(x[:, :co]).sum(-1)
             + F.logsigmoid(-x[:, co:]).sum(-1)).mean()
    scale = grad_loss / b
    g = torch.cat([-scale * torch.sigmoid(-x[:, :co]),
                   scale * torch.sigmoid(x[:, co:])], 1)
    dh = (g[..., None] * rows).sum(1) / in_ids.shape[1]
    return loss, g, h, dh


def bucket_slots_plain(slot_rows, num_nodes: int):
    """Plain mirror of K17's counting sort: (offsets (N + 1), the exclusive
    scan of each row's slot count; order, the slots grouped by row, each
    row's in slot order).  The kernel's scatter fills a row in the order of
    its atomics; the plain version keeps slot (window) order."""
    order = torch.argsort(slot_rows, stable=True)
    offsets = torch.zeros(num_nodes + 1, dtype=torch.int64,
                          device=slot_rows.device)
    offsets[1:] = torch.cumsum(torch.bincount(slot_rows,
                                              minlength=num_nodes), 0)
    return offsets, order


def owner_rows_plain(offsets, order, weight, src, per: int):
    """Plain mirror of K17's owner passes: row r of the (N, D) float32
    result is the sum over its slots s (``order[offsets[r]:offsets[r +
    1]]``, added in that order) of ``weight[s]`` (1 where None) times
    ``src[s // per]``; a row with no slot is zero."""
    counts = offsets[1:] - offsets[:-1]
    rows = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=order.device), counts)
    terms = src[order // per]
    if weight is not None:
        terms = weight[order, None] * terms
    out = torch.zeros((counts.shape[0], src.shape[1]), dtype=torch.float32,
                      device=src.device)
    return out.index_add_(0, rows, terms)


def windows_grads_plain(in_emb, out_emb, in_ids, pos, neg, grad_loss=1.0):
    """(loss, [grad_in, grad_out]) of the per-window loss as K17 computes
    them, in tensor code: the per-window pass, then the out slots (s = b * 2
    CO + c, of weight g[b, c] and source h_b) bucketed by row and summed by
    their owners.  The in rows' gradient, which the kernel adds with one
    atomic row add a window and in row, is the same sum over the in slots (s
    = b * CI + c, of source dh_b), taken here by the same owner mirror."""
    n = in_emb.shape[0]
    loss, g, h, dh = window_terms_plain(in_emb, out_emb, in_ids, pos, neg,
                                        grad_loss)
    out_rows = table_rows(torch.cat([pos, neg], 1), n).reshape(-1)
    in_rows = table_rows(in_ids, n).reshape(-1)
    grad_out = owner_rows_plain(*bucket_slots_plain(out_rows, n),
                                g.reshape(-1), h, g.shape[1])
    grad_in = owner_rows_plain(*bucket_slots_plain(in_rows, n), None, dh,
                               in_ids.shape[1])
    return loss, [grad_in, grad_out]


@torch.no_grad()
def adam_dense_plain(param, mu, nu, grad, lr, b1, b2, eps, bc1, bc2) -> None:
    """Plain version of K18's dense entry: one Adam step over every element,
    in place; ``grad`` float32 (consumed: it serves as scratch), ``mu`` and
    ``nu`` in the parameter's type, ``bc1``/``bc2`` the bias corrections
    already cast to it.  See the module docstring for where it rounds."""
    narrow = param.dtype != torch.float32
    if narrow:
        grad.copy_(grad.to(param.dtype))
    for moment, decay, squared in ((mu, b1, False), (nu, b2, True)):
        new = moment.float() if narrow else moment
        new.mul_(decay)
        if squared:
            new.addcmul_(grad, grad, value=1.0 - decay)
        else:
            new.add_(grad, alpha=1.0 - decay)
        if narrow:
            moment.copy_(new)
    # The gradient is spent; its buffer holds sqrt(nu_hat) + eps.
    denom = grad.copy_(nu).div_(bc2)
    denom.sqrt_().add_(eps)
    step = mu.float() if narrow else mu.clone()
    step.div_(bc1).div_(denom)
    param.copy_(step.mul_(-lr).add_(param))


@torch.no_grad()
def adam_rows_plain(param, mu, nu, grad, ids, flag, lr, b1, b2, eps, bc1,
                    bc2) -> None:
    """Plain version of K18's rows entry (JAX's lazy Adam), in place: slot m
    of ``ids`` (M,) writes row ids[m] (-1 is row N - 1, ids outside [-1, N)
    write nothing) where ``flag`` (M,) is None or nonzero, from its float32
    gradient row ``grad[m]`` rounded to the tables' type; ``mu``/``nu``
    float32, ``bc1``/``bc2`` float32.  Each operation rounds on its own."""
    n = param.shape[0]
    ids = ids.to(torch.int64)
    write = (ids >= -1) & (ids < n)
    if flag is not None:
        write &= flag.bool()
    rows = torch.where(ids < 0, ids + n, ids)[write]
    g = grad[write].to(param.dtype).float()
    bc1 = torch.tensor(bc1, dtype=torch.float32, device=param.device)
    bc2 = torch.tensor(bc2, dtype=torch.float32, device=param.device)
    m = b1 * mu[rows] + (1.0 - b1) * g
    v = b2 * nu[rows] + (1.0 - b2) * (g * g)
    upd = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    param[rows] = (param[rows].float() - upd).to(param.dtype)
    mu[rows] = m
    nu[rows] = v


def sparse_bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as the JAX touched-rows step
    computes it (equal to JAX's value at every count checked, 1 to 3000)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def touched_row_ids(ids, flag, n: int):
    """The ids the touched-rows update writes through: ``ids`` with a slot
    of -1 turned into the pad ``n`` where a writing slot (``flag`` None or
    nonzero) of id n - 1 exists, since both address row N - 1 and the later
    slot (n - 1 sorts last) wins in JAX's scatter.  No host
    synchronisation."""
    last = ids == n - 1
    if flag is not None:
        last = last & flag.bool()
    return torch.where((ids == -1) & last.any(), n, ids)


class WalkSGNSLoss(torch.autograd.Function):
    """The blockwise loss of CUDA tables through K5, its gradient through K6
    (which recomputes the logits from the saved inputs).

    It serves callers who differentiate ``walk_loss`` themselves, and so it
    hands autograd gradients of the tables' own type.  The train steps do
    not come this way: they launch the same two kernels and keep K6's
    float32 tables, without a second (N, D) copy of each."""

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


class WindowsSGNSLoss(torch.autograd.Function):
    """The per-window loss of CUDA tables through K16, its gradient through
    K17, in the tables' own type (see ``WalkSGNSLoss``)."""

    @staticmethod
    def forward(ctx, in_emb, out_emb, in_ids, pos, neg, cbow):
        ctx.save_for_backward(in_emb, out_emb, in_ids, pos, neg)
        ctx.cbow = cbow
        return bindings.sgns_windows_loss_fwd(in_emb, out_emb, in_ids, pos,
                                              neg, cbow)

    @staticmethod
    def backward(ctx, grad_loss):
        in_emb, out_emb, in_ids, pos, neg = ctx.saved_tensors
        grad_in, grad_out = bindings.sgns_windows_loss_bwd(
            in_emb, out_emb, in_ids, pos, neg,
            grad_loss.to(torch.float32).contiguous(), ctx.cbow)
        return (grad_in.to(in_emb.dtype), grad_out.to(out_emb.dtype), None,
                None, None, None)


def _leaves(*tables):
    """The tables as leaves of autograd in their own type: the plain versions
    sum a bfloat16 table's gradient in bfloat16, as JAX's gather transpose
    does (the kernels sum it in float32 and round it once in K18)."""
    return [t.detach().requires_grad_(True) for t in tables]


def walk_loss_and_grads(in_emb, out_emb, walks, neg_ids, window_size: int,
                        num_neg: int):
    """(loss, [float32 gradient of in_emb, of out_emb]) of the blockwise
    loss, without autograd's graph on the tables: K5 and K6 on CUDA tables
    (nothing of size (N, D) allocated but K6's two float32 gradients), the
    plain version through autograd on CPU tables."""
    if in_emb.is_cuda:
        with torch.no_grad():
            loss = bindings.walk_sgns_loss_fwd(in_emb, out_emb, walks,
                                               neg_ids, window_size, num_neg)
            grads = bindings.walk_sgns_loss_bwd(
                in_emb, out_emb, walks, neg_ids, window_size, num_neg,
                torch.ones_like(loss))
        return loss, list(grads)
    tables = _leaves(in_emb, out_emb)
    loss = walk_loss_plain(*tables, walks, neg_ids, window_size, num_neg)
    grads = torch.autograd.grad(loss, tables)
    return loss.detach(), [g.float() for g in grads]


def windows_loss_and_grads(in_emb, out_emb, in_ids, pos, neg, cbow: bool):
    """(loss, [float32 gradients]) of the per-window loss: K16 and K17 in
    one call on CUDA tables (``bindings.sgns_windows_loss_and_grads``: one
    per-window pass takes the loss and the gradient's inputs), the plain
    version through autograd on CPU tables."""
    if in_emb.is_cuda:
        with torch.no_grad():
            loss, *grads = bindings.sgns_windows_loss_and_grads(
                in_emb, out_emb, in_ids, pos, neg, cbow)
        return loss, grads
    tables = _leaves(in_emb, out_emb)
    loss = windows_loss_plain(*tables, in_ids, pos, neg)
    grads = torch.autograd.grad(loss, tables)
    return loss.detach(), [g.float() for g in grads]


def table_dtype(dtype) -> torch.dtype:
    """"float32", "bfloat16" or the torch type -> the torch type; raises on
    any other."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        dtype = _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"dtype {dtype} is not supported")
    return dtype


class AdamTables(nn.Module):
    """Named tables of one type, float32 or bfloat16, with their optimizer:
    dense Adam over every table (K18 on the card) or a custom ``optimizer``
    factory, and the touched-rows state (``init_sparse_opt_state``).  A
    subclass registers its tables as parameters and then calls
    ``reset_optimizer``.  ``dense_hparams`` are the (b1, b2, eps) of the
    dense update; ``b1``, ``b2`` and ``eps`` those of the touched-rows one.
    ``state_dict()`` holds the tables and, as extra state, the optimizer's
    (``get_extra_state``), so that ``utils/checkpoint.py`` saves and
    restores a model whole.  The base of ``EmbeddingTables`` and
    ``models/kge.py::KGEModel``."""

    def __init__(self, dtype, optimizer, learning_rate: float, b1: float,
                 b2: float, eps: float, sparse_hparams_ok: bool):
        super().__init__()
        self.dtype = table_dtype(dtype)
        if optimizer is not None and not callable(optimizer):
            raise TypeError("optimizer must be a factory, params -> "
                            "torch.optim.Optimizer")
        self._sparse_hparams_ok = sparse_hparams_ok
        self._optimizer_factory = optimizer
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.dense_hparams = (b1, b2, eps)

    def reset_optimizer(self) -> None:
        """Zero moments and step count (optax's ``init``), or a fresh custom
        optimizer."""
        self.optimizer = None
        self.sparse_state = False
        if self._optimizer_factory is not None:
            self.optimizer = self._optimizer_factory(list(self.parameters()))
            self.mu, self.nu = {}, {}
        else:
            self.mu = {n: torch.zeros_like(p)
                       for n, p in self.named_parameters()}
            self.nu = {n: torch.zeros_like(p)
                       for n, p in self.named_parameters()}
        self.count = 0

    def init_sparse_opt_state(self) -> None:
        """State of the touched-rows step: float32 moments shaped like the
        tables whatever their type, and the global step count at 0."""
        self.mu = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in self.named_parameters()}
        self.nu = {n: torch.zeros_like(m) for n, m in self.mu.items()}
        self.count = 0
        self.sparse_state = True

    def get_extra_state(self) -> dict:
        """The optimizer state, which ``state_dict()`` carries beside the
        tables so that a checkpoint resumes whole: the step count, whether
        the moments are the touched-rows step's, the moments by table name,
        and a custom optimizer's own state dict."""
        return {"count": self.count, "sparse_state": self.sparse_state,
                "mu": dict(self.mu), "nu": dict(self.nu),
                "optimizer": (None if self.optimizer is None
                              else self.optimizer.state_dict())}

    def set_extra_state(self, state: dict) -> None:
        """Load ``get_extra_state``'s dict (from any device) onto the tables'
        devices; the moments are copied."""
        if (state["optimizer"] is None) != (self.optimizer is None):
            raise ValueError("the saved state was made with "
                             f"{'no' if state['optimizer'] is None else 'a'} "
                             "custom optimizer; this model has "
                             f"{'none' if self.optimizer is None else 'one'}")
        params = dict(self.named_parameters())
        moments = {}
        for key in ("mu", "nu"):
            saved = state[key]
            if set(saved) != (set(params) if self.optimizer is None
                              else set()):
                raise ValueError(f"saved {key} holds {sorted(saved)}, the "
                                 f"model's tables are {sorted(params)}")
            for name, m in saved.items():
                if m.shape != params[name].shape:
                    raise ValueError(f"saved {key}[{name!r}] is "
                                     f"{tuple(m.shape)}, the table "
                                     f"{tuple(params[name].shape)}")
            moments[key] = {name: m.to(params[name].device, copy=True)
                            for name, m in saved.items()}
        self.mu, self.nu = moments["mu"], moments["nu"]
        self.count = int(state["count"])
        self.sparse_state = bool(state["sparse_state"])
        if self.optimizer is not None:
            self.optimizer.load_state_dict(state["optimizer"])

    def _as_ids(self, *ids):
        dev = next(self.parameters()).device
        return [common.as_int32(x, dev) for x in ids]

    @torch.no_grad()
    def apply_gradients(self, grads: dict) -> None:
        """One optimizer step from float32 gradients keyed by table name
        (consumed): dense Adam, or the custom optimizer fed gradients of the
        tables' type."""
        if self.optimizer is None:
            self.adam_update(grads)
            return
        self.count += 1
        for name, param in self.named_parameters():
            param.grad = grads[name].to(param.dtype)
        self.optimizer.step()
        for param in self.parameters():
            param.grad = None

    @torch.no_grad()
    def adam_update(self, grads: dict) -> None:
        """Dense Adam over every table from float32 gradients (consumed: they
        serve as scratch): K18's dense entry on the card, its plain version
        on the CPU.  See the module docstring for where it rounds."""
        if self.optimizer is not None:
            raise ValueError("this model steps a custom optimizer; use "
                             "apply_gradients")
        if self.sparse_state:
            raise ValueError("the model holds the touched-rows state of its "
                             "sparse step; reset_optimizer() first")
        self.count += 1
        b1, b2, eps = self.dense_hparams
        bc1 = self._bias_correction(b1)
        bc2 = self._bias_correction(b2)
        for name, param in self.named_parameters():
            update = bindings.adam_dense if param.is_cuda else adam_dense_plain
            update(param.data, self.mu[name], self.nu[name], grads[name],
                   self.learning_rate, b1, b2, eps, bc1, bc2)

    def _bias_correction(self, decay: float) -> float:
        """optax's ``1 - decay ** count``, computed in float32 and then cast
        to the moments' type."""
        bc = sparse_bias_correction(decay, self.count)
        return float(torch.tensor(bc).to(self.dtype))

    @torch.no_grad()
    def adam_rows_update(self, updates) -> None:
        """The lazy Adam update of a touched-rows step (count one step):
        ``updates`` holds (table name, float32 gradient rows, ids, flag) per
        table, as ``adam_rows_plain`` takes them (K18's rows entry on the
        card)."""
        self.count += 1
        bc1 = sparse_bias_correction(self.b1, self.count)
        bc2 = sparse_bias_correction(self.b2, self.count)
        for name, grad, rows, flag in updates:
            param = getattr(self, name)
            update = bindings.adam_rows if param.is_cuda else adam_rows_plain
            update(param.data, self.mu[name], self.nu[name], grad, rows, flag,
                   self.learning_rate, self.b1, self.b2, self.eps, bc1, bc2)


class EmbeddingTables(AdamTables):
    """Two (num_nodes, dim) tables, ``in_emb`` and ``out_emb``, in ``dtype``
    ("float32" or "bfloat16"), with their optimizer (``AdamTables``).
    ``device=None`` means the card.  The base of ``SkipGramModel`` and
    ``CBOWModel``."""

    def __init__(self, num_nodes: int, dim: int = 128, optimizer=None,
                 dtype="float32", learning_rate: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 device=None):
        # A custom optimizer is opaque: the touched-rows step runs only if
        # learning_rate= came with it (the JAX rule).
        super().__init__(dtype, optimizer,
                         1e-3 if learning_rate is None else learning_rate,
                         b1, b2, eps,
                         optimizer is None or learning_rate is not None)
        dev = resolve_device(device)
        self.num_nodes, self.dim = int(num_nodes), int(dim)
        shape = (self.num_nodes, self.dim)
        self.in_emb = nn.Parameter(torch.zeros(shape, dtype=self.dtype,
                                               device=dev))
        self.out_emb = nn.Parameter(torch.zeros(shape, dtype=self.dtype,
                                                device=dev))
        self.reset_optimizer()

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

    def _windows_step(self, in_ids, pos, neg, cbow: bool):
        loss, grads = windows_loss_and_grads(self.in_emb, self.out_emb,
                                             in_ids, pos, neg, cbow)
        self.apply_gradients(dict(zip(("in_emb", "out_emb"), grads)))
        return loss

    def _windows_loss(self, in_ids, pos, neg, cbow: bool):
        if self.in_emb.is_cuda:
            return WindowsSGNSLoss.apply(self.in_emb, self.out_emb, in_ids,
                                         pos, neg, cbow)
        return windows_loss_plain(self.in_emb, self.out_emb, in_ids, pos, neg)

    def embeddings(self) -> torch.Tensor:
        return self.in_emb.detach()


class SkipGramModel(EmbeddingTables):
    """SGNS embedding tables with their optimizer state (see
    ``EmbeddingTables``)."""

    # --- window mode: to_windows batches ----------------------------------------

    def _window_ids(self, targets, pos, neg):
        targets, pos, neg = self._as_ids(targets, pos, neg)
        return targets.reshape(-1, 1), pos, neg

    def loss_fn(self, targets, pos, neg):
        """JAX's ``loss_fn``: -log σ(u·v⁺) - Σ log σ(-u·v⁻) summed over a
        window's C contexts and averaged over the windows; ``targets`` (B,),
        ``pos``/``neg`` (B, C) node ids.  Differentiable with respect to the
        tables."""
        return self._windows_loss(*self._window_ids(targets, pos, neg), False)

    def train_step(self, targets, pos, neg):
        """One train step on (targets, pos, neg) windows: the loss and its
        float32 gradients (K16/K17 on the card), then the optimizer, in
        place.  Returns the loss before the update."""
        return self._windows_step(*self._window_ids(targets, pos, neg), False)

    # --- block mode: whole walks -----------------------------------------------

    def walk_loss(self, walks, neg_ids, window_size: int, num_neg: int):
        """The blockwise loss of (B, L+1) walks, differentiable with respect
        to the tables."""
        walks, neg_ids = self._as_ids(walks, neg_ids)
        if self.in_emb.is_cuda:
            return WalkSGNSLoss.apply(self.in_emb, self.out_emb, walks,
                                      neg_ids, int(window_size), int(num_neg))
        return walk_loss_plain(self.in_emb, self.out_emb, walks, neg_ids,
                               int(window_size), int(num_neg))

    def walk_loss_and_grads(self, walks, neg_ids, window_size: int,
                            num_neg: int):
        """(loss, {name: float32 gradient}) of the two tables (see
        ``walk_loss_and_grads``)."""
        walks, neg_ids = self._as_ids(walks, neg_ids)
        loss, grads = walk_loss_and_grads(self.in_emb, self.out_emb, walks,
                                          neg_ids, int(window_size),
                                          int(num_neg))
        return loss, dict(zip(("in_emb", "out_emb"), grads))

    def walk_train_step(self, walks, neg_ids, window_size: int, num_neg: int):
        """One fused blockwise train step on (B, L+1) walks: loss, gradients,
        the optimizer, in place.  Returns the loss before the update (float32
        scalar on the tables' device)."""
        loss, grads = self.walk_loss_and_grads(walks, neg_ids, window_size,
                                               num_neg)
        self.apply_gradients(grads)
        return loss

    # --- the touched-rows step ---------------------------------------------------

    def gather_touched_rows(self, walks, neg_ids):
        """The dedup and gathers of the touched-rows step: (ids (M,) sorted
        unique rows of ``walks ++ neg_ids`` padded with N, walk locations
        (B, L+1) and negative locations (S,) into them, in_emb's and
        out_emb's rows at ``ids`` (a pad reads row N - 1, -1 row N - 1))."""
        n = self.num_nodes
        flat = torch.cat([walks.reshape(-1), neg_ids])
        ids, loc = sorted_unique_with_locations(flat, n)
        safe = torch.clamp(ids, max=n - 1).long()
        return (ids, loc[: walks.numel()].view(walks.shape),
                loc[walks.numel():], self.in_emb.detach()[safe],
                self.out_emb.detach()[safe])

    def walk_train_step_sparse(self, walks, neg_ids, window_size: int,
                               num_neg: int, group_scatter: bool = True):
        """Blockwise train step with JAX's touched-rows (lazy) Adam: rows
        absent from the batch keep their parameters and moments bitwise.
        Needs ``init_sparse_opt_state()`` first.  Returns the loss before the
        update.  ``group_scatter`` is accepted for the JAX signature."""
        if not self._sparse_hparams_ok:
            raise ValueError(SPARSE_CUSTOM_OPTIMIZER_ERROR)
        if not self.sparse_state:
            raise ValueError("walk_train_step_sparse needs float32 moments: "
                             "call init_sparse_opt_state() first")
        walks, neg_ids = self._as_ids(walks, neg_ids)
        window_size = int(window_size)
        ids, out_loc, neg_loc, in_sub, out_sub = self.gather_touched_rows(
            walks, neg_ids)
        loss, grads = walk_loss_and_grads(in_sub, out_sub, out_loc, neg_loc,
                                          window_size, int(num_neg))
        self.update_touched_rows(ids, out_loc, *grads, window_size)
        return loss

    def touched_row_writes(self, ids, out_loc, window_size: int):
        """(write ids, flag) of the touched-rows update for in_emb (the
        slots that occur as centers) and out_emb (every real slot; no
        flag)."""
        hw, length1 = int(window_size) // 2, out_loc.shape[1]
        center = torch.zeros(ids.shape, dtype=torch.uint8, device=ids.device)
        center[out_loc[:, hw: length1 - hw].reshape(-1).long()] = 1
        n = self.num_nodes
        return ((touched_row_ids(ids, center, n), center),
                (touched_row_ids(ids, None, n), None))

    def update_touched_rows(self, ids, out_loc, grad_in, grad_out,
                            window_size: int) -> None:
        """The lazy Adam update of the touched-rows step from the float32
        gradients of the two gathered sub-tables (K18's rows entry on the
        card)."""
        writes = self.touched_row_writes(ids, out_loc, window_size)
        self.adam_rows_update([
            (name, grad, rows, flag) for name, grad, (rows, flag) in zip(
                ("in_emb", "out_emb"), (grad_in, grad_out), writes)])
