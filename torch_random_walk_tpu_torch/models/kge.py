"""Knowledge-graph embedding trainers over triples walks (twin of
``torch_random_walk_tpu/models/kge.py``).

Two objective families over the same walks of ``walk_triples``:

- **Link prediction** (``objective="transe" | "distmult" | "rotate"``): the
  (h, r, t) triples a walk visits are the positives; ``corrupt_triples``
  replaces the tail (even slots) or the head (odd slots) by a uniform entity
  for the negatives; the loss is the logistic NEG loss of the score s(h, r,
  t) (TransE ``margin - ||e_h + w_r - e_t||``, DistMult ``<e_h, w_r, e_t>``,
  RotatE ``margin - ||e_h o e^{i theta_r} - e_t||``) masked by the
  positive's relation.  On CUDA tables it is the hand-written kernel K19
  (``kernels/kge_pair.cu``: the loss alone, or the loss and both gradients
  in one pass); ``pair_loss_plain`` is its plain version.
- **Co-occurrence** (``objective="skipgram" | "cbow"``): SGNS between
  composed triple vectors e_h + w_r + e_t (in and out tables) on the
  batches of ``to_windows_triples`` / ``to_windows_triples_cbow``.  On CUDA
  tables it is K20 (``kernels/kge_windows.cu``, CBOW a template flag);
  ``skipgram_loss_plain`` and ``cbow_loss_plain`` are its plain versions.

The masks differ, as in JAX: a composition leaves out any component outside
[0, n) of its table; a loss masks a slot by ``relation != padding_idx``;
skip-gram negatives are never masked; CBOW's context mean sums and divides
in the tables' type.  For bfloat16 tables the plain versions round where
JAX rounds (``e_h + w_r``, then ``- e_t``; the triple product; each add of a
composition) and the kernels the same way; RotatE works in float32 with
1e-12 under the root.  At ||d|| = 0 JAX's TransE gradient is NaN, and so
are both of the port's.

The dense update is optax's ``adam(learning_rate)`` (its default b1, b2 and
eps, whatever the model's ``b1``, ``b2``, ``eps``, as in JAX) through
``AdamTables`` (K18's dense entry on the card); ``optimizer=`` takes a
factory, as ``SkipGramModel`` does.  The touched-rows step
``pair_train_step_sparse`` (after ``init_sparse_opt_state``) deduplicates the
entity and relation rows of a batch once (``sorted_unique_with_locations``),
runs K19 on the gathered sub-tables with the locations as ids, and updates
only those rows through K18's rows entry with the model's ``b1``, ``b2``,
``eps`` and the global step count; a custom optimizer forbids it (the JAX
rule).  Losses are float32 scalars on the tables' device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch_random_walk_tpu_torch.graph.triples import TriplesGraph
from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.models.skipgram import (
    AdamTables,
    sorted_unique_with_locations,
)
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.ops.walk import walk_triples
from torch_random_walk_tpu_torch.ops.windows import (
    _triples_targets_and_windows,
    to_windows_triples,
    to_windows_triples_cbow,
)
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device

OBJECTIVES = ("transe", "distmult", "rotate", "skipgram", "cbow")
PAIR_OBJECTIVES = ("transe", "distmult", "rotate")
PAIR_TABLES = ("ent", "rel")
WINDOW_TABLES = ("ent_in", "rel_in", "ent_out", "rel_out")
# optax.adam(learning_rate)'s own (b1, b2, eps): the dense update's.
OPTAX_ADAM = (0.9, 0.999, 1e-8)

SPARSE_CUSTOM_OPTIMIZER_ERROR = (
    "pair_train_step_sparse applies the model's Adam hyperparameters "
    "manually, which cannot be read out of a custom optimizer; construct "
    "KGEModel with learning_rate/b1/b2/eps instead of optimizer=")


def corrupt_triples(pos_triples, num_entities: int, num_neg: int, seed,
                    epoch=0) -> torch.Tensor:
    """(B, 3) positives -> (B, num_neg, 3) negatives on the positives'
    device: even slots replace the tail, odd slots the head, by a uniform
    entity drawn from the (seed, STREAM_KGE_NEG) Threefry stream with
    counters (slot, epoch); equal to the JAX function value for value.
    ``seed`` and ``epoch`` are Python ints (a trainer's step seed lies in
    [0, 2^32), ``prng.epoch_seed``)."""
    pos = torch.as_tensor(pos_triples)
    b = pos.shape[0]
    key = prng.derive_key(seed, prng.STREAM_KGE_NEG)
    ids = torch.arange(b * num_neg, dtype=torch.int64, device=pos.device)
    bits, _ = prng.counter_bits(key, ids & prng.MASK32,
                                int(epoch) & prng.MASK32)
    repl = prng.randint_from_bits(bits, int(num_entities)).reshape(
        b, num_neg).to(pos.dtype)
    neg = pos[:, None, :].expand(b, num_neg, 3).clone()
    tail = torch.arange(num_neg, device=pos.device) % 2 == 0
    neg[:, :, 2] = torch.where(tail, repl, neg[:, :, 2])
    neg[:, :, 0] = torch.where(tail, neg[:, :, 0], repl)
    return neg


# --- plain versions of K19 and K20 -------------------------------------------

def _rounder(tables, rounding):
    """x -> x rounded to ``rounding`` (default: the tables' type) and back to
    float32, its gradient passed through unrounded: the arithmetic of an
    elementwise operation on tables of that type, with the float32
    gradient the kernels form."""
    rounding = tables[0].dtype if rounding is None else rounding
    if rounding == torch.float32:
        return lambda x: x
    return lambda x: x + (x.to(rounding).float() - x).detach()


def pair_scores_plain(objective: str, margin: float, ent, rel, triples,
                      rounding=None):
    """s(h, r, t) of (..., 3) triples with every component in range, float32
    (JAX's ``_score_tabs``), rounded where an operation on tables of type
    ``rounding`` (default: the tables') rounds."""
    rnd = _rounder((ent,), rounding)
    triples = triples.long()
    e_h, w_r, e_t = (tab[triples[..., i]].float()
                     for i, tab in enumerate((ent, rel, ent)))
    if objective == "transe":
        d = rnd(rnd(e_h + w_r) - e_t)
        # sqrt of the sum, as jnp.linalg.norm: its gradient at 0 is NaN.
        return margin - torch.sqrt((d * d).sum(-1))
    if objective == "rotate":
        half = ent.shape[-1] // 2
        re_h, im_h = e_h[..., :half], e_h[..., half:]
        cos, sin = torch.cos(w_r), torch.sin(w_r)
        d_re = re_h * cos - im_h * sin - e_t[..., :half]
        d_im = re_h * sin + im_h * cos - e_t[..., half:]
        return margin - torch.sqrt((d_re * d_re + d_im * d_im).sum(-1)
                                   + 1e-12)
    return rnd(rnd(e_h * w_r) * e_t).sum(-1)


def pair_loss_plain(objective: str, margin: float, ent, rel, pos, neg,
                    valid, rounding=None):
    """Plain version of K19 (and, through autograd, of its gradient): the
    masked mean of -(logsig(s_pos) + sum logsig(-s_neg)) over the positives
    of weight ``valid`` (B,).  Tables of float32 holding bfloat16 values with
    ``rounding=torch.bfloat16`` give K19's arithmetic on bfloat16 tables
    with float32 gradient sums."""
    pos_s = pair_scores_plain(objective, margin, ent, rel, pos, rounding)
    neg_s = pair_scores_plain(objective, margin, ent, rel, neg, rounding)
    per = -(F.logsigmoid(pos_s) + F.logsigmoid(-neg_s).sum(-1))
    w = valid.float()
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def compose_plain(ent, rel, triples, rounding=None):
    """e_h + w_r + e_t of (..., 3) triples as float32 values of the tables'
    type (or ``rounding``'s), each add rounded there, each component outside
    [0, n) of its table left out (JAX's ``_compose``)."""
    rnd = _rounder((ent,), rounding)

    def rows(tab, ids):
        ok = (ids >= 0) & (ids < tab.shape[0])
        g = tab[ids.long().clamp(0, tab.shape[0] - 1)].float()
        return torch.where(ok[..., None], g, 0.0)

    return rnd(rnd(rows(ent, triples[..., 0]) + rows(rel, triples[..., 1]))
               + rows(ent, triples[..., 2]))


def _masked_mean(per, ok):
    ok = ok.float()
    return (per * ok).sum() / torch.clamp(ok.sum(), min=1.0)


def skipgram_loss_plain(tables, targets, pos_windows, neg_windows,
                        padding_idx: int, rounding=None):
    """Plain version of K20's skip-gram form: ``tables`` (ent_in, rel_in,
    ent_out, rel_out), targets (B, 3), windows (B, C, 3)."""
    ent_in, rel_in, ent_out, rel_out = tables
    u = compose_plain(ent_in, rel_in, targets, rounding)[:, None]
    pos_logit = (u * compose_plain(ent_out, rel_out, pos_windows,
                                   rounding)).sum(-1)
    neg_logit = (u * compose_plain(ent_out, rel_out, neg_windows,
                                   rounding)).sum(-1)
    pos_ok = pos_windows[..., 1] != padding_idx
    per = -(torch.where(pos_ok, F.logsigmoid(pos_logit), 0.0).sum(-1)
            + F.logsigmoid(-neg_logit).sum(-1))
    return _masked_mean(per, targets[..., 1] != padding_idx)


def cbow_loss_plain(tables, pos_triples, neg_triples, windows,
                    padding_idx: int, rounding=None):
    """Plain version of K20's CBOW form: pos and neg triples (B, 3), windows
    (B, C, 3); the context mean summed and divided in the tables' type."""
    ent_in, rel_in, ent_out, rel_out = tables
    rnd = _rounder(tables, rounding)
    ctx = compose_plain(ent_out, rel_out, windows, rounding)
    ctx_ok = (windows[..., 1] != padding_idx)[..., None]
    denom = torch.clamp(ctx_ok.sum(1), min=1).float()
    mean = rnd(rnd(torch.where(ctx_ok, ctx, 0.0).sum(1)) / denom)
    x_pos = (mean * compose_plain(ent_in, rel_in, pos_triples,
                                  rounding)).sum(-1)
    x_neg = (mean * compose_plain(ent_in, rel_in, neg_triples,
                                  rounding)).sum(-1)
    per = -(F.logsigmoid(x_pos) + F.logsigmoid(-x_neg))
    return _masked_mean(per, pos_triples[..., 1] != padding_idx)


def windows_loss_plain(tables, a, b, c, padding_idx: int, cbow: bool,
                       rounding=None):
    """K20's plain version in either form, arguments in the JAX order."""
    fn = cbow_loss_plain if cbow else skipgram_loss_plain
    return fn(tables, a, b, c, padding_idx, rounding)


def window_slot_rows(batch, padding_idx: int, cbow: bool, num_entities: int,
                     num_relations: int) -> dict:
    """The rows whose gradient K20 adds, by side, as its merged adds take
    them: ``{"in": (B, S, 3), "out": (B, S', 3)}`` int64 (h, r, t) rows of
    each window's composed slots, -1 where none is added (a window of
    weight 0, a masked slot, a component outside [0, n)).  Skip-gram
    (``batch`` = targets, pos and neg windows): in the target, out the 2 C
    positive then negative slots; CBOW (pos, neg, windows): in the positive
    and the negative, out the C context slots."""
    a, b, c = (x.long() for x in batch)
    if cbow:
        ins, outs, ok_out = torch.stack([a, b], 1), c, c[..., 1] != padding_idx
    else:  # negatives are never masked
        ins, outs = a[:, None], torch.cat([b, c], 1)
        ok_out = torch.cat([b[..., 1] != padding_idx,
                            torch.ones_like(c[..., 1], dtype=torch.bool)], 1)
    weight = a[:, 1] != padding_idx
    limits = torch.tensor([num_entities, num_relations, num_entities],
                          device=a.device)

    def rows(x, ok):
        keep = ok[..., None] & (x >= 0) & (x < limits)
        return torch.where(keep, x, -1)

    return {"in": rows(ins, weight[:, None].expand(ins.shape[:2])),
            "out": rows(outs, ok_out & weight[:, None])}


def merged_row_adds(rows, coef, lanes: int) -> dict:
    """Plain version of K20's merged row adds (``kge_windows.cu``
    ``merged_adds``): of ``rows`` (B, S, 3), the rows of each window's S
    slots (-1: none), with ``coef`` (B, S) their coefficients, taken in
    rounds of ``lanes`` slots; each distinct row of a round, the entity rows
    h and t alike, gets the sum of its occurrences' coefficients (h == t:
    twice) in one add.  Returns ``{"entity": (window, row, coef), "relation":
    (window, row, coef)}``, one entry an add."""
    b, s, _ = rows.shape
    dev = rows.device
    rounds = -(-s // lanes)
    slot_round = (torch.arange(s, device=dev) // lanes).expand(b, s)
    window = torch.arange(b, device=dev)[:, None].expand(b, s)
    span = max(int(rows.max()) + 1, 1)
    out = {}
    for name, comps in (("entity", (0, 2)), ("relation", (1,))):
        ids = torch.cat([rows[..., i].reshape(-1) for i in comps])
        key = ((window.reshape(-1) * rounds + slot_round.reshape(-1))
               .repeat(len(comps)) * span + ids)
        c = coef.reshape(-1).repeat(len(comps))
        keep = ids >= 0
        key, inverse = torch.unique(key[keep], return_inverse=True)
        total = torch.zeros(key.shape, dtype=c.dtype, device=dev)
        total.index_add_(0, inverse, c[keep])
        out[name] = (key // span // rounds, key % span, total)
    return out


# --- the kernels through autograd, and in one call ---------------------------

def _leaves(tables):
    """The tables as leaves of autograd in their own type (a bfloat16
    table's gradient is summed in bfloat16 there, as in JAX)."""
    return [t.detach().requires_grad_(True) for t in tables]


class KGEPairLoss(torch.autograd.Function):
    """The pair loss of CUDA tables through K19's loss-only launch, its
    gradient through K19's value-and-grad call, cast to each table's type."""

    @staticmethod
    def forward(ctx, ent, rel, pos, neg, valid, objective, margin):
        ctx.save_for_backward(ent, rel, pos, neg, valid)
        ctx.objective, ctx.margin = objective, margin
        return bindings.kge_pair_loss(ent, rel, pos, neg, valid, objective,
                                      margin)

    @staticmethod
    def backward(ctx, grad_loss):
        ent, rel, pos, neg, valid = ctx.saved_tensors
        _, grad_ent, grad_rel = bindings.kge_pair_loss_and_grads(
            ent, rel, pos, neg, valid, ctx.objective, ctx.margin,
            grad_loss.to(torch.float32).contiguous())
        return (grad_ent.to(ent.dtype), grad_rel.to(rel.dtype), None, None,
                None, None, None)


class KGEWindowsLoss(torch.autograd.Function):
    """The skip-gram or CBOW loss of CUDA tables through K20's loss-only
    launch, its gradient through K20's value-and-grad call."""

    @staticmethod
    def forward(ctx, ent_in, rel_in, ent_out, rel_out, a, b, c, padding_idx,
                cbow):
        ctx.save_for_backward(ent_in, rel_in, ent_out, rel_out, a, b, c)
        ctx.padding_idx, ctx.cbow = padding_idx, cbow
        return bindings.kge_windows_loss((ent_in, rel_in, ent_out, rel_out),
                                         a, b, c, padding_idx, cbow)

    @staticmethod
    def backward(ctx, grad_loss):
        *tables, a, b, c = ctx.saved_tensors
        _, grads = bindings.kge_windows_loss_and_grads(
            tables, a, b, c, ctx.padding_idx, ctx.cbow,
            grad_loss.to(torch.float32).contiguous())
        return (*[g.to(t.dtype) for g, t in zip(grads, tables)], None, None,
                None, None, None)


def pair_loss_and_grads(objective: str, margin: float, ent, rel, pos, neg,
                        valid):
    """(loss, [float32 gradient of ent, of rel]): K19's one value-and-grad
    call on CUDA tables, the plain version through autograd on CPU
    tables."""
    if ent.is_cuda:
        with torch.no_grad():
            loss, grad_ent, grad_rel = bindings.kge_pair_loss_and_grads(
                ent, rel, pos, neg, valid, objective, margin)
        return loss, [grad_ent, grad_rel]
    tables = _leaves((ent, rel))
    loss = pair_loss_plain(objective, margin, *tables, pos, neg, valid)
    grads = torch.autograd.grad(loss, tables)
    return loss.detach(), [g.float() for g in grads]


def windows_loss_and_grads(tables, a, b, c, padding_idx: int, cbow: bool):
    """(loss, [four float32 gradients]) of the skip-gram or CBOW loss: K20's
    one value-and-grad call on CUDA tables, the plain version through
    autograd on CPU tables."""
    if tables[0].is_cuda:
        with torch.no_grad():
            return bindings.kge_windows_loss_and_grads(tables, a, b, c,
                                                       padding_idx, cbow)
    leaves = _leaves(tables)
    loss = windows_loss_plain(leaves, a, b, c, padding_idx, cbow)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.float() for g in grads]


# --- the model ---------------------------------------------------------------

class KGEModel(AdamTables):
    """KG-embedding tables with their optimizer state.  Parameters by
    objective: transe/distmult/rotate ``ent`` (N_e, D) and ``rel`` (N_r, D)
    (RotatE: (N_r, D/2) phases); skipgram/cbow ``ent_in``, ``rel_in``,
    ``ent_out``, ``rel_out``.  ``device=None`` means the card."""

    def __init__(self, num_entities: int, num_relations: int, dim: int = 128,
                 objective: str = "transe", margin: float = 2.0,
                 optimizer=None, learning_rate: float = 1e-2,
                 dtype="float32", b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, device=None):
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"expected one of {OBJECTIVES}")
        if objective == "rotate" and dim % 2:
            raise ValueError("rotate needs an even dim (entity rows are "
                             f"dim/2 complex pairs); got dim={dim}")
        # The touched-rows step applies Adam by hand, so a custom optimizer
        # (opaque) forbids it, as in JAX.
        super().__init__(dtype, optimizer, learning_rate, b1, b2, eps,
                         optimizer is None)
        self.dense_hparams = OPTAX_ADAM
        dev = resolve_device(device)
        self.num_entities, self.num_relations = int(num_entities), int(
            num_relations)
        self.dim, self.objective, self.margin = int(dim), objective, margin
        self.pair = objective in PAIR_OBJECTIVES
        rel_dim = self.dim // 2 if objective == "rotate" else self.dim
        shapes = ({"ent": (self.num_entities, self.dim),
                   "rel": (self.num_relations, rel_dim)} if self.pair else
                  {"ent_in": (self.num_entities, self.dim),
                   "rel_in": (self.num_relations, self.dim),
                   "ent_out": (self.num_entities, self.dim),
                   "rel_out": (self.num_relations, self.dim)})
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=self.dtype, device=dev)))
        self.reset_optimizer()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Entity rows (and the relation rows of TransE, DistMult and the in
        tables) uniform in +-1/sqrt(dim), RotatE's phases uniform in [-pi,
        pi), drawn in float32 from ``generator`` (on the tables' device);
        the out tables zero; the optimizer state reset.  Not the numbers of
        ``jax.random``."""
        scale = 1.0 / self.dim ** 0.5
        with torch.no_grad():
            for name, param in self.named_parameters():
                if name.endswith("_out"):
                    param.zero_()
                    continue
                rotate = name == "rel" and self.objective == "rotate"
                bound = math.pi if rotate else scale
                draw = torch.empty(param.shape, dtype=torch.float32,
                                   device=param.device)
                draw.uniform_(-bound, bound, generator=generator)
                param.copy_(draw)
        self.reset_optimizer()

    def entity_embeddings(self) -> torch.Tensor:
        return (self.ent if self.pair else self.ent_in).detach()

    def relation_embeddings(self) -> torch.Tensor:
        return (self.rel if self.pair else self.rel_in).detach()

    def _tables(self, pair: bool) -> list:
        if pair != self.pair:
            raise ValueError(f"objective {self.objective!r} has no "
                             f"{'pair' if pair else 'window'} loss")
        return [getattr(self, n) for n in (PAIR_TABLES if pair
                                           else WINDOW_TABLES)]

    # -- link-prediction objectives -------------------------------------------

    def _safe(self, t):
        """Components clipped into their tables (padding slots are masked out
        of the loss separately)."""
        return torch.stack([t[..., 0].clamp(0, self.num_entities - 1),
                            t[..., 1].clamp(0, self.num_relations - 1),
                            t[..., 2].clamp(0, self.num_entities - 1)], -1)

    def _pair_batch(self, pos_triples, neg_triples, padding_idx: int):
        """(clipped pos (B, 3), clipped neg (B, K, 3), valid (B,) uint8) of
        (..., 3) positives and (..., K, 3) negatives."""
        pos, neg = self._as_ids(pos_triples, neg_triples)
        pos = pos.reshape(-1, 3)
        neg = neg.reshape(pos.shape[0], -1, 3)
        valid = (pos[:, 1] != padding_idx).to(torch.uint8)
        return (self._safe(pos).contiguous(), self._safe(neg).contiguous(),
                valid)

    def pair_loss_fn(self, pos_triples, neg_triples, padding_idx: int):
        """JAX's ``pair_loss_fn``: the logistic NEG loss; positives whose
        relation is ``padding_idx`` are masked out of the mean with their
        negatives.  Differentiable with respect to the tables."""
        ent, rel = self._tables(True)
        batch = self._pair_batch(pos_triples, neg_triples, padding_idx)
        if ent.is_cuda:
            return KGEPairLoss.apply(ent, rel, *batch, self.objective,
                                     self.margin)
        return pair_loss_plain(self.objective, self.margin, ent, rel, *batch)

    def pair_train_step(self, pos_triples, neg_triples, padding_idx: int):
        """One dense step: the loss and its float32 gradients (K19's one
        call on the card), then the optimizer, in place.  Returns the loss
        before the update."""
        ent, rel = self._tables(True)
        batch = self._pair_batch(pos_triples, neg_triples, padding_idx)
        loss, grads = pair_loss_and_grads(self.objective, self.margin, ent,
                                          rel, *batch)
        self.apply_gradients(dict(zip(PAIR_TABLES, grads)))
        return loss

    def gather_touched_rows(self, pos, neg):
        """The dedup and gathers of the touched-rows step on clipped ``pos``
        (B, 3) and ``neg`` (B, K, 3): (entity ids, relation ids (sorted
        unique, padded with the table size), pos and neg as locations into
        them, the entity and relation rows at those ids)."""
        ne, nr = self.num_entities, self.num_relations
        ent_ids, ent_loc = sorted_unique_with_locations(torch.cat(
            [pos[:, 0], pos[:, 2], neg[..., 0].reshape(-1),
             neg[..., 2].reshape(-1)]), ne)
        rel_ids, rel_loc = sorted_unique_with_locations(torch.cat(
            [pos[:, 1], neg[..., 1].reshape(-1)]), nr)
        k1, k2 = pos.shape[0], neg[..., 0].numel()
        pos_l = torch.stack([ent_loc[:k1], rel_loc[:k1],
                             ent_loc[k1: 2 * k1]], -1)
        neg_l = torch.stack([ent_loc[2 * k1: 2 * k1 + k2],
                             rel_loc[k1: k1 + k2],
                             ent_loc[2 * k1 + k2:]], -1).view(neg.shape)
        ent_sub = self.ent.detach()[ent_ids.clamp(max=ne - 1).long()]
        rel_sub = self.rel.detach()[rel_ids.clamp(max=nr - 1).long()]
        return ent_ids, rel_ids, pos_l, neg_l, ent_sub, rel_sub

    def pair_train_step_sparse(self, pos_triples, neg_triples,
                               padding_idx: int):
        """Pair step with the touched-rows (lazy) Adam: the loss on gathered
        sub-tables (equal to the dense step's), then only the touched entity
        and relation rows updated, with float32 moments and the global step
        count; rows absent from the batch keep their parameters and moments
        bitwise.  Needs ``init_sparse_opt_state()`` first.  Returns the loss
        before the update."""
        if not self._sparse_hparams_ok:
            raise ValueError(SPARSE_CUSTOM_OPTIMIZER_ERROR)
        self._tables(True)
        if not self.sparse_state:
            raise ValueError("pair_train_step_sparse needs float32 moments: "
                             "call init_sparse_opt_state() first")
        pos, neg, valid = self._pair_batch(pos_triples, neg_triples,
                                           padding_idx)
        ent_ids, rel_ids, pos_l, neg_l, ent_sub, rel_sub = (
            self.gather_touched_rows(pos, neg))
        loss, (grad_ent, grad_rel) = pair_loss_and_grads(
            self.objective, self.margin, ent_sub, rel_sub, pos_l, neg_l,
            valid)
        self.adam_rows_update([("ent", grad_ent, ent_ids, None),
                               ("rel", grad_rel, rel_ids, None)])
        return loss

    # -- co-occurrence objectives ---------------------------------------------

    def _windows_loss(self, batch, padding_idx: int, cbow: bool):
        tables = self._tables(False)
        ids = self._as_ids(*batch)
        if tables[0].is_cuda:
            return KGEWindowsLoss.apply(*tables, *ids, int(padding_idx), cbow)
        return windows_loss_plain(tables, *ids, padding_idx, cbow)

    def _windows_step(self, batch, padding_idx: int, cbow: bool):
        tables = self._tables(False)
        loss, grads = windows_loss_and_grads(tables, *self._as_ids(*batch),
                                             int(padding_idx), cbow)
        self.apply_gradients(dict(zip(WINDOW_TABLES, grads)))
        return loss

    def skipgram_loss_fn(self, targets, pos_windows, neg_windows,
                         padding_idx: int):
        """JAX's ``skipgram_loss_fn`` on the ``to_windows_triples`` batch:
        targets (B, 3), windows (B, 2W, 3).  Differentiable."""
        return self._windows_loss((targets, pos_windows, neg_windows),
                                  padding_idx, False)

    def cbow_loss_fn(self, pos_triples, neg_triples, windows,
                     padding_idx: int):
        """JAX's ``cbow_loss_fn`` on the ``to_windows_triples_cbow`` batch:
        pos and neg triples (B, 3), windows (B, 2W, 3).  Differentiable."""
        return self._windows_loss((pos_triples, neg_triples, windows),
                                  padding_idx, True)

    def skipgram_train_step(self, targets, pos_windows, neg_windows,
                            padding_idx: int):
        """One step: the loss and its float32 gradients (K20's one call on
        the card), then the optimizer on the four tables, in place.  Returns
        the loss before the update."""
        return self._windows_step((targets, pos_windows, neg_windows),
                                  padding_idx, False)

    def cbow_train_step(self, pos_triples, neg_triples, windows,
                        padding_idx: int):
        """As ``skipgram_train_step``, on the CBOW batch."""
        return self._windows_step((pos_triples, neg_triples, windows),
                                  padding_idx, True)


@dataclasses.dataclass(frozen=True)
class KGEmbeddingConfig:
    dim: int = 128
    walk_length: int = 20
    window_size: int = 3
    objective: str = "transe"   # transe | distmult | rotate | skipgram | cbow
    num_negatives: int = 4      # corrupted negatives a positive (pair obj.)
    margin: float = 2.0
    learning_rate: float = 1e-2
    seed: int = 0
    dtype: str = "float32"
    # The walks' padding id; None -> max(num_entities, num_relations), out
    # of range of both id spaces.
    padding_idx: int | None = None
    # "dense" = Adam over the whole tables each step; "sparse" = the
    # touched-rows step (pair objectives only).
    update_mode: str = "dense"


class KGEmbedding:
    """KG-embedding trainer over a ``TriplesGraph``: one ``epoch_step``
    walks from a batch of start entities and takes one train step on the
    walks, which stay on the device.  The run is a pure function of
    (config.seed, epoch, targets) and the initial tables: walks, positives,
    negatives and windows equal the JAX package's value for value.
    ``device=None`` means the card; the graph must live on the same
    device."""

    def __init__(self, graph: TriplesGraph,
                 config: KGEmbeddingConfig = KGEmbeddingConfig(),
                 device=None):
        self.graph = graph
        self.config = config
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, the trainer was "
                             f"asked for {self.device}")
        if config.padding_idx is None:
            self.padding_idx = max(graph.num_entities, graph.num_relations)
        else:
            if 0 <= config.padding_idx < graph.num_relations:
                raise ValueError(
                    f"padding_idx={config.padding_idx} is a valid relation "
                    f"id (num_relations={graph.num_relations}); padded and "
                    "real window slots would be indistinguishable")
            if 0 <= config.padding_idx < graph.num_entities:
                raise ValueError(
                    f"padding_idx={config.padding_idx} is a valid entity "
                    f"id (num_entities={graph.num_entities}); walks "
                    "reaching that entity would silently absorb")
            self.padding_idx = config.padding_idx
        if config.update_mode not in ("dense", "sparse"):
            raise ValueError(f"unknown update_mode {config.update_mode!r}")
        if (config.update_mode == "sparse"
                and config.objective not in PAIR_OBJECTIVES):
            raise ValueError("update_mode='sparse' requires a pair "
                             "objective (transe, distmult or rotate)")
        self.model = KGEModel(
            graph.num_entities, max(graph.num_relations, 1), dim=config.dim,
            objective=config.objective, margin=config.margin,
            learning_rate=config.learning_rate, dtype=config.dtype,
            device=self.device)

    def init(self) -> KGEModel:
        """Fresh tables from ``config.seed`` (through ``torch.Generator``)
        and zero optimizer state (float32 moments for
        ``update_mode="sparse"``)."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(self.config.seed))
        self.model.reset_parameters(generator)
        if self.config.update_mode == "sparse":
            self.model.init_sparse_opt_state()
        return self.model

    def step_seed(self, epoch: int) -> int:
        return prng.epoch_seed(self.config.seed, epoch)

    def walks(self, targets, epoch: int) -> torch.Tensor:
        """The epoch's walks through ``walk_triples(graph, ...)``: the fat
        engine where ``graph.fat``, else the oracle, as the JAX ``_walk``
        picks by ``triple_tab``."""
        return walk_triples(self.graph, target_nodes=targets,
                            walk_length=self.config.walk_length,
                            padding_idx=self.padding_idx,
                            seed=self.step_seed(epoch), device=self.device)

    def batch(self, walks, epoch: int) -> tuple:
        """The train step's batch of the epoch's walks: (positives,
        negatives) for a pair objective, else the triple windows."""
        cfg, pad, seed = self.config, self.padding_idx, self.step_seed(epoch)
        n = self.graph.num_entities
        if cfg.objective in PAIR_OBJECTIVES:
            pos, _ = _triples_targets_and_windows(walks, 1, pad)
            return pos, corrupt_triples(pos, n, cfg.num_negatives, seed, epoch)
        make = (to_windows_triples if cfg.objective == "skipgram"
                else to_windows_triples_cbow)
        return make(walks, cfg.window_size, n, pad, self.graph.triples, seed,
                    device=self.device)

    def train_step(self, batch) -> torch.Tensor:
        """The step of the objective and update mode on ``batch``."""
        cfg, model, pad = self.config, self.model, self.padding_idx
        if cfg.objective in PAIR_OBJECTIVES:
            step = (model.pair_train_step_sparse if cfg.update_mode == "sparse"
                    else model.pair_train_step)
            return step(*batch, pad)
        if cfg.objective == "skipgram":
            return model.skipgram_train_step(*batch, pad)
        return model.cbow_train_step(*batch, pad)

    def epoch_step(self, targets, epoch: int) -> torch.Tensor:
        """One sample+train step over a batch of start entities; updates the
        model in place and returns the loss (before the update)."""
        walks = self.walks(targets, epoch)
        return self.train_step(self.batch(walks, epoch))

    def train(self, num_epochs: int, batch_entities=None, log_every: int = 0):
        """Training loop from fresh tables (default batch: every entity);
        returns (model, losses)."""
        self.init()
        if batch_entities is None:
            batch_entities = torch.arange(self.graph.num_entities,
                                          dtype=torch.int32,
                                          device=self.device)
        batch_entities = common.as_int32(batch_entities, self.device)
        losses = []
        for epoch in range(num_epochs):
            losses.append(float(self.epoch_step(batch_entities, epoch)))
            if log_every and epoch % log_every == 0:
                print(f"epoch {epoch}: loss {losses[-1]:.4f}")
        return self.model, np.array(losses)

    def embeddings(self) -> torch.Tensor:
        return self.model.entity_embeddings()
