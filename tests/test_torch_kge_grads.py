"""How K19 and K20 assemble their gradients, in tensor code, against the JAX
package's ``value_and_grad`` on batches of the grid-world KG.

K20 merges the rows that repeat among a round of a window's composed slots
and adds each distinct row once with the sum of its occurrences'
coefficients (``kge.merged_row_adds``); K19 sums the rows a negative shares
with its positive before one add; both sum the relation rows' gradient by
block (item b in block (b // groups) % grid) and add the blocks' sums.  The
mirrors below build the gradients that way from the plain versions' per-slot
coefficients and row gradients, for rounds of 4, 16 and 32 lanes and
several grids, and the tests hold them against JAX: float32 within 1e-4 of
the largest entry; bfloat16 within max(4, sqrt(n)) bfloat16 ulps of it, n
the most terms a row of the table sums (JAX sums a bfloat16 gradient in
bfloat16, each of its n adds rounding by up to half an ulp, so its error
grows as sqrt(n); the kernels and the mirrors sum in float32; 4 ulps is
test_torch_kge.py's allowance on its batches of 20).  The windows come
from the port's walks and windows on the grid KG, with a window of weight
0, a slot with h == t, a negative equal to a positive, a masked positive
and components outside their tables put in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.models.kge import KGEModel as JModel
from torch_random_walk_tpu_torch.models import kge as tkge

SIDE, NE, NR = 6, 36, 4
PAD = NE
BF16_ULP = 2.0 ** -8
# The kernels' lanes (16: bfloat16 rows; 32: float32) and rounds of 4, which
# split a W = 3 window's 12 slots as rounds of 16 split a W = 9 window's 18.
LANES_AND_GRIDS = ((4, 3), (16, 1), (32, 5))
# XLA's CPU at optimization level 0; bfloat16 without excess precision, so
# that each bfloat16 operation rounds as it does op by op.
_FAST = {"xla_backend_optimization_level": 0}
_EXACT_BF16 = {**_FAST, "xla_allow_excess_precision": False}


def close(got, want, dtype, terms):
    """``got`` against JAX's gradient ``want`` of a table whose rows sum at
    most ``terms`` terms."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * scale + 1e-9)
    else:
        ulps = max(4.0, float(np.sqrt(terms)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ulps * BF16_ULP * scale + 1e-9)


def most_terms(ids, n):
    """The most occurrences of a row among ``ids`` (-1: none)."""
    ids = ids.reshape(-1)
    return int(torch.bincount(ids[ids >= 0], minlength=n).max())


def np_table(x, dtype):
    """A numpy table of ``dtype`` (no XLA conversion to compile)."""
    return np.asarray(x, np.float32).astype(jnp.dtype(dtype))


def jax_run(fn, args, dtype):
    return jax.jit(fn).lower(args).compile(
        _FAST if dtype == "float32" else _EXACT_BF16)(args)


def random_tables(names, dims, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.uniform(-0.5, 0.5, (NR if "rel" in n else NE, d)).astype(
        np.float32) for n, d in zip(names, dims)}


def as_port(t, dtype):
    """float32 copies of the tables rounded to ``dtype`` (exact), as the
    plain versions read them."""
    return [torch.tensor(v).to(getattr(torch, dtype)).float() for v in t]


def block_sums(window, rows, vecs, lanes, grid, num_rows):
    """The relation rows' gradient summed by block, as the kernels sum it in
    shared memory (item b in block (b // (256 // lanes)) % grid), then the
    blocks' sums added."""
    block = (window // (256 // lanes)) % grid
    sums = torch.zeros(grid * num_rows, vecs.shape[-1], dtype=torch.float32)
    sums.index_add_(0, block * num_rows + rows, vecs)
    return sums.reshape(grid, num_rows, -1).sum(0)


# --- the merge itself -------------------------------------------------------

def test_merged_row_adds_sum_each_rounds_repeated_rows_once():
    """Slots (1, 0, 2), (2, 1, 3), (4, 0, 4), none, (2, 3, 5): a tail that
    is the next head, h == t (twice), a row that repeats two slots on, a
    skipped slot.  In one round of 32 lanes and in rounds of 2."""
    rows = torch.tensor([[[1, 0, 2], [2, 1, 3], [4, 0, 4], [-1, -1, -1],
                          [2, 3, 5]]])
    coef = torch.tensor([[1.0, 10.0, 100.0, 1000.0, 10000.0]])
    for lanes, entity, relation in (
            (32, {1: 1.0, 2: 10011.0, 3: 10.0, 4: 200.0, 5: 10000.0},
             {0: 101.0, 1: 10.0, 3: 10000.0}),
            (2, [(1, 1.0), (2, 11.0), (3, 10.0), (4, 200.0), (2, 10000.0),
                 (5, 10000.0)],
             [(0, 1.0), (1, 10.0), (0, 100.0), (3, 10000.0)])):
        got = tkge.merged_row_adds(rows, coef, lanes)
        for name, want in (("entity", entity), ("relation", relation)):
            window, row, total = got[name]
            assert window.tolist() == [0] * len(row)
            pairs = list(zip(row.tolist(), total.tolist()))
            if isinstance(want, dict):
                assert dict(pairs) == want and len(pairs) == len(want)
            else:
                assert sorted(pairs) == sorted(want)


# --- K20 --------------------------------------------------------------------

def grid_windows(cbow, w):
    """The port's triple windows of grid-KG walks (CPU), with the edge
    cases put in."""
    tg, _, _ = tt.synthetic_grid_kg(SIDE, seed=3, device="cpu")
    targets = torch.arange(NE, dtype=torch.int32)
    walks = tt.walk_triples(tg, target_nodes=targets,
                            walk_length=4, padding_idx=PAD, seed=1,
                            device="cpu")
    make = tt.to_windows_triples_cbow if cbow else tt.to_windows_triples
    a, b, c = (x.clone() for x in make(walks, w, NE, PAD, tg.triples, seed=2,
                                       device="cpu"))
    a[0, 1] = PAD  # a window of weight 0
    many = c if cbow else b
    many[1, 0] = torch.tensor([5, 2, 5])  # h == t
    many[2, 1, 1] = PAD  # a masked slot
    many[3, 0, 0], many[3, 1, 2] = -1, NE + 3  # outside the tables
    if cbow:
        b[4] = a[4]  # the negative is the positive
    else:
        c[4, 0] = b[4, 1]  # a negative equal to a positive
    return a, b, c


def windows_mirror(tables, batch, cbow, lanes, grid, rounding):
    """K20's gradients as it assembles them: the per-slot coefficients of
    the plain forward (the logits' gradient), merged by round, times u (the
    out rows of skip-gram) or dm / n (CBOW's context rows), and du or m for
    the in rows; relation rows by block."""
    ent_in, rel_in, ent_out, rel_out = tables
    a, b, c = batch
    rows = tkge.window_slot_rows(batch, PAD, cbow, NE, NR)
    if cbow:
        ctx = tkge.compose_plain(ent_out, rel_out, c, rounding)
        ok = (c[..., 1] != PAD)[..., None]
        denom = torch.clamp(ok.sum(1), min=1).float()
        rnd = tkge._rounder(tables, rounding)
        m = rnd(rnd(torch.where(ok, ctx, 0.0).sum(1)) / denom)
        ins = torch.stack([tkge.compose_plain(ent_in, rel_in, t, rounding)
                           for t in (a, b)], 1)
        x = (m[:, None] * ins).sum(-1).requires_grad_(True)
        per = -(F.logsigmoid(x[:, 0]) + F.logsigmoid(-x[:, 1]))
        g = torch.autograd.grad(tkge._masked_mean(per, a[:, 1] != PAD), x)[0]
        in_coef, in_vec = g, m
        out_coef = torch.ones(c.shape[:2])
        out_vec = (g[:, :, None] * ins).sum(1) / denom
    else:
        u = tkge.compose_plain(ent_in, rel_in, a, rounding)
        v = tkge.compose_plain(ent_out, rel_out, torch.cat([b, c], 1),
                               rounding)
        x = (u[:, None] * v).sum(-1).requires_grad_(True)
        cols = b.shape[1]
        per = -(torch.where(b[..., 1] != PAD, F.logsigmoid(x[:, :cols]),
                            0.0).sum(-1)
                + F.logsigmoid(-x[:, cols:]).sum(-1))
        g = torch.autograd.grad(tkge._masked_mean(per, a[:, 1] != PAD), x)[0]
        in_coef, in_vec = torch.ones(a.shape[0], 1), (g[..., None] * v).sum(1)
        out_coef, out_vec = g, u
    grads = [torch.zeros(t.shape) for t in tables]
    adds, unmerged = 0, 0
    for side, coef, vec in (("in", in_coef, in_vec), ("out", out_coef,
                                                      out_vec)):
        merged = tkge.merged_row_adds(rows[side], coef, lanes)
        ent_grad = grads[0 if side == "in" else 2]
        win, row, total = merged["entity"]
        ent_grad.index_add_(0, row, total[:, None] * vec[win])
        win, row, total = merged["relation"]
        grads[1 if side == "in" else 3] += block_sums(
            win, row, total[:, None] * vec[win], lanes, grid, NR)
        adds += len(merged["entity"][0])
        unmerged += int((rows[side][..., ::2] >= 0).sum())
    return grads, adds, unmerged


WINDOW_DIMS, WINDOW_SIZE = (1, 7, 16), 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
def test_k20_gradient_assembly_equals_jax(cbow, dtype):
    """At D = 1, 7, 16 and W = 3, against JAX's ``value_and_grad`` of
    ``skipgram_loss_fn`` or ``cbow_loss_fn``; and no more row adds than
    PR 18's one an entity component of a composed slot, and fewer here."""
    names = tkge.WINDOW_TABLES
    objective = "cbow" if cbow else "skipgram"
    batch = grid_windows(cbow, WINDOW_SIZE)
    cases = [(random_tables(names, (d,) * 4, seed=d), d)
             for d in WINDOW_DIMS]
    models = [JModel(NE, NR, dim=d, objective=objective) for _, d in cases]
    args = [({n: np_table(t[n], dtype) for n in names},
             *(x.numpy() for x in batch)) for t, _ in cases]
    want = jax_run(lambda args: [
        jax.value_and_grad(getattr(m, f"{objective}_loss_fn"))(*a, PAD)
        for m, a in zip(models, args)], args, dtype)
    rounding = getattr(torch, dtype)
    for (t, d), (_, jgrads) in zip(cases, want):
        tables = as_port([t[n] for n in names], dtype)
        rows = tkge.window_slot_rows(batch, PAD, cbow, NE, NR)
        terms = [most_terms(rows[side][..., comps], n)
                 for side in ("in", "out")
                 for comps, n in ((slice(None, None, 2), NE), (1, NR))]
        for lanes, grid in LANES_AND_GRIDS:
            grads, adds, unmerged = windows_mirror(tables, batch, cbow,
                                                   lanes, grid, rounding)
            for n, g, most in zip(names, grads, terms):
                close(g.numpy(), np.asarray(jgrads[n], np.float32), dtype,
                      most)
            assert adds < unmerged, (d, lanes)


# --- K19 --------------------------------------------------------------------

def pair_batch(seed, k=4):
    """Positives of grid-KG walks, the port's negatives, and the edge
    cases: h == t, a negative's corrupted row equal to the positive's other
    entity."""
    tg, _, _ = tt.synthetic_grid_kg(SIDE, seed=3, device="cpu")
    targets = torch.arange(NE, dtype=torch.int32)
    walks = tt.walk_triples(tg, target_nodes=targets, walk_length=2,
                            padding_idx=PAD, seed=seed, device="cpu")
    pos = torch.cat([walks[:, 0:3], walks[:, 2:5]]).clone()
    pos[3] = torch.tensor([7, 1, 7])
    valid = ((pos[:, 1] != PAD) & (torch.arange(pos.shape[0]) % 5 != 0))
    pos = torch.minimum(pos.clamp(min=0), torch.tensor([NE - 1, NR - 1,
                                                        NE - 1]))
    neg = tt.corrupt_triples(pos.contiguous(), NE, k, 9, 1)
    neg[5, 0, 2] = pos[5, 0]
    return pos.contiguous(), neg, valid.to(torch.uint8)


def pair_mirror(objective, ent, rel, pos, neg, valid, lanes, grid,
                rounding):
    """K19's gradients as it assembles them: each scored triple's row
    gradients (autograd of the plain score on its gathered rows); a
    negative's rows equal to its positive's summed with the positive's,
    the positive's h and t added once (h == t: one add of their sum), a
    negative's own rows at once; relation rows by block."""
    b, k = neg.shape[:2]
    trip = torch.cat([pos[:, None], neg], 1).reshape(-1, 3).long()
    h, r, t = (tab[trip[:, i]].detach().clone().requires_grad_(True)
               for i, tab in enumerate((ent, rel, ent)))
    n = trip.shape[0]
    idx = torch.stack([torch.arange(n), torch.arange(n),
                       n + torch.arange(n)], 1)
    s = tkge.pair_scores_plain(objective, 2.0, torch.cat([h, t]), r, idx,
                               rounding).reshape(b, k + 1)
    per = -(F.logsigmoid(s[:, 0]) + F.logsigmoid(-s[:, 1:]).sum(-1))
    w = valid.float()
    loss = (per * w).sum() / torch.clamp(w.sum(), min=1.0)
    gh, gr, gt = (g.reshape(b, k + 1, -1) for g in torch.autograd.grad(
        loss, (h, r, t)))
    pos, neg = pos.long(), neg.long()
    same = [neg[..., i] == pos[:, None, i] for i in range(3)]
    gsum = [g[:, 0] + (g[:, 1:] * sm[..., None]).sum(1)
            for g, sm in zip((gh, gr, gt), same)]
    grad_ent, adds = torch.zeros(ent.shape), 0
    one = pos[:, 0] == pos[:, 2]
    grad_ent.index_add_(0, pos[:, 0], gsum[0] + torch.where(
        one[:, None], gsum[2], 0.0))
    grad_ent.index_add_(0, pos[~one, 2], gsum[2][~one])
    adds += b + int((~one).sum())
    for i, g in ((0, gh), (2, gt)):
        own = ~same[i]
        grad_ent.index_add_(0, neg[..., i][own], g[:, 1:][own])
        adds += int(own.sum())
    items = torch.arange(b)
    own = ~same[1]
    rows = torch.cat([pos[:, 1], neg[..., 1][own]])
    window = torch.cat([items, items[:, None].expand(b, k)[own]])
    vecs = torch.cat([gsum[1], gr[:, 1:][own]])
    grad_rel = block_sums(window, rows, vecs, lanes, grid, rel.shape[0])
    return [grad_ent, grad_rel], adds


PAIR_DIMS = {"transe": (1, 7, 16), "distmult": (1, 7, 16),
             "rotate": (2, 16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("objective", list(PAIR_DIMS))
def test_k19_gradient_assembly_equals_jax(objective, dtype):
    """Against JAX's ``value_and_grad`` of ``_pair_loss_tabs`` on the same
    clipped triples and weights, NaN (TransE at ||d|| = 0) where JAX's is;
    at most 2 + K row adds a positive, relation rows on the chip."""
    dims = PAIR_DIMS[objective]
    cases = []
    for d in dims:
        pos, neg, valid = pair_batch(d)
        width = d // 2 if objective == "rotate" else d
        t = random_tables(("ent", "rel"), (d, width), seed=d)
        if objective == "rotate":
            t["rel"] *= 2 * np.pi
        if objective == "transe":  # ||d|| = 0 on a masked positive
            h, r, tl = pos[0].tolist()
            t["ent"][tl] = (np.asarray(t["ent"][h], np.float32)
                            + t["rel"][r])
        cases.append((d, t, pos, neg, valid))
    models = [JModel(NE, NR, dim=d, objective=objective, margin=2.0)
              for d, *_ in cases]
    args = [(np_table(t["ent"], dtype), np_table(t["rel"], dtype),
             *(x.numpy() for x in (pos, neg, valid)))
            for _, t, pos, neg, valid in cases]
    want = jax_run(lambda args: [
        jax.value_and_grad(m._pair_loss_tabs, argnums=(0, 1))(*a)
        for m, a in zip(models, args)], args, dtype)
    rounding = getattr(torch, dtype)
    for (d, t, pos, neg, valid), (_, jgrads) in zip(cases, want):
        ent, rel = as_port((t["ent"], t["rel"]), dtype)
        trips = torch.cat([pos[:, None], neg], 1)
        terms = (most_terms(trips[..., ::2], NE), most_terms(trips[..., 1],
                                                             NR))
        for lanes, grid in LANES_AND_GRIDS:
            grads, adds = pair_mirror(objective, ent, rel, pos, neg, valid,
                                      lanes, grid, rounding)
            for g, jg, most in zip(grads, jgrads, terms):
                jg = np.asarray(jg, np.float32)
                nan = np.isnan(jg)
                np.testing.assert_array_equal(np.isnan(g.numpy()), nan)
                if (~nan).any():
                    close(g.numpy()[~nan], jg[~nan], dtype, most)
            assert adds < pos.shape[0] * (2 + neg.shape[1])
