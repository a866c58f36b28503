"""node2vec p/q-biased CSR random walks (twin of
``torch_random_walk_tpu/ops/node2vec.py``).

Two samplers with two bitstreams, both exact for the node2vec law:

- ``node2vec_walk_csr``: rejection against the flat envelope
  max(1/p, 1, 1/q), a float32 draw per round;
- ``node2vec_walk_csr_mixture``: the composition-envelope sampler of the JAX
  package's graph entry point (``ops/fatwalk.py``), an integer quotient draw
  with an exact point mass for the return to ``t``.

On a CUDA device both run in the hand-written kernel K2
(``kernels/node2vec_walk.cu``, one template flag); ``node2vec_walk_plain`` is
the plain PyTorch version of both, used on the CPU and to check the kernel.
It runs rounds in lock step over the frontier, as the JAX code does, and
keeps each walker's first accepted candidate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from torch_random_walk_tpu_torch.kernels import bindings
from torch_random_walk_tpu_torch.ops import common
from torch_random_walk_tpu_torch.utils import prng
from torch_random_walk_tpu_torch.utils.device import resolve_device

# Placeholders for the sampler that a call does not use.
NO_CONSTS = (1, 0, 0, 0, 0)
NO_PROBS = (0.0, 0.0, 0.0)


class BiasedWalks(NamedTuple):
    walks: torch.Tensor      # (B, L+1) int32
    exhausted: torch.Tensor  # (B,) bool: a step spent the whole round budget
    # Plain version only, (B, L-1) int32 by walker and step 2..L: the rounds
    # drawn, and those of them whose draw needs a search of t's row (a
    # candidate other than t with its draw between the two thresholds, the
    # only rounds where being a neighbour of t decides).
    rounds: torch.Tensor | None
    searches: torch.Tensor | None


def mixture_consts(p: float, q: float, deg_bits: int) -> tuple:
    """Integer weights (mi, ei, wt_i, w1_i, w2_i) of the mixture sampler,
    copied from ``ops/fatwalk.py::_mixture_consts``.

    Envelope M = max(1, 1/q) for the base part min(w, M), plus an exact point
    mass extra * mult_v(t) at x == t with extra = max(0, 1/p - M).  Weights
    are scaled to integers so that the total mass of any row fits 32 bits;
    ``deg_bits`` (``CSRGraph.deg_bits``) fixes the scale and is therefore
    part of the bitstream."""
    max_deg = 1 << deg_bits
    m_env = max(1.0, 1.0 / q)
    extra = max(0.0, 1.0 / p - m_env)
    worst = max_deg * max(m_env, 1.0 / p) + 1
    s_bits = 31
    while (1 << s_bits) * worst > float(1 << 31) and s_bits > 1:
        s_bits -= 1
    scale = 1 << s_bits
    mi = max(int(round(m_env * scale)), 1)
    ei = int(round(extra * scale))
    wt_i = max(int(round(min(1.0 / p, m_env) * scale)), 0)
    w1_i = min(int(round(1.0 * scale)), mi)
    w2_i = min(int(round((1.0 / q) * scale)), mi)
    return mi, ei, wt_i, w1_i, w2_i


def _count_in_row(row_ptr, col_idx, v, x, iters):
    """Multiplicity of ``x`` in v's sorted row: two binary searches."""
    lo, end = common.row_bounds(row_ptr, v)
    return (common.lower_bound(col_idx, lo, end, x, True, iters)
            - common.lower_bound(col_idx, lo, end, x, False, iters))


def node2vec_walk_plain(row_ptr, col_idx, target_nodes, walk_length, key,
                        walker_offset, mixture, probs, consts, search_iters,
                        max_rounds) -> BiasedWalks:
    """Plain version of K2, either sampler.  ``probs`` are the rejection
    thresholds, ``consts`` the mixture weights."""
    dev = target_nodes.device
    num_walkers = target_nodes.shape[0]
    wid = common.walker_ids(num_walkers, walker_offset, dev)
    if col_idx.shape[0] == 0:  # no edges: every walker stays in place
        stay = target_nodes.to(torch.int32)[:, None].repeat(1, walk_length + 1)
        none = torch.zeros(num_walkers, walk_length - 1, dtype=torch.int32,
                           device=dev)
        return BiasedWalks(stay, torch.zeros(num_walkers, dtype=torch.bool,
                                             device=dev), none, none)
    prob_0, prob_1, prob_2 = (torch.tensor(x, dtype=torch.float32, device=dev)
                              for x in probs)
    mi, ei, wt_i, w1_i, w2_i = consts
    p_lo, p_hi = torch.minimum(prob_1, prob_2), torch.maximum(prob_1, prob_2)
    w_lo, w_hi = min(w1_i, w2_i), max(w1_i, w2_i)
    cur0 = target_nodes.to(torch.int64)

    # First hop: a plain uniform draw at (step 1, round 0).
    bits, _ = prng.counter_bits(key, wid, prng.step_round_counter(1))
    if mixture:
        start0, end0 = common.row_bounds(row_ptr, cur0)
        deg0 = end0 - start0
        pos0 = prng.mulhi32(bits, ((mi * deg0) & prng.MASK32).clamp(min=1))
        first = torch.where(deg0 == 0, cur0,
                            common.gather_col(col_idx, start0 + pos0 // mi))
    else:
        first = common.sample_csr_neighbor(row_ptr, col_idx, cur0, bits)

    cols = [cur0, first]
    exhausted = torch.zeros(num_walkers, dtype=torch.bool, device=dev)
    rounds, searches = [], []
    t, v = cur0, first
    for step in range(2, walk_length + 1):
        if mixture:
            start, end = common.row_bounds(row_ptr, v)
            deg = end - start
            dead = deg == 0
            mult = _count_in_row(row_ptr, col_idx, v, t,
                                 search_iters).clamp(max=0xFFFF)
            g_spike = (ei * mult) & prng.MASK32
            g_total = (mi * deg + g_spike) & prng.MASK32
        resolved = torch.zeros(num_walkers, dtype=torch.bool, device=dev)
        sel = v
        rnd = 0
        step_rounds = torch.zeros(num_walkers, dtype=torch.int32, device=dev)
        step_searches = torch.zeros_like(step_rounds)
        while rnd < max_rounds and not bool(resolved.all()):
            step_rounds += ~resolved
            b_cand, b_acc = prng.counter_bits(
                key, wid, prng.step_round_counter(step, rnd))
            if mixture:
                pos = prng.mulhi32(b_cand, g_total.clamp(min=1))
                spike = (pos < g_spike) & ~dead
                base = (pos - g_spike) & prng.MASK32
                sub = base % mi
                cand = torch.where(
                    dead, v, torch.where(
                        spike, t,
                        common.gather_col(col_idx, start + base // mi)))
                nbr = common.is_neighbor_csr(cand, t, row_ptr, col_idx,
                                             search_iters)
                accept = spike | dead | torch.where(
                    cand == t, sub < wt_i,
                    torch.where(nbr, sub < w1_i, sub < w2_i))
                band = ~spike & ~dead & (sub >= w_lo) & (sub < w_hi)
            else:
                cand = common.sample_csr_neighbor(row_ptr, col_idx, v, b_cand)
                r = prng.uniform_from_bits(b_acc)
                nbr = common.is_neighbor_csr(cand, t, row_ptr, col_idx,
                                             search_iters)
                accept = torch.where(
                    cand == t, r < prob_0,
                    torch.where(nbr, r < prob_1, r < prob_2))
                band = (r >= p_lo) & (r < p_hi)
            step_searches += ~resolved & band & (cand != t)
            sel = torch.where(~resolved & accept, cand, sel)
            resolved = resolved | accept
            rnd += 1
        # Round budget spent: the walker keeps v, as the JAX oracles do.
        exhausted |= ~resolved
        rounds.append(step_rounds)
        searches.append(step_searches)
        cols.append(sel)
        t, v = v, sel
    walks = torch.stack(cols[: walk_length + 1], dim=1).to(torch.int32)
    per_step = [torch.stack(x, dim=1) if x else
                torch.zeros(num_walkers, 0, dtype=torch.int32, device=dev)
                for x in (rounds, searches)]
    return BiasedWalks(walks, exhausted, *per_step)


def biased_walk(row_ptr, col_idx, target_nodes, walk_length, seed,
                walker_offset, mixture, probs, consts, search_iters,
                max_rounds, device=None) -> BiasedWalks:
    """Shared entry of both samplers: K2 on a CUDA device, the plain version
    on the CPU."""
    dev = resolve_device(device)
    row_ptr = common.as_int32(row_ptr, dev)
    col_idx = common.as_int32(col_idx, dev)
    target_nodes = common.as_int32(target_nodes, dev)
    key = prng.derive_key(seed, prng.STREAM_CSR_BIASED)
    args = (row_ptr, col_idx, target_nodes, int(walk_length), key,
            int(walker_offset), mixture, probs, consts, int(search_iters),
            int(max_rounds))
    if dev.type == "cuda":
        walks, exhausted = bindings.node2vec_walk_csr(*args)
        return BiasedWalks(walks, exhausted, None, None)
    common.check_walk_length(walk_length)
    return node2vec_walk_plain(*args)


def node2vec_walk_csr(row_ptr, col_idx, target_nodes, p, q, walk_length, seed,
                      walker_offset=0,
                      search_iters=common.DEFAULT_SEARCH_ITERS,
                      max_rounds=common.DEFAULT_MAX_ROUNDS, device=None):
    """Batched node2vec walks, rejection sampler.  A walker whose round
    budget runs out at a step stays where it is for that step."""
    probs = common.node2vec_accept_probs(float(p), float(q))
    return biased_walk(row_ptr, col_idx, target_nodes, walk_length, seed,
                       walker_offset, False, probs, NO_CONSTS, search_iters,
                       max_rounds, device).walks


def node2vec_walk_csr_mixture(row_ptr, col_idx, target_nodes, p, q,
                              walk_length, seed, deg_bits, walker_offset=0,
                              search_iters=common.DEFAULT_SEARCH_ITERS,
                              max_rounds=common.DEFAULT_MAX_ROUNDS,
                              device=None):
    """Batched node2vec walks, mixture sampler.  ``deg_bits`` must be the
    graph's ``CSRGraph.deg_bits``.  A walker whose round budget runs out at a
    step stays where it is for that step."""
    consts = mixture_consts(float(p), float(q), int(deg_bits))
    return biased_walk(row_ptr, col_idx, target_nodes, walk_length, seed,
                       walker_offset, True, NO_PROBS, consts, search_iters,
                       max_rounds, device).walks
