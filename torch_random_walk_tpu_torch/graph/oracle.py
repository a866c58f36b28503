"""NumPy oracle: the exact per-step transition distributions of the
reference's samplers (the port's own copy of
``torch_random_walk_tpu/graph/oracle.py``; it imports NumPy only).

The parity bar of the walks is *per-step transition-distribution
equivalence*: for every (state, graph) the probability of each successor
must match the reference's sampler.  This module computes those
probabilities exactly, in NumPy, from the transition rules of the
reference's CPU samplers:

- uniform CSR:    ``csrc/cpu/rw_cpu.cpp:58-107``
- node2vec CSR:   ``csrc/cpu/rw_cpu.cpp:109-201`` (rejection)
- edge-list:      ``csrc/cpu/rw_cpu_edge_list.cpp``
- triples:        ``csrc/cpu/rw_cpu_triples.cpp``

For the rejection samplers the oracle returns the *conditional-on-accept*
distribution, which is the sampler's exact per-step law (rejection rounds are
i.i.d., so P(select=x) = accept_mass(x) / total_accept_mass).
"""

from __future__ import annotations

import numpy as np


def _row(row_ptr, col_idx, v):
    return np.asarray(col_idx[int(row_ptr[v]) : int(row_ptr[v + 1])])


def uniform_csr_probs(row_ptr, col_idx, v, num_nodes):
    """P(next | cur=v) for the uniform CSR walk.  Degree-0 nodes stay put
    (our defined behavior where the reference has UB, rw_cpu.cpp:20)."""
    p = np.zeros(num_nodes)
    nbrs = _row(row_ptr, col_idx, v)
    if nbrs.size == 0:
        p[v] = 1.0
    else:
        for x in nbrs:
            p[x] += 1.0 / nbrs.size
    return p


def node2vec_csr_probs(row_ptr, col_idx, t, v, p, q, num_nodes):
    """P(next | prev=t, cur=v) for the node2vec rejection walk
    (rw_cpu.cpp:129-198).  Equals normalized weights w(x) with
    w = 1/p if x==t, 1 if x is a neighbor of t, 1/q otherwise."""
    out = np.zeros(num_nodes)
    nbrs = _row(row_ptr, col_idx, v)
    if nbrs.size == 0:
        out[v] = 1.0  # degree-0: candidate==v every round; accepted eventually
        return out
    t_nbrs = set(_row(row_ptr, col_idx, t).tolist())
    for x in nbrs:
        if x == t:
            w = 1.0 / p
        elif int(x) in t_nbrs:
            w = 1.0
        else:
            w = 1.0 / q
        out[x] += w
    out /= out.sum()
    return out


def uniform_edge_probs(edge_list, node_edge_index, v, jump, padding_idx, num_nodes):
    """P(next | cur=v) for the uniform edge-list walk
    (rw_cpu_edge_list.cpp:8-35): padding -> jump; no out-edges -> padding;
    else uniform over out-edges (parallel edges add mass)."""
    size = num_nodes if padding_idx < num_nodes else padding_idx + 1
    out = np.zeros(size)
    if v == padding_idx:
        out[jump] = 1.0
        return out
    s, e = int(node_edge_index[v][0]), int(node_edge_index[v][1])
    if s == -1 or e == -1:
        out[padding_idx] = 1.0
        return out
    tails = np.asarray(edge_list[s : e + 1, 1])
    for x in tails:
        out[x] += 1.0 / tails.size
    return out


def biased_edge_probs(
    edge_list, node_edge_index, t, v, p, q, jump, padding_idx, num_nodes
):
    """P(next | prev=t, cur=v) for the biased edge-list rejection walk
    (rw_cpu_edge_list.cpp:128-238), with the clean branch semantics we
    implement (SURVEY.md §2.4 notes the reference's bare-if quirk):
      candidate==t        -> accept w.p. prob_0, select candidate
      candidate==padding  -> accept w.p. prob_0, select jump
      candidate ~ t       -> accept w.p. prob_1
      else                -> accept w.p. prob_2
    """
    size = num_nodes if padding_idx < num_nodes else padding_idx + 1
    out = np.zeros(size)
    max_prob = max(1.0 / p, 1.0, 1.0 / q)
    p0, p1, p2 = 1.0 / p / max_prob, 1.0 / max_prob, 1.0 / q / max_prob

    # Candidate distribution = uniform edge-list step from v.
    cand = uniform_edge_probs(edge_list, node_edge_index, v, jump, padding_idx, num_nodes)

    if t == padding_idx:
        t_tails = set()
    else:
        s, e = int(node_edge_index[t][0]), int(node_edge_index[t][1])
        t_tails = (
            set(np.asarray(edge_list[s : e + 1, 1]).tolist()) if s != -1 else set()
        )

    for x in np.nonzero(cand)[0]:
        m = cand[x]
        if x == t:
            out[x] += m * p0
        elif x == padding_idx:
            out[jump] += m * p0
        elif int(x) in t_tails:
            out[x] += m * p1
        else:
            out[x] += m * p2
    out /= out.sum()
    return out


def triples_probs(triples, relation_tail_index, v, padding_idx, num_entities, num_relations):
    """P(rel, tail | cur=v) for the uniform triples walk
    (rw_cpu_triples.cpp:11-46): padding absorbing; no triples -> (pad, pad);
    else uniform over the head's triples.  Returned as a dict
    {(rel, tail): prob}."""
    if v == padding_idx:
        return {(padding_idx, padding_idx): 1.0}
    s, e = int(relation_tail_index[v][0]), int(relation_tail_index[v][1])
    if s == -1 or e == -1:
        return {(padding_idx, padding_idx): 1.0}
    out: dict = {}
    rows = np.asarray(triples[s : e + 1])
    for _, r, tl in rows:
        key = (int(r), int(tl))
        out[key] = out.get(key, 0.0) + 1.0 / rows.shape[0]
    return out


def walk_uniform_csr(row_ptr, col_idx, targets, walk_length, rng):
    """Sequential NumPy uniform walker (sanity oracle, not bit-matched)."""
    targets = np.asarray(targets)
    walks = np.zeros((targets.size, walk_length + 1), np.int64)
    walks[:, 0] = targets
    for i, t in enumerate(targets):
        v = int(t)
        for s in range(1, walk_length + 1):
            nbrs = _row(row_ptr, col_idx, v)
            v = int(rng.choice(nbrs)) if nbrs.size else v
            walks[i, s] = v
    return walks
