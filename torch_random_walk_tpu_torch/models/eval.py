"""Embedding quality evaluation: link prediction, node classification and KG
tail ranking (twin of ``torch_random_walk_tpu/models/eval.py``).

The draws (``numpy.random.default_rng``: negative edges, permutations) and
the filtered protocol's index stay on the host, so they are the JAX
package's; the arithmetic (edge scores, the logistic readouts, the AUC
ranks, the candidate scores over all entities) runs in float64 torch on the
embeddings' device (a numpy table: the CPU).  Results are Python floats;
ranks count strictly greater scores fully and ties half, as in JAX.  Two
scores that tie across the positive and negative sets are ordered by
torch's stable sort in the AUC, where numpy's order is unspecified.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x, device=None) -> torch.Tensor:
    """A table or array as float64 on its own device (a tensor) or on
    ``device`` (numpy input; the CPU by default)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _ids(edges, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(edges), device=device).long()


def _unit_rows(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1,
                                                      keepdim=True), min=1e-12)


def _rank_auc(pos: torch.Tensor, neg: torch.Tensor) -> float:
    """P(a positive scores above a negative) by the rank statistic."""
    scores = torch.cat([pos, neg])
    ranks = torch.empty_like(scores)
    order = torch.argsort(scores, stable=True)
    ranks[order] = torch.arange(1, scores.numel() + 1, dtype=scores.dtype,
                                device=scores.device)
    n_pos, n_neg = pos.numel(), neg.numel()
    return float((ranks[:n_pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def link_prediction_auc(embeddings, pos_edges, neg_edges,
                        score: str = "dot") -> float:
    """AUC of edge scores: positive (real) edges vs negative (absent) pairs.
    embeddings (N, D); pos_edges/neg_edges (K, 2); score 'dot' | 'cosine'
    | 'hadamard-l2'."""
    emb = _f64(embeddings)
    if score == "cosine":
        emb = _unit_rows(emb)

    def s(edges):
        e = _ids(edges, emb.device)
        a, b = emb[e[:, 0]], emb[e[:, 1]]
        if score == "hadamard-l2":
            return -torch.linalg.vector_norm(a - b, dim=1)
        return (a * b).sum(1)

    return _rank_auc(s(pos_edges), s(neg_edges))


def link_prediction_auc_trained(embeddings, train_edges, test_pos, test_neg,
                                num_nodes: int, seed: int = 0,
                                iters: int = 300, lr: float = 0.5,
                                l2: float = 1e-4) -> float:
    """The node2vec paper's protocol (Grover & Leskovec 2016 §4.3): Hadamard
    edge features of unit rows, a logistic classifier trained by full-batch
    gradient descent on the training edges against as many sampled
    non-edges, AUC on the held-out positives against the negatives."""
    rng = np.random.default_rng(seed)
    emb = _unit_rows(_f64(embeddings))
    dev = emb.device
    train_edges = np.asarray(train_edges)
    known = np.concatenate([train_edges, np.asarray(test_pos)])
    train_neg = sample_negative_edges(num_nodes, known, len(train_edges),
                                      seed=seed + 17)

    def feats(edges):
        e = _ids(edges, dev)
        return emb[e[:, 0]] * emb[e[:, 1]]

    x = torch.cat([feats(train_edges), feats(train_neg)])
    y = torch.cat([torch.ones(len(train_edges), dtype=torch.float64),
                   torch.zeros(len(train_neg), dtype=torch.float64)]).to(dev)
    perm = torch.as_tensor(rng.permutation(len(x)), device=dev)
    x, y = x[perm], y[perm]
    w = torch.zeros(x.shape[1], dtype=torch.float64, device=dev)
    b = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(iters):
        p = 1.0 / (1.0 + torch.exp(-(x @ w + b)))
        g = (p - y) / len(x)
        w -= lr * (x.T @ g + l2 * w)
        b -= lr * g.sum()
    return _rank_auc(feats(test_pos) @ w, feats(test_neg) @ w)


def sbm_oracle_auc(labels, test_pos, test_neg) -> float:
    """The information ceiling of link prediction on a stochastic block
    model: the same-block indicator as the score, ties counted half."""
    y = torch.as_tensor(np.asarray(labels))

    def same(edges):
        e = _ids(edges, y.device)
        return (y[e[:, 0]] == y[e[:, 1]]).to(torch.float64)

    sp, sn = same(test_pos), same(test_neg)
    wins = (sp[:, None] > sn[None, :]).sum(dtype=torch.float64)
    ties = (sp[:, None] == sn[None, :]).sum(dtype=torch.float64)
    return float((wins + 0.5 * ties) / (len(sp) * len(sn)))


def sample_negative_edges(num_nodes: int, pos_edges, k: int,
                          seed: int = 0) -> np.ndarray:
    """k (u, v) pairs not present in pos_edges (and u != v), drawn on the
    host as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    present = {(int(a), int(b)) for a, b in np.asarray(pos_edges)}
    out = []
    while len(out) < k:
        u = int(rng.integers(0, num_nodes))
        v = int(rng.integers(0, num_nodes))
        if u != v and (u, v) not in present:
            out.append((u, v))
    return np.asarray(out, np.int64)


def node_classification_accuracy(embeddings, labels, train_frac: float = 0.5,
                                 seed: int = 0, l2: float = 1e-3,
                                 iters: int = 200, lr: float = 0.5) -> float:
    """Multinomial logistic regression on frozen unit rows (the
    DeepWalk/node2vec protocol), full-batch gradient descent; returns the
    test accuracy."""
    rng = np.random.default_rng(seed)
    emb = _unit_rows(_f64(embeddings))
    dev = emb.device
    y = np.asarray(labels)
    n = emb.shape[0]
    perm = rng.permutation(n)
    n_train = int(train_frac * n)
    tr = torch.as_tensor(perm[:n_train], device=dev)
    te = torch.as_tensor(perm[n_train:], device=dev)
    classes = np.unique(y)
    k = classes.shape[0]
    y_idx = torch.as_tensor(np.searchsorted(classes, y), device=dev)
    w = torch.zeros((emb.shape[1], k), dtype=torch.float64, device=dev)
    b = torch.zeros(k, dtype=torch.float64, device=dev)
    onehot = torch.eye(k, dtype=torch.float64, device=dev)[y_idx[tr]]
    x = emb[tr]
    for _ in range(iters):
        logits = x @ w + b
        logits -= logits.max(dim=1, keepdim=True).values
        p = torch.exp(logits)
        p /= p.sum(dim=1, keepdim=True)
        g = (p - onehot) / len(tr)
        w -= lr * (x.T @ g + l2 * w)
        b -= lr * g.sum(dim=0)
    pred = (emb[te] @ w + b).argmax(dim=1)
    return float((pred == y_idx[te]).to(torch.float64).mean())


# Candidate scores a chunk of test triples at a time: chunk x N float64.
RANKING_CHUNK_BYTES = 1 << 30


def kg_tail_ranking_metrics(ent_emb, rel_emb, test_triples,
                            score: str = "transe",
                            hits=(1, 10), filter_triples=None) -> dict:
    """Tail ranking for KG embeddings: each (h, r, t) ranks every entity as
    candidate tail by s(h, r, .) ('transe' -||e_h + w_r - e||, 'distmult'
    <e_h, w_r, e>, 'rotate' -||e_h o e^{i theta_r} - e||); returns {"mrr":
    ..., "hits@k": ...}.  Raw ranks by default; ``filter_triples`` (the full
    (E, 3) triples) excludes the other known tails of each (h, r).  A rank is
    1 + the candidates scoring strictly higher + half the ties (LibKGE's
    convention).  The candidates' scores run a chunk of test triples at a
    time on the tables' device; the mean and hits are taken in numpy from
    the ranks, as the JAX package takes them."""
    ent = _f64(ent_emb)
    dev = ent.device
    rel = _f64(rel_emb, dev)
    test = np.asarray(test_triples).reshape(-1, 3)
    if test.shape[0] == 0:
        raise ValueError("empty test_triples")
    if score not in ("transe", "distmult", "rotate"):
        raise ValueError(f"unknown score {score!r}")
    known: dict = {}
    if filter_triples is not None:
        for h, r, t in np.asarray(filter_triples):
            known.setdefault((int(h), int(r)), []).append(int(t))
    num = ent.shape[0]
    chunk = max(1, RANKING_CHUNK_BYTES // (8 * num))
    ranks = []
    for c0 in range(0, test.shape[0], chunk):
        part = test[c0: c0 + chunk].astype(np.int64)
        h, r, t = (torch.as_tensor(part[:, i], device=dev) for i in range(3))
        if score == "distmult":
            s = (ent[h] * rel[r]) @ ent.T
        else:
            if score == "transe":
                query = ent[h] + rel[r]
            else:
                half = ent.shape[1] // 2
                re_h, im_h = ent[h, :half], ent[h, half:]
                cos, sin = torch.cos(rel[r]), torch.sin(rel[r])
                query = torch.cat([re_h * cos - im_h * sin,
                                   re_h * sin + im_h * cos], 1)
            s = -torch.cdist(query, ent,
                             compute_mode="donot_use_mm_for_euclid_dist")
        rows = torch.arange(len(part), device=dev)
        true_t = s[rows, t]
        if known:
            hit_rows, hit_cols = [], []
            for i, (hh, rr, _) in enumerate(part):
                cols = known.get((int(hh), int(rr)), [])
                hit_rows += [i] * len(cols)
                hit_cols += cols
            if hit_rows:
                s[torch.as_tensor(hit_rows, device=dev),
                  torch.as_tensor(hit_cols, device=dev)] = -torch.inf
            s[rows, t] = true_t  # never filter the target
        greater = (s > true_t[:, None]).sum(1)
        ties = (s == true_t[:, None]).sum(1) - 1
        ranks.append(1 + greater.to(torch.float64) + ties / 2.0)
    ranks = torch.cat(ranks).cpu().numpy()
    out = {"mrr": float((1.0 / ranks).mean())}
    for k in hits:
        out[f"hits@{k}"] = float((ranks <= k).mean())
    return out
