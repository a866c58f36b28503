"""The port's evaluations (``models/eval.py``) against the JAX package's on
the same numpy inputs, tables given as numpy arrays and as CPU tensors.

Tolerances: AUCs, the trained readouts' AUC and the accuracy within 1e-9
(float64 on both sides; the sums' order differs); the sampled edges, MRR and
Hits@k exactly (integer ranks from the same comparisons, their mean taken in
numpy on both sides), raw and filtered, also where every score ties.
"""

import numpy as np
import pytest
import torch

from torch_random_walk_tpu.models import eval as jeval
from torch_random_walk_tpu_torch.models import eval as teval

N, D = 60, 8


def embeddings(seed, n=N, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def edges(seed, k, n=N, avoid=()):
    """Up to k distinct pairs u < v, none of ``avoid``: no two edges score
    alike, so that no tie is left to the two sorts' orders (numpy's
    quicksort and torch's stable sort order ties apart)."""
    rng = np.random.default_rng(seed)
    e = np.sort(rng.integers(0, n, (k, 2)), axis=1)
    e = np.unique(e[e[:, 0] != e[:, 1]], axis=0)
    taken = {tuple(x) for x in np.asarray(avoid).reshape(-1, 2)}
    return rng.permutation(np.asarray([x for x in e if tuple(x) not in taken]))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("score", ["dot", "cosine", "hadamard-l2"])
def test_link_prediction_auc_equals_jax(score, as_tensor):
    emb = embeddings(1)
    pos = edges(2, 50)
    neg = edges(3, 70, avoid=pos)
    got = teval.link_prediction_auc(torch.tensor(emb) if as_tensor else emb,
                                    pos, neg, score=score)
    assert isinstance(got, float)
    assert abs(got - jeval.link_prediction_auc(emb, pos, neg,
                                               score=score)) <= 1e-9


@pytest.mark.parametrize("seed", [0, 4])
def test_link_prediction_auc_trained_equals_jax(seed):
    emb = embeddings(5 + seed)
    train = edges(6 + seed, 80)
    test_pos = edges(7 + seed, 20, avoid=train)
    test_neg = jeval.sample_negative_edges(N, np.concatenate([train,
                                                              test_pos]),
                                           len(test_pos), seed=9)
    want = jeval.link_prediction_auc_trained(emb, train, test_pos, test_neg,
                                             N, seed=seed, iters=120)
    got = teval.link_prediction_auc_trained(torch.tensor(emb), train,
                                            test_pos, test_neg, N, seed=seed,
                                            iters=120)
    assert abs(got - want) <= 1e-9


def test_sbm_oracle_auc_equals_jax():
    labels = np.random.default_rng(2).integers(0, 4, N)
    pos, neg = edges(8, 90), edges(9, 90)
    assert abs(teval.sbm_oracle_auc(labels, pos, neg)
               - jeval.sbm_oracle_auc(labels, pos, neg)) <= 1e-9


@pytest.mark.parametrize("seed", [0, 17])
def test_sample_negative_edges_equals_jax(seed):
    present = edges(10, 300)
    got = teval.sample_negative_edges(N, present, 40, seed=seed)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, jeval.sample_negative_edges(N, present, 40, seed=seed))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_node_classification_accuracy_equals_jax(as_tensor):
    labels = np.random.default_rng(3).integers(0, 3, N)
    emb = embeddings(4) + labels[:, None].astype(np.float32)
    want = jeval.node_classification_accuracy(emb, labels, seed=1, iters=80)
    got = teval.node_classification_accuracy(
        torch.tensor(emb) if as_tensor else emb, labels, seed=1, iters=80)
    assert abs(got - want) <= 1e-9


def kg_case(score, seed):
    rng = np.random.default_rng(seed)
    ne, nr, d = 40, 3, 6
    ent = rng.normal(size=(ne, d))
    rel = (rng.uniform(-np.pi, np.pi, (nr, d // 2)) if score == "rotate"
           else rng.normal(size=(nr, d)))
    triples = np.stack([rng.integers(0, ne, 120), rng.integers(0, nr, 120),
                        rng.integers(0, ne, 120)], 1)
    return ent, rel, triples


@pytest.mark.parametrize("filtered", [False, True], ids=["raw", "filtered"])
@pytest.mark.parametrize("score", ["transe", "distmult", "rotate"])
def test_kg_tail_ranking_metrics_equal_jax(score, filtered):
    ent, rel, triples = kg_case(score, seed=len(score))
    test = triples[:30]
    kw = dict(score=score, hits=(1, 3, 10),
              filter_triples=triples if filtered else None)
    want = jeval.kg_tail_ranking_metrics(ent, rel, test, **kw)
    got = teval.kg_tail_ranking_metrics(torch.tensor(ent), torch.tensor(rel),
                                        test, **kw)
    assert got == want


def test_kg_tail_ranking_ties_and_filter_cases_equal_jax():
    """The JAX tests' cases: every score tied (a collapsed model ranks
    (N + 1) / 2, not 1), and a line graph every test tail of which ranks
    first once the known tails are filtered; and an unknown score."""
    n = 10
    ent, rel = np.ones((n, 4)), np.zeros((1, 4))
    triples = np.asarray([(0, 0, 1), (1, 0, 2)])
    for score in ("transe", "distmult"):
        want = jeval.kg_tail_ranking_metrics(ent, rel, triples, score=score)
        assert teval.kg_tail_ranking_metrics(ent, rel, triples,
                                             score=score) == want
    want = jeval.kg_tail_ranking_metrics(ent, rel, triples, score="transe")
    np.testing.assert_allclose(want["mrr"], 1.0 / (1 + (n - 1) / 2.0))
    line = np.arange(12, dtype=np.float64)[:, None]
    chain = np.asarray([(i, 0, i + 1) for i in range(11)])
    got = teval.kg_tail_ranking_metrics(line, np.asarray([[1.0]]), chain,
                                        filter_triples=chain)
    assert got == jeval.kg_tail_ranking_metrics(
        line, np.asarray([[1.0]]), chain, filter_triples=chain)
    assert got["mrr"] == 1.0
    with pytest.raises(ValueError, match="unknown score"):
        teval.kg_tail_ranking_metrics(ent, rel, triples, score="complex")
    with pytest.raises(ValueError, match="empty"):
        teval.kg_tail_ranking_metrics(ent, rel, np.zeros((0, 3), np.int64))


def test_kg_tail_ranking_in_chunks_equals_one_chunk(monkeypatch):
    """The candidate scores taken a few test triples at a time give the
    same ranks as all at once."""
    ent, rel, triples = kg_case("transe", seed=8)
    want = teval.kg_tail_ranking_metrics(ent, rel, triples[:25],
                                         filter_triples=triples)
    monkeypatch.setattr(teval, "RANKING_CHUNK_BYTES", 8 * 40 * 3)
    assert teval.kg_tail_ranking_metrics(ent, rel, triples[:25],
                                         filter_triples=triples) == want
