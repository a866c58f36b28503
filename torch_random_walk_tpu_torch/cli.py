"""Command-line entry points of the port: sampling and training (PyTorch
twin of ``torch_random_walk_tpu/cli.py``).

    trw-torch-walk GRAPH [-o walks.npy] [--walkers B] [-p P -q Q] ...
    trw-torch-train GRAPH [-o embeddings.npy] [--checkpoint-dir D] ...
    trw-torch-train-kg TRIPLES [-o kg_embeddings.npz] [--eval-holdout F] ...
    python -m torch_random_walk_tpu_torch.cli walk|train|train-kg ARGS

Flags, defaults, output files, metrics lines and log lines are the JAX
CLI's, plus ``--device``: by default the CUDA card, and the commands raise
where there is none; ``--device cpu`` runs the kernels' plain versions on the
CPU.  A graph is a ``.npz`` with ``src``/``dst`` arrays or
``synth:<nodes>:<avg_degree>[:seed]``; triples are a ``.npz`` with
``head``/``rel``/``tail`` arrays or ``grid:<side>[:seed]``.  The synthetic
edges are drawn on the host with the JAX CLI's numpy calls, so they are the
same graph, and every graph is built on the device.  The trainers run
through ``utils.elastic.run_resumable`` with the whole model (tables and
optimizer state) as the state: ``--checkpoint-dir`` saves every
``--checkpoint-every`` epochs and at the end, and a rerun into the same
directory resumes after the last saved epoch (``utils/checkpoint.py`` gives
the layout).  The JAX CLI's ``trw-bench`` is not ported.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.graph.datasets import grid_kg_triples
from torch_random_walk_tpu_torch.graph.triples import TriplesGraph
from torch_random_walk_tpu_torch.models.eval import kg_tail_ranking_metrics
from torch_random_walk_tpu_torch.models.kge import (
    OBJECTIVES,
    PAIR_OBJECTIVES,
    KGEmbedding,
    KGEmbeddingConfig,
)
from torch_random_walk_tpu_torch.models.node2vec import Node2Vec, Node2VecConfig
from torch_random_walk_tpu_torch.ops.walk import walk
from torch_random_walk_tpu_torch.utils.device import resolve_device
from torch_random_walk_tpu_torch.utils.elastic import (
    ElasticConfig,
    run_resumable,
)
from torch_random_walk_tpu_torch.utils.logging import MetricsWriter, get_logger

_DEVICE_HELP = ("torch device (default: the CUDA card, and the command fails "
                "without one; 'cpu' runs the plain versions on the CPU)")


def _load_graph(spec: str, device=None):
    """'path.npz' | 'synth:<nodes>:<avg_degree>[:seed]'"""
    if spec.startswith("synth:"):
        parts = spec.split(":")
        n, deg = int(parts[1]), int(parts[2])
        seed = int(parts[3]) if len(parts) > 3 else 0
        rng = np.random.default_rng(seed)
        e = n * deg
        src = np.concatenate([np.arange(n), rng.integers(0, n, e)])
        dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, e)])
        return CSRGraph.from_edges(src, dst, num_nodes=n, symmetrize=True,
                                   device=device)
    with np.load(spec) as data:
        return CSRGraph.from_edges(data["src"], data["dst"], device=device)


def _load_triples(spec: str) -> np.ndarray:
    """'path.npz' (head/rel/tail) | 'grid:<side>[:seed]' -> (E, 3) numpy."""
    if spec.startswith("grid:"):
        parts = spec.split(":")
        seed = int(parts[2]) if len(parts) > 2 else 0
        return grid_kg_triples(int(parts[1]), seed=seed)[0]
    with np.load(spec) as data:
        return np.stack([data["head"], data["rel"], data["tail"]], axis=1)


def _add_elastic_flags(ap) -> None:
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--heartbeat", default="",
                    help="liveness file for an external watchdog")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="restore-and-replay retries on device faults")
    ap.add_argument("--metrics", default="", help="JSONL metrics path")


def _run_epochs(args, model, epoch_step, log, scratch_prefix: str):
    """``args.epochs`` epochs of ``epoch_step(epoch) -> loss`` through
    ``run_resumable`` with ``model`` as the state, one metrics line an epoch.
    Without ``--checkpoint-dir`` no periodic checkpoint is written (a user
    who asked for none should not pay multi-GB table dumps), unless
    ``--max-retries`` needs restore points: a scratch directory still takes
    a SIGTERM's checkpoint, and is removed after a run that ends."""
    metrics = MetricsWriter(args.metrics or None)

    def step_fn(state, epoch):
        loss = float(epoch_step(epoch))
        metrics.emit(epoch=epoch, loss=loss)
        if epoch % 10 == 0:
            log.info("epoch %d loss %.4f", epoch, loss)
        return state

    scratch = None if args.checkpoint_dir else tempfile.mkdtemp(
        prefix=scratch_prefix)
    periodic = bool(args.checkpoint_dir) or args.max_retries > 0
    result = run_resumable(
        step_fn, model, args.epochs,
        ElasticConfig(ckpt_dir=args.checkpoint_dir or scratch,
                      every_steps=(args.checkpoint_every if periodic
                                   else args.epochs + 1),
                      heartbeat_path=args.heartbeat or None,
                      max_retries=args.max_retries,
                      save_final=bool(args.checkpoint_dir)))
    metrics.close()
    if result.preempted:
        log.warning("preempted at epoch %d (checkpointed to %s; rerun with "
                    "--checkpoint-dir to resume)", result.steps_done,
                    args.checkpoint_dir or scratch)
    elif scratch is not None:
        shutil.rmtree(scratch, ignore_errors=True)
    return result


def walk_main(argv=None):
    """Sample walks and save them to .npy."""
    ap = argparse.ArgumentParser(prog="trw-torch-walk")
    ap.add_argument("graph", help=".npz with src/dst arrays, or synth:N:deg")
    ap.add_argument("-o", "--out", default="walks.npy")
    ap.add_argument("--walkers", type=int, default=0, help="0 = one per node")
    ap.add_argument("--walk-length", type=int, default=80)
    ap.add_argument("-p", type=float, default=1.0)
    ap.add_argument("-q", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    log = get_logger("trw-torch-walk")
    g = _load_graph(args.graph, dev)
    b = args.walkers or g.num_nodes
    targets = torch.arange(b, dtype=torch.int32, device=dev) % g.num_nodes
    t0 = time.perf_counter()
    walks = walk(g, target_nodes=targets, p=args.p, q=args.q,
                 walk_length=args.walk_length, seed=args.seed, device=dev)
    out = walks.cpu().numpy()
    dt = time.perf_counter() - t0
    np.save(args.out, out)
    log.info("sampled %s walks of length %d in %.2fs (%.1fM node-steps/s) "
             "-> %s", out.shape[0], args.walk_length, dt,
             out.shape[0] * args.walk_length / dt / 1e6, args.out)


def train_main(argv=None):
    """Train node2vec embeddings end-to-end; save embeddings to .npy."""
    ap = argparse.ArgumentParser(prog="trw-torch-train")
    ap.add_argument("graph", help=".npz with src/dst arrays, or synth:N:deg")
    ap.add_argument("-o", "--out", default="embeddings.npy")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--walk-length", type=int, default=40)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("-p", type=float, default=1.0)
    ap.add_argument("-q", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    _add_elastic_flags(ap)
    ap.add_argument("--update-mode", default="dense",
                    choices=["dense", "sparse"],
                    help="sparse = touched-rows lazy Adam (optimizer "
                         "traffic scales with the batch, not the vocab)")
    ap.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    log = get_logger("trw-torch-train")
    g = _load_graph(args.graph, dev)
    cfg = Node2VecConfig(dim=args.dim, walk_length=args.walk_length,
                         window_size=args.window, p=args.p, q=args.q,
                         learning_rate=args.lr, seed=args.seed,
                         update_mode=args.update_mode)
    n2v = Node2Vec(g, cfg, device=dev)
    targets = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
    _run_epochs(args, n2v.init(), lambda e: n2v.epoch_step(targets, e), log,
                "trw_torch_train_")
    emb = n2v.embeddings().cpu().numpy()
    np.save(args.out, emb)
    log.info("saved %s embeddings -> %s", emb.shape, args.out)


def kg_train_main(argv=None):
    """Train KG embeddings over triples walks (models/kge.py)."""
    ap = argparse.ArgumentParser(prog="trw-torch-train-kg")
    ap.add_argument("triples", help=".npz with head/rel/tail arrays, or "
                                    "grid:<side>[:seed] synthetic")
    ap.add_argument("-o", "--out", default="kg_embeddings.npz",
                    help="output .npz with entities/relations arrays")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--walk-length", type=int, default=20)
    ap.add_argument("--window", type=int, default=3,
                    help="context window (skipgram/cbow objectives)")
    ap.add_argument("--objective", default="transe", choices=OBJECTIVES)
    ap.add_argument("--negatives", type=int, default=8,
                    help="corrupted negatives per positive "
                         "(pair objectives)")
    ap.add_argument("--margin", type=float, default=2.0)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    _add_elastic_flags(ap)
    ap.add_argument("--eval-holdout", type=float, default=0.0,
                    help=">0 holds out this fraction of triples and prints "
                         "filtered tail-ranking MRR/Hits@10 after training "
                         "(pair objectives only)")
    ap.add_argument("--update-mode", default="dense",
                    choices=["dense", "sparse"],
                    help="sparse = touched-rows lazy Adam (optimizer "
                         "traffic scales with the batch, not the entity "
                         "vocabulary; pair objectives only)")
    ap.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    log = get_logger("trw-torch-train-kg")
    triples = _load_triples(args.triples)
    test = None
    if args.eval_holdout > 0:
        if args.objective not in PAIR_OBJECTIVES:
            ap.error("--eval-holdout needs a triple-scoring objective "
                     "(transe, distmult or rotate); the co-occurrence "
                     "objectives have no tail-ranking score")
        rng = np.random.default_rng(args.seed)
        perm = rng.permutation(triples.shape[0])
        k = int(args.eval_holdout * triples.shape[0])
        if k < 1:
            ap.error(f"--eval-holdout {args.eval_holdout} of "
                     f"{triples.shape[0]} triples holds out 0 — raise the "
                     "fraction")
        test, train_triples = triples[perm[:k]], triples[perm[k:]]
    else:
        train_triples = triples
    # Id spaces sized from the FULL triples array: entities and relations
    # that occur only in the held-out split still get table rows.
    graph = TriplesGraph.from_arrays(
        train_triples,
        num_entities=int(max(triples[:, 0].max(), triples[:, 2].max())) + 1,
        num_relations=int(triples[:, 1].max()) + 1, device=dev)
    cfg = KGEmbeddingConfig(dim=args.dim, walk_length=args.walk_length,
                            window_size=args.window,
                            objective=args.objective,
                            num_negatives=args.negatives, margin=args.margin,
                            learning_rate=args.lr, seed=args.seed,
                            update_mode=args.update_mode)
    kge = KGEmbedding(graph, cfg, device=dev)
    targets = torch.arange(graph.num_entities, dtype=torch.int32, device=dev)
    result = _run_epochs(args, kge.init(),
                         lambda e: kge.epoch_step(targets, e), log,
                         "trw_torch_train_kg_")
    model = result.state
    ent = model.entity_embeddings()
    rel = model.relation_embeddings()
    np.savez(args.out, entities=ent.cpu().numpy(),
             relations=rel.cpu().numpy())
    log.info("saved %s entity + %s relation embeddings -> %s",
             tuple(ent.shape), tuple(rel.shape), args.out)
    if test is not None:
        m = kg_tail_ranking_metrics(ent, rel, test, score=args.objective,
                                    filter_triples=triples)
        print(json.dumps({"filtered_" + k: round(v, 4)
                          for k, v in m.items()}))


COMMANDS = {"walk": walk_main, "train": train_main, "train-kg": kg_train_main}


def main(argv=None):
    """``python -m torch_random_walk_tpu_torch.cli walk|train|train-kg
    ARGS``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit("usage: python -m torch_random_walk_tpu_torch.cli "
                         f"{{{'|'.join(COMMANDS)}}} ARGS")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
