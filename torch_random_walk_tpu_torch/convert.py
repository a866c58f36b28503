"""State carried across from the JAX package.

The JAX package's ``CSRGraph``, ``EdgeListGraph``, ``TriplesGraph`` and
``PartitionedCSR`` fields and the routed node2vec engine's per-shard cuckoo
tables and Bloom filters, handed over as
numpy arrays (``numpy.asarray(graph.row_ptr)`` and so on; this module imports
neither JAX nor the JAX package), become the port's objects with the same
``max_degree``, ``search_iters`` and ``deg_bits``, so that walks over a
converted graph equal walks over the original.  The SGNS, CBOW and KGE tables,
optax's Adam state and the touched-rows steps' state cross as float32 numpy
arrays, keyed as the JAX params are
(``np.asarray(x.astype(jnp.float32))`` is exact for bfloat16 tables); the port
casts them to its tables' or moments' type, which is exact on the way back
too.  ``checkpoint_from_numpy`` writes a JAX trainer's initial tables as a
port checkpoint at step 0, from which ``utils.elastic.run_resumable`` starts.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.graph.edge_list import EdgeListGraph
from torch_random_walk_tpu_torch.graph.triples import TriplesGraph
from torch_random_walk_tpu_torch.models.cbow import CBOWModel
from torch_random_walk_tpu_torch.models.kge import KGEModel
from torch_random_walk_tpu_torch.models.skipgram import SkipGramModel
from torch_random_walk_tpu_torch.parallel.partition import PartitionedCSR
from torch_random_walk_tpu_torch.utils import checkpoint
from torch_random_walk_tpu_torch.utils.device import resolve_device


def csr_from_numpy(row_ptr, col_idx, build_fat: bool = True,
                   device=None) -> CSRGraph:
    """(num_nodes + 1,) row offsets and (num_edges,) neighbour ids, rows
    already sorted (every JAX ``CSRGraph`` constructor guarantees it).
    ``build_fat`` as the JAX graph was built (``graph.edge_tab is not
    None`` for a graph at hand)."""
    return CSRGraph.from_arrays(np.asarray(row_ptr), np.asarray(col_idx),
                                sort_rows=False, build_fat=build_fat,
                                device=device)


def edge_list_from_numpy(edge_list, num_nodes: int,
                         device=None) -> EdgeListGraph:
    """(E, 2) [head, tail] edges and the node count of a JAX
    ``EdgeListGraph`` (``graph.edge_list``, ``graph.num_nodes``)."""
    return EdgeListGraph.from_arrays(np.asarray(edge_list),
                                     num_nodes=int(num_nodes), device=device)


def triples_from_numpy(triples, num_entities: int, num_relations: int,
                       device=None) -> TriplesGraph:
    """(E, 3) [head, relation, tail] triples and the id-space sizes of a JAX
    ``TriplesGraph`` (``graph.triples``, ``graph.num_entities``,
    ``graph.num_relations``)."""
    return TriplesGraph.from_arrays(np.asarray(triples),
                                    num_entities=int(num_entities),
                                    num_relations=int(num_relations),
                                    device=device)


def partitioned_from_numpy(node_meta, col, num_nodes: int, num_shards: int,
                           shard_nodes: int, device=None) -> PartitionedCSR:
    """Stacked (D, S, 2) ``node_meta_shards`` and (D, E_max) ``col_shards``
    of a JAX ``PartitionedCSR`` -> one separately allocated tensor pair per
    shard."""
    dev = resolve_device(device)
    node_meta = np.asarray(node_meta)
    col = np.asarray(col)
    if node_meta.shape != (num_shards, shard_nodes, 2):
        raise ValueError(f"node_meta must be ({num_shards}, {shard_nodes}, 2)"
                         f", got {node_meta.shape}")
    if col.ndim != 2 or col.shape[0] != num_shards:
        raise ValueError(f"col must be ({num_shards}, E_max), got {col.shape}")

    def shard(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)  # copies

    return PartitionedCSR(
        node_meta=tuple(shard(node_meta[d]) for d in range(num_shards)),
        col=tuple(shard(col[d]) for d in range(num_shards)),
        num_nodes=int(num_nodes), num_shards=int(num_shards),
        shard_nodes=int(shard_nodes))


def _uint32_bits(x, device) -> torch.Tensor:
    """uint32 array -> int32 tensor of the same bits (a copy)."""
    return torch.tensor(np.asarray(x, np.uint32).view(np.int32), device=device)


def partition_hashes_from_numpy(tables, salts, log_size: int, device=None):
    """The (tables (D, S_h, 2) uint32, salts (D,) uint32, log_size) of the
    JAX package's ``build_partition_hashes`` -> the port's
    ``build_partition_hashes`` triple, so that a port walk probes exactly
    the JAX tables."""
    dev = resolve_device(device)
    tables, salts = np.asarray(tables), np.asarray(salts)
    if tables.ndim != 3 or tables.shape[2] != 2 or tables.shape[1] != (
            1 << int(log_size)) or salts.shape != tables.shape[:1]:
        raise ValueError(f"tables must be (D, 2^{log_size}, 2) and salts "
                         f"(D,), got {tables.shape} and {salts.shape}")
    return _uint32_bits(tables, dev), _uint32_bits(salts, dev), int(log_size)


def partition_blooms_from_numpy(blooms, device=None) -> torch.Tensor:
    """The (D, S, 4) uint32 filters of the JAX package's
    ``build_partition_blooms`` -> the port's (D, S, 4) int32 bit patterns."""
    blooms = np.asarray(blooms)
    if blooms.ndim != 3 or blooms.shape[2] != 4:
        raise ValueError(f"blooms must be (D, S, 4), got {blooms.shape}")
    return _uint32_bits(blooms, resolve_device(device))


def _table(x, like: torch.Tensor) -> torch.Tensor:
    x = np.asarray(x, dtype=np.float32)
    if x.shape != tuple(like.shape):
        raise ValueError(f"expected shape {tuple(like.shape)}, got {x.shape}")
    return torch.tensor(x, device=like.device).to(like.dtype)


def _load_tables(model, in_emb, out_emb):
    with torch.no_grad():
        model.in_emb.copy_(_table(in_emb, model.in_emb))
        model.out_emb.copy_(_table(out_emb, model.out_emb))
    return model


def _shape(in_emb) -> tuple[int, int]:
    in_emb = np.asarray(in_emb)
    if in_emb.ndim != 2:
        raise ValueError(f"in_emb must be (N, D), got {in_emb.shape}")
    return in_emb.shape


def skipgram_from_numpy(in_emb, out_emb, dtype="float32", learning_rate=None,
                        optimizer=None, device=None) -> SkipGramModel:
    """(N, D) float32 tables -> a ``SkipGramModel`` in ``dtype`` holding them,
    with zero optimizer state (``optimizer``: a custom factory, as
    ``SkipGramModel`` takes it)."""
    model = SkipGramModel(*_shape(in_emb), optimizer=optimizer, dtype=dtype,
                          learning_rate=learning_rate, device=device)
    return _load_tables(model, in_emb, out_emb)


def cbow_from_numpy(in_emb, out_emb, optimizer=None,
                    device=None) -> CBOWModel:
    """(N, D) float32 tables of a JAX ``CBOWModel`` -> a ``CBOWModel``
    holding them, with zero optimizer state."""
    model = CBOWModel(*_shape(in_emb), optimizer=optimizer, device=device)
    return _load_tables(model, in_emb, out_emb)


def cbow_to_numpy(model: CBOWModel) -> dict:
    """The CBOW tables as float32 numpy arrays, keyed as the JAX params
    are."""
    return skipgram_to_numpy(model)


def kge_from_numpy(params: dict, objective: str = "transe",
                   margin: float = 2.0, dtype="float32",
                   learning_rate: float = 1e-2, optimizer=None,
                   device=None) -> KGEModel:
    """The params of a JAX ``KGEModel`` as float32 arrays ({"ent", "rel"} or
    {"ent_in", "rel_in", "ent_out", "rel_out"}) -> a ``KGEModel`` in
    ``dtype`` holding them, with zero optimizer state; the entity and
    relation counts and the dim from the shapes."""
    ent = np.asarray(params["ent" if "ent" in params else "ent_in"])
    rel = np.asarray(params["rel" if "rel" in params else "rel_in"])
    if ent.ndim != 2 or rel.ndim != 2:
        raise ValueError(f"ent and rel must be 2-d, got {ent.shape} and "
                         f"{rel.shape}")
    model = KGEModel(ent.shape[0], rel.shape[0], dim=ent.shape[1],
                     objective=objective, margin=margin, optimizer=optimizer,
                     learning_rate=learning_rate, dtype=dtype, device=device)
    if set(params) != {n for n, _ in model.named_parameters()}:
        raise ValueError(f"objective {objective!r} takes the tables "
                         f"{sorted(n for n, _ in model.named_parameters())}, "
                         f"got {sorted(params)}")
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(_table(params[name], param))
    return model


def kge_to_numpy(model: KGEModel) -> dict:
    """The KGE tables as float32 numpy arrays, keyed as the JAX params
    are."""
    return skipgram_to_numpy(model)


def adam_state_from_numpy(model, mu: dict, nu: dict, count: int) -> None:
    """optax's ``ScaleByAdamState`` (``mu`` and ``nu`` as dicts of float32
    arrays keyed by table name, "in_emb"/"out_emb" or a KGE model's, and the
    step count) into ``model`` (a ``SkipGramModel``, ``CBOWModel`` or
    ``KGEModel``), in its moments' type."""
    for name, _ in model.named_parameters():
        model.mu[name] = _table(mu[name], model.mu[name])
        model.nu[name] = _table(nu[name], model.nu[name])
    model.count = int(count)


def skipgram_to_numpy(model) -> dict:
    """The tables as float32 numpy arrays, keyed as the JAX params are."""
    return {name: p.detach().float().cpu().numpy()
            for name, p in model.named_parameters()}


def adam_state_to_numpy(model):
    """(mu, nu, count) of ``model`` as float32 numpy arrays."""
    mu = {k: v.float().cpu().numpy() for k, v in model.mu.items()}
    nu = {k: v.float().cpu().numpy() for k, v in model.nu.items()}
    return mu, nu, model.count


def sparse_state_from_numpy(model, state: dict) -> None:
    """The JAX touched-rows state (``init_sparse_opt_state`` /
    ``walk_train_step_sparse`` / ``pair_train_step_sparse``: ``{"mu": {...},
    "nu": {...}, "count": c}``, moments as float32 arrays keyed by table
    name) into ``model``: float32 moments whatever the tables' type."""
    for key in ("mu", "nu"):
        moments = {}
        for name, param in model.named_parameters():
            x = np.asarray(state[key][name], dtype=np.float32)
            if x.shape != tuple(param.shape):
                raise ValueError(f"expected shape {tuple(param.shape)}, got "
                                 f"{x.shape}")
            moments[name] = torch.tensor(x, device=param.device)
        setattr(model, key, moments)
    model.count = int(state["count"])
    model.sparse_state = True


def sparse_state_to_numpy(model) -> dict:
    """``model``'s touched-rows state in the JAX layout: {"mu": {...}, "nu":
    {...}, "count": c}, the moments as float32 numpy arrays."""
    return {"mu": {k: v.float().cpu().numpy() for k, v in model.mu.items()},
            "nu": {k: v.float().cpu().numpy() for k, v in model.nu.items()},
            "count": model.count}


def checkpoint_from_numpy(ckpt_dir: str, model, params: dict):
    """Load a JAX trainer's initial tables into ``model`` (a
    ``SkipGramModel``, ``CBOWModel`` or ``KGEModel``, e.g. a port trainer's
    ``.model``) and save it as a checkpoint at step 0 in ``ckpt_dir``, so
    that ``run_resumable`` over the port's trainer starts from the tables
    the JAX trainer starts from.  ``params``: the tables as float32 arrays
    keyed by table name.  The model's optimizer state is saved as it
    stands.  Returns ``model``."""
    names = {n for n, _ in model.named_parameters()}
    if set(params) != names:
        raise ValueError(f"the model's tables are {sorted(names)}, got "
                         f"{sorted(params)}")
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(_table(params[name], param))
    checkpoint.save(ckpt_dir, model, 0)
    return model
