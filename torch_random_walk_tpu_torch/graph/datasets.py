"""Dataset loaders and generators (PyTorch twin of
``torch_random_walk_tpu/graph/datasets.py``).

Graphs load from .npz edge files, from the files a real dataset leaves on
disk (an OGB edge cache, the Planetoid pickles), or from generators that
draw their edges on the host with the same ``numpy.random.default_rng``
calls, in the same order, as the JAX package's.  The files are read and the
numbers drawn on the host; every CSR is built on the device (``device=None``
means the card).  The on-disk caches use the JAX package's names and keys,
so a cache that one package writes loads in the other as the same graph.
There is no download: where the JAX package would fetch a dataset with the
``ogb`` package, the port raises and names the cache file it looks for.
"""

from __future__ import annotations

import os

import numpy as np

from torch_random_walk_tpu_torch.graph.csr import CSRGraph
from torch_random_walk_tpu_torch.graph.triples import TriplesGraph


def load_npz(path: str, device=None) -> CSRGraph:
    """.npz with ``src``/``dst`` int arrays (optionally ``num_nodes``)."""
    with np.load(path) as data:
        n = int(data["num_nodes"]) if "num_nodes" in data else None
        return CSRGraph.from_edges(data["src"], data["dst"], num_nodes=n,
                                   device=device)


def _atomic_savez(path: str, compressed: bool = False, **arrays) -> None:
    """Write to a temporary file, then ``os.replace``, so that an interrupted
    save never leaves a truncated .npz at the final path (a corrupt cache
    would win every later ``os.path.exists`` check).  Appends '.npz' to a
    path without it, as ``np.savez`` does."""
    if not path.endswith(".npz"):
        path += ".npz"
    # The temporary name keeps the .npz suffix: np.savez would append one
    # otherwise, and the rename's source would not exist.
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_npz(path: str, src, dst, num_nodes: int | None = None) -> None:
    arrays = {"src": np.asarray(src, np.int64),
              "dst": np.asarray(dst, np.int64)}
    if num_nodes is not None:
        arrays["num_nodes"] = np.int64(num_nodes)
    _atomic_savez(path, compressed=True, **arrays)


def _csr_from_cache(path: str, device) -> CSRGraph:
    """A CSR cache (``row_ptr``/``col_idx``, rows sorted) -> the graph."""
    with np.load(path) as data:
        return CSRGraph.from_arrays(data["row_ptr"], data["col_idx"],
                                    sort_rows=False, device=device)


def _save_csr_cache(path: str, graph: CSRGraph) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_savez(path, row_ptr=graph.row_ptr.cpu().numpy(),
                  col_idx=graph.col_idx.cpu().numpy())


def load_ogbn(name: str, root: str = "dataset", symmetrize: bool = True,
              device=None):
    """ogbn-products, ogbn-papers100M etc. from the edge cache that the JAX
    package's loader writes next to an OGB download
    (``{root}/{name}_edges.npz``, '-' read as '_', the raw directed edges,
    and ``{name}_labels.npy``).  Returns (CSRGraph, labels or None).  Without
    the cache it raises: the port downloads nothing."""
    stem = name.replace("-", "_")
    cache = os.path.join(root, f"{stem}_edges.npz")
    labels_cache = os.path.join(root, f"{stem}_labels.npy")
    if not os.path.exists(cache):
        raise ImportError(
            f"no cached edge file for {name}: provide {cache} (src/dst"
            "[/num_nodes]); the port does not download datasets")
    # The cache holds the raw directed edges: symmetrize applies on every
    # load, as it does in the JAX package.
    with np.load(cache) as data:
        g = CSRGraph.from_edges(
            data["src"], data["dst"],
            num_nodes=int(data["num_nodes"]) if "num_nodes" in data else None,
            symmetrize=symmetrize, device=device)
    labels = np.load(labels_cache) if os.path.exists(labels_cache) else None
    return g, labels


def load_planetoid(name: str, root: str = "dataset", device=None):
    """Cora/Citeseer/Pubmed (BASELINE.json config 2 graphs).

    Reads a cached ``{root}/{name}_edges.npz`` with src/dst int arrays (and
    optional ``num_nodes`` and ``labels``), or else the Planetoid pickle files
    ``ind.{name}.graph`` / ``ind.{name}.ally`` / ``ind.{name}.ty`` /
    ``ind.{name}.test.index`` as the GCN codebase distributes them.  Returns
    (CSRGraph symmetrized, labels or None).  The pickles are unpickled:
    read only files of a dataset you trust.
    """
    name = name.lower()
    cache = os.path.join(root, f"{name}_edges.npz")
    if os.path.exists(cache):
        with np.load(cache) as data:
            g = CSRGraph.from_edges(data["src"], data["dst"],
                                    num_nodes=(int(data["num_nodes"])
                                               if "num_nodes" in data
                                               else None),
                                    symmetrize=True, device=device)
            labels = data["labels"] if "labels" in data else None
        return g, labels
    graph_path = os.path.join(root, f"ind.{name}.graph")
    if not os.path.exists(graph_path):
        raise FileNotFoundError(
            f"no planetoid data for '{name}' under {root}: provide {cache} "
            f"(src/dst[/labels]) or the ind.{name}.* pickle files")
    import pickle

    with open(graph_path, "rb") as f:
        adj = pickle.load(f, encoding="latin1")  # {node: [nbrs]}
    src = np.concatenate([np.full(len(v), k, np.int64)
                          for k, v in adj.items()]) if adj else np.zeros(0)
    dst = np.concatenate([np.asarray(v, np.int64)
                          for v in adj.values()]) if adj else np.zeros(0)
    # num_nodes from the adjacency's keys too: real Citeseer has isolated
    # nodes (empty neighbour lists, some in the test split), which no edge
    # names.
    n = max(len(adj),
            int(max(adj.keys())) + 1 if adj else 0,
            int(max(src.max(), dst.max())) + 1 if src.size else 0)
    tidx = os.path.join(root, f"ind.{name}.test.index")
    test_index = (np.loadtxt(tidx, dtype=np.int64).reshape(-1)
                  if os.path.exists(tidx) else None)
    if test_index is not None and test_index.size:
        n = max(n, int(test_index.max()) + 1)
    g = CSRGraph.from_edges(src, dst, num_nodes=n, symmetrize=True,
                            device=device)
    labels = None
    ally = os.path.join(root, f"ind.{name}.ally")
    ty = os.path.join(root, f"ind.{name}.ty")
    if test_index is not None and all(os.path.exists(p) for p in (ally, ty)):
        with open(ally, "rb") as f:
            y_all = pickle.load(f, encoding="latin1")
        with open(ty, "rb") as f:
            y_test = pickle.load(f, encoding="latin1")
        labels = np.full(n, -1, np.int64)
        labels[: y_all.shape[0]] = np.asarray(y_all).argmax(1)
        order = np.sort(test_index)
        labels[order] = np.asarray(y_test)[np.argsort(test_index)].argmax(1)
    return g, labels


def synthetic_sbm(num_nodes: int, num_blocks: int, avg_degree: float,
                  assortativity: float = 0.9, seed: int = 0, device=None):
    """Stochastic-block-model graph with ground-truth communities: node2vec
    embeddings must separate the blocks (node classification) and score
    held-out edges above chance (link prediction).  Drawn with the JAX
    package's numpy calls.  Returns (CSRGraph, labels, undirected edges
    (E, 2) int64)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_blocks, num_nodes)
    target_edges = int(num_nodes * avg_degree / 2)
    n_in = int(target_edges * assortativity)
    n_out = target_edges - n_in
    # In-block edges: a block drawn in proportion to its size, two members.
    by_block = [np.where(labels == b)[0] for b in range(num_blocks)]
    sizes = np.array([len(b) for b in by_block])
    blocks = rng.choice(num_blocks, n_in, p=sizes / sizes.sum())
    src_in = np.empty(n_in, np.int64)
    dst_in = np.empty(n_in, np.int64)
    for b in range(num_blocks):
        m = blocks == b
        k = int(m.sum())
        if k and sizes[b] >= 2:
            src_in[m] = rng.choice(by_block[b], k)
            dst_in[m] = rng.choice(by_block[b], k)
        else:
            src_in[m] = rng.integers(0, num_nodes, k)
            dst_in[m] = rng.integers(0, num_nodes, k)
    src_out = rng.integers(0, num_nodes, n_out)
    dst_out = rng.integers(0, num_nodes, n_out)
    src = np.concatenate([src_in, src_out])
    dst = np.concatenate([dst_in, dst_out])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    edges = np.stack([src, dst], axis=1)
    g = CSRGraph.from_edges(src, dst, num_nodes=num_nodes, symmetrize=True,
                            device=device)
    return g, labels, edges


# Version token of the synthetic_power_law cache files, the JAX package's:
# bump both when the edge construction changes.
_POWERLAW_GEN_VERSION = "v1"
# Graphs below this many nodes build faster than they load: never cached.
_POWERLAW_CACHE_MIN_NODES = 500_000


def power_law_edges(num_nodes: int, avg_degree: int, seed: int = 0):
    """The power-law generator's directed edges (src, dst), int64 numpy,
    drawn with the JAX package's numpy calls: in-degrees heavy-tailed (u^2
    of a uniform u), and a ring through all nodes both ways, so that no node
    is a dead end."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    u = rng.random(num_edges)
    dst = (u * u * num_nodes).astype(np.int64)
    src = rng.integers(0, num_nodes, num_edges)
    ring = np.arange(num_nodes, dtype=np.int64)
    src = np.concatenate([src, ring, (ring + 1) % num_nodes])
    dst = np.concatenate([dst, (ring + 1) % num_nodes, ring])
    return src, dst


def synthetic_power_law(num_nodes: int, avg_degree: int, seed: int = 0,
                        cache_root: str | None = None,
                        device=None) -> CSRGraph:
    """Synthetic graph with a heavy-tailed in-degree (hub) distribution, the
    stand-in for ogbn-scale graphs.

    The edges are ``power_law_edges``, the same graph edge for edge as the
    JAX package's generator gives; the CSR is sorted and built on the
    device.  The graph is a pure function of (num_nodes, avg_degree, seed),
    so from 500 000 nodes on ``cache_root`` (or ``$TRW_GRAPH_CACHE``) keeps
    its CSR on disk under the JAX package's file names:
    ``powerlaw_v1_{N}_{deg}_{seed}.npz``, or the unversioned legacy name,
    which the v1 construction wrote too.
    """
    cache_root = cache_root or os.environ.get("TRW_GRAPH_CACHE")
    cache = None
    if cache_root and num_nodes >= _POWERLAW_CACHE_MIN_NODES:
        cache = os.path.join(
            cache_root,
            f"powerlaw_{_POWERLAW_GEN_VERSION}_"
            f"{num_nodes}_{avg_degree}_{seed}.npz")
        legacy = os.path.join(
            cache_root, f"powerlaw_{num_nodes}_{avg_degree}_{seed}.npz")
        found = next((p for p in (cache, legacy) if os.path.exists(p)), None)
        if found is not None and (found == cache
                                  or _POWERLAW_GEN_VERSION == "v1"):
            return _csr_from_cache(found, device)
    src, dst = power_law_edges(num_nodes, avg_degree, seed)
    graph = CSRGraph.from_edges(src, dst, num_nodes=num_nodes, device=device)
    if cache:
        _save_csr_cache(cache, graph)
    return graph


PRODUCTS_SHAPE = (2_449_029, 50, 0)  # (nodes, avg_degree, seed)


def products_shape_graph(root: str = "dataset", device=None) -> CSRGraph:
    """ogbn-products-shaped synthetic graph (2.45 M nodes, about 127 M
    directed edges, hub skew; BASELINE.json config 4): the power-law edges
    drawn on the host, the CSR built on the device, and the CSR kept in
    ``{root}/products_shape_csr.npz`` (the JAX package's file and keys), so
    that a later call loads it instead of drawing again."""
    cache = os.path.join(root, "products_shape_csr.npz")
    if os.path.exists(cache):
        return _csr_from_cache(cache, device)
    graph = synthetic_power_law(*PRODUCTS_SHAPE, device=device)
    _save_csr_cache(cache, graph)
    return graph


def grid_kg_triples(side: int = 45, seed: int = 0):
    """The grid-world KG's triples: (all (E, 3), held-out, kept), int64
    numpy, a tenth held out by the JAX package's
    ``numpy.random.default_rng(seed)`` permutation.  Entities are the cells
    of a side x side grid; relations are translations (0 = east, 1 = north,
    2 = east-2, 3 = north-east)."""
    offsets = [(1, 0), (0, 1), (2, 0), (1, 1)]  # (dx, dy) per relation
    triples = []
    for r, (dx, dy) in enumerate(offsets):
        x, y = np.meshgrid(np.arange(side - dx), np.arange(side - dy),
                           indexing="ij")
        h = x.ravel() * side + y.ravel()
        t = (x.ravel() + dx) * side + (y.ravel() + dy)
        triples.append(np.stack([h, np.full_like(h, r), t], axis=1))
    triples = np.concatenate(triples)
    perm = np.random.default_rng(seed).permutation(triples.shape[0])
    k = triples.shape[0] // 10
    return triples, triples[perm[:k]], triples[perm[k:]]


def synthetic_grid_kg(side: int = 45, seed: int = 0, device=None):
    """Grid-world knowledge graph with an exact TransE ground truth
    (``grid_kg_triples``).  Border cells lack some out-triples and the far
    corner is a dead end, which gives triples walks their padding path.
    Returns (``TriplesGraph`` over the kept triples on ``device``, all
    triples, held-out triples), the last two as (E, 3) int64 numpy arrays,
    as the JAX package returns them."""
    triples, test, train = grid_kg_triples(side, seed)
    return (TriplesGraph.from_arrays(train, num_entities=side * side,
                                     device=device),
            triples, test)
