"""ctypes bindings of the CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, allocates the outputs with ``torch.empty``,
launches on PyTorch's current stream without synchronising, raises if the
launch was refused, and adds one to its entry of ``launch_counts`` where it
launches, and nowhere else.  Nothing here is called for a CPU tensor: the
modules in ``ops/`` and ``parallel/`` take their plain versions for those.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from torch_random_walk_tpu_torch.kernels.build import build_library

KERNEL_NAMES = ("uniform_walk_csr", "node2vec_walk_csr_mixture",
                "node2vec_walk_csr_rejection", "to_windows",
                "all_to_all_chunks", "walk_sgns_loss_fwd",
                "walk_sgns_loss_bwd", "uniform_walk_edge_list",
                "biased_walk_edge_list", "uniform_walk_triples",
                "to_windows_triples", "to_windows_triples_cbow",
                "routed_uniform_phase", "routed_node2vec_phase",
                "routed_triples_batch", "routed_edge_list_batch",
                "routed_edge_list_node2vec_batch", "sgns_windows_loss_fwd",
                "sgns_windows_loss_bwd", "sgns_windows_loss_and_grads",
                "adam_dense", "adam_rows", "kge_pair_loss",
                "kge_pair_loss_and_grads", "kge_windows_loss",
                "kge_windows_loss_and_grads")
launch_counts = dict.fromkeys(KERNEL_NAMES, 0)

_lib = None

_PTR = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float


class _WindowsGradCall(ctypes.Structure):
    """One call of K17 (sgns_windows.cuh ``GradCall``): the inputs and every
    output and scratch buffer, as device pointers (None: absent)."""
    _fields_ = ([(name, _PTR) for name in (
        "in_ids", "pos", "neg", "in_emb", "out_emb", "partial", "loss",
        "grad_loss", "h", "grad_in", "grad_out", "sort", "entries",
        "heavy")]
        + [("num_windows", _I64)]
        + [(name, _I32) for name in (
            "in_cols", "out_cols", "num_nodes", "dim", "elem_bytes", "vec",
            "cbow", "heavy_slots")])


class _KgePairCall(ctypes.Structure):
    """One call of K19 (kge_pair.cu ``PairCall``)."""
    _fields_ = ([(name, _PTR) for name in (
        "ent", "rel", "pos", "neg", "valid", "count", "partial", "loss",
        "grad_loss", "grad_ent", "grad_rel")]
        + [("num_pos", _I64)]
        + [(name, _I32) for name in (
            "num_neg", "num_ent", "num_rel", "dim", "score", "elem_bytes",
            "vec", "rel_shared_rows")]
        + [("margin", _F32)])


class _KgeWindowsCall(ctypes.Structure):
    """One call of K20 (kge_windows.cu ``WindowsCall``)."""
    _fields_ = ([(name, _PTR) for name in (
        "ent_in", "rel_in", "ent_out", "rel_out", "center", "pos", "neg",
        "count", "partial", "loss", "grad_loss", "grad_ent_in", "grad_rel_in",
        "grad_ent_out", "grad_rel_out")]
        + [("num_windows", _I64)]
        + [(name, _I32) for name in (
            "cols", "num_ent", "num_rel", "dim", "padding_idx", "cbow",
            "elem_bytes", "vec", "rel_shared_rows")])


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(verbose=verbose)))
        lib.trw_uniform_walk_csr.argtypes = [
            _PTR, _PTR, _I32, _I64, _PTR, _PTR, _I32, _I32, _U32, _U32, _U32,
            _PTR]
        lib.trw_node2vec_walk_csr.argtypes = [
            _PTR, _PTR, _I32, _I64, _PTR, _PTR, _PTR, _I32, _I32, _U32, _U32,
            _U32, _I32, _F32, _F32, _F32, _U32, _U32, _U32, _U32, _U32, _I32,
            _I32, _PTR]
        lib.trw_node2vec_walk_geometry.argtypes = [_I32, _I32, _PTR]
        lib.trw_to_windows.argtypes = [
            _PTR, _I64, _I32, _I32, _U32, _U32, _U32, _U32, _U32, _U32, _U32,
            _U32, _I32, _I32, _PTR, _PTR, _PTR, _PTR]
        lib.trw_all_to_all_chunks.argtypes = [_PTR, _PTR]
        lib.trw_empty_kernel.argtypes = [_I32, _I32, _I32, _I32, _PTR]
        lib.trw_walk_sgns_chunk.argtypes = [_I32] * 6
        lib.trw_walk_sgns_partials.argtypes = [_I32] * 6
        lib.trw_walk_sgns_partials.restype = ctypes.c_int64
        lib.trw_walk_sgns_describe.argtypes = [_I32] * 7 + [_PTR]
        lib.trw_walk_sgns_loss_fwd.argtypes = [
            _PTR, _I32, _I32, _PTR, _PTR, _I32, _I32, _I32, _PTR, _I32, _I32,
            _F32, _PTR, _PTR, _PTR]
        lib.trw_walk_sgns_loss_bwd.argtypes = [
            _PTR, _I32, _I32, _PTR, _PTR, _I32, _I32, _I32, _PTR, _I32, _I32,
            _F32, _PTR, _PTR, _PTR, _PTR]
        lib.trw_uniform_walk_edge_list.argtypes = [
            _PTR, _PTR, _I32, _I32, _I64, _U32, _U32, _U32, _PTR, _PTR, _I32,
            _I32, _U32, _U32, _U32, _I32, _I32, _PTR]
        lib.trw_biased_walk_edge_list.argtypes = [
            _PTR, _PTR, _I32, _I64, _PTR, _PTR, _PTR, _I32, _I32, _U32, _U32,
            _U32, _I32, _I32, _I32, _F32, _F32, _F32, _I32, _I32, _PTR]
        lib.trw_uniform_walk_triples.argtypes = [
            _PTR, _PTR, _I32, _I64, _PTR, _PTR, _I32, _I32, _U32, _U32, _U32,
            _I32, _I32, _PTR]
        lib.trw_to_windows_triples_sg.argtypes = [
            _PTR, _I64, _I32, _I32, _I32, _PTR, _I64, _U32, _U32, _PTR, _PTR,
            _PTR, _PTR]
        lib.trw_to_windows_triples_cbow.argtypes = [
            _PTR, _I64, _I32, _I32, _I32, _PTR, _U32, _U32, _U32, _U32, _U32,
            _U32, _U32, _U32, _I32, _PTR, _PTR, _PTR, _PTR]
        lib.trw_routed_uniform_phase.argtypes = [_PTR, _I32, _PTR]
        lib.trw_routed_node2vec_phase.argtypes = [_PTR, _I32, _PTR]
        lib.trw_routed_start.argtypes = [_PTR, _I32, _PTR]
        lib.trw_routed_triples_batch.argtypes = [_PTR, _I32, _PTR]
        lib.trw_routed_edge_list_batch.argtypes = [_PTR, _I32, _PTR]
        lib.trw_routed_edge_list_node2vec_batch.argtypes = [_PTR, _I32, _PTR]
        lib.trw_routed_batch_geometry.argtypes = [_I32, _I32, _I32, _PTR]
        lib.trw_sgns_windows_grid.argtypes = [_I64, _I32]
        lib.trw_sgns_windows_loss_fwd.argtypes = [
            _PTR, _PTR, _PTR, _I64, _I32, _I32, _PTR, _PTR, _I32, _I32, _I32,
            _I32, _I32, _PTR, _PTR, _PTR]
        for fn in (lib.trw_sgns_windows_grads_begin,
                   lib.trw_sgns_windows_grads_end):
            fn.argtypes = [ctypes.POINTER(_WindowsGradCall), _PTR]
        lib.trw_adam_dense.argtypes = [_I64, _I32] + [_F32] * 8 + [_PTR] * 5
        lib.trw_adam_rows.argtypes = ([_I64, _I32, _I32, _I32, _I32]
                                      + [_F32] * 8 + [_PTR] * 7)
        lib.trw_kge_pair_grid.argtypes = [_I64, _I32]
        lib.trw_kge_windows_grid.argtypes = [_I64, _I32]
        for fn in (lib.trw_kge_pair_loss, lib.trw_kge_pair_loss_and_grads):
            fn.argtypes = [ctypes.POINTER(_KgePairCall), _PTR]
        for fn in (lib.trw_kge_windows_loss,
                   lib.trw_kge_windows_loss_and_grads):
            fn.argtypes = [ctypes.POINTER(_KgeWindowsCall), _PTR]
        for fn in (lib.trw_routed_uniform_phase, lib.trw_routed_node2vec_phase,
                   lib.trw_routed_start, lib.trw_routed_triples_batch,
                   lib.trw_routed_edge_list_batch,
                   lib.trw_routed_edge_list_node2vec_batch,
                   lib.trw_routed_batch_geometry,
                   lib.trw_uniform_walk_edge_list,
                   lib.trw_biased_walk_edge_list, lib.trw_uniform_walk_triples,
                   lib.trw_to_windows_triples_sg,
                   lib.trw_to_windows_triples_cbow,
                   lib.trw_uniform_walk_csr, lib.trw_node2vec_walk_csr,
                   lib.trw_node2vec_walk_geometry, lib.trw_to_windows,
                   lib.trw_all_to_all_chunks, lib.trw_empty_kernel,
                   lib.trw_walk_sgns_chunk, lib.trw_walk_sgns_describe,
                   lib.trw_walk_sgns_loss_fwd, lib.trw_walk_sgns_loss_bwd,
                   lib.trw_sgns_windows_grid, lib.trw_sgns_windows_loss_fwd,
                   lib.trw_sgns_windows_grads_begin,
                   lib.trw_sgns_windows_grads_end, lib.trw_adam_dense,
                   lib.trw_adam_rows, lib.trw_kge_pair_grid,
                   lib.trw_kge_windows_grid, lib.trw_kge_pair_loss,
                   lib.trw_kge_pair_loss_and_grads, lib.trw_kge_windows_loss,
                   lib.trw_kge_windows_loss_and_grads):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device | None = None) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimension(s), got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _device_index(device: torch.device) -> int:
    if device.index is None:
        return torch.cuda.current_device()
    return device.index


def _call(fn, device_index: int, *args) -> int:
    """``fn(*args, stream)`` with PyTorch's current stream of the card, which
    is made current only where it is not."""
    if torch.cuda.current_device() == device_index:
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    with torch.cuda.device(device_index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))


def _launch(name: str, fn, device_index: int, *args) -> None:
    """``_call``, raising if the launch was refused, and count the launch."""
    rc = _call(fn, device_index, *args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"code {rc}")
    launch_counts[name] += 1


def _check_csr(row_ptr, col_idx, targets, walk_length: int) -> None:
    dev = row_ptr.device if isinstance(row_ptr, torch.Tensor) else None
    _check("row_ptr", row_ptr, torch.int32, 1)
    _check("col_idx", col_idx, torch.int32, 1, dev)
    _check("target_nodes", targets, torch.int32, 1, dev)
    if row_ptr.shape[0] < 2:
        raise ValueError("row_ptr must describe at least one node")
    if walk_length < 1:
        raise ValueError(f"walk_length must be >= 1, got {walk_length}")


def uniform_walk_csr(row_ptr, col_idx, targets, walk_length: int,
                     key: tuple[int, int], walker_offset: int):
    """K1.  (B,) int32 targets -> (B, L+1) int32 walks."""
    _check_csr(row_ptr, col_idx, targets, walk_length)
    num_walkers = targets.shape[0]
    walks = torch.empty((num_walkers, walk_length + 1), dtype=torch.int32,
                        device=targets.device)
    if num_walkers == 0:
        return walks
    _launch("uniform_walk_csr", library().trw_uniform_walk_csr,
            _device_index(targets.device), row_ptr.data_ptr(),
            col_idx.data_ptr(), row_ptr.shape[0] - 1, col_idx.shape[0],
            targets.data_ptr(),
            walks.data_ptr(), num_walkers, walk_length, key[0], key[1],
            walker_offset & 0xFFFFFFFF)
    return walks


def node2vec_walk_csr(row_ptr, col_idx, targets, walk_length: int,
                      key: tuple[int, int], walker_offset: int, mixture: bool,
                      probs: tuple[float, float, float],
                      consts: tuple[int, int, int, int, int],
                      search_iters: int, max_rounds: int):
    """K2.  Returns ((B, L+1) int32 walks, (B,) bool: some step of the walker
    spent its whole round budget)."""
    _check_csr(row_ptr, col_idx, targets, walk_length)
    num_walkers = targets.shape[0]
    walks = torch.empty((num_walkers, walk_length + 1), dtype=torch.int32,
                        device=targets.device)
    exhausted = torch.empty((num_walkers,), dtype=torch.uint8,
                            device=targets.device)
    if num_walkers == 0:
        return walks, exhausted.bool()
    name = ("node2vec_walk_csr_mixture" if mixture
            else "node2vec_walk_csr_rejection")
    _launch(name, library().trw_node2vec_walk_csr,
            _device_index(targets.device),
            row_ptr.data_ptr(), col_idx.data_ptr(), row_ptr.shape[0] - 1,
            col_idx.shape[0], targets.data_ptr(), walks.data_ptr(),
            exhausted.data_ptr(), num_walkers, walk_length, key[0], key[1],
            walker_offset & 0xFFFFFFFF, int(mixture), *probs, *consts,
            search_iters, max_rounds)
    return walks, exhausted.bool()


def _check_ranges(name: str, table, width: int, index, targets,
                  walk_length: int, padding_idx: int) -> None:
    """The checks K7, K8 and K9 share: an (E, width) table and an (N, 2)
    range index of at least one node, (B,) targets, int32 on one card."""
    dev = index.device if isinstance(index, torch.Tensor) else None
    _check("index", index, torch.int32, 2)
    _check(name, table, torch.int32, 2, dev)
    _check("target_nodes", targets, torch.int32, 1, dev)
    if index.shape[0] < 1 or index.shape[1] != 2 or table.shape[1] != width:
        raise ValueError(f"index must be (N >= 1, 2) and {name} (E, {width}),"
                         f" got {tuple(index.shape)} and {tuple(table.shape)}")
    if walk_length < 1:
        raise ValueError(f"walk_length must be >= 1, got {walk_length}")
    if not -2 ** 31 <= padding_idx < 2 ** 31:
        raise ValueError(f"padding_idx {padding_idx} does not fit int32")


# K7's tables (``trw_uniform_walk_edge_list``'s ``layout``): the raw (E, 2)
# [head, tail] rows, a graph's (E,) tails column or its packed (E, 2)
# (tail, start, cnt) rows.
EDGE_LAYOUTS = {"edge_rows": (0, 2), "tails": (1, 1), "packed": (2, 2)}


def uniform_walk_edge_list(table, node_edge_index, targets, walk_length: int,
                           key: tuple[int, int], padding_idx: int,
                           restart: bool, walker_offset: int,
                           layout: str = "edge_rows",
                           bits: tuple[int, int, int] = (0, 0, 0)):
    """K7 on ``table`` in ``layout`` (``EDGE_LAYOUTS``: its code and row
    width); ``bits`` are the packed rows' (node, start, deg) field widths.
    (B,) int32 targets -> (B, L+1) int32 walks."""
    if layout not in EDGE_LAYOUTS:
        raise ValueError(f"unknown edge layout {layout!r}")
    code, width = EDGE_LAYOUTS[layout]
    _check("edge table", table, torch.int32, 1 if layout == "tails" else 2)
    _check_ranges("edge table", table.view(-1, 1) if layout == "tails"
                  else table, width, node_edge_index, targets, walk_length,
                  padding_idx)
    if layout == "packed" and table.shape[0] == 0:
        raise ValueError("packed edge rows need at least one edge")
    if layout == "packed" and not (all(0 < b < 32 for b in bits)
                                   and sum(bits) <= 64):
        raise ValueError(f"packed field widths {bits} do not fit two words")
    num_walkers = targets.shape[0]
    walks = torch.empty((num_walkers, walk_length + 1), dtype=torch.int32,
                        device=targets.device)
    if num_walkers == 0:
        return walks
    _launch("uniform_walk_edge_list", library().trw_uniform_walk_edge_list,
            _device_index(targets.device), node_edge_index.data_ptr(),
            table.data_ptr(), code, node_edge_index.shape[0],
            table.shape[0], *(bits if layout == "packed" else (0, 0, 0)),
            targets.data_ptr(), walks.data_ptr(), num_walkers, walk_length,
            key[0], key[1], walker_offset & 0xFFFFFFFF, padding_idx,
            int(restart))
    return walks


def biased_walk_edge_list(tails, node_edge_index, targets, walk_length: int,
                          key: tuple[int, int], padding_idx: int,
                          restart: bool, probs: tuple[float, float, float],
                          search_iters: int, max_rounds: int, fat: bool,
                          walker_offset: int):
    """K8 on the (E,) int32 tails column of an edge list sorted by (head,
    tail).  Returns ((B, L+1) int32 walks, (B,) bool: some step of the
    walker spent its whole round budget)."""
    _check("tails", tails, torch.int32, 1)
    _check_ranges("tails", tails.view(-1, 1), 1, node_edge_index, targets,
                  walk_length, padding_idx)
    num_walkers = targets.shape[0]
    walks = torch.empty((num_walkers, walk_length + 1), dtype=torch.int32,
                        device=targets.device)
    exhausted = torch.empty((num_walkers,), dtype=torch.uint8,
                            device=targets.device)
    if num_walkers == 0:
        return walks, exhausted.bool()
    _launch("biased_walk_edge_list", library().trw_biased_walk_edge_list,
            _device_index(targets.device), node_edge_index.data_ptr(),
            tails.data_ptr(), node_edge_index.shape[0], tails.shape[0],
            targets.data_ptr(), walks.data_ptr(), exhausted.data_ptr(),
            num_walkers, walk_length, key[0], key[1],
            walker_offset & 0xFFFFFFFF, padding_idx, int(restart), int(fat),
            *probs, search_iters, max_rounds)
    return walks, exhausted.bool()


def uniform_walk_triples(table, relation_tail_index, targets,
                         walk_length: int, key: tuple[int, int],
                         padding_idx: int, fat: bool, walker_offset: int):
    """K9: the fat semantics on (T, 4) [relation, tail, start_tail,
    cnt_tail] rows (``TriplesGraph.triple_tab``), the oracle's on the (T, 3)
    [head, relation, tail] triples.  (B,) int32 targets -> (B, 2L+1) int32
    walks [v0, r1, v1, ...]."""
    _check_ranges("triple_tab" if fat else "triples", table, 4 if fat else 3,
                  relation_tail_index, targets, walk_length, padding_idx)
    num_walkers = targets.shape[0]
    walks = torch.empty((num_walkers, 2 * walk_length + 1), dtype=torch.int32,
                        device=targets.device)
    if num_walkers == 0:
        return walks
    _launch("uniform_walk_triples", library().trw_uniform_walk_triples,
            _device_index(targets.device), relation_tail_index.data_ptr(),
            table.data_ptr(), relation_tail_index.shape[0],
            table.shape[0], targets.data_ptr(), walks.data_ptr(),
            num_walkers, walk_length, key[0], key[1],
            walker_offset & 0xFFFFFFFF, padding_idx, int(fat))
    return walks


# The windows a group of K10 CBOW's launch may hold (blockIdx.y), so that
# every window index inside a group, a thread's and its block's others' (at
# most 255), stays below 2^31; CBOW's draws a window (kCbowRounds;
# ops/windows.py::CBOW_TRIPLE_ROUNDS).
TRIPLE_WINDOW_GROUP = 2 ** 31 - 256
TRIPLE_CBOW_ROUNDS = 4


class TripleWindowsPlan(NamedTuple):
    """K10 CBOW's launch: the walks cut into ``groups`` of ``group_walks``
    walks (the last may hold fewer), one thread a window; window u of a
    group lies in its walk ``u * magic >> shift`` (= u // per_walk), and the
    group's windows and draw counters mod 2^32 advance by ``group_windows``
    and ``group_draws``.  The C function cuts each group into blocks."""

    per_walk: int
    group_walks: int
    groups: int
    group_windows: int
    group_draws: int
    magic: int
    shift: int


def triple_windows_plan(num_walks: int, width: int,
                        group_windows: int = TRIPLE_WINDOW_GROUP
                        ) -> TripleWindowsPlan:
    """K10 CBOW's launch for ``num_walks`` [v0, r1, v1, ...] walks of
    ``width`` words (at least one window each); ``group_windows`` bounds the
    windows of one group."""
    per_walk = (width - 1) // 2
    if not 0 < per_walk <= group_windows:
        raise ValueError(f"walks of {width} words hold {per_walk} windows, "
                         f"not 1 to {group_windows}")
    group_walks = max(1, min(num_walks, group_windows // per_walk))
    groups = -(-num_walks // group_walks)
    if groups > 65535:
        raise ValueError(f"{num_walks} walks need {groups} groups, more than "
                         "a grid holds")
    windows_here = group_walks * per_walk
    return TripleWindowsPlan(per_walk, group_walks, groups, windows_here,
                             windows_here * TRIPLE_CBOW_ROUNDS & 0xFFFFFFFF,
                             *division_magic(per_walk))


def to_windows_triples(walks, window_size: int, padding_idx: int, triples,
                       key: tuple[int, int], cbow: bool,
                       group_windows: int = TRIPLE_WINDOW_GROUP):
    """K10.  (num_walks, width) int32 [v0, r1, v1, ...] walks -> targets
    (num_win, 3), windows (num_win, 2W, 3) and negatives (num_win, 2W, 3)
    for skip-gram; (targets, negatives (num_win, 3), windows) for CBOW.
    ``group_windows`` as in ``triple_windows_plan`` (CBOW): a test passes a
    small one to run many groups."""
    _check("walks", walks, torch.int32, 2)
    _check("triples", triples, torch.int32, 2, walks.device)
    num_walks, width = walks.shape
    if not 0 < triples.shape[0] < 2 ** 31 or triples.shape[1] != 3:
        raise ValueError(f"triples must be (T, 3) with 0 < T < 2^31, got "
                         f"{tuple(triples.shape)}")
    if window_size < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")
    if not -2 ** 31 <= padding_idx < 2 ** 31:
        raise ValueError(f"padding_idx {padding_idx} does not fit int32")
    num_win = num_walks * ((width - 1) // 2)
    dev = walks.device
    targets = torch.empty((num_win, 3), dtype=torch.int32, device=dev)
    windows = torch.empty((num_win, 2 * window_size, 3), dtype=torch.int32,
                          device=dev)
    negatives = torch.empty((num_win, 3) if cbow
                            else (num_win, 2 * window_size, 3),
                            dtype=torch.int32, device=dev)
    if num_win and cbow:
        plan = triple_windows_plan(num_walks, width, group_windows)
        _launch("to_windows_triples_cbow",
                library().trw_to_windows_triples_cbow, _device_index(dev),
                walks.data_ptr(), num_walks, width, window_size, padding_idx,
                triples.data_ptr(), triples.shape[0], key[0], key[1],
                plan.magic, plan.shift, plan.group_walks, plan.group_windows,
                plan.group_draws, plan.groups, targets.data_ptr(),
                windows.data_ptr(), negatives.data_ptr())
    elif num_win:
        _launch("to_windows_triples", library().trw_to_windows_triples_sg,
                _device_index(dev), walks.data_ptr(), num_walks, width,
                window_size, padding_idx, triples.data_ptr(),
                triples.shape[0], key[0], key[1], targets.data_ptr(),
                windows.data_ptr(), negatives.data_ptr())
    if cbow:
        return targets, negatives, windows
    return targets, windows, negatives


def node2vec_walk_geometry(mixture: bool, threads: int = 0) -> dict:
    """K2's launch geometry on the current card: ``threads`` per block (the
    launch's own when 0) and how many such blocks one SM holds at once."""
    out = (ctypes.c_int32 * 2)()
    rc = library().trw_node2vec_walk_geometry(int(mixture), int(threads), out)
    if rc != 0:
        raise RuntimeError(f"node2vec_walk_geometry: CUDA error code {rc}")
    return {"threads": out[0], "blocks_per_sm": out[1]}


# Walk words a group of K3's launch may span (blockIdx.y), so that every index
# inside a group, a thread's window index plus its block's 255 others
# included, stays below 2^31.
WINDOW_GROUP_WORDS = 2 ** 31 - 256
WINDOW_THREADS = 256  # K3's threads a block, one window each: kWindowThreads


class WindowsPlan(NamedTuple):
    """K3's launch: the walks cut into ``groups`` of ``group_walks`` walks
    (the last may hold fewer), ``blocks`` blocks of ``WINDOW_THREADS``
    windows a group; window u of a group lies in its walk
    ``u * magic >> shift`` (= u // per_walk), and the group's windows and
    slots mod 2^32 advance by ``group_windows`` and ``group_slots``."""

    per_walk: int
    group_walks: int
    groups: int
    blocks: int
    group_windows: int
    group_slots: int
    magic: int
    shift: int


def division_magic(divisor: int) -> tuple[int, int]:
    """(magic, shift) with ``u * magic >> shift == u // divisor`` for every
    0 <= u < 2^31 and magic < 2^32: shift = 31 + ceil(log2 divisor), magic =
    ceil(2^shift / divisor).  The error of the product, under divisor / 2^31,
    never reaches the next multiple."""
    if not 0 < divisor < 2 ** 31:
        raise ValueError(f"divisor must be in (0, 2^31), got {divisor}")
    shift = 31 + (divisor - 1).bit_length()
    return -(-(1 << shift) // divisor), shift


def windows_plan(num_walks: int, length: int, window: int,
                 group_words: int = WINDOW_GROUP_WORDS) -> WindowsPlan:
    """K3's launch for ``num_walks`` walks of ``length`` words and windows of
    ``window``; ``group_words`` bounds the walk words of one group."""
    if length > group_words:
        raise ValueError(f"walks of {length} words do not fit one group of "
                         f"{group_words}")
    per_walk = length - window + 1
    group_walks = max(1, min(num_walks, group_words // length))
    groups = -(-num_walks // group_walks)
    if groups > 65535:
        raise ValueError(f"{num_walks} walks need {groups} groups, more than "
                         "a grid holds")
    group_windows = group_walks * per_walk
    return WindowsPlan(per_walk, group_walks, groups,
                       -(-group_windows // WINDOW_THREADS), group_windows,
                       group_windows * (window - 1) & 0xFFFFFFFF,
                       *division_magic(per_walk))


def to_windows(walks, window_size: int, num_nodes: int, key: tuple[int, int],
               group_words: int = WINDOW_GROUP_WORDS):
    """K3.  (num_walks, length) int32 walks -> targets (num_win,), positives
    and negatives (num_win, W-1), all int32.  ``group_words`` as in
    ``windows_plan``: a test passes a small one to run many groups."""
    _check("walks", walks, torch.int32, 2)
    num_walks, length = walks.shape
    if not 2 <= window_size <= length:
        raise ValueError(f"window_size must be in [2, {length}], got "
                         f"{window_size}")
    if not 0 < num_nodes < 2 ** 31:
        raise ValueError(f"num_nodes must be in (0, 2^31), got {num_nodes}")
    num_win = num_walks * (length - window_size + 1)
    dev = walks.device
    targets = torch.empty((num_win,), dtype=torch.int32, device=dev)
    pos = torch.empty((num_win, window_size - 1), dtype=torch.int32, device=dev)
    neg = torch.empty((num_win, window_size - 1), dtype=torch.int32, device=dev)
    if num_win == 0:
        return targets, pos, neg
    plan = windows_plan(num_walks, length, window_size, group_words)
    _launch("to_windows", library().trw_to_windows, _device_index(dev),
            walks.data_ptr(), num_walks, length, window_size, num_nodes,
            key[0], key[1], plan.magic, plan.shift, plan.group_walks,
            plan.group_windows, plan.group_slots, plan.groups, plan.blocks,
            targets.data_ptr(), pos.data_ptr(), neg.data_ptr())
    return targets, pos, neg


# K4 passes 2 * D base pointers as kernel parameters (4 KB at most); its
# block and the words a thread copies.  The values of exchange.cu's
# kMaxShards, kExchangeThreads and kLoads.
MAX_SHARDS = 256
EXCHANGE_THREADS, EXCHANGE_LOADS = 256, 4


class ExchangePlan(NamedTuple):
    """K4's launch: a grid of (``pieces``, D, D) blocks of ``threads``; block
    (x, dst, src) copies words [x * threads * loads, (x + 1) * threads *
    loads) of chunk (src, dst), ``elems`` words of 16 bytes (``vec``) or of 4
    bytes, thread t of it the words x * threads * loads + k * threads + t."""

    num_shards: int
    vec: int
    elems: int
    pieces: int
    threads: int
    loads: int


def exchange_plan(num_shards: int, words: int, vec: bool) -> ExchangePlan:
    """K4's launch for D shards and chunks of ``words`` 32-bit words."""
    if not 0 < num_shards <= MAX_SHARDS:
        raise ValueError(f"the exchange takes 1 to {MAX_SHARDS} shards, got "
                         f"{num_shards}")
    elems = words // 4 if vec else words
    per_block = EXCHANGE_THREADS * EXCHANGE_LOADS
    return ExchangePlan(num_shards, int(vec), elems, -(-elems // per_block),
                        EXCHANGE_THREADS, EXCHANGE_LOADS)


class _ExchangeLaunch(ctypes.Structure):
    """``TrwExchangeLaunch`` of ``kernels/exchange.cu``."""

    _fields_ = [("num_shards", ctypes.c_int32), ("vec", ctypes.c_int32),
                ("words", ctypes.c_int64),
                ("bases", ctypes.c_void_p * (2 * MAX_SHARDS))]


class ChunkTable(NamedTuple):
    """What K4 needs to exchange one fixed set of buffers: its launch's
    arguments packed once (``launch`` holds them, ``address`` is where), the
    card, and the plan.  Holding the buffers keeps the pointers valid."""

    launch: _ExchangeLaunch
    address: int
    buffers: tuple
    device_index: int
    plan: ExchangePlan


def chunk_pointer_table(outboxes, inboxes) -> ChunkTable:
    """Check one (D, C, R) int32 outbox and inbox per shard and pack their
    ``ChunkTable``."""
    num_shards = len(outboxes)
    if num_shards == 0 or len(inboxes) != num_shards:
        raise ValueError("need one outbox and one inbox per shard")
    if num_shards > MAX_SHARDS:
        raise ValueError(f"the exchange takes 1 to {MAX_SHARDS} shards, got "
                         f"{num_shards}")
    dev, shape = outboxes[0].device, tuple(outboxes[0].shape)
    if len(shape) != 3 or shape[0] != num_shards:
        raise ValueError(f"each buffer must be (D={num_shards}, C, R), got "
                         f"{shape}")
    for name, bufs in (("outbox", outboxes), ("inbox", inboxes)):
        for buf in bufs:
            _check(name, buf, torch.int32, 3, dev)
            if tuple(buf.shape) != shape:
                raise ValueError(f"{name} shapes differ: {tuple(buf.shape)} "
                                 f"vs {shape}")
    buffers = (*outboxes, *inboxes)
    if len({b.data_ptr() for b in buffers}) != len(buffers) and shape[1]:
        raise ValueError("outboxes and inboxes must be distinct buffers")
    words = shape[1] * shape[2]
    # 16-byte copies where every chunk starts on a 16-byte boundary.
    vec = words % 4 == 0 and all(b.data_ptr() % 16 == 0 for b in buffers)
    launch = _ExchangeLaunch(num_shards, int(vec), words)
    for i, b in enumerate(buffers):
        launch.bases[i] = b.data_ptr()
    return ChunkTable(launch, ctypes.addressof(launch), buffers,
                      _device_index(dev), exchange_plan(num_shards, words, vec))


def all_to_all_chunks(table: ChunkTable) -> None:
    """K4.  Copies outboxes[src][dst] into inboxes[dst][src] for every pair
    of the buffers ``table`` was built for, in one launch."""
    if table.plan.elems == 0:
        return
    _launch("all_to_all_chunks", library().trw_all_to_all_chunks,
            table.device_index, table.address)


def empty_kernel(device_index: int, grid: tuple[int, int, int],
                 threads: int) -> None:
    """An empty kernel on ``grid`` blocks of ``threads``, launched through the
    same path as the kernels: the floor of a launch.  A measurement probe, on
    no path of the package; it counts nothing."""
    rc = _call(library().trw_empty_kernel, device_index, *grid, threads)
    if rc != 0:
        raise RuntimeError(f"empty_kernel: CUDA error code {rc}")


_TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _check_sgns(in_emb, out_emb, walks, neg_ids, window_size: int,
                backward: bool) -> tuple:
    """The checks K5 and K6 share.  Returns the C functions' common leading
    arguments."""
    if not isinstance(in_emb, torch.Tensor) or in_emb.dtype not in _TABLE_DTYPES:
        raise ValueError("the tables must be float32 or bfloat16 tensors")
    dev = in_emb.device
    _check("in_emb", in_emb, in_emb.dtype, 2)
    _check("out_emb", out_emb, in_emb.dtype, 2, dev)
    _check("walks", walks, torch.int32, 2, dev)
    _check("neg_ids", neg_ids, torch.int32, 1, dev)
    if in_emb.shape != out_emb.shape:
        raise ValueError(f"in_emb {tuple(in_emb.shape)} and out_emb "
                         f"{tuple(out_emb.shape)} must have one shape")
    num_nodes, dim = in_emb.shape
    num_walks, length1 = walks.shape
    hw = int(window_size) // 2
    if not 0 < num_nodes < 2 ** 31 or dim < 1:
        raise ValueError(f"tables of shape {tuple(in_emb.shape)} are not "
                         "supported")
    if num_walks < 1 or length1 - 2 * hw < 1 or hw < 0:
        raise ValueError(f"walks of shape {tuple(walks.shape)} hold no center "
                         f"for window_size {window_size}")
    if neg_ids.shape[0] < 1:
        raise ValueError("at least one shared negative is required")
    elem = in_emb.element_size()
    with torch.cuda.device(dev):
        fits = library().trw_walk_sgns_chunk(length1, dim, hw,
                                             neg_ids.shape[0], elem,
                                             int(backward))
    if fits == 0:
        raise ValueError(
            f"walk length {length1 - 1}, dim {dim} and window_size "
            f"{window_size} do not fit the loss kernel (dim <= 512, and one "
            "walk's rows must fit the card's shared memory)")
    return (walks.data_ptr(), num_walks, length1, in_emb.data_ptr(),
            out_emb.data_ptr(), num_nodes, dim, elem, neg_ids.data_ptr(),
            neg_ids.shape[0], hw)


def walk_sgns_loss_fwd(in_emb, out_emb, walks, neg_ids, window_size: int,
                       num_neg: int) -> torch.Tensor:
    """K5.  (N, D) tables, (B, L+1) int32 walks, (S,) int32 shared negatives
    -> the blockwise SGNS loss, a float32 scalar on the device."""
    args = _check_sgns(in_emb, out_emb, walks, neg_ids, window_size, False)
    num_walks, length1, _, _, _, dim, elem, _, num_neg_ids, hw = args[1:]
    with torch.cuda.device(walks.device):
        num_partials = library().trw_walk_sgns_partials(
            num_walks, length1, dim, hw, num_neg_ids, elem)
    partial = torch.empty((num_partials,), dtype=torch.float32,
                          device=walks.device)
    loss = torch.empty((), dtype=torch.float32, device=walks.device)
    _launch("walk_sgns_loss_fwd", library().trw_walk_sgns_loss_fwd,
            _device_index(walks.device), *args, float(num_neg),
            partial.data_ptr(), loss.data_ptr())
    return loss


def walk_sgns_loss_bwd(in_emb, out_emb, walks, neg_ids, window_size: int,
                       num_neg: int, grad_loss: torch.Tensor):
    """K6.  The gradient of K5's loss, times the float32 device scalar
    ``grad_loss``, as two dense (N, D) float32 tables (in_emb's, out_emb's)."""
    args = _check_sgns(in_emb, out_emb, walks, neg_ids, window_size, True)
    _check("grad_loss", grad_loss, torch.float32, 0, walks.device)
    grad_in = torch.zeros(in_emb.shape, dtype=torch.float32,
                          device=walks.device)
    grad_out = torch.zeros(in_emb.shape, dtype=torch.float32,
                           device=walks.device)
    _launch("walk_sgns_loss_bwd", library().trw_walk_sgns_loss_bwd,
            _device_index(walks.device), *args, float(num_neg),
            grad_loss.data_ptr(), grad_in.data_ptr(), grad_out.data_ptr())
    return grad_in, grad_out


SGNS_PLAN_FIELDS = ("tile_rows", "walks_per_tile", "centers_per_walk_in_tile",
                    "tiles", "negatives_per_launch", "launches", "stages",
                    "shared_bytes", "blocks_per_sm", "grid")


def walk_sgns_plan(in_emb, walks, neg_ids, window_size: int) -> dict:
    """How K5 and K6 cut this shape for these tables' type: per kernel
    (``fwd``, ``bwd_rows``, ``bwd_negatives``; float32 tables have no third
    kernel) the fields of ``SGNS_PLAN_FIELDS``, launching nothing."""
    num_walks, length1 = walks.shape
    num_nodes, dim = in_emb.shape
    out = torch.zeros(3 * len(SGNS_PLAN_FIELDS), dtype=torch.int32)
    with torch.cuda.device(walks.device):
        rc = library().trw_walk_sgns_describe(
            num_walks, length1, num_nodes, dim, int(window_size) // 2,
            neg_ids.shape[0], in_emb.element_size(), out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"walk_sgns_plan: CUDA error code {rc}")
    rows = out.view(3, -1).tolist()
    names = ("fwd", "bwd_rows", "bwd_negatives")
    return {n: dict(zip(SGNS_PLAN_FIELDS, r)) for n, r in zip(names, rows)
            if any(r)}


# K16/K17 take a window's rows as a group of lanes: D up to 512, 16-byte
# loads (8 bfloat16 or 4 float32 elements a lane) where D is a multiple of
# the width and the tables are 16-byte aligned, else one element a lane.
SGNS_WINDOWS_MAX_DIM = 512
# K17's owner pass leaves a row of more slots than this to a block of its own
# (sgns_windows_owner.cu); the wrapper sizes the list of such rows by it.
SGNS_WINDOWS_HEAVY_SLOTS = 128


def _check_windows(in_emb, out_emb, in_ids, pos, neg, cbow: bool) -> tuple:
    """The checks K16 and K17 share.  ``in_ids`` (B, CI), ``pos`` and
    ``neg`` (B, CO) int32: skip-gram CI = 1, CBOW CO = 1.  Returns the C
    functions' common leading arguments."""
    if not isinstance(in_emb, torch.Tensor) or in_emb.dtype not in _TABLE_DTYPES:
        raise ValueError("the tables must be float32 or bfloat16 tensors")
    dev = in_emb.device
    _check("in_emb", in_emb, in_emb.dtype, 2)
    _check("out_emb", out_emb, in_emb.dtype, 2, dev)
    _check("in_ids", in_ids, torch.int32, 2, dev)
    _check("pos", pos, torch.int32, 2, dev)
    _check("neg", neg, torch.int32, 2, dev)
    if in_emb.shape != out_emb.shape:
        raise ValueError(f"in_emb {tuple(in_emb.shape)} and out_emb "
                         f"{tuple(out_emb.shape)} must have one shape")
    num_nodes, dim = in_emb.shape
    num_windows, in_cols = in_ids.shape
    if pos.shape != neg.shape or pos.shape[0] != num_windows:
        raise ValueError(f"pos {tuple(pos.shape)} and neg {tuple(neg.shape)} "
                         f"must be ({num_windows}, C)")
    out_cols = pos.shape[1]
    if (out_cols if cbow else in_cols) != 1 or min(in_cols, out_cols) < 1:
        raise ValueError(f"{'CBOW' if cbow else 'skip-gram'} windows take "
                         f"{'one positive and one negative' if cbow else 'one target'}"
                         f" a window, got in_ids {tuple(in_ids.shape)} and "
                         f"pos {tuple(pos.shape)}")
    if num_windows < 1:
        raise ValueError("at least one window is required")
    if not 0 < num_nodes < 2 ** 31 or not 1 <= dim <= SGNS_WINDOWS_MAX_DIM:
        raise ValueError(f"tables of shape {tuple(in_emb.shape)} are not "
                         f"supported (dim <= {SGNS_WINDOWS_MAX_DIM})")
    if num_windows * 2 * out_cols >= 2 ** 31:
        raise ValueError(f"{num_windows} windows hold more than 2^31 - 1 "
                         "out slots")
    wide = 16 // in_emb.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (in_emb, out_emb))
    vec = wide if dim % wide == 0 and aligned else 1
    return (in_ids.data_ptr(), pos.data_ptr(), neg.data_ptr(), num_windows,
            in_cols, out_cols, in_emb.data_ptr(), out_emb.data_ptr(),
            num_nodes, dim, in_emb.element_size(), vec, int(cbow))


def _windows_partials(args, device) -> tuple:
    """K16's scratch for its per-block partial sums, and the loss."""
    with torch.cuda.device(device):
        grid = library().trw_sgns_windows_grid(args[3], args[11])
    return (torch.empty((grid,), dtype=torch.float32, device=device),
            torch.empty((), dtype=torch.float32, device=device))


def sgns_windows_loss_fwd(in_emb, out_emb, in_ids, pos, neg,
                          cbow: bool = False) -> torch.Tensor:
    """K16.  The per-window SGNS loss (skip-gram, or CBOW with ``cbow``), a
    float32 scalar on the device; equal inputs give equal bits."""
    args = _check_windows(in_emb, out_emb, in_ids, pos, neg, cbow)
    partial, loss = _windows_partials(args, in_ids.device)
    _launch("sgns_windows_loss_fwd", library().trw_sgns_windows_loss_fwd,
            _device_index(in_ids.device), *args, partial.data_ptr(),
            loss.data_ptr())
    return loss


def _windows_grads(in_emb, out_emb, in_ids, pos, neg, cbow: bool, grad_loss,
                   with_loss: bool):
    """K17's passes (with K16's loss from the same per-window pass where
    ``with_loss``): the histogram of the out slots by row, its scan by
    ``torch.cumsum``, the per-window pass (each out slot's (source row,
    dloss/dlogit) placed in its row's bucket, each window's in-row gradient
    added with atomics, CBOW's h written), and the owner passes, which write
    every row of the out table's gradient once.  Returns (loss or None,
    grad_in, grad_out)."""
    args = _check_windows(in_emb, out_emb, in_ids, pos, neg, cbow)
    dev = in_ids.device
    (_, _, _, num_windows, in_cols, out_cols, _, _, num_nodes, dim, elem,
     vec, _) = args
    slots = num_windows * 2 * out_cols
    f32 = dict(dtype=torch.float32, device=dev)
    # counts (N), the heavy-row count (1), offsets (N + 1)
    sort = torch.zeros((2 * num_nodes + 2,), dtype=torch.int32, device=dev)
    entries = torch.empty((slots, 2), dtype=torch.int32, device=dev)
    heavy = torch.empty((slots // (SGNS_WINDOWS_HEAVY_SLOTS + 1) + 1,),
                        dtype=torch.int32, device=dev)
    grad_in = torch.zeros((num_nodes, dim), **f32)
    grad_out = torch.empty((num_nodes, dim), **f32)
    h = torch.empty((num_windows, dim), **f32) if cbow else None
    partial, loss = (_windows_partials(args, dev) if with_loss
                     else (None, None))
    call = _WindowsGradCall(
        in_ids=_ptr(in_ids), pos=_ptr(pos), neg=_ptr(neg),
        in_emb=_ptr(in_emb), out_emb=_ptr(out_emb), partial=_ptr(partial),
        loss=_ptr(loss), grad_loss=_ptr(grad_loss), h=_ptr(h),
        grad_in=_ptr(grad_in), grad_out=_ptr(grad_out), sort=_ptr(sort),
        entries=_ptr(entries), heavy=_ptr(heavy), num_windows=num_windows,
        in_cols=in_cols,
        out_cols=out_cols, num_nodes=num_nodes, dim=dim, elem_bytes=elem,
        vec=vec, cbow=int(cbow), heavy_slots=SGNS_WINDOWS_HEAVY_SLOTS)
    lib, index = library(), _device_index(dev)
    rc = _call(lib.trw_sgns_windows_grads_begin, index, ctypes.byref(call))
    if rc == 0:
        torch.cumsum(sort[:num_nodes], 0, dtype=torch.int32,
                     out=sort[num_nodes + 2:])
        rc = _call(lib.trw_sgns_windows_grads_end, index, ctypes.byref(call))
    if rc != 0:
        name = ("sgns_windows_loss_and_grads" if with_loss
                else "sgns_windows_loss_bwd")
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"code {rc}")
    return loss, grad_in, grad_out


def sgns_windows_loss_bwd(in_emb, out_emb, in_ids, pos, neg,
                          grad_loss: torch.Tensor, cbow: bool = False):
    """K17.  The gradient of K16's loss, times the float32 device scalar
    ``grad_loss``, as two dense (N, D) float32 tables (in_emb's, out_emb's),
    each out row summed by its owner, written once."""
    _check("grad_loss", grad_loss, torch.float32, 0, in_ids.device)
    _, grad_in, grad_out = _windows_grads(in_emb, out_emb, in_ids, pos, neg,
                                          cbow, grad_loss, False)
    launch_counts["sgns_windows_loss_bwd"] += 1
    return grad_in, grad_out


def sgns_windows_loss_and_grads(in_emb, out_emb, in_ids, pos, neg,
                                cbow: bool = False):
    """K16 and K17 in one call, the train step's value and gradient: (the
    loss, equal to K16's bit for bit, and its two dense float32 gradients).
    K17's launches with the loss taken in its per-window pass (K16's body
    with K17's outputs), which reads each window's rows once; the owner
    pass then reads each out slot's source row again.  K16's own kernel
    does not run.  Counted under its own name."""
    loss, grad_in, grad_out = _windows_grads(in_emb, out_emb, in_ids, pos,
                                             neg, cbow, None, True)
    launch_counts["sgns_windows_loss_and_grads"] += 1
    return loss, grad_in, grad_out


def _adam_hyper(lr, b1, b2, eps, bc1, bc2) -> tuple:
    """The float32 hyperparameters of K18, 1 - b computed in double first as
    PyTorch and JAX compute a Python scalar."""
    return (float(lr), float(b1), 1.0 - float(b1), float(b2),
            1.0 - float(b2), float(eps), float(bc1), float(bc2))


def adam_dense(param, mu, nu, grad, lr, b1, b2, eps, bc1, bc2) -> None:
    """K18, dense entry: one Adam step over every element of ``param``, in
    place, from the float32 gradient ``grad``; ``mu`` and ``nu`` in the
    parameter's type, ``bc1``/``bc2`` the bias corrections already cast to
    it."""
    if not isinstance(param, torch.Tensor) or param.dtype not in _TABLE_DTYPES:
        raise ValueError("param must be a float32 or bfloat16 tensor")
    dev = param.device
    _check("param", param, param.dtype, param.dim())
    for name, t in (("mu", mu), ("nu", nu)):
        _check(name, t, param.dtype, param.dim(), dev)
    _check("grad", grad, torch.float32, param.dim(), dev)
    if not mu.shape == nu.shape == grad.shape == param.shape:
        raise ValueError("param, mu, nu and grad must have one shape")
    if any(t.data_ptr() % 16 for t in (param, mu, nu, grad)):
        raise ValueError("adam_dense takes 16-byte aligned tensors")
    if param.numel() == 0:
        return
    _launch("adam_dense", library().trw_adam_dense, _device_index(dev),
            param.numel(), param.element_size(),
            *_adam_hyper(lr, b1, b2, eps, bc1, bc2), grad.data_ptr(),
            param.data_ptr(), mu.data_ptr(), nu.data_ptr())


def adam_rows(param, mu, nu, grad, ids, flag, lr, b1, b2, eps, bc1,
              bc2) -> None:
    """K18, rows entry: JAX's lazy Adam over M slots, in place.  ``param``
    (N, D) float32 or bfloat16, ``mu``/``nu`` (N, D) float32, ``grad`` (M, D)
    float32 slot rows, ``ids`` (M,) int32 (-1 is row N - 1; ids outside
    [-1, N) write nothing), ``flag`` (M,) uint8 or None (a zero writes
    nothing); at most one writing slot a row."""
    if not isinstance(param, torch.Tensor) or param.dtype not in _TABLE_DTYPES:
        raise ValueError("param must be a float32 or bfloat16 tensor")
    dev = param.device
    _check("param", param, param.dtype, 2)
    _check("mu", mu, torch.float32, 2, dev)
    _check("nu", nu, torch.float32, 2, dev)
    _check("grad", grad, torch.float32, 2, dev)
    _check("ids", ids, torch.int32, 1, dev)
    if flag is not None:
        _check("flag", flag, torch.uint8, 1, dev)
        if flag.shape != ids.shape:
            raise ValueError("flag and ids must have one shape")
    num_nodes, dim = param.shape
    if not mu.shape == nu.shape == param.shape:
        raise ValueError("param, mu and nu must have one shape")
    if grad.shape != (ids.shape[0], dim):
        raise ValueError(f"grad must be ({ids.shape[0]}, {dim}), got "
                         f"{tuple(grad.shape)}")
    if ids.shape[0] == 0:
        return
    wide = 16 // param.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (param, mu, nu, grad))
    vec = wide if dim % wide == 0 and aligned else 1
    _launch("adam_rows", library().trw_adam_rows, _device_index(dev),
            ids.shape[0], num_nodes, dim, param.element_size(), vec,
            *_adam_hyper(lr, b1, b2, eps, bc1, bc2), ids.data_ptr(),
            None if flag is None else flag.data_ptr(), grad.data_ptr(),
            param.data_ptr(), mu.data_ptr(), nu.data_ptr())


# K19 and K20 take rows as K16 does (D up to 512, 16-byte loads where the
# row width is a multiple of the load width and the tables are 16-byte
# aligned, else one element a lane).  K19's scores, by the kernel's ids.
KGE_MAX_DIM = 512
KGE_SCORES = {"transe": 0, "distmult": 1, "rotate": 2}


def _vec_width(tables, width: int) -> int:
    wide = 16 // tables[0].element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in tables)
    return wide if width % wide == 0 and aligned else 1


# K19 and K20 sum the gradient of the leading relation rows in each block's
# shared memory, as many as fit this budget in all relation tables of a call
# (kge.cuh kRelSharedBytes); rows past them (larger vocabularies) are added
# to the tables with float4 atomics, as the entity rows.  A choice by shape,
# never a retry.
KGE_REL_SHARED_BYTES = 47 * 1024


def kge_rel_shared_bytes(num_rel: int, width: int, vec: int,
                         tables: int) -> int:
    """Shared bytes of the relation sums (kge.cuh ``rel_shared_bytes``):
    on the vector path a row holds K pieces of 128 floats (K = 1, 2 or 4,
    as the kernels' ``with_width`` picks it), on the scalar path the row."""
    k = -(-width // 128)
    stride = width if vec == 1 else (1 if k <= 1 else 2 if k <= 2 else 4) * 128
    return 4 * tables * num_rel * stride


def _shared_relation_rows(num_rel: int, width: int, vec: int,
                          tables: int) -> int:
    return min(num_rel, KGE_REL_SHARED_BYTES
               // kge_rel_shared_bytes(1, width, vec, tables))


def kge_plan(tables) -> dict:
    """How K19 (``tables`` = (ent, rel)) or K20 (ent_in, rel_in, ent_out,
    rel_out) runs on these tables: the load width, the lanes of a group
    (one item a group), the leading relation rows whose gradient each block
    sums in shared memory and flushes once at its end (the rest are row
    adds into the table), and the path that makes: "shared" (every row) or
    "shared and global"."""
    rels = tables[1::2]
    num_rel, width = rels[0].shape
    vec = _vec_width(tables, width)
    rows = _shared_relation_rows(num_rel, width, vec, len(rels))
    return {"vec": vec, "lanes": 16 if vec == 8 else 32,
            "shared_relation_rows": rows,
            "relation_rows": num_rel,
            "relation_path": ("shared" if rows == num_rel
                              else "shared and global"),
            "relation_shared_bytes": kge_rel_shared_bytes(rows, width, vec,
                                                          len(rels))}


def _mean_scratch(grid_fn, items: int, vec: int, device) -> tuple:
    """The masked mean's device count (zero), per-block partials and loss."""
    with torch.cuda.device(device):
        grid = grid_fn(items, vec)
    return (torch.zeros((1,), dtype=torch.int32, device=device),
            torch.empty((grid,), dtype=torch.float32, device=device),
            torch.empty((), dtype=torch.float32, device=device))


def _check_pair(ent, rel, pos, neg, valid, score: str) -> tuple:
    """The checks of K19's entries.  ``pos`` (B, 3) and ``neg`` (B, K, 3)
    int32 with components in range, ``valid`` (B,) uint8.  Returns (D, P,
    vec): P the relation rows' width (D, or D / 2 for RotatE)."""
    if score not in KGE_SCORES:
        raise ValueError(f"unknown score {score!r}; expected one of "
                         f"{tuple(KGE_SCORES)}")
    if not isinstance(ent, torch.Tensor) or ent.dtype not in _TABLE_DTYPES:
        raise ValueError("the tables must be float32 or bfloat16 tensors")
    dev = ent.device
    _check("ent", ent, ent.dtype, 2)
    _check("rel", rel, ent.dtype, 2, dev)
    _check("pos", pos, torch.int32, 2, dev)
    _check("neg", neg, torch.int32, 3, dev)
    _check("valid", valid, torch.uint8, 1, dev)
    num_ent, dim = ent.shape
    width = dim // 2 if score == "rotate" else dim
    if score == "rotate" and dim % 2:
        raise ValueError(f"rotate needs an even dim, got {dim}")
    if rel.shape[1] != width or rel.shape[0] < 1 or num_ent < 1:
        raise ValueError(f"rel must be (R, {width}) beside ent "
                         f"{tuple(ent.shape)}, got {tuple(rel.shape)}")
    if not 1 <= width <= dim <= KGE_MAX_DIM or num_ent >= 2 ** 31:
        raise ValueError(f"tables of shape {tuple(ent.shape)} are not "
                         f"supported (dim <= {KGE_MAX_DIM})")
    b = pos.shape[0]
    if pos.shape[1] != 3 or neg.shape[0] != b or neg.shape[2] != 3 or (
            valid.shape[0] != b):
        raise ValueError(f"pos (B, 3), neg (B, K, 3) and valid (B,) expected,"
                         f" got {tuple(pos.shape)}, {tuple(neg.shape)} and "
                         f"{tuple(valid.shape)}")
    if b < 1:
        raise ValueError("at least one positive is required")
    return dim, width, _vec_width((ent, rel), width)


def _kge_pair(ent, rel, pos, neg, valid, score: str, margin: float,
              grads: bool, grad_loss=None):
    dim, width, vec = _check_pair(ent, rel, pos, neg, valid, score)
    dev = ent.device
    count, partial, loss = _mean_scratch(library().trw_kge_pair_grid,
                                         pos.shape[0], vec, dev)
    grad_ent = grad_rel = None
    if grads:
        grad_ent = torch.zeros(ent.shape, dtype=torch.float32, device=dev)
        grad_rel = torch.zeros(rel.shape, dtype=torch.float32, device=dev)
    call = _KgePairCall(
        ent=_ptr(ent), rel=_ptr(rel), pos=_ptr(pos), neg=_ptr(neg),
        valid=_ptr(valid), count=_ptr(count), partial=_ptr(partial),
        loss=_ptr(loss), grad_loss=_ptr(grad_loss), grad_ent=_ptr(grad_ent),
        grad_rel=_ptr(grad_rel), num_pos=pos.shape[0],
        num_neg=neg.shape[1], num_ent=ent.shape[0], num_rel=rel.shape[0],
        dim=dim, score=KGE_SCORES[score], elem_bytes=ent.element_size(),
        vec=vec, margin=float(margin),
        rel_shared_rows=(_shared_relation_rows(rel.shape[0], width, vec, 1)
                         if grads else 0))
    name = "kge_pair_loss_and_grads" if grads else "kge_pair_loss"
    _launch(name, getattr(library(), "trw_" + name), _device_index(dev),
            ctypes.byref(call))
    return loss, grad_ent, grad_rel


def kge_pair_loss(ent, rel, pos, neg, valid, score: str,
                  margin: float) -> torch.Tensor:
    """K19, loss only: the masked-mean logistic NEG loss of the pair
    objective ``score`` ("transe", "distmult", "rotate"), a float32 scalar on
    the device; equal inputs give equal bits.  ``ent`` (N_e, D), ``rel``
    (N_r, D) or, for RotatE, (N_r, D / 2) phases; ``pos`` (B, 3) and ``neg``
    (B, K, 3) int32 triples with every component in range; ``valid`` (B,)
    uint8, a positive's weight."""
    return _kge_pair(ent, rel, pos, neg, valid, score, margin, False)[0]


def kge_pair_loss_and_grads(ent, rel, pos, neg, valid, score: str,
                            margin: float, grad_loss=None):
    """K19, the loss and its gradient in one pass: (the loss, K19's loss-only
    bits; the float32 gradients of ``ent`` and ``rel``, times the float32
    device scalar ``grad_loss`` where it is given)."""
    if grad_loss is not None:
        _check("grad_loss", grad_loss, torch.float32, 0, ent.device)
    return _kge_pair(ent, rel, pos, neg, valid, score, margin, True,
                     grad_loss)


def _check_kge_windows(tables, center, pos, neg, cbow: bool) -> tuple:
    """The checks of K20's entries.  ``tables`` (ent_in, rel_in, ent_out,
    rel_out) of one type and width D.  Skip-gram: ``center`` the targets
    (B, 3), ``pos`` and ``neg`` (B, C, 3); CBOW: ``center`` the windows (B,
    C, 3), ``pos`` and ``neg`` (B, 3).  Returns (B, C, D, vec)."""
    ent = tables[0]
    if not isinstance(ent, torch.Tensor) or ent.dtype not in _TABLE_DTYPES:
        raise ValueError("the tables must be float32 or bfloat16 tensors")
    dev = ent.device
    for name, t in zip(("ent_in", "rel_in", "ent_out", "rel_out"), tables):
        _check(name, t, ent.dtype, 2, dev)
    one, many = (pos, center) if cbow else (center, pos)
    _check("windows" if cbow else "targets", center, torch.int32,
           3 if cbow else 2, dev)
    _check("pos", pos, torch.int32, 2 if cbow else 3, dev)
    _check("neg", neg, torch.int32, 2 if cbow else 3, dev)
    num_ent, dim = ent.shape
    num_rel = tables[1].shape[0]
    if (tables[2].shape != ent.shape or tables[3].shape != tables[1].shape
            or tables[1].shape[1] != dim or num_rel < 1 or num_ent < 1):
        raise ValueError("ent_in and ent_out must be (N_e, D), rel_in and "
                         "rel_out (N_r, D)")
    if not 1 <= dim <= KGE_MAX_DIM or num_ent >= 2 ** 31:
        raise ValueError(f"tables of shape {tuple(ent.shape)} are not "
                         f"supported (dim <= {KGE_MAX_DIM})")
    b = one.shape[0]
    if (one.shape != (b, 3) or many.shape[0] != b or many.shape[2] != 3
            or neg.shape != pos.shape):
        raise ValueError("windows of mismatched shapes: "
                         f"{tuple(center.shape)}, {tuple(pos.shape)}, "
                         f"{tuple(neg.shape)}")
    if b < 1 or many.shape[1] < 1:
        raise ValueError("at least one window of one slot is required")
    return b, many.shape[1], dim, _vec_width(tables, dim)


def _kge_windows(tables, center, pos, neg, padding_idx: int, cbow: bool,
                 grads: bool, grad_loss=None):
    b, cols, dim, vec = _check_kge_windows(tables, center, pos, neg, cbow)
    dev = tables[0].device
    count, partial, loss = _mean_scratch(library().trw_kge_windows_grid, b,
                                         vec, dev)
    gts = [None] * 4
    if grads:
        gts = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
               for t in tables]
    call = _KgeWindowsCall(
        ent_in=_ptr(tables[0]), rel_in=_ptr(tables[1]),
        ent_out=_ptr(tables[2]), rel_out=_ptr(tables[3]),
        center=_ptr(center), pos=_ptr(pos), neg=_ptr(neg), count=_ptr(count),
        partial=_ptr(partial), loss=_ptr(loss), grad_loss=_ptr(grad_loss),
        grad_ent_in=_ptr(gts[0]), grad_rel_in=_ptr(gts[1]),
        grad_ent_out=_ptr(gts[2]), grad_rel_out=_ptr(gts[3]),
        num_windows=b, cols=cols, num_ent=tables[0].shape[0],
        num_rel=tables[1].shape[0], dim=dim,
        padding_idx=int(padding_idx), cbow=int(cbow),
        elem_bytes=tables[0].element_size(), vec=vec,
        rel_shared_rows=(_shared_relation_rows(tables[1].shape[0], dim, vec,
                                               2) if grads else 0))
    name = "kge_windows_loss_and_grads" if grads else "kge_windows_loss"
    _launch(name, getattr(library(), "trw_" + name), _device_index(dev),
            ctypes.byref(call))
    return loss, gts


def kge_windows_loss(tables, a, b, c, padding_idx: int,
                     cbow: bool = False) -> torch.Tensor:
    """K20, loss only: the masked-mean skip-gram (``a, b, c`` = targets (B,
    3), positive and negative windows (B, C, 3)) or CBOW (``a, b, c`` =
    positive and negative triples (B, 3), windows (B, C, 3)) loss over
    composed triples, a float32 scalar on the device; equal inputs give equal
    bits.  ``tables`` (ent_in, rel_in, ent_out, rel_out), (N, D) each; the
    argument order is the JAX loss functions'."""
    center, pos, neg = (c, a, b) if cbow else (a, b, c)
    return _kge_windows(tables, center, pos, neg, padding_idx, cbow,
                        False)[0]


def kge_windows_loss_and_grads(tables, a, b, c, padding_idx: int,
                               cbow: bool = False, grad_loss=None):
    """K20, the loss and its gradient in one pass: (the loss, K20's loss-only
    bits; the four float32 gradient tables, times the float32 device scalar
    ``grad_loss`` where it is given)."""
    if grad_loss is not None:
        _check("grad_loss", grad_loss, torch.float32, 0, tables[0].device)
    center, pos, neg = (c, a, b) if cbow else (a, b, c)
    return _kge_windows(tables, center, pos, neg, padding_idx, cbow, True,
                        grad_loss)


# The routed phase kernels (K11-K15) take up to 256 shards (routed.cuh
# kRoutedMaxShards).  K11, K12: a phase is two launches, the body kernel and
# the compaction kernel, counted as one call.  K13-K15: one cooperative
# launch runs up to a walk's phases, counted as one call.  Phase 0 is a
# histogram launch and the compaction kernel, counted as one call of the
# engine's kernel.  The compaction ranks tiles of ROUTED_TILE slots.
ROUTED_MAX_SHARDS = 256
ROUTED_TILE = 256
ROUTED_STREAMS = {3: 2, 14: 4, 4: 2, 15: 4}  # departure streams by width


class RoutedEngine(NamedTuple):
    """A routed engine's record width, its kernel (its label, the name of
    its wrapper and launch count, and its C entry point), whether it is a
    family engine (K13-K15: a fourth stats column, terminated walkers; walk
    rows filled with the padding id) and whether its kernel is the
    persistent batch kernel (K13-K15: phases a launch, ``routed_batch``)
    or a phase a call."""

    width: int
    label: str
    kernel: str
    entry: str
    family: bool
    batch: bool = False


ROUTED_ENGINES = {
    "uniform": RoutedEngine(3, "K11", "routed_uniform_phase",
                            "trw_routed_uniform_phase", False),
    "node2vec": RoutedEngine(14, "K12", "routed_node2vec_phase",
                             "trw_routed_node2vec_phase", False),
    "triples": RoutedEngine(4, "K13", "routed_triples_batch",
                            "trw_routed_triples_batch", True, True),
    "edge_list": RoutedEngine(4, "K14", "routed_edge_list_batch",
                              "trw_routed_edge_list_batch", True, True),
    "edge_list_node2vec": RoutedEngine(
        15, "K15", "routed_edge_list_node2vec_batch",
        "trw_routed_edge_list_node2vec_batch", True, True),
}
_ROUTED_SHARD_FIELDS = ("meta", "col", "walks", "inbox", "outbox", "carry",
                        "stage", "code", "hist", "pool_count", "hash_table",
                        "bloom")


def routed_flow_words(num_shards: int) -> int:
    """Words of one parity of a batch pipeline's flow counts (routed.cuh
    ``flow_words``): the (D, D) records each shard boxed for each
    destination, each destination's records in, and the largest box
    count."""
    return num_shards * num_shards + num_shards + 1


def routed_scratch_shapes(num_shards: int, cap: int, ccap: int, blk: int,
                          width: int) -> dict:
    """Per shard, the shapes of the phase kernels' scratch for one walk:
    ``stage`` and ``code`` (a phase stages D*cap slots, phase 0 blk),
    ``hist`` (the stage tiles' departures by stream and destination, for a
    phase's streams or phase 0's one) and, per pipeline, ``pool_count``
    (each of the two carry pools' records by tile and destination, and a
    last row of totals)."""
    def tiles(n):
        return -(-n // ROUTED_TILE)
    slots = max(num_shards * cap, blk)
    hist = max(tiles(num_shards * cap) * ROUTED_STREAMS[width], tiles(blk))
    return {"stage": (slots, width), "code": (slots,),
            "hist": (hist * num_shards,),
            "pool_count": (2, tiles(ccap) + 1, num_shards)}


class RoutedShard(NamedTuple):
    """One shard's buffers for a routed phase kernel (``routed.cuh``
    ``RoutedShard``): its (S, 2) meta rows and its payload ``col`` ((E_max,)
    neighbour ids or tails; K13: (E_max, 2) [relation, tail] rows), its
    (blk+1, walk_cols) walk rows, this pipeline's (D, cap, R) inbox and
    outbox and its two (ccap, R+1) carry pools as one (2, ccap, R+1)
    tensor, the stage, code and hist scratch and the pipeline's pool counts
    (``routed_scratch_shapes``), and for K12 and K15 its cuckoo table (or
    None: K12's binary search) and (S, 4) Bloom filters, all int32 on one
    card."""

    meta: torch.Tensor
    col: torch.Tensor
    walks: torch.Tensor
    inbox: torch.Tensor
    outbox: torch.Tensor
    carry: torch.Tensor
    stage: torch.Tensor
    code: torch.Tensor
    hist: torch.Tensor
    pool_count: torch.Tensor
    hash_table: torch.Tensor | None
    bloom: torch.Tensor | None
    salt: int


class _RoutedLaunch(ctypes.Structure):
    """``TrwRoutedLaunch`` of ``kernels/routed.cuh``."""

    _fields_ = [("shards", ctypes.c_void_p), ("stats", ctypes.c_void_p),
                ("live", ctypes.c_void_p), ("live_all", ctypes.c_void_p),
                ("phases", ctypes.c_void_p), ("num_live", _I32),
                ("num_shards", _I32), ("shard_nodes", _I32), ("blk", _I32),
                ("walk_length", _I32), ("cap", _I32), ("ccap", _I32),
                ("e_max", _I64), ("key0", _U32), ("key1", _U32),
                ("spec_rounds", _I32), ("hash_log", _I32),
                ("use_search", _I32), ("prob0", _F32), ("prob1", _F32),
                ("prob2", _F32), ("lo_acc", _F32), ("hi_acc", _F32),
                ("stats_width", _I32), ("walk_cols", _I32),
                ("padding", _I32), ("restart", _I32),
                ("flow", ctypes.c_void_p)]


class RoutedLaunch(NamedTuple):
    """A routed pipeline's phase launch, packed once: the scalars
    (``launch``, at ``address``), the device table of the shards' pointers
    and the buffers it points to (held, so that the pointers stay valid),
    the card, the engine it was packed for (a key of ``ROUTED_ENGINES``),
    and whether every shard's outbox, inbox and stage start on 16 bytes and
    a chunk's words are a multiple of 4 (the batch kernel's 16-byte
    copies)."""

    launch: _RoutedLaunch
    address: int
    table: torch.Tensor
    buffers: tuple
    device_index: int
    engine: str
    aligned: bool


def routed_phase_launch(shards, stats, live, live_all, phases, *,
                        shard_nodes: int, blk: int, walk_length: int,
                        cap: int, ccap: int, key: tuple[int, int],
                        node2vec=None, engine: str | None = None,
                        padding: int = 0, restart: bool = False,
                        flow: torch.Tensor | None = None) -> RoutedLaunch:
    """Check one pipeline's buffers for the phase kernel of ``engine`` (a
    key of ``ROUTED_ENGINES``; by default K11, or K12 where ``node2vec``, a
    ``parallel.partition_v2.Node2VecRouting``, is given, which K15 needs
    too) and pack their launch.  ``stats`` is the walk's (D, 3) int64
    (logged, sent, dropped; the family engines' (D, 4) adds terminated),
    ``live`` the pipeline's (D, 2) int64 (boxed, carried), ``live_all``
    every pipeline's live counts (int64, contiguous: the phase counts
    itself if any is above 0) and ``phases`` the walk's (1,) int64 phase
    counter.  The walk rows are (blk+1, L+2), K13's (blk+1, 2L+2);
    ``padding`` and ``restart`` are the family engines' (K13-K15).  ``flow``
    is the pipeline's (2, ``routed_flow_words(D)``) int32 outbox counts,
    which the batch engines (K13-K15) need and the others take not."""
    if engine is None:
        engine = "uniform" if node2vec is None else "node2vec"
    if engine not in ROUTED_ENGINES:
        raise ValueError(f"engine must be one of {tuple(ROUTED_ENGINES)}, got "
                         f"{engine!r}")
    spec = ROUTED_ENGINES[engine]
    needs_routing = engine in ("node2vec", "edge_list_node2vec")
    if needs_routing != (node2vec is not None):
        raise ValueError(f"the {engine} engine takes "
                         f"{'a' if needs_routing else 'no'} node2vec routing")
    d = len(shards)
    if not 0 < d <= ROUTED_MAX_SHARDS:
        raise ValueError(f"the phase kernels take 1 to {ROUTED_MAX_SHARDS} "
                         f"shards, got {d}")
    width = spec.width
    nstats = 4 if spec.family else 3
    walk_cols = (2 * walk_length + 2 if engine == "triples"
                 else walk_length + 2)
    dev = shards[0].col.device
    _check("stats", stats, torch.int64, 2, dev)
    _check("live", live, torch.int64, 2, dev)
    _check("phases", phases, torch.int64, 1, dev)
    if not (isinstance(live_all, torch.Tensor) and live_all.is_cuda
            and live_all.device == dev and live_all.dtype == torch.int64
            and live_all.is_contiguous() and 0 < live_all.numel() < 2 ** 31):
        raise ValueError("live_all must be a contiguous int64 CUDA tensor on "
                         "the shards' card")
    if tuple(stats.shape) != (d, nstats) or tuple(live.shape) != (d, 2):
        raise ValueError(f"stats must be ({d}, {nstats}) and live ({d}, 2), "
                         f"got {tuple(stats.shape)} and {tuple(live.shape)}")
    if tuple(phases.shape) != (1,):
        raise ValueError(f"phases must be (1,), got {tuple(phases.shape)}")
    if not (0 < shard_nodes < 2 ** 31 and 0 < blk < 2 ** 31 and 0 < cap
            and 0 < ccap < 2 ** 31 and 0 <= walk_length
            and d * cap < 2 ** 31 and walk_cols < 2 ** 31):
        raise ValueError("shard sizes or capacities out of range")
    if width >= 14 and walk_length >= 2 ** 24:
        raise ValueError(f"walk_length must be below 2^24, got {walk_length}")
    if spec.family and not -2 ** 31 <= padding < 2 ** 31:
        raise ValueError(f"padding {padding} is no int32 id")
    if spec.batch != (flow is not None):
        raise ValueError(f"the {engine} engine takes "
                         f"{'a' if spec.batch else 'no'} flow buffer")
    if flow is not None:
        _check("flow", flow, torch.int32, 2, dev)
        if tuple(flow.shape) != (2, routed_flow_words(d)):
            raise ValueError(f"flow must be (2, {routed_flow_words(d)}), got "
                             f"{tuple(flow.shape)}")
    e_max = shards[0].col.shape[0]
    shapes = {"meta": (shard_nodes, 2),
              "col": (e_max, 2) if engine == "triples" else (e_max,),
              "walks": (blk + 1, walk_cols), "inbox": (d, cap, width),
              "outbox": (d, cap, width), "carry": (2, ccap, width + 1),
              "bloom": (shard_nodes, 4),
              **routed_scratch_shapes(d, cap, ccap, blk, width)}
    rows, buffers = [], []
    for sh in shards:
        if needs_routing and sh.bloom is None:
            raise ValueError(f"the {engine} engine needs each shard's Bloom "
                             f"filters")
        ptrs = []
        for name in _ROUTED_SHARD_FIELDS:
            t = getattr(sh, name)
            if t is None:
                ptrs.append(0)
                continue
            if name == "hash_table":
                _check(name, t, torch.int32, 2, dev)
                if t.shape[0] != 1 << node2vec.log_size or t.shape[1] != 2:
                    raise ValueError(f"hash table of shape {tuple(t.shape)} "
                                     f"for log_size {node2vec.log_size}")
            else:
                _check(name, t, torch.int32, len(shapes[name]), dev)
                if tuple(t.shape) != shapes[name]:
                    raise ValueError(f"{name} must be {shapes[name]}, got "
                                     f"{tuple(t.shape)}")
            ptrs.append(t.data_ptr())
            buffers.append(t)
        rows.append(ptrs + [int(sh.salt) & 0xFFFFFFFF])
    if e_max < 1:
        raise ValueError("every shard's col must hold at least one row")
    table = torch.tensor(rows, dtype=torch.int64).to(dev)
    launch = _RoutedLaunch(table.data_ptr(), stats.data_ptr(), live.data_ptr(),
                           live_all.data_ptr(), phases.data_ptr(),
                           live_all.numel(), d, shard_nodes, blk, walk_length,
                           cap, ccap, e_max, key[0] & 0xFFFFFFFF,
                           key[1] & 0xFFFFFFFF)
    launch.stats_width = nstats
    launch.walk_cols = walk_cols
    launch.padding = int(padding) if spec.family else 0
    launch.restart = int(bool(restart))
    if flow is not None:
        launch.flow = flow.data_ptr()
        buffers.append(flow)
    if node2vec is not None:
        search = node2vec.tables is None
        if search and engine == "edge_list_node2vec":
            raise ValueError("the edge_list_node2vec engine needs the cuckoo "
                             "tables")
        if not search and not 0 < node2vec.log_size < 32:
            raise ValueError(f"log_size {node2vec.log_size} out of range")
        if not search and any(sh.hash_table is None for sh in shards):
            raise ValueError("every shard needs its cuckoo table")
        launch.spec_rounds = node2vec.spec_rounds
        launch.hash_log = node2vec.log_size
        launch.use_search = int(search)
        (launch.prob0, launch.prob1, launch.prob2, launch.lo_acc,
         launch.hi_acc) = node2vec.thresholds
    aligned = (cap * width) % 4 == 0 and all(
        getattr(sh, name).data_ptr() % 16 == 0
        for sh in shards for name in ("inbox", "outbox", "stage"))
    return RoutedLaunch(launch, ctypes.addressof(launch), table,
                        (*buffers, stats, live, live_all, phases),
                        _device_index(dev), engine, aligned)


def _routed_phase(engine: str, launch: RoutedLaunch, pool: int) -> None:
    if launch.engine != engine:
        raise ValueError(f"this launch was packed for "
                         f"{ROUTED_ENGINES[launch.engine].label}, not "
                         f"{ROUTED_ENGINES[engine].label}")
    spec = ROUTED_ENGINES[engine]
    _launch(spec.kernel, getattr(library(), spec.entry), launch.device_index,
            launch.address, int(pool))


def routed_uniform_phase(launch: RoutedLaunch, pool: int) -> None:
    """K11.  One phase of the uniform routed engine for every shard: the
    pipeline's inboxes and live carry pools (``pool``, 0 or 1) in; its
    outboxes, other carry pools and live counts out; the walk rows, stats
    and phase counter updated."""
    _routed_phase("uniform", launch, pool)


def routed_node2vec_phase(launch: RoutedLaunch, pool: int) -> None:
    """K12.  One phase of the node2vec routed engine for every shard, as
    K11's."""
    _routed_phase("node2vec", launch, pool)


def routed_start(launch: RoutedLaunch) -> None:
    """Phase 0 of any routed engine, counted as one call of its kernel:
    compact the first ``blk`` stage slots of every shard (each local
    walker's first record, code its destination or -1) into the pipeline's
    outboxes, which the caller has reset to sentinel records, and carry
    pools 1 (pool 0 is empty; the caller has zeroed both pools' counts),
    and set the live counts."""
    spec = ROUTED_ENGINES[launch.engine]
    _launch(spec.kernel, library().trw_routed_start, launch.device_index,
            launch.address, spec.width)


# K13-K15: the persistent batch kernel, launched with as many blocks on each
# SM as the occupancy query allows (every block must be resident, for the
# kernel's grid barriers).  The C side numbers its kernels by label
# (routed_families.cu BatchKernel), not by record width, which K13 and K14
# share.
BATCH_KERNELS = ("K13", "K14", "K15")
_GEOMETRY_FIELDS = ("blocks_per_sm", "sms", "registers", "local_bytes",
                    "static_smem_bytes", "dynamic_smem_bytes")
_GEOMETRY_WORDS = len(_GEOMETRY_FIELDS) + 2  # and the kernel's address


class _RoutedBatch(ctypes.Structure):
    """``TrwRoutedBatch`` of ``kernels/routed_families.cu``."""

    _fields_ = [("pipe", _RoutedLaunch * 2), ("max_phases", _I64),
                ("num_pipes", _I32), ("first", _I32), ("cur", _I32 * 2),
                ("vec", _I32), ("resident", _I32)]


class RoutedBatch(NamedTuple):
    """A walk's batch launch, packed once: the scalars (``batch``, at
    ``address``; the phases, live pools and first pipeline are set at each
    launch), the pipelines' launches (held), the card, the engine, the grid
    it launches with (every resident block; at most ``batch.resident``) and
    the kernel's geometry (``routed_batch_geometry``)."""

    batch: _RoutedBatch
    address: int
    launches: tuple
    device_index: int
    engine: str
    grid: int
    geometry: dict


def routed_batch_geometry(engine: str, restart: bool, num_shards: int,
                          device_index: int | None = None) -> dict:
    """The batch kernel of ``engine`` (K13, or K14 or K15 by restart flag)
    at D shards on the card: its resident blocks per SM under a cooperative
    launch (0 where the card cannot launch one), the SMs, its registers,
    local (spill) bytes and static and dynamic shared bytes a block, and
    ``function``, the address of the kernel that answered."""
    spec = ROUTED_ENGINES[engine]
    if not spec.batch:
        raise ValueError(f"the {engine} engine has no batch kernel")
    out = (ctypes.c_uint32 * _GEOMETRY_WORDS)()
    if device_index is None:
        device_index = torch.cuda.current_device()
    with torch.cuda.device(device_index):
        rc = library().trw_routed_batch_geometry(
            BATCH_KERNELS.index(spec.label), int(bool(restart)),
            int(num_shards), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"routed_batch_geometry: CUDA error code {rc}")
    words = list(out)
    return {**dict(zip(_GEOMETRY_FIELDS, words)),
            "function": words[-2] | words[-1] << 32}


def routed_batch_launch(launches) -> RoutedBatch:
    """Pack the batch launch of a walk's pipelines (``launches``: one
    ``RoutedLaunch`` under the serial schedule, two under the overlapped
    one, packed for K13, K14 or K15 with their flow buffers).  Raises where
    the card cannot hold a block of the kernel resident (no cooperative
    launch is possible)."""
    launches = tuple(launches)
    if not 1 <= len(launches) <= 2:
        raise ValueError(f"a walk has one or two pipelines, got "
                         f"{len(launches)}")
    engine = launches[0].engine
    spec = ROUTED_ENGINES[engine]
    if not spec.batch or any(x.engine != engine for x in launches):
        raise ValueError(f"the batch kernel runs K13, K14 or K15 launches, "
                         f"got {[x.engine for x in launches]}")
    dev_index = launches[0].device_index
    if any(x.device_index != dev_index for x in launches):
        raise ValueError("the pipelines' launches are on different cards")
    if spec.width == 4 and not all(x.aligned for x in launches):
        raise ValueError(f"{spec.label}'s inboxes and stages must start on 16 "
                         f"bytes (K13's and K14's records are 16-byte words)")
    a = launches[0].launch
    geometry = routed_batch_geometry(engine, bool(a.restart), a.num_shards,
                                     dev_index)
    per_sm = geometry["blocks_per_sm"]
    if per_sm < 1:
        raise RuntimeError(f"{spec.label}'s batch kernel has no resident "
                           f"block on this card: {geometry}")
    batch = _RoutedBatch()
    for p, x in enumerate(launches):
        batch.pipe[p] = x.launch
    batch.num_pipes = len(launches)
    batch.vec = int(all(x.aligned for x in launches))
    batch.resident = per_sm * geometry["sms"]
    return RoutedBatch(batch, ctypes.addressof(batch), launches, dev_index,
                       engine, batch.resident, geometry)


def _routed_batch(engine: str, batch: RoutedBatch, phases: int, pools,
                  first: int) -> None:
    if batch.engine != engine:
        raise ValueError(f"this batch was packed for "
                         f"{ROUTED_ENGINES[batch.engine].label}, not "
                         f"{ROUTED_ENGINES[engine].label}")
    spec = ROUTED_ENGINES[engine]
    b = batch.batch
    b.max_phases = int(phases)
    for p, cur in enumerate(pools):
        b.cur[p] = int(cur)
    b.first = int(first)
    _launch(spec.kernel, getattr(library(), spec.entry), batch.device_index,
            batch.address, int(batch.grid))


def routed_triples_batch(batch: RoutedBatch, phases: int, pools,
                         first: int = 0) -> None:
    """K13.  Up to ``phases`` phases of the routed KG-triples engine for
    every shard, in one cooperative launch, as K14's; the stats' fourth
    column counts the walkers that end."""
    _routed_batch("triples", batch, phases, pools, first)


def routed_edge_list_batch(batch: RoutedBatch, phases: int, pools,
                           first: int = 0) -> None:
    """K14.  Up to ``phases`` phases of the routed uniform edge-list engine
    for every shard, in one cooperative launch: under the serial schedule
    each phase exchanges the pipeline and processes it; under the
    overlapped one each interval exchanges one pipeline (``first`` in the
    first interval) while it processes the other, and the roles swap.
    ``pools`` is each pipeline's live carry pool (0 or 1) at the start.  It
    stops early once nothing is in flight; the walk's phase counter counts
    the phases run."""
    _routed_batch("edge_list", batch, phases, pools, first)


def routed_edge_list_node2vec_batch(batch: RoutedBatch, phases: int, pools,
                                    first: int = 0) -> None:
    """K15.  The same for the routed biased (p/q) edge-list engine."""
    _routed_batch("edge_list_node2vec", batch, phases, pools, first)
