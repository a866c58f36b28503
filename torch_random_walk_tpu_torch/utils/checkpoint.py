"""Checkpoint and resume of the trainers' state (PyTorch twin of
``torch_random_walk_tpu/utils/checkpoint.py``).

A state is anything with ``state_dict()`` and ``load_state_dict()``: a
trainer's model (``SkipGramModel``, ``CBOWModel``, ``KGEModel``), whose state
dict holds the tables and, through ``AdamTables.get_extra_state``, the
optimizer's moments, step count, touched-rows state or custom optimizer, so
that a resumed run continues exactly where the saved one stood.

A checkpoint directory holds ``step_{k}.pt``, ``torch.save`` of the state
dict with every tensor copied to the host, and ``meta.json``,
``{"step": k, **metadata}``, the step of the newest checkpoint.  Steps are
numbered as in the JAX package: the checkpoint at k holds the state after k
steps.  Both files are written under a temporary name and renamed, so an
interrupted save leaves the previous checkpoint whole.  ``restore`` reads
with ``torch.load(weights_only=True)`` (tensors and plain containers, no
code) and loads the payload into the given state in place, onto the
state's own devices.  Older step files are kept, as the JAX package keeps
them.
"""

from __future__ import annotations

import json
import os

import torch


def host_copy(obj):
    """A copy of a state dict whose tensors are detached copies on the host
    (copies also of host tensors, so that in-place steps leave it as it
    was)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def _replace_atomically(path: str, write) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       f".tmp_{os.getpid()}_{os.path.basename(path)}")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def payload_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.pt")


def save(path: str, state, step: int, metadata: dict | None = None) -> None:
    """Save ``state.state_dict()`` at ``step``; the payload first, then the
    meta file that names it, each by an atomic rename."""
    os.makedirs(path, exist_ok=True)
    host = host_copy(state.state_dict())
    _replace_atomically(payload_path(path, step),
                        lambda tmp: torch.save(host, tmp))
    meta = {"step": step, **(metadata or {})}

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _replace_atomically(os.path.join(path, "meta.json"), write_meta)


def latest_step(path: str) -> int | None:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)["step"]


def restore(path: str, state, step: int | None = None):
    """Load the checkpoint at ``step`` (default: the newest) into ``state``
    in place.  Returns (state, step), or (None, None), with ``state``
    untouched, where the directory holds no checkpoint."""
    if step is None:
        step = latest_step(path)
    if step is None:
        return None, None
    payload = torch.load(payload_path(path, step), map_location="cpu",
                         weights_only=True)
    state.load_state_dict(payload)
    return state, step
