"""Tracing and timing helpers (PyTorch twin of
``torch_random_walk_tpu/utils/profiling.py``).

``trace`` captures ``torch.profiler`` activity (the host's, and the card's
where there is one) and writes a Chrome trace; ``annotate`` names a region
in that trace and, on the card, as an NVTX range.  CUDA launches return
before the device has run them, so ``sync`` and ``StepTimer`` read a
device-side checksum back and synchronise the device: a time includes the
work, and a fault of the timed calls surfaces there.

The JAX package's ``honor_jax_platforms_env`` has no counterpart: the port
picks its device by argument (``device=None`` is the card, the CPU only when
named), and the command-line entry points take ``--device``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from torch_random_walk_tpu_torch.utils.device import synchronize


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/trace_{pid}_{ns}.json`` (Chrome trace format); yields the
    profiler, whose ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler traces (a context manager): a
    ``record_function`` range, and an NVTX range where there is a card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out.detach()]
    if isinstance(out, torch.nn.Module):
        return [p.detach() for p in out.parameters()]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _leaves(x)]
    return []


def checksum(out) -> torch.Tensor:
    """Device-side float64 scalar: the sum of every tensor in ``out`` (a
    tensor, a module's parameters, or dicts, lists and tuples of them);
    reading it back forces the work that made them."""
    leaves = _leaves(out)
    if not leaves:
        return torch.zeros((), dtype=torch.float64)
    return sum(x.sum(dtype=torch.float64) for x in leaves)


def sync(out) -> float:
    """Read back a scalar derived from ``out`` and synchronise the device
    (the fault-surfacing barrier)."""
    value = float(checksum(out))
    synchronize()
    return value


class StepTimer:
    """Wall-clock timer for step functions.

    >>> timer = StepTimer()
    >>> dt = timer.time(fn, *args, iters=5)   # seconds per call
    """

    def time(self, fn, *args, warmup: int = 2, iters: int = 5) -> float:
        for _ in range(warmup):
            sync(fn(*args))
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        sync(out)
        return (time.perf_counter() - t0) / iters
