"""Failure detection and elastic resumption for long-running jobs (PyTorch
twin of ``torch_random_walk_tpu/utils/elastic.py``).

- **Preemption** arrives as SIGTERM shortly before the machine goes away
  (SIGINT is treated alike): the job gets one chance to checkpoint.
- **Device faults.**  ``run_resumable`` restores the last checkpoint and
  replays on ``torch.cuda.OutOfMemoryError`` and on the exception types a
  caller adds in ``ElasticConfig.retryable``.  It does not replay other CUDA
  errors: an illegal address, a launch failure or an assertion on the
  device is sticky, the context is lost and every later call of the process
  fails with it, so only a new process recovers, and that process resumes
  from the last checkpoint by restore-on-start.  A kernel's fault surfaces
  at a later call, the launches being asynchronous, so the loop synchronises
  the device before each checkpoint: a fault of the steps before it is
  raised inside the retry net, never saved.
- **Resume** continues at exactly the next step: every draw of the walks,
  negatives and windows is keyed by (seed, step) Threefry counters.  On the
  CPU a resumed run is bit-identical to an uninterrupted one wherever two
  uninterrupted runs are: PyTorch's CPU scatter-adds of the gradients run
  on several threads in a run's own order once a batch is large enough,
  unless ``torch.use_deterministic_algorithms(True)``.  On the card the
  gradient kernels add rows with float atomics in a run's own order, so two
  runs differ in the last bits of the tables, resumed or not.

Three pieces, composing ``utils.checkpoint`` and ``utils.logging``:

- ``Heartbeat``: a per-step liveness file that an external watchdog polls
  (``Heartbeat.is_stalled``).
- ``run_resumable``: a step function with restore-on-start,
  checkpoint-every-N, checkpoint-and-return on SIGTERM/SIGINT, and
  restore-and-replay retries on faults.
- ``ElasticResult``: what happened (completed, preempted, resumed from).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time

import torch

from torch_random_walk_tpu_torch.utils import checkpoint
from torch_random_walk_tpu_torch.utils.device import synchronize
from torch_random_walk_tpu_torch.utils.logging import get_logger


class Heartbeat:
    """Atomic JSON liveness file: ``{"ts": ..., "step": ..., **info}``.

    The trainer beats it each step; an external watchdog (or a peer host)
    polls ``is_stalled`` to detect a hung device without being in-process.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def beat(self, step: int, **info) -> None:
        record = {"ts": time.time(), "step": int(step), **info}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self.path)

    @staticmethod
    def read(path: str) -> dict | None:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    @staticmethod
    def is_stalled(path: str, timeout_sec: float, now: float | None = None
                   ) -> bool:
        """True if the heartbeat is absent or older than ``timeout_sec``."""
        record = Heartbeat.read(path)
        if record is None:
            return True
        return ((now if now is not None else time.time())
                - record["ts"]) > timeout_sec


@dataclasses.dataclass
class ElasticConfig:
    ckpt_dir: str
    every_steps: int = 100          # checkpoint cadence
    heartbeat_path: str | None = None
    max_retries: int = 0            # restore-and-replay retries on faults
    retryable: tuple = ()           # extra exception types to treat as faults
    save_final: bool = True         # checkpoint after the last step


@dataclasses.dataclass
class ElasticResult:
    state: object
    steps_done: int                 # number of steps completed
    preempted: bool                 # stopped early on SIGTERM/SIGINT
    resumed_from: int | None        # checkpoint step resumed at start, if any
    retries_used: int


def run_resumable(step_fn, init_state, num_steps: int,
                  config: ElasticConfig) -> ElasticResult:
    """Run ``state = step_fn(state, step)`` for ``step in range(num_steps)``
    with restore-on-start, periodic checkpointing, preemption handling and
    fault replay.

    ``init_state`` has ``state_dict()`` and ``load_state_dict()`` (a
    trainer's model).  ``step_fn`` may update it in place and return it, as
    the trainers' ``epoch_step`` does.  A checkpoint in ``config.ckpt_dir``
    is loaded into ``init_state`` at start.  Checkpoints save the state
    after step ``k`` under step number ``k + 1`` (the steps completed), so a
    resumed run continues at exactly the next step.

    Replay before the first checkpoint: the JAX package's step functions are
    functional, so it replays from ``init_state``, which is still intact.
    The port's trainers update in place and the initial state is gone after
    the first step, so where ``max_retries > 0`` and no checkpoint was
    restored at start, a host copy of the initial state dict is kept for the
    whole run, and a replay before the first checkpoint loads a copy of it.
    That costs one device-to-host copy at start and host memory of one
    checkpoint (float32 tables and their Adam moments: 7.5 GB at the
    ogbn-products size, 2.45 M nodes at dim 128).
    """
    log = get_logger("elastic")
    state, done = init_state, 0
    restored, ckpt_step = checkpoint.restore(config.ckpt_dir, state)
    resumed_from = None
    if restored is not None:
        done = resumed_from = ckpt_step
        log.info("resumed from checkpoint at step %d", ckpt_step)
    initial = (checkpoint.host_copy(state.state_dict())
               if restored is None and config.max_retries > 0 else None)

    heartbeat = (Heartbeat(config.heartbeat_path)
                 if config.heartbeat_path else None)
    stop = {}

    def _handler(signum, frame):
        stop["signal"] = signum

    old_handlers = {}
    in_main = threading.current_thread() is threading.main_thread()
    if in_main:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _handler)

    fault_types = (torch.cuda.OutOfMemoryError, *config.retryable)
    retries_used = 0
    preempted = False
    try:
        while done < num_steps:
            if stop:
                log.warning("signal %s: checkpointing at step %d and "
                            "stopping", stop["signal"], done)
                synchronize()
                checkpoint.save(config.ckpt_dir, state, done)
                preempted = True
                break
            try:
                new_state = step_fn(state, done)
                if (done + 1) % config.every_steps == 0:
                    # Surface the queued steps' faults here, inside the
                    # retry net, never as a corrupt checkpoint.
                    synchronize()
            except fault_types as exc:
                if retries_used >= config.max_retries:
                    raise
                retries_used += 1
                log.warning("step %d failed (%s: %s); restoring last "
                            "checkpoint (retry %d/%d)", done,
                            type(exc).__name__, exc, retries_used,
                            config.max_retries)
                restored, ckpt_step = checkpoint.restore(config.ckpt_dir,
                                                         state)
                if restored is None:
                    state.load_state_dict(checkpoint.host_copy(initial))
                    done = 0
                else:
                    done = ckpt_step
                continue
            state, done = new_state, done + 1
            if heartbeat is not None:
                heartbeat.beat(done)
            if done % config.every_steps == 0 and done < num_steps:
                checkpoint.save(config.ckpt_dir, state, done)
        if not preempted and config.save_final and done > 0:
            synchronize()
            checkpoint.save(config.ckpt_dir, state, done)
    finally:
        if in_main:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
    return ElasticResult(state=state, steps_done=done, preempted=preempted,
                         resumed_from=resumed_from, retries_used=retries_used)
