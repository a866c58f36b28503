"""The port's checkpoints, elastic resume, heartbeat and profiling helpers
(``utils/checkpoint.py``, ``utils/elastic.py``, ``utils/profiling.py``), on
the CPU.

The invariant under test is the JAX package's ``tests/test_elastic.py``'s: a
run that is interrupted, preempted (SIGTERM at a step) or faulted and resumed
from a checkpoint is bit-identical to the uninterrupted run (tolerance 0),
because every draw is keyed by (seed, step) Threefry counters and the state
dict holds the tables and the whole optimizer state.  Against the JAX
package: the port's ``run_resumable`` over its ``Node2Vec``, started from the
JAX trainer's initial tables through ``convert.checkpoint_from_numpy``,
follows JAX's ``run_resumable`` over the JAX trainer: losses within rtol
1e-4 and tables within rtol 1e-3, atol 1e-5 after the run (float32 tables:
only the order of float32 sums differs), as
``tests/test_torch_node2vec_model.py`` holds the trainers step by step.
"""

import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_random_walk_tpu as trw
import torch_random_walk_tpu_torch as tt
from torch_random_walk_tpu.models import Node2Vec as JNode2Vec
from torch_random_walk_tpu.models import Node2VecConfig as JConfig
from torch_random_walk_tpu.utils import elastic as j_elastic
from torch_random_walk_tpu_torch import convert
from torch_random_walk_tpu_torch.utils import checkpoint, profiling
from torch_random_walk_tpu_torch.utils.elastic import (
    ElasticConfig,
    Heartbeat,
    run_resumable,
)

N = 64
CONFIG = dict(dim=8, walk_length=6, window_size=3)


def toy_edges():
    """The JAX elastic tests' toy graph: a ring and 2N random edges,
    symmetrized."""
    rng = np.random.default_rng(0)
    src = np.concatenate([np.arange(N), rng.integers(0, N, 2 * N)])
    dst = np.concatenate([(np.arange(N) + 1) % N, rng.integers(0, N, 2 * N)])
    return src, dst


@pytest.fixture(scope="module")
def graph():
    return tt.CSRGraph.from_edges(*toy_edges(), num_nodes=N, symmetrize=True,
                                  device="cpu")


def trainer(graph, **kw):
    return tt.Node2Vec(graph, tt.Node2VecConfig(**CONFIG, **kw),
                       device="cpu")


def make_step(n2v, losses=None):
    targets = torch.arange(N, dtype=torch.int32)

    def step_fn(model, step):
        loss = n2v.epoch_step(targets, step)
        if losses is not None:
            losses.append(float(loss))
        return model

    return step_fn


def snapshot(model) -> dict:
    """Every value the model's state dict carries, cloned."""
    return {"tables": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "mu": {n: m.clone() for n, m in model.mu.items()},
            "nu": {n: m.clone() for n, m in model.nu.items()},
            "count": model.count, "sparse_state": model.sparse_state}


def assert_same(a: dict, b: dict) -> None:
    assert a["count"] == b["count"] and a["sparse_state"] == b["sparse_state"]
    for key in ("tables", "mu", "nu"):
        assert a[key].keys() == b[key].keys()
        for name in a[key]:
            assert a[key][name].dtype == b[key][name].dtype
            assert torch.equal(a[key][name], b[key][name]), (key, name)


def run(graph, tmp_path, name, steps, every=100, step_fn=None, **cfg):
    n2v = trainer(graph)
    result = run_resumable(step_fn or make_step(n2v), n2v.init(), steps,
                           ElasticConfig(ckpt_dir=str(tmp_path / name),
                                         every_steps=every, **cfg))
    return n2v, result


def test_clean_run_and_final_checkpoint(graph, tmp_path):
    n2v, res = run(graph, tmp_path, "ck", 7, every=3)
    assert res.steps_done == 7 and not res.preempted
    assert res.resumed_from is None and res.state is n2v.model
    ck = str(tmp_path / "ck")
    assert checkpoint.latest_step(ck) == 7
    assert sorted(f for f in os.listdir(ck)) == [
        "meta.json", "step_3.pt", "step_6.pt", "step_7.pt"]
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f) == {"step": 7}
    other = trainer(graph).init()
    restored, step = checkpoint.restore(ck, other)
    assert restored is other and step == 7
    assert_same(snapshot(other), snapshot(res.state))
    # An older step loads on request.
    assert checkpoint.restore(ck, trainer(graph).init(), step=3)[1] == 3
    assert checkpoint.restore(str(tmp_path / "none"), other) == (None, None)


def test_resume_is_bit_identical(graph, tmp_path):
    _, ref = run(graph, tmp_path, "ref", 10)
    _, first = run(graph, tmp_path, "int", 4, every=2)
    assert first.steps_done == 4
    _, second = run(graph, tmp_path, "int", 10, every=2)
    assert second.resumed_from == 4 and second.steps_done == 10
    assert_same(snapshot(second.state), snapshot(ref.state))


def test_preemption_checkpoints_and_resumes(graph, tmp_path):
    n2v = trainer(graph)
    inner = make_step(n2v)

    def step_fn(model, step):
        if step == 5:  # preemption arrives mid-run
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(model, step)

    before = signal.getsignal(signal.SIGTERM)
    res = run_resumable(step_fn, n2v.init(), 10,
                        ElasticConfig(ckpt_dir=str(tmp_path / "ck")))
    # The signal lands during step 5; the loop finishes it, then stops.
    assert res.preempted and res.steps_done == 6
    assert signal.getsignal(signal.SIGTERM) is before
    _, resumed = run(graph, tmp_path, "ck", 10)
    assert resumed.resumed_from == 6 and resumed.steps_done == 10
    _, ref = run(graph, tmp_path, "ref", 10)
    assert_same(snapshot(resumed.state), snapshot(ref.state))


class FakeDeviceFault(Exception):
    pass


@pytest.mark.parametrize("fault_at,every", [(6, 2), (2, 100)],
                         ids=["from-checkpoint", "before-any-checkpoint"])
def test_fault_replay_is_bit_identical(graph, tmp_path, fault_at, every):
    """A fault after a checkpoint replays from it; one before any
    checkpoint replays from the host copy of the initial state (the port's
    trainers update in place, so the initial state itself is gone).  The
    faulting call has already updated the tables in place."""
    n2v = trainer(graph)
    inner = make_step(n2v)
    calls = {"n": 0}

    def step_fn(model, step):
        calls["n"] += 1
        model = inner(model, step)
        if calls["n"] == fault_at:
            raise FakeDeviceFault("HBM parity error")
        return model

    res = run_resumable(step_fn, n2v.init(), 8, ElasticConfig(
        ckpt_dir=str(tmp_path / "ck"), every_steps=every, max_retries=1,
        retryable=(FakeDeviceFault,)))
    assert res.retries_used == 1 and res.steps_done == 8
    assert calls["n"] == 10  # steps 4-7 (from-checkpoint), 0-7 again
    _, ref = run(graph, tmp_path, "ref", 8)
    assert_same(snapshot(res.state), snapshot(ref.state))


def test_out_of_memory_is_replayed_and_other_errors_are_not(graph, tmp_path):
    n2v = trainer(graph)
    inner = make_step(n2v)
    calls = {"n": 0}

    def step_fn(model, step):
        calls["n"] += 1
        if calls["n"] == 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return inner(model, step)

    res = run_resumable(step_fn, n2v.init(), 4, ElasticConfig(
        ckpt_dir=str(tmp_path / "oom"), max_retries=1))
    assert res.retries_used == 1 and res.steps_done == 4

    def sticky(model, step):
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_resumable(sticky, n2v.init(), 3, ElasticConfig(
            ckpt_dir=str(tmp_path / "sticky"), max_retries=3))


def test_fault_without_retries_raises(tmp_path):
    def step_fn(state, step):
        raise torch.cuda.OutOfMemoryError("device lost")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        run_resumable(step_fn, torch.nn.Linear(2, 2), 3,
                      ElasticConfig(ckpt_dir=str(tmp_path / "ck")))


def test_run_resumable_from_the_jax_initial_tables_follows_jax(graph,
                                                               tmp_path):
    """p = q = 1, dim 8: JAX's run_resumable over its trainer for 6 steps
    against the port's, resumed from a checkpoint that holds the JAX
    trainer's initial tables and zero Adam state."""
    steps = 6
    jg = trw.CSRGraph.from_edges(*toy_edges(), num_nodes=N, symmetrize=True)
    jn2v = JNode2Vec(jg, JConfig(**CONFIG))
    j_targets = jnp.arange(N, dtype=jnp.int32)
    j_losses = []

    def j_step(state, step):
        params, opt_state, loss = jn2v.epoch_step(
            state[0], state[1], j_targets, jnp.uint32(step))
        j_losses.append(float(loss))
        return (params, opt_state)

    params, opt_state = jn2v.init()
    want = j_elastic.run_resumable(
        j_step, (params, opt_state), steps,
        j_elastic.ElasticConfig(ckpt_dir=str(tmp_path / "jax"),
                                every_steps=100, save_final=False))
    n2v = trainer(graph)
    ck = str(tmp_path / "port")
    convert.checkpoint_from_numpy(
        ck, n2v.init(), {k: np.asarray(v) for k, v in params.items()})
    losses = []
    got = run_resumable(make_step(n2v, losses), n2v.model, steps,
                        ElasticConfig(ckpt_dir=ck, every_steps=100))
    assert got.resumed_from == 0 and got.steps_done == steps
    assert len(losses) == len(j_losses) == steps
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    tables = convert.skipgram_to_numpy(got.state)
    for name in ("in_emb", "out_emb"):
        np.testing.assert_allclose(tables[name],
                                   np.asarray(want.state[0][name]),
                                   rtol=1e-3, atol=1e-5)
    assert got.state.count == steps


def sgd_model():
    return tt.SkipGramModel(N, CONFIG["dim"], device="cpu",
                            optimizer=lambda ps: torch.optim.SGD(
                                ps, lr=0.1, momentum=0.9))


def kge(update_mode="dense", objective="transe"):
    g, _, _ = tt.synthetic_grid_kg(5, seed=1, device="cpu")
    return tt.KGEmbedding(g, tt.KGEmbeddingConfig(
        dim=8, walk_length=4, objective=objective, update_mode=update_mode),
        device="cpu")


@pytest.mark.parametrize("case", ["skipgram-dense", "skipgram-sparse",
                                  "skipgram-bf16", "skipgram-sgd",
                                  "kge-dense", "kge-sparse", "kge-cbow"])
def test_checkpoint_round_trip_keeps_the_optimizer_state(graph, tmp_path,
                                                         case):
    """Two steps, save, two more steps; a fresh model restored from the
    checkpoint takes the same two steps to the same bits: tables, moments
    (their type too), count, sparse_state, or a custom optimizer's
    momentum."""
    family, mode = case.split("-")
    if family == "kge":
        objective = "cbow" if mode == "cbow" else "transe"
        update = "dense" if mode == "cbow" else mode
        make = lambda: kge(update, objective)  # noqa: E731
        targets = torch.arange(25, dtype=torch.int32)
    else:
        kw = {"dense": {}, "sparse": {"update_mode": "sparse"},
              "bf16": {"dtype": "bfloat16"}, "sgd": {}}[mode]
        make = lambda: trainer(graph, **kw)  # noqa: E731
        targets = torch.arange(N, dtype=torch.int32)

    def fresh():
        t = make()
        if mode == "sgd":
            t.model = sgd_model()
        t.init()
        return t

    a = fresh()
    for e in range(2):
        a.epoch_step(targets, e)
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, a.model, 2, metadata={"case": case})
    saved = snapshot(a.model)
    momentum = (None if mode != "sgd" else
                [a.model.optimizer.state[p]["momentum_buffer"].clone()
                 for p in a.model.parameters()])
    for e in range(2, 4):
        a.epoch_step(targets, e)
    b = fresh()
    assert checkpoint.restore(ck, b.model)[1] == 2
    assert_same(snapshot(b.model), saved)
    assert saved["sparse_state"] == (mode == "sparse")
    if mode == "sgd":
        for p, m in zip(b.model.parameters(), momentum):
            assert torch.equal(b.model.optimizer.state[p]["momentum_buffer"],
                               m)
    for e in range(2, 4):
        b.epoch_step(targets, e)
    assert_same(snapshot(b.model), snapshot(a.model))


def test_restore_refuses_another_optimizer(graph, tmp_path):
    a = trainer(graph)
    checkpoint.save(str(tmp_path), a.init(), 1)
    with pytest.raises(ValueError, match="custom optimizer"):
        checkpoint.restore(str(tmp_path), sgd_model())


class TestHeartbeat:
    def test_beat_and_stall_detection(self, tmp_path):
        path = str(tmp_path / "hb.json")
        assert Heartbeat.is_stalled(path, 1.0)  # absent = stalled
        hb = Heartbeat(path)
        hb.beat(7, loss=0.5)
        record = Heartbeat.read(path)
        assert record["step"] == 7 and record["loss"] == 0.5
        assert not Heartbeat.is_stalled(path, 60.0)
        assert Heartbeat.is_stalled(path, 5.0, now=record["ts"] + 10.0)

    def test_wired_into_run_resumable(self, graph, tmp_path):
        hb_path = str(tmp_path / "hb.json")
        run(graph, tmp_path, "ck", 4, every=10, heartbeat_path=hb_path)
        assert Heartbeat.read(hb_path)["step"] == 4


def test_profiling_helpers_on_the_cpu(tmp_path):
    x = torch.arange(6, dtype=torch.float32)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("trw_probe_region"):
            y = (x * 2).sum()
    assert float(y) == 30.0
    assert "trw_probe_region" in {e.key for e in prof.key_averages()}
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        assert "trw_probe_region" in f.read()
    model = torch.nn.Linear(2, 1)
    with torch.no_grad():
        model.weight.fill_(1.0)
        model.bias.fill_(0.5)
    assert profiling.sync({"a": x, "b": [torch.ones(2, dtype=torch.int32),
                                         model]}) == 15.0 + 2 + 2.5
    calls = []
    dt = profiling.StepTimer().time(lambda v: calls.append(1) or v * 2, x,
                                    warmup=1, iters=3)
    assert dt > 0 and len(calls) == 4
