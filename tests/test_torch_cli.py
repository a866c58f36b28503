"""The port's command-line entry points (``torch_random_walk_tpu_torch/cli.py``)
end to end on the CPU (``--device cpu``), at tiny sizes, against the JAX
CLI: ``trw-torch-walk`` writes the JAX ``trw-walk``'s walks bit for bit
(tolerance 0) for the same arguments, uniform and p = 0.5, q = 2, on a
``synth:`` graph and on a ``.npz`` one; the trainers are checked as JAX's
``tests/test_cli.py`` checks its own (output shapes, metrics lines, the
checkpoint's meta file, the holdout guards), and a run resumed from
``--checkpoint-dir`` equals the uninterrupted run bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from torch_random_walk_tpu import cli as j_cli
from torch_random_walk_tpu_torch import cli
from torch_random_walk_tpu_torch.utils import checkpoint

CPU = ["--device", "cpu"]


def _save_symmetric_synth(path, spec):
    """The edges of ``synth:`` as a .npz, symmetrized, so that both CLIs
    build the synth graph from the file (and JAX's biased engine compiles
    once for both graphs of the walk test)."""
    g = cli._load_graph(spec, "cpu")
    src = torch.repeat_interleave(torch.arange(g.num_nodes),
                                  (g.row_ptr[1:] - g.row_ptr[:-1]).long())
    np.savez(path, src=src.numpy(), dst=g.col_idx.numpy())


@pytest.mark.parametrize("pq", [("1", "1"), ("0.5", "2.0")],
                         ids=["uniform", "p0.5-q2"])
def test_walk_main_equals_the_jax_cli(tmp_path, pq):
    npz = str(tmp_path / "g.npz")
    _save_symmetric_synth(npz, "synth:200:4")
    # One walker count for both biased runs: a JAX biased engine compiles
    # for each new shape (about 10 s).
    for spec, walkers in (("synth:200:4", "50"),
                          (npz, "0" if pq == ("1", "1") else "50")):
        args = [spec, "--walkers", walkers, "--walk-length", "7", "-p", pq[0],
                "-q", pq[1], "--seed", "3"]
        got, want = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
        cli.walk_main(args + ["-o", got] + CPU)
        j_cli.walk_main(args + ["-o", want])
        walks = np.load(got)
        np.testing.assert_array_equal(walks, np.load(want))
        assert walks.shape == (int(walkers) or 200, 8)
        assert walks.dtype == np.int32
        assert walks.min() >= 0 and walks.max() < 200


def test_train_main(tmp_path):
    out = str(tmp_path / "emb.npy")
    metrics = str(tmp_path / "m.jsonl")
    cli.train_main(["synth:100:4", "-o", out, "--dim", "8",
                    "--walk-length", "6", "--epochs", "3",
                    "--metrics", metrics] + CPU)
    emb = np.load(out)
    assert emb.shape == (100, 8) and emb.dtype == np.float32
    lines = [json.loads(line) for line in open(metrics)]
    assert [line["epoch"] for line in lines] == [0, 1, 2]
    assert all(np.isfinite(line["loss"]) for line in lines)


def test_train_main_checkpointing_and_resume(tmp_path):
    """Two epochs with --checkpoint-dir, then four into the same directory:
    the second run resumes after epoch 2 and ends where an uninterrupted
    four-epoch run ends, bit for bit (embeddings and checkpointed state)."""
    def train(name, epochs, ckpt):
        out = str(tmp_path / f"{name}.npy")
        metrics = str(tmp_path / f"{name}.jsonl")
        cli.train_main(["synth:100:4", "-o", out, "--dim", "8",
                        "--walk-length", "6", "--epochs", str(epochs),
                        "--checkpoint-dir", ckpt, "--checkpoint-every", "1",
                        "--metrics", metrics, "-p", "0.5", "-q", "2"] + CPU)
        return np.load(out), [json.loads(line) for line in open(metrics)]

    ckpt, ref_ckpt = str(tmp_path / "ck"), str(tmp_path / "ref_ck")
    train("first", 2, ckpt)
    with open(os.path.join(ckpt, "meta.json")) as f:
        assert json.load(f) == {"step": 2}
    emb, lines = train("second", 4, ckpt)
    assert [line["epoch"] for line in lines] == [2, 3]
    want_emb, want_lines = train("ref", 4, ref_ckpt)
    np.testing.assert_array_equal(emb, want_emb)
    assert [line["loss"] for line in lines] == [
        line["loss"] for line in want_lines[2:]]
    got = torch.load(checkpoint.payload_path(ckpt, 4), weights_only=True)
    want = torch.load(checkpoint.payload_path(ref_ckpt, 4), weights_only=True)
    for name in ("in_emb", "out_emb"):
        assert torch.equal(got[name], want[name])
    extra, want_extra = got["_extra_state"], want["_extra_state"]
    assert extra["count"] == want_extra["count"] == 4
    for key in ("mu", "nu"):
        for name in ("in_emb", "out_emb"):
            assert torch.equal(extra[key][name], want_extra[key][name])


def test_train_main_without_checkpoint_dir_leaves_no_scratch(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    cli.train_main(["synth:50:3", "-o", str(tmp_path / "e.npy"), "--dim", "4",
                    "--walk-length", "4", "--epochs", "2"] + CPU)
    assert sorted(os.listdir(tmp_path)) == ["e.npy"]


def _save_triples(path, triples):
    t = np.asarray(triples)
    np.savez(path, head=t[:, 0], rel=t[:, 1], tail=t[:, 2])


def test_kg_train_main(tmp_path, capsys):
    npz = str(tmp_path / "kg.npz")
    _save_triples(npz, [(i, 0, i + 1) for i in range(20)])
    out = str(tmp_path / "kg_emb.npz")
    cli.kg_train_main([npz, "-o", out, "--dim", "8", "--epochs", "5",
                       "--eval-holdout", "0.2"] + CPU)
    with np.load(out) as data:
        assert data["entities"].shape == (21, 8)
        assert data["relations"].shape == (1, 8)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    m = json.loads(printed)
    assert sorted(m) == ["filtered_hits@1", "filtered_hits@10",
                         "filtered_mrr"]
    assert 0.0 <= m["filtered_mrr"] <= 1.0


@pytest.mark.parametrize("objective,mode", [("transe", "sparse"),
                                            ("skipgram", "dense")])
def test_kg_train_main_grid(tmp_path, objective, mode):
    out = str(tmp_path / "kg_emb.npz")
    metrics = str(tmp_path / "m.jsonl")
    ckpt = str(tmp_path / "ck")
    cli.kg_train_main(["grid:6", "-o", out, "--dim", "8", "--epochs", "3",
                       "--objective", objective, "--update-mode", mode,
                       "--metrics", metrics, "--checkpoint-dir", ckpt,
                       "--checkpoint-every", "2"] + CPU)
    with np.load(out) as data:
        assert data["entities"].shape == (36, 8)
        assert data["relations"].shape == (4, 8)
    lines = [json.loads(line) for line in open(metrics)]
    assert len(lines) == 3 and all(np.isfinite(x["loss"]) for x in lines)
    assert sorted(os.listdir(ckpt)) == ["meta.json", "step_2.pt", "step_3.pt"]
    state = torch.load(checkpoint.payload_path(ckpt, 3), weights_only=True)
    assert state["_extra_state"]["sparse_state"] == (mode == "sparse")


def test_kg_train_main_holdout_guards(tmp_path):
    npz = str(tmp_path / "kg.npz")
    _save_triples(npz, [(0, 0, 1), (1, 0, 2)])
    with pytest.raises(SystemExit):
        cli.kg_train_main([npz, "--objective", "skipgram",
                           "--eval-holdout", "0.5"] + CPU)
    with pytest.raises(SystemExit):
        cli.kg_train_main([npz, "--eval-holdout", "0.01"] + CPU)


def test_module_entry_and_the_card(tmp_path):
    out = str(tmp_path / "w.npy")
    cli.main(["walk", "synth:30:2", "-o", out, "--walk-length", "3"] + CPU)
    assert np.load(out).shape == (30, 4)
    with pytest.raises(SystemExit, match="walk|train|train-kg"):
        cli.main(["bench"])
    if torch.cuda.is_available():
        return
    for main in (cli.walk_main, cli.train_main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["synth:30:2", "-o", out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.kg_train_main(["grid:3", "-o", out])
