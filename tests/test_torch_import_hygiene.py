"""The port stands alone: importing it (every module, and chip_smoke.py)
pulls in neither jax, optax nor the JAX package, and its sources name none of
them in an import statement."""

import os
import re
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "torch_random_walk_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
import torch_random_walk_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
assert "torch_random_walk_tpu_torch.models.skipgram" in sys.modules
assert "torch_random_walk_tpu_torch.models.node2vec" in sys.modules
assert "torch_random_walk_tpu_torch.models.cbow" in sys.modules
assert "torch_random_walk_tpu_torch.models.kge" in sys.modules
assert "torch_random_walk_tpu_torch.models.eval" in sys.modules
assert "torch_random_walk_tpu_torch.utils.alias" in sys.modules
assert "torch_random_walk_tpu_torch.graph.bloom" in sys.modules
assert "torch_random_walk_tpu_torch.graph.hashset" in sys.modules
assert "torch_random_walk_tpu_torch.parallel.partition_v2" in sys.modules
assert "torch_random_walk_tpu_torch.parallel.mesh" in sys.modules
assert "torch_random_walk_tpu_torch.parallel.walk_dp" in sys.modules
assert "torch_random_walk_tpu_torch.parallel.trainer" in sys.modules
assert "torch_random_walk_tpu_torch.parallel.kge_trainer" in sys.modules
assert "torch_random_walk_tpu_torch.cli" in sys.modules
assert "torch_random_walk_tpu_torch.utils.checkpoint" in sys.modules
assert "torch_random_walk_tpu_torch.utils.elastic" in sys.modules
assert "torch_random_walk_tpu_torch.utils.logging" in sys.modules
assert "torch_random_walk_tpu_torch.utils.profiling" in sys.modules
assert "torch_random_walk_tpu_torch.graph.oracle" in sys.modules
assert "torch_random_walk_tpu_torch.graph.datasets" in sys.modules
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "optax" or m.startswith("optax.")
             or m == "torch_random_walk_tpu"
             or m.startswith("torch_random_walk_tpu."))
assert not bad, bad
print("PORT_IMPORT_CLEAN")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], text=True,
                         capture_output=True, env=env, cwd=_REPO, timeout=120)
    assert out.returncode == 0 and "PORT_IMPORT_CLEAN" in out.stdout, (
        out.stdout + out.stderr)


def test_port_sources_have_no_such_import_statement():
    pattern = re.compile(
        r"^\s*(import|from) +(jax|optax|torch_random_walk_tpu)\b")
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(_PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    assert any(p.endswith(os.path.join("models", "skipgram.py")) for p in files)
    for path in files:
        with open(path) as f:
            hits = [line for line in f if pattern.match(line)]
        assert not hits, (path, hits)


def test_importing_the_port_builds_and_loads_no_kernel():
    probe = ("import torch_random_walk_tpu_torch as p, sys;"
             "from torch_random_walk_tpu_torch.kernels import bindings;"
             "assert bindings._lib is None;"
             "assert 'triton' not in sys.modules; print('LAZY_OK')")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", probe], text=True,
                         capture_output=True, env=env, cwd=_REPO, timeout=120)
    assert out.returncode == 0 and "LAZY_OK" in out.stdout, (
        out.stdout + out.stderr)


# Public names of the JAX package that the port does not have yet, by
# sub-package: the reduction-based v1 partitioned walks (ROADMAP.md queue 1
# item 8).
STILL_MISSING = {"parallel": {"walk_partitioned", "walk_partitioned_node2vec"}}


def test_port_exports_cover_the_jax_package():
    """The ``__all__`` of the port's top level, ``graph``, ``utils`` and
    ``parallel`` hold every name of the JAX package's, but STILL_MISSING's,
    and every name they list resolves."""
    import importlib

    for sub in ("", "graph", "utils", "parallel"):
        suffix = "." + sub if sub else ""
        jax_pkg = importlib.import_module("torch_random_walk_tpu" + suffix)
        port = importlib.import_module("torch_random_walk_tpu_torch" + suffix)
        missing = set(jax_pkg.__all__) - set(port.__all__)
        assert missing == STILL_MISSING.get(sub, set()), (sub, missing)
        for name in port.__all__:
            assert hasattr(port, name), (sub, name)
