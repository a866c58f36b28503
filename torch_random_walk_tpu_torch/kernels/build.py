"""Build the CUDA sources of this directory into one shared library.

Every ``*.cu`` file has a plain C interface (no PyTorch headers), so ``nvcc``
compiles each in seconds.  One ``nvcc -c`` per source is started at the same
time, for ``sm_90a`` (Hopper), and a last ``nvcc -shared`` links the objects.
The library lands in ``build/torch_kernels/`` at the root of the checkout (or
in ``$TRW_TORCH_BUILD_DIR``), under a name that carries a hash of the sources
and flags, so an unchanged tree is built once.  Beside it, ``<library>.log``
keeps what ``nvcc -Xptxas -v`` reported for each source (registers, spills
and static shared memory of every kernel).  The build happens at first use
of a kernel, never at import, and a failed build raises: there is no
fall-back to the plain PyTorch versions.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = ("uniform_walk.cu", "node2vec_walk.cu", "windows.cu", "exchange.cu",
           "sgns_loss.cu", "sgns_loss_tc.cu", "edge_list_walk.cu",
           "triples.cu", "routed.cu", "routed_families.cu", "sgns_windows.cu",
           "sgns_windows_owner.cu", "adam.cu", "kge_pair.cu",
           "kge_windows.cu")
HEADERS = ("threefry.cuh", "csr.cuh", "ranges.cuh", "sgns_loss.cuh",
           "routed.cuh", "exchange.cuh", "sgns_windows.cuh", "kge.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    override = os.environ.get("TRW_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return SOURCE_DIR.parents[1] / "build" / "torch_kernels"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SOURCE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"libtrw_kernels_{_digest()}.so"


def build_log() -> str:
    """What ``-Xptxas -v`` reported when the library was built."""
    return library_path().with_suffix(".log").read_text()


def build_library(verbose: bool = False) -> Path:
    """Compile (if needed) and return the path of the shared library; with
    ``verbose``, print the compiler's report of a build made now."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objects = [out_dir / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(SOURCE_DIR), "-c",
             str(SOURCE_DIR / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objects)
    ]
    try:
        logs = [(src, p.communicate()[0], p.returncode)
                for src, p in zip(SOURCES, procs)]
        failed = [(src, out) for src, out, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {src}\n{out}" for src, out in failed))
        report = "".join(f"--- nvcc {src}\n{out}" for src, out, _ in logs)
        if verbose:
            print(report, flush=True)
        (out_dir / f"{tag}.log").write_text(report)
        tmp = out_dir / f"{tag}.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out_dir / f"{tag}.log", lib.with_suffix(".log"))
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objects:
            obj.unlink(missing_ok=True)
        (out_dir / f"{tag}.log").unlink(missing_ok=True)
    return lib

