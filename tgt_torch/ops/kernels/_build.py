"""Build and load the hand-written CUDA kernels of the package.

Each ``tgt_torch/csrc/<name>.cu`` exposes a plain C entry point. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``tgt_torch/_build/`` at first use, and loaded with ``ctypes``. The library
name carries a hash of the source, the ``csrc/*.cuh`` headers and the flags,
so an edited source or header is rebuilt.
The compiler's own report (``-Xptxas -v``: registers, shared memory, spills)
is kept beside the library as ``<name>.log``.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# every kernel source of the package, csrc/<name>.cu
LIBRARIES = ("triplet_dense_fwd", "triplet_dense_bwd", "triplet_aggregate_fwd",
             "triplet_aggregate_bwd", "triplet_attention_fwd",
             "triplet_attention_bwd", "layernorm_fwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers beside
    it and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named kernel source that has no up-to-date library,
    one ``nvcc`` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    targets = {name: library_path(name) for name in names}
    todo = {name: path for name, path in targets.items() if not path.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    path = build_libraries([name])[name]
    return ctypes.CDLL(str(path))
