"""Build, load and launch the hand-written CUDA kernels of the package.

Each ``tgt_torch/csrc/<name>.cu`` exposes plain C entry points. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``tgt_torch/_build/`` at first use, and loaded with ``ctypes``. The library
name carries a hash of the source, the ``csrc/*.cuh`` headers and the flags,
so an edited source or header is rebuilt.
The compiler's own report (``-Xptxas -v``: registers, shared memory, spills)
is kept beside the library as ``<name>.log``.

Every wrapper in ``ops/kernels`` calls its kernels through one seam:
:class:`Entry` declares a C entry point once, :func:`launch` calls it on a
tensor's device and current stream and raises on a CUDA error,
:func:`counted` and :func:`count` keep the wrappers' launch counters, and
:func:`records_grad` is the one test of whether autograd records a call.

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
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# every kernel source of the package, csrc/<name>.cu
LIBRARIES = ("triplet_dense_fwd", "triplet_dense_bwd", "triplet_aggregate_fwd",
             "triplet_aggregate_bwd", "triplet_attention_fwd",
             "triplet_attention_bwd", "layernorm_fwd", "residual_fwd")

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


# argument types of the C entry points
PTR = ctypes.c_void_p
INT = ctypes.c_int
UINT = ctypes.c_uint
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float
LONGS = ctypes.POINTER(ctypes.c_longlong)   # an array of element strides
STREAM = ctypes.c_void_p                    # cudaStream_t, always the last


class Entry:
    """One C entry point, declared once: its library (``csrc/<library>.cu``),
    its symbol and its argument types. Calling the entry calls the symbol,
    which is loaded, typed and cached at the first call; ``fn`` may be set to
    another callable (a variant build's symbol, or a fake in a test)."""

    def __init__(self, library: str, symbol: str, *argtypes):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.fn: Optional[Callable[..., int]] = None

    def bind(self, lib: ctypes.CDLL) -> "Entry":
        """This declaration applied to ``lib``, a build of its library: a
        new entry whose ``fn`` is ``lib``'s symbol, typed."""
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        entry = Entry(self.library, self.symbol, *self.argtypes)
        entry.fn = fn
        return entry

    def __call__(self, *args) -> int:
        if self.fn is None:
            self.fn = self.bind(load_library(self.library)).fn
        return self.fn(*args)


def strides(values: Sequence[int]) -> ctypes.Array:
    """``values`` (element strides) as the C array a ``LONGS`` argument takes."""
    return (ctypes.c_longlong * len(values))(*values)


def launch(entry: Entry, on: torch.Tensor, *args) -> None:
    """Call ``entry`` with ``args`` and, last, the raw handle of the current
    stream of ``on``'s device (a ``torch.cuda.Stream`` object costs
    microseconds a call). The device guard is entered only when that device
    is not the current one. Raises ``RuntimeError`` naming the symbol where
    the entry returns a CUDA error."""
    device = on.get_device()
    if device == torch.cuda.current_device():
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = entry(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"{entry.symbol} launch failed with CUDA error {rc}")


def counted(*names: str) -> Callable:
    """Decorator declaring a wrapper's launch counters: function attributes,
    each starting at 0, that :func:`count` bumps and ``chip_smoke.py`` and
    ``h100bench`` read by name."""
    def declare(wrapper):
        for name in names:
            setattr(wrapper, name, 0)
        return wrapper
    return declare


def count(wrapper, name: str = "launches") -> None:
    """One more call of ``wrapper`` on the card, counted under ``name``."""
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def records_grad(tensors: Iterable[Optional[torch.Tensor]]) -> bool:
    """Whether autograd would record a call on ``tensors`` (None skipped):
    grad mode is on and one of them requires grad. ``tensors`` is read only
    when grad mode is on."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
