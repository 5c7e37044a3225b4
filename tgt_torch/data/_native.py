"""ctypes binding of the native data-preparation functions in
csrc/tgt_native.cpp (counterpart of tgt_tpu/data/_native.py: the same five
functions with the same argument types).

The library is built at first use with ``g++ -O3 -shared -fPIC`` into
``tgt_torch/_build/``, named by a hash of the source and the flags, and
written under a temporary name that is renamed into place, so that several
processes may build it at once. It is built without ``-march``: a library
cached in ``_build/`` then runs on any x86-64 host, and the code is integer
code, so its results do not depend on the instructions chosen.

Nothing is built when the module is imported. ``library()`` builds and
loads it; a failed build raises with the compiler's output.
``tgt_torch.data.structural`` wires ``preprocess_graph``; the collate and
the bins keep their numpy code, as tgt_tpu's do.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "csrc" / "tgt_native.cpp"
BUILD_DIR = _PKG / "_build"
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC")

_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = ctypes.POINTER(ctypes.c_uint8)
_ARGTYPES = {
    "floyd_warshall": [_i16p, _i16p, ctypes.c_int],
    "preprocess_graph": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, _i64p, _i16p, _i16p, _i16p, _i16p,
                         _i16p],
    "pack_bins_multi": [_u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "unpack_bins_multi": [_u8p, _u8p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int],
    "stack_with_pad": [ctypes.POINTER(ctypes.c_char_p), _i64p, ctypes.c_int,
                       ctypes.c_int, _i64p, _u8p, ctypes.c_int],
}


def compiler() -> Optional[str]:
    """The C++ compiler on PATH, or None."""
    return shutil.which(COMPILER)


def library_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libtgt_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/tgt_native.cpp unless its library is up to date.
    Raises with the compiler's output if the compiler is missing or
    fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"{COMPILER} not found on PATH: {SOURCE} cannot "
                           f"be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {SOURCE} (exit "
                           f"{res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every function's
    argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def floyd_warshall(adj: np.ndarray) -> np.ndarray:
    """All-pairs hop counts of a square adjacency (int16), unreachable
    510."""
    adj = np.ascontiguousarray(adj, np.int16)
    n = adj.shape[0]
    if adj.shape != (n, n):
        raise ValueError(f"adjacency of shape {adj.shape} is not square")
    out = np.empty((n, n), np.int16)
    library().floyd_warshall(adj, out, n)
    return out


def preprocess_graph(num_nodes: int, edges: np.ndarray,
                     node_feats: np.ndarray, edge_feats: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """As ``structural.preprocess_graph``: (node features (N, Fn), hop
    distances (N, N), edge features scattered to (N, N, Fe)), int16."""
    num_nodes = int(num_nodes)
    edges = np.ascontiguousarray(edges, np.int64).reshape(-1, 2)
    node_feats = np.ascontiguousarray(node_feats, np.int16)
    edge_feats = np.ascontiguousarray(edge_feats, np.int16)
    fn = node_feats.shape[-1]
    fe = edge_feats.shape[-1]
    m = edges.shape[0]
    if node_feats.shape != (num_nodes, fn) or edge_feats.shape != (m, fe):
        raise ValueError(f"{num_nodes} nodes and {m} edges, but node "
                         f"features {node_feats.shape} and edge features "
                         f"{edge_feats.shape}")
    if m and (edges.min() < 0 or edges.max() >= num_nodes):
        raise ValueError(f"an edge leaves the {num_nodes} nodes")
    node_out = np.empty((num_nodes, fn), np.int16)
    dist = np.empty((num_nodes, num_nodes), np.int16)
    featm = np.empty((num_nodes, num_nodes, fe), np.int16)
    library().preprocess_graph(num_nodes, fn, fe, m, edges, node_feats,
                               node_out, edge_feats, dist, featm)
    return node_out, dist, featm


def _u8view(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def pack_bins_multi(bins: np.ndarray) -> np.ndarray:
    """(S, N, N) -> (S, N(N-1)/2): the strict upper triangle."""
    bins = np.ascontiguousarray(bins)
    s, n, n2 = bins.shape
    if n != n2:
        raise ValueError(f"bins of shape {bins.shape} are not square")
    out = np.empty((s, n * (n - 1) // 2), bins.dtype)
    library().pack_bins_multi(_u8view(bins), _u8view(out), s, n,
                              bins.dtype.itemsize)
    return out


def unpack_bins_multi(packed: np.ndarray, num_nodes: int) -> np.ndarray:
    """(S, N(N-1)/2) -> (S, N, N), zero on and below the diagonal."""
    packed = np.ascontiguousarray(packed)
    s = packed.shape[0]
    if packed.shape != (s, num_nodes * (num_nodes - 1) // 2):
        raise ValueError(f"packed bins of shape {packed.shape} do not hold "
                         f"{num_nodes} nodes")
    out = np.empty((s, num_nodes, num_nodes), packed.dtype)
    library().unpack_bins_multi(_u8view(packed), _u8view(out), s, num_nodes,
                                packed.dtype.itemsize)
    return out


def stack_with_pad(arrays: List[np.ndarray],
                   pad_to: Optional[dict] = None) -> np.ndarray:
    """Ragged stack of ranks 1-4 into a zero-padded batch, as
    ``collate.stack_with_pad``."""
    rank = arrays[0].ndim
    if rank == 0 or rank > 4:
        raise ValueError("native stack supports ranks 1-4")
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if any(a.ndim != rank or a.dtype != arrays[0].dtype for a in arrays):
        raise ValueError("native stack needs one rank and one dtype")
    # left-pad shapes to rank 4 so the innermost dim stays a memcpy row
    pad = 4 - rank
    shapes = np.asarray([(1,) * pad + a.shape for a in arrays], np.int64)
    maxs = shapes.max(axis=0)
    if pad_to:
        for d, size in pad_to.items():
            maxs[d + pad] = max(maxs[d + pad], size)
    out = np.zeros((len(arrays), *maxs), arrays[0].dtype)
    ptrs = (ctypes.c_char_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_char_p) for a in arrays])
    library().stack_with_pad(ptrs, np.ascontiguousarray(shapes), len(arrays),
                             4, np.ascontiguousarray(maxs, np.int64),
                             _u8view(out), arrays[0].dtype.itemsize)
    return out.reshape((len(arrays),) + tuple(maxs[pad:]))
