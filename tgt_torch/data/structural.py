"""Structural preprocessing: hop-distance matrix + dense feature scatter
(counterpart of tgt_tpu/data/structural.py).

As the reference's numba kernels (lib/data/pcqm/structural_transform.py:8-75):
- ``floyd_warshall``: all-pairs hop distance, unreachable pairs = 510,
  diagonal = 0 (int16);
- ``preprocess_graph``: offset-encodes node/edge features
  (feat + 1 + k*OFFSET, 0 reserved for padding) and scatters the edge
  features into dense (N, N) matrices.

``preprocess_graph`` runs the native library of csrc/tgt_native.cpp
(``tgt_torch.data._native``, built at first use), which gives the same
arrays as its numpy version ``preprocess_graph_numpy``. The numpy version
runs only when no C++ compiler is on PATH, and then it warns once; a
compiler whose build or load fails raises. ``backend()`` says which ran.

``AddStructuralData`` runs inside a ``data.transform`` span (``atoms``;
``tgt_torch.utils.tracing``, recorded while torch's profiler runs).
"""
from __future__ import annotations

import functools
import warnings
from typing import Dict

import numpy as np

from tgt_torch.utils import tracing

NODE_FEATURES_OFFSET = 128
EDGE_FEATURES_OFFSET = 8
UNREACHABLE = 510


@functools.cache
def _native_module():
    """The native binding, built and loaded; None, with a warning, when
    there is no compiler to build it."""
    from tgt_torch.data import _native

    if not _native.library_path().exists() and _native.compiler() is None:
        warnings.warn(f"{_native.COMPILER} is not on PATH: the structural "
                      f"transform runs its numpy version", RuntimeWarning)
        return None
    _native.library()
    return _native


def backend() -> str:
    """'native' when ``preprocess_graph`` runs the C++ library, 'numpy'
    when there is no compiler to build it."""
    return "numpy" if _native_module() is None else "native"


def floyd_warshall(adj: np.ndarray) -> np.ndarray:
    """All-pairs shortest hop counts; unreachable = 510 (int16)."""
    n = adj.shape[0]
    d = np.where(adj != 0, 1, UNREACHABLE).astype(np.int16)
    np.fill_diagonal(d, 0)
    for k in range(n):
        np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :], out=d)
    return d


def preprocess_graph(num_nodes: int, edges: np.ndarray,
                     node_feats: np.ndarray, edge_feats: np.ndarray):
    """Returns (node_feats (N, Fn) int16, dist_matrix (N, N) int16,
    feature_matrix (N, N, Fe) int16), through the native library."""
    native = _native_module()
    if native is None:
        return preprocess_graph_numpy(num_nodes, edges, node_feats,
                                      edge_feats)
    return native.preprocess_graph(num_nodes, edges, node_feats, edge_feats)


def preprocess_graph_numpy(num_nodes: int, edges: np.ndarray,
                           node_feats: np.ndarray, edge_feats: np.ndarray):
    """``preprocess_graph`` in numpy."""
    fn = node_feats.shape[-1]
    fe = edge_feats.shape[-1]
    node_out = (node_feats.astype(np.int16)
                + np.arange(1, fn * NODE_FEATURES_OFFSET + 1,
                            NODE_FEATURES_OFFSET, dtype=np.int16))
    edge_enc = (edge_feats.astype(np.int16)
                + np.arange(1, fe * EDGE_FEATURES_OFFSET + 1,
                            EDGE_FEATURES_OFFSET, dtype=np.int16))
    adj = np.zeros((num_nodes, num_nodes), np.int16)
    emat = np.zeros((num_nodes, num_nodes, fe), np.int16)
    if len(edges):
        ei, ej = edges[:, 0], edges[:, 1]
        adj[ei, ej] = 1
        emat[ei, ej] = edge_enc
    return node_out, floyd_warshall(adj), emat


class AddStructuralData:
    """Row transform: raw edge-list record -> dense structural matrices
    (reference structural_transform.py:62-75)."""

    def __call__(self, item: Dict) -> Dict:
        num_nodes = int(item["num_nodes"])
        with tracing.span("data.transform") as span:
            if span is not None:
                span["atoms"] = num_nodes
            edges = item.pop("edges")
            node_feats = item.pop("node_features")
            edge_feats = item.pop("edge_features")
            nf, dist, fmat = preprocess_graph(num_nodes, edges, node_feats,
                                              edge_feats)
            item["node_features"] = nf
            item["distance_matrix"] = dist
            item["feature_matrix"] = fmat
            return item
