"""Distance-bin packing: strict-upper-triangle flat storage (counterpart of
tgt_tpu/data/bins.py; the same arrays give the same bytes).

The on-disk format of predicted distances (reference: lib/data/pcqm/bin_ops.py
:5-48): symmetric (N, N) bin matrices are stored as the flattened strict upper
triangle (uint8/uint16), one row per MC sample.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=512)
def flat_triu_indices(n: int) -> np.ndarray:
    """Flat indices of the strict upper triangle of an (n, n) matrix."""
    i, j = np.triu_indices(n, k=1)
    return (i * n + j).astype(np.int64)


def pack_bins(bins: np.ndarray) -> np.ndarray:
    """(N, N) -> (N*(N-1)/2,) strict upper triangle."""
    n = bins.shape[0]
    return bins.reshape(n * n)[flat_triu_indices(n)]


def unpack_bins(packed: np.ndarray, num_nodes: int) -> np.ndarray:
    """(N*(N-1)/2,) -> (N, N) with zero diagonal/lower triangle."""
    out = np.zeros(num_nodes * num_nodes, dtype=packed.dtype)
    out[flat_triu_indices(num_nodes)] = packed
    return out.reshape(num_nodes, num_nodes)


def pack_bins_multi(bins: np.ndarray) -> np.ndarray:
    """(S, N, N) -> (S, N*(N-1)/2)."""
    s, n, _ = bins.shape
    return bins.reshape(s, n * n)[:, flat_triu_indices(n)]


def unpack_bins_multi(packed: np.ndarray, num_nodes: int) -> np.ndarray:
    """(S, K) -> (S, N, N)."""
    s = packed.shape[0]
    out = np.zeros((s, num_nodes * num_nodes), dtype=packed.dtype)
    out[:, flat_triu_indices(num_nodes)] = packed
    return out.reshape(s, num_nodes, num_nodes)


def bins_dtype(num_bins: int) -> np.dtype:
    """uint8 when bins fit, else uint16 (reference: dist_pred/scheme.py:216-219)."""
    return np.dtype(np.uint8) if num_bins <= 256 else np.dtype(np.uint16)
