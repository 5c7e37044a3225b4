"""Padded batching to a fixed ladder of bucket sizes (counterpart of
tgt_tpu/data/collate.py).

Node axes pad to the smallest bucket that holds the batch's largest graph,
so a server sees a handful of shapes. ``padded_collate`` runs inside a
``data.collate`` span (``rows``, ``bucket``; ``tgt_torch.utils.tracing``,
recorded while torch's profiler runs).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tgt_torch.utils import tracing

# Node-count axes per batch key (dims after the leading batch dim).
_NODE_AXES = {
    "node_features": (0,),
    "node_mask": (0,),
    "distance_matrix": (0, 1),
    "feature_matrix": (0, 1),
    "dist_input": (0, 1),
    "dist_target": (0, 1),
    "coords": (0,),
    "dft_coords": (0,),
    "rdkit_coords": (0,),
    "dist_bins": (1, 2),   # (S, N, N)
    "restype": (0,),
    "residue_index": (0,),
    "asym_id": (0,),
    "target_feat": (0,),
    "msa_feat": (1,),         # (S, N, ...): sequences, then residues
    "msa_mask": (1,),
    "extra_msa_feat": (1,),
    "extra_msa_mask": (1,),
    "true_msa": (1,),
    "bert_mask": (1,),
}

DEFAULT_BUCKETS = (16, 24, 32, 48, 64)


def pick_bucket(max_nodes: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if max_nodes <= b:
            return b
    return max_nodes  # oversize graph: its own shape


def stack_with_pad(arrays: List[np.ndarray],
                   pad_to: Optional[Dict[int, int]] = None) -> np.ndarray:
    """Stack ragged arrays into a zero-padded dense batch; ``pad_to`` maps
    axis -> minimum padded size."""
    if np.ndim(arrays[0]) == 0:
        return np.stack(arrays)
    rank = arrays[0].ndim
    maxs = [max(a.shape[d] for a in arrays) for d in range(rank)]
    if pad_to:
        for d, size in pad_to.items():
            maxs[d] = max(maxs[d], size)
    out = np.zeros((len(arrays), *maxs), dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


def padded_collate(batch: List[Dict[str, np.ndarray]],
                   buckets: Optional[Sequence[int]] = DEFAULT_BUCKETS,
                   ) -> Dict[str, np.ndarray]:
    """List of row dicts -> padded dense arrays. With ``buckets`` node axes
    pad to the bucket size; with ``buckets=None`` to the batch's own max
    (the reference's collate, lib/data/dataset/collate.py:7-17)."""
    bucket = None
    if buckets is not None:
        max_nodes = max(int(np.asarray(row["num_nodes"])) if "num_nodes" in row
                        else len(row["node_mask"]) for row in batch)
        bucket = pick_bucket(max_nodes, buckets)
    with tracing.span("data.collate") as span:
        if span is not None:
            span.update(rows=len(batch), bucket=bucket)
        out = {}
        for k in batch[0].keys():
            arrays = [np.asarray(row[k]) for row in batch]
            pad_to = None
            if bucket is not None and k in _NODE_AXES:
                pad_to = {d: bucket for d in _NODE_AXES[k]}
            out[k] = stack_with_pad(arrays, pad_to)
        return out


def add_edge_mask(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """edge_mask = outer product of node_mask."""
    nm = batch["node_mask"].astype(np.float32)
    batch["edge_mask"] = nm[:, :, None] * nm[:, None, :]
    return batch


def pad_batch_dim(batch: Dict[str, np.ndarray], target_bsize: int
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Zero-pad the batch dimension to ``target_bsize``; returns the batch
    and a (target_bsize,) sample-validity mask."""
    b = len(next(iter(batch.values())))
    sample_mask = np.zeros(target_bsize, np.float32)
    sample_mask[:b] = 1
    if b == target_bsize:
        return batch, sample_mask
    out = {}
    for k, v in batch.items():
        pad_width = [(0, target_bsize - b)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    return out, sample_mask
