"""Plain version of what the program derives from a raw molecule before its
model runs: the structural transform (offset-encoded features, all-pairs
hop distances, the edge features scattered to a matrix), padding to the
bucket, the masks, distances from coordinates and their bins.

As the published data pipeline (lib/data/pcqm/structural_transform.py,
lib/data/dataset/collate.py, lib/training_schemes/pcqm/commons.py), in
numpy and plain torch.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

NODE_OFFSET = 128
EDGE_OFFSET = 8
UNREACHABLE = 510


def structural(mol: dict) -> Dict[str, np.ndarray]:
    """Offset-encoded node features (n, 9), hop distances (n, n) with
    unreachable pairs 510, edge features (n, n, 3), 0 where no edge."""
    n = int(mol["num_nodes"])
    nf = mol["node_features"].astype(np.int64)
    ef = mol["edge_features"].astype(np.int64)
    node = nf + 1 + NODE_OFFSET * np.arange(nf.shape[1])
    enc = ef + 1 + EDGE_OFFSET * np.arange(ef.shape[1])
    adj = np.zeros((n, n), bool)
    featm = np.zeros((n, n, ef.shape[1]), np.int64)
    edges = np.asarray(mol["edges"], np.int64).reshape(-1, 2)
    if len(edges):
        adj[edges[:, 0], edges[:, 1]] = True
        featm[edges[:, 0], edges[:, 1]] = enc
    hops = np.where(adj, 1, UNREACHABLE).astype(np.int64)
    np.fill_diagonal(hops, 0)
    for k in range(n):
        hops = np.minimum(hops, hops[:, k:k + 1] + hops[k:k + 1, :])
    return {"node_features": node, "distance_matrix": hops,
            "feature_matrix": featm}


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return int(b)
    return int(n)


def coords2dist(coords: torch.Tensor) -> torch.Tensor:
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    return torch.sqrt(torch.square(diff).sum(dim=-1) + 1e-24)


def collate(mols: List[dict], buckets: Sequence[int], batch_rows: int,
            device, coords_keys=("rdkit_coords",)) -> Dict[str, torch.Tensor]:
    """The padded batch of ``mols`` at their bucket, ``batch_rows`` rows
    (rows past the molecules are all padding): integer features, node and
    edge masks, ``sample_mask``, and each of ``coords_keys`` zero-padded."""
    bucket = pick_bucket(max(int(m["num_nodes"]) for m in mols), buckets)
    b = batch_rows
    out = {"node_features": np.zeros((b, bucket, 9), np.int64),
           "distance_matrix": np.zeros((b, bucket, bucket), np.int64),
           "feature_matrix": np.zeros((b, bucket, bucket, 3), np.int64),
           "node_mask": np.zeros((b, bucket), np.float32),
           "sample_mask": np.zeros((b,), np.float32)}
    for key in coords_keys:
        out[key] = np.zeros((b, bucket, 3), np.float32)
    for r, mol in enumerate(mols):
        n = int(mol["num_nodes"])
        s = structural(mol)
        out["node_features"][r, :n] = s["node_features"]
        out["distance_matrix"][r, :n, :n] = s["distance_matrix"]
        out["feature_matrix"][r, :n, :n] = s["feature_matrix"]
        out["node_mask"][r, :n] = 1.0
        out["sample_mask"][r] = 1.0
        for key in coords_keys:
            out[key][r, :n] = mol[key]
    t = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    nm = t["node_mask"]
    t["edge_mask"] = nm[:, :, None] * nm[:, None, :]
    return t


def distance_bins(dist: torch.Tensor, num_bins: int,
                  range_bins: float) -> torch.Tensor:
    """bin = clamp(trunc(d (B - 1) / range), 0, B - 1)."""
    d = dist * ((num_bins - 1) / range_bins)
    return d.to(torch.int32).clamp(0, num_bins - 1).long()
