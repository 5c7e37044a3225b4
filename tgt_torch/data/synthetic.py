"""Synthetic molecular-graph dataset for tests and hermetic training runs
(counterpart of tgt_tpu/data/synthetic.py; the same seed gives the same
molecules as tgt_tpu's).

Random connected molecule-like graphs (spanning tree + extra ring bonds),
OGB-style integer features, 3D coordinates and a scalar target correlated
with graph statistics: the record schema of the PCQM dataset, so the
training path runs without the real download.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from tgt_torch.data.structural import AddStructuralData


def make_molecule(rs: np.random.RandomState, num_nodes: int) -> Dict:
    # spanning tree + ~15% extra edges (rings)
    edges = []
    for j in range(1, num_nodes):
        i = rs.randint(0, j)
        edges.append((i, j))
    n_extra = max(0, int(0.15 * num_nodes))
    for _ in range(n_extra):
        i, j = rs.randint(0, num_nodes, 2)
        if i != j:
            edges.append((min(i, j), max(i, j)))
    edges = sorted(set(edges))
    # undirected: store both directions like OGB
    und = np.array(edges + [(j, i) for i, j in edges], np.int64)
    edge_feats = rs.randint(0, 5, size=(len(edges), 3)).astype(np.int16)
    edge_feats = np.concatenate([edge_feats, edge_feats], axis=0)

    node_feats = rs.randint(0, 60, size=(num_nodes, 9)).astype(np.int16)
    coords = (rs.randn(num_nodes, 3) * 1.5).astype(np.float32)
    target = float(np.tanh(node_feats[:, 0].mean() / 30.0) * 2.0
                   + 0.05 * num_nodes + rs.randn() * 0.01)
    return {
        "num_nodes": num_nodes,
        "edges": und,
        "node_features": node_feats,
        "edge_features": edge_feats,
        "dft_coords": coords,
        "rdkit_coords": coords + rs.randn(num_nodes, 3).astype(np.float32) * 0.2,
        "target": target,
    }


class SyntheticDataset:
    """Map-style dataset of random molecules with cached structural
    transforms."""

    def __init__(self, num_samples: int = 256, max_nodes: int = 16,
                 seed: int = 0):
        rs = np.random.RandomState(seed)
        transform = AddStructuralData()
        self._cache = []
        for i in range(num_samples):
            # at least 4 atoms, tgt_tpu's default: a seed gives its molecules
            n = int(rs.randint(4, max_nodes + 1))
            row = make_molecule(rs, n)
            row["node_mask"] = np.ones(n, np.uint8)
            row["idx"] = i                   # global row id
            self._cache.append(transform(row))
        # per-row node counts, read by the size-bucketed sampler
        self.sizes = np.asarray([r["num_nodes"] for r in self._cache])

    def __len__(self):
        return len(self._cache)

    def __getitem__(self, idx: int) -> Dict:
        return dict(self._cache[idx])
