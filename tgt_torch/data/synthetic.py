"""Synthetic molecular-graph dataset for tests and hermetic training runs
(counterpart of tgt_tpu/data/synthetic.py; the same seed gives the same
molecules as tgt_tpu's).

Random connected molecule-like graphs (spanning tree + extra ring bonds),
OGB-style integer features, 3D coordinates and a scalar target correlated
with graph statistics: the record schema of the PCQM dataset, so the
training path runs without the real download.

:class:`SyntheticStructures` is the structure source of the
``structure.distogram`` scheme (the Pairformer): one chain per structure,
residue types drawn from the 20 standard amino acids (ids 0-19 of 32),
residue index 0..n-1, and a representative atom per residue on a
persistent random walk of 3.8 A steps (the C-alpha spacing), whose
distances the distogram is trained on.
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


STANDARD_RESIDUES = 20
CA_STEP = 3.8           # A between consecutive representative atoms


def make_structure(rng: np.random.Generator, num_tokens: int) -> Dict:
    """One chain of ``num_tokens`` residues: ``restype``,
    ``residue_index``, ``asym_id`` (all int32) and ``coords`` (float32,
    A), a walk whose each step keeps most of the last one's direction."""
    steps = np.empty((num_tokens, 3))
    direction = rng.standard_normal(3)
    for t in range(num_tokens):
        direction = direction / np.linalg.norm(direction)
        steps[t] = direction
        direction = direction + 1.2 * rng.standard_normal(3)
    coords = np.cumsum(steps * CA_STEP, axis=0)
    return {"num_nodes": num_tokens,
            "restype": rng.integers(0, STANDARD_RESIDUES,
                                    num_tokens).astype(np.int32),
            "residue_index": np.arange(num_tokens, dtype=np.int32),
            "asym_id": np.zeros(num_tokens, np.int32),
            "coords": (coords - coords.mean(0)).astype(np.float32),
            "node_mask": np.ones(num_tokens, np.uint8)}


class SyntheticStructures:
    """Map-style dataset of ``num_samples`` chains of ``min_tokens`` to
    ``max_tokens`` residues, drawn from ``seed``."""

    def __init__(self, num_samples: int = 64, min_tokens: int = 16,
                 max_tokens: int = 32, seed: int = 0):
        rng = np.random.default_rng(seed)
        self._cache = [make_structure(rng, int(rng.integers(
            min_tokens, max_tokens + 1))) for _ in range(num_samples)]
        self.sizes = np.asarray([r["num_nodes"] for r in self._cache])

    def __len__(self):
        return len(self._cache)

    def __getitem__(self, idx: int) -> Dict:
        return dict(self._cache[idx])
