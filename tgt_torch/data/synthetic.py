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

:class:`SyntheticMSAStructures` is the source of the ``structure.evoformer``
scheme (AlphaFold 2's Evoformer): such a chain with a multiple sequence
alignment (:func:`make_msa`) and AlphaFold 2's input features
(:func:`msa_example`; Jumper et al. 2021, Supplementary sections 1.2.6-1.2.9
and Table 1): the masked MSA of the cluster rows (:func:`mask_msa`), each
extra row's nearest cluster, the cluster profiles and deletion means, the
49-channel ``msa_feat``, the 25-channel ``extra_msa_feat`` and the
22-channel ``target_feat``.
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


# AlphaFold 2's MSA alphabet: 20 amino acids, unknown (20), gap (21) and the
# masked-MSA token (22)
MSA_UNKNOWN, MSA_GAP, MSA_MASK = 20, 21, 22
MSA_CLASSES = 23
# the masked MSA (Supplementary section 1.2.7): the share of positions
# replaced, and their replacements: uniform over the amino acids, drawn
# from the profile, left as it is; else the mask token
MASK_RATE = 0.15
MASK_UNIFORM, MASK_PROFILE, MASK_SAME = 0.1, 0.1, 0.1
# assumed: each row's substitution and gap rates are uniform in these
# ranges; a position carries a deletion of 1-9 residues at this rate
MSA_SUBSTITUTION = (0.05, 0.5)
MSA_GAPS = (0.0, 0.15)
MSA_DELETION_RATE = 0.02


def make_msa(rng: np.random.Generator, query: np.ndarray, num_rows: int):
    """(num_rows, r) int32 residues and deletion counts: row 0 the query
    itself, each other row the query with a substitution rate and a gap
    rate of its own and sparse deletions."""
    r = len(query)
    sub = rng.uniform(*MSA_SUBSTITUTION, (num_rows, 1))
    gap = rng.uniform(*MSA_GAPS, (num_rows, 1))
    u = rng.random((num_rows, r))
    other = rng.integers(0, STANDARD_RESIDUES, (num_rows, r))
    msa = np.where(u < gap, MSA_GAP, np.where(u < gap + sub, other,
                                               query[None]))
    dels = np.where(rng.random((num_rows, r)) < MSA_DELETION_RATE,
                    rng.integers(1, 10, (num_rows, r)), 0)
    msa[0], dels[0] = query, 0
    return msa.astype(np.int32), dels.astype(np.int32)


def mask_msa(rng: np.random.Generator, msa: np.ndarray, profile: np.ndarray):
    """AlphaFold 2's masked MSA (section 1.2.7): each position is replaced
    at ``MASK_RATE``, by a draw that is uniform over the amino acids (0.1),
    from ``profile`` (r, 22) (0.1), the residue itself (0.1) or the mask
    token (0.7). Returns the corrupted MSA and the (n, r) float32 mask of the
    replaced positions."""
    n, r = msa.shape
    probs = np.zeros((n, r, MSA_CLASSES))
    probs[..., :STANDARD_RESIDUES] += MASK_UNIFORM / STANDARD_RESIDUES
    probs[..., :MSA_MASK] += MASK_PROFILE * profile[None]
    probs[..., :MSA_MASK] += MASK_SAME * np.eye(MSA_MASK)[msa]
    probs[..., MSA_MASK] = 1.0 - MASK_UNIFORM - MASK_PROFILE - MASK_SAME
    # inverse CDF; the last class takes what rounding leaves above 1
    draw = (probs.cumsum(-1) < rng.random((n, r, 1))).sum(-1)
    draw = np.minimum(draw, MSA_MASK)
    where = rng.random((n, r)) < MASK_RATE
    return (np.where(where, draw, msa).astype(np.int32),
            where.astype(np.float32))


def _deletion_value(d: np.ndarray) -> np.ndarray:
    return np.arctan(d / 3.0) * (2.0 / np.pi)


def msa_features(cluster: np.ndarray, cluster_dels: np.ndarray,
                 extra: np.ndarray, extra_dels: np.ndarray):
    """AlphaFold 2's ``msa_feat`` (n, r, 49) and ``extra_msa_feat`` (m, r,
    25), float32, of a (masked) cluster MSA and the extra rows. Each extra
    row joins the cluster it agrees with at the most positions, gaps and
    mask tokens not counted (section 1.2.7's nearest neighbour); a
    cluster's profile (23 classes) and deletion mean are taken over its
    centre and the extra rows that joined it."""
    eye = np.eye(MSA_CLASSES, dtype=np.float32)
    c_hot, e_hot = eye[cluster], eye[extra]
    n, r = cluster.shape
    agree = (e_hot[..., :MSA_GAP].reshape(len(extra), -1)
             @ c_hot[..., :MSA_GAP].reshape(n, -1).T)
    member = np.eye(n, dtype=np.float32)[agree.argmax(1)].T     # (n, m)
    counts = 1.0 + member.sum(1)[:, None]
    profile = (c_hot + (member @ e_hot.reshape(len(extra), -1)).reshape(
        n, r, MSA_CLASSES)) / counts[..., None]
    del_mean = (cluster_dels + member @ extra_dels) / counts
    msa_feat = np.concatenate([
        c_hot, np.clip(cluster_dels, 0, 1)[..., None],
        _deletion_value(cluster_dels)[..., None], profile,
        _deletion_value(del_mean)[..., None]], axis=-1)
    extra_feat = np.concatenate([
        e_hot, np.clip(extra_dels, 0, 1)[..., None],
        _deletion_value(extra_dels)[..., None]], axis=-1)
    return msa_feat.astype(np.float32), extra_feat.astype(np.float32)


def target_features(restype: np.ndarray) -> np.ndarray:
    """(r, 22): no chain break, then the residue type over 21 classes."""
    out = np.zeros((len(restype), 22), np.float32)
    out[np.arange(len(restype)), 1 + restype] = 1.0
    return out


def msa_example(rng: np.random.Generator, structure: Dict,
                num_clusters: int, num_extra: int) -> Dict:
    """``structure`` (:func:`make_structure`) with an MSA of its residues
    and AlphaFold 2's features: the query row 0 of ``num_clusters`` cluster
    rows, ``num_extra`` extra rows, the masked MSA's targets
    (``true_msa``) and positions (``bert_mask``)."""
    query = structure["restype"]
    msa, dels = make_msa(rng, query, num_clusters + num_extra)
    profile = np.eye(MSA_MASK)[msa].mean(0)
    bert, bert_mask = mask_msa(rng, msa[:num_clusters], profile)
    msa_feat, extra_feat = msa_features(bert, dels[:num_clusters],
                                        msa[num_clusters:],
                                        dels[num_clusters:])
    r = len(query)
    return dict(structure, target_feat=target_features(query),
                msa_feat=msa_feat, msa_mask=np.ones((num_clusters, r),
                                                    np.float32),
                extra_msa_feat=extra_feat,
                extra_msa_mask=np.ones((num_extra, r), np.float32),
                true_msa=msa[:num_clusters], bert_mask=bert_mask)


class SyntheticMSAStructures:
    """Map-style dataset of ``num_samples`` chains of ``min_tokens`` to
    ``max_tokens`` residues with their MSAs (:func:`msa_example`), drawn
    from ``seed``; item k is made when it is read, from a stream of its
    own."""

    def __init__(self, num_samples: int = 64, min_tokens: int = 16,
                 max_tokens: int = 32, num_clusters: int = 8,
                 num_extra: int = 16, seed: int = 0):
        self.seed = seed
        self.num_clusters, self.num_extra = num_clusters, num_extra
        rng = np.random.default_rng(seed)
        self.sizes = rng.integers(min_tokens, max_tokens + 1, num_samples)

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng([self.seed, idx])
        return msa_example(rng, make_structure(rng, int(self.sizes[idx])),
                           self.num_clusters, self.num_extra)
