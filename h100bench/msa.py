"""The MSA traffic of the Evoformer's training cell: a mix's parameters
(``traffic/<mix>.json``) and the run's seed give crop k of the run.

Crop k is the structure crop of ``structures.crop`` (a contiguous window
of ``crop_tokens`` residues of a chain of a length drawn from
``chain_tokens``) with a multiple sequence alignment of its window:
``msa_clusters`` cluster rows, the query (the crop's residue types) as row
0, and ``msa_extra`` extra rows. Every other row is the query with a
substitution rate and a gap rate of its own, uniform in ``substitution``
and ``gaps``, and a deletion of 1-9 residues at a position at
``deletion_rate``. The cluster rows are corrupted as AlphaFold 2's masked
MSA does (Jumper et al. 2021, Supplementary section 1.2.7): each position
at ``masked_msa.rate``, to a uniform amino acid, a draw from the MSA's
profile or itself (``uniform``, ``profile``, ``same``), else to the mask
token. The features are AlphaFold 2's (section 1.2.9, Table 1):
``target_feat`` (r, 22), ``msa_feat`` (s, r, 49) with each cluster's
profile and deletion mean over its centre and the extra rows nearest to it
(the most agreeing positions, gaps not counted), ``extra_msa_feat`` (S, r,
25).

The program's data layer has its own source of the same kind
(``tgt_torch.data.synthetic.msa_example``), which the cell does not use:
the benchmark's inputs are part of its yardstick.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from h100bench import structures

AMINO, UNKNOWN, GAP, MASK, CLASSES = 20, 20, 21, 22, 23


def alignment(rng: np.random.Generator, query: np.ndarray, rows: int,
              mix: dict):
    """(rows, r) residues and deletion counts, row 0 the query."""
    r = len(query)
    sub = rng.uniform(*mix["substitution"], (rows, 1))
    gap = rng.uniform(*mix["gaps"], (rows, 1))
    u = rng.random((rows, r))
    msa = np.where(u < gap, GAP,
                   np.where(u < gap + sub, rng.integers(0, AMINO, (rows, r)),
                            query[None])).astype(np.int32)
    dels = np.where(rng.random((rows, r)) < mix["deletion_rate"],
                    rng.integers(1, 10, (rows, r)), 0).astype(np.int32)
    msa[0], dels[0] = query, 0
    return msa, dels


def corrupt(rng: np.random.Generator, msa: np.ndarray, profile: np.ndarray,
            masked: dict):
    """The masked MSA of ``msa`` and the mask of its replaced positions."""
    n, r = msa.shape
    probs = np.zeros((n, r, CLASSES))
    probs[..., :AMINO] = masked["uniform"] / AMINO
    probs[..., :MASK] += masked["profile"] * profile
    probs[np.arange(n)[:, None], np.arange(r)[None], msa] += masked["same"]
    probs[..., MASK] = (1.0 - masked["uniform"] - masked["profile"]
                        - masked["same"])
    cdf = np.cumsum(probs, axis=-1)
    draw = np.minimum((rng.random((n, r, 1)) > cdf).sum(-1), MASK)
    replaced = rng.random((n, r)) < masked["rate"]
    return np.where(replaced, draw, msa).astype(np.int32), replaced


def _onehot(x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape + (CLASSES,), np.float32)
    np.put_along_axis(out, x[..., None].astype(np.int64), 1.0, axis=-1)
    return out


def _deletion_value(d):
    return 2.0 / np.pi * np.arctan(np.asarray(d, np.float64) / 3.0)


def features(cluster, cluster_dels, extra, extra_dels):
    """``msa_feat`` (n, r, 49) and ``extra_msa_feat`` (m, r, 25)."""
    n = len(cluster)
    agree = np.stack([((extra == c[None]) & (extra <= UNKNOWN)).sum(1)
                      for c in cluster], axis=1)                   # (m, n)
    nearest = agree.argmax(1)
    c_hot, e_hot = _onehot(cluster), _onehot(extra)
    profile = np.empty_like(c_hot)
    del_mean = np.empty(cluster.shape, np.float64)
    for c in range(n):
        members = nearest == c
        count = 1 + int(members.sum())
        profile[c] = (c_hot[c] + e_hot[members].sum(0)) / count
        del_mean[c] = (cluster_dels[c] + extra_dels[members].sum(0)) / count
    msa_feat = np.concatenate(
        [c_hot, np.minimum(cluster_dels, 1)[..., None],
         _deletion_value(cluster_dels)[..., None], profile,
         _deletion_value(del_mean)[..., None]], axis=-1)
    extra_feat = np.concatenate(
        [e_hot, np.minimum(extra_dels, 1)[..., None],
         _deletion_value(extra_dels)[..., None]], axis=-1)
    return msa_feat.astype(np.float32), extra_feat.astype(np.float32)


def msa_crop(rng: np.random.Generator, mix: dict) -> Dict[str, np.ndarray]:
    out = structures.crop(rng, mix)
    query, r = out["restype"], len(out["restype"])
    n, m = mix["msa_clusters"], mix["msa_extra"]
    msa, dels = alignment(rng, query, n + m, mix)
    hot = np.zeros((r, MASK))
    for row in msa:
        hot[np.arange(r), row] += 1.0
    bert, replaced = corrupt(rng, msa[:n], hot / len(msa), mix["masked_msa"])
    msa_feat, extra_feat = features(bert, dels[:n], msa[n:], dels[n:])
    target = np.zeros((r, 22), np.float32)
    target[np.arange(r), 1 + query] = 1.0
    out.update(target_feat=target, msa_feat=msa_feat,
               msa_mask=np.ones((n, r), np.float32),
               extra_msa_feat=extra_feat,
               extra_msa_mask=np.ones((m, r), np.float32),
               true_msa=msa[:n], bert_mask=replaced.astype(np.float32))
    return out


class MSACrops:
    """Crop k of a mix under one run seed, from a stream of its own."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)

    def crop(self, k: int) -> Dict[str, np.ndarray]:
        return msa_crop(structures._rng(self.seed, structures.ITEM, k),
                        self.mix)

    def tokens(self, k: int) -> int:
        return int(self.mix["crop_tokens"])
