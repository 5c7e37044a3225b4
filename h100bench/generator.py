"""The one traffic generator: takes a mix's parameters (``traffic/<mix>.json``)
and makes its molecules from the run's seed.

A mix is a cycle of ``pool_items`` items (a request, or a training batch)
of ``item_molecules`` molecules each. The atom counts of the cycle are
drawn once from ``pool_seed`` out of ``mix`` (each part a lognormal
``round(exp(N(mu, sigma)))`` or a uniform integer range, with its count),
clipped to ``clip``; they are the same for every run seed. The run seed
permutes the items anew in every cycle and draws every molecule's graph,
features and coordinates, so that two seeds do the same work in another
order and on other molecules.

A molecule is a connected molecule-like graph (a random spanning tree and
about 15% ring bonds) with OGB-style integer features (9 per atom, 3 per
bond, both bond directions listed) and coordinates: ``dft_coords`` drawn at
1.5 A per axis, ``rdkit_coords`` the same moved by 0.2 A per axis.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from h100bench.reference.data import pick_bucket

# stream tags: the cycle order, the window's molecules, warm-up molecules
ORDER, ITEM, WARM = 1, 2, 3


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(w) % (2 ** 64) for w in words]))


def pool_sizes(mix: dict) -> List[List[int]]:
    """The atom counts of each item of the cycle, fixed by ``pool_seed``."""
    rng = _rng(mix["pool_seed"])
    lo, hi = mix["clip"]
    parts = []
    for part in mix["mix"]:
        if part["kind"] == "lognormal":
            s = np.round(np.exp(rng.normal(part["mu"], part["sigma"],
                                           part["count"])))
        elif part["kind"] == "uniform":
            s = rng.integers(part["low"], part["high"] + 1, part["count"])
        else:
            raise ValueError(f"unknown size distribution {part['kind']!r}")
        parts.append(np.clip(s, lo, hi).astype(int))
    sizes = np.concatenate(parts)
    want = mix["pool_items"] * mix["item_molecules"]
    if len(sizes) != want:
        raise ValueError(f"the mix draws {len(sizes)} sizes for {want} "
                         "molecules of the cycle")
    sizes = sizes[rng.permutation(len(sizes))]
    k = mix["item_molecules"]
    return [sizes[i * k:(i + 1) * k].tolist() for i in range(mix["pool_items"])]


def molecule(rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
    parents = np.floor(rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    i = np.concatenate([parents, rng.integers(0, n, int(0.15 * n))])
    j = np.concatenate([np.arange(1, n), rng.integers(0, n, int(0.15 * n))])
    keep = i != j
    lo, hi = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    pairs = np.unique(lo * n + hi)
    a, b = pairs // n, pairs % n
    edges = np.concatenate([np.stack([a, b], 1), np.stack([b, a], 1)])
    ef = rng.integers(0, 5, (len(pairs), 3)).astype(np.int16)
    dft = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32)
    rdkit = dft + (rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
    return {"num_nodes": n, "edges": edges.astype(np.int64),
            "node_features": rng.integers(0, 60, (n, 9)).astype(np.int16),
            "edge_features": np.concatenate([ef, ef]),
            "dft_coords": dft, "rdkit_coords": rdkit}


class Traffic:
    """Items of a mix under one run seed: ``sizes(k)`` and
    ``molecules(k)`` of item k (k = 0, 1, ...), and ``warm(p)``, the
    molecules of a warm-up copy of pool item p, drawn apart from the
    window's."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.pool = pool_sizes(mix)
        self._orders: Dict[int, np.ndarray] = {}

    def _order(self, cycle: int) -> np.ndarray:
        if cycle not in self._orders:
            self._orders[cycle] = _rng(self.seed, ORDER, cycle).permutation(
                len(self.pool))
        return self._orders[cycle]

    def sizes(self, k: int) -> List[int]:
        cycle, pos = divmod(k, len(self.pool))
        return self.pool[self._order(cycle)[pos]]

    def molecule(self, k: int, pos: int) -> dict:
        """Molecule ``pos`` of item k, from a stream of its own."""
        return molecule(_rng(self.seed, ITEM, k, pos), self.sizes(k)[pos])

    def molecules(self, k: int) -> List[dict]:
        return [self.molecule(k, pos) for pos in range(len(self.sizes(k)))]

    def warm(self, pool_item: int) -> List[dict]:
        return [molecule(_rng(self.seed, WARM, pool_item, pos), n)
                for pos, n in enumerate(self.pool[pool_item])]


def bucket_of(sizes: List[int], buckets: List[int]) -> int:
    """The bucket an item of molecules of these sizes is padded to."""
    return pick_bucket(max(sizes), buckets)
