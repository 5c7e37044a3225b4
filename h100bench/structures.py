"""The structure traffic of the Pairformer's training cell: a mix's
parameters (``traffic/<mix>.json``: ``crop_tokens``, ``chain_tokens``)
and the run's seed give crop k of the run.

Crop k is a contiguous window of ``crop_tokens`` residues of one chain of
a length drawn uniformly from ``chain_tokens``, at a uniform start: residue
types uniform over the 20 standard amino acids (ids 0-19), the residue
index the chain's own, one chain (``asym_id`` 0), and one representative
atom per residue on a persistent random walk of 3.8 A steps (each step's
direction the last one's plus 1.2 times a standard normal, normalised).
Every crop has the same number of tokens, so two seeds do the same work.

The walk is the same as the program's ``tgt_torch.data.synthetic.
make_structure`` (which the ``structure.distogram`` scheme trains on), but
the benchmark keeps its own copy: its inputs are part of its yardstick, so a
change to the program's data layer must not change the crops both sides of a
comparison train on.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

STANDARD_RESIDUES = 20
STEP_A = 3.8
ITEM, WARM = 2, 3       # stream tags, as generator.py's


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(w) % (2 ** 64) for w in words]))


def chain_walk(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3) float32 positions of a persistent walk of ``STEP_A`` steps,
    centred."""
    noise = rng.standard_normal((n, 3))
    steps = np.empty((n, 3))
    direction = noise[0]
    for t in range(n):
        direction = direction / np.linalg.norm(direction)
        steps[t] = direction
        direction = direction + 1.2 * noise[t]
    x = np.cumsum(steps * STEP_A, axis=0)
    return (x - x.mean(0)).astype(np.float32)


def crop(rng: np.random.Generator, mix: dict) -> Dict[str, np.ndarray]:
    n = int(mix["crop_tokens"])
    lo, hi = mix["chain_tokens"]
    length = int(rng.integers(max(lo, n), hi + 1))
    start = int(rng.integers(0, length - n + 1))
    restype = rng.integers(0, STANDARD_RESIDUES, length).astype(np.int32)
    coords = chain_walk(rng, length)
    window = slice(start, start + n)
    return {"num_nodes": n, "restype": restype[window],
            "residue_index": np.arange(start, start + n, dtype=np.int32),
            "asym_id": np.zeros(n, np.int32),
            "coords": coords[window] - coords[window].mean(0),
            "node_mask": np.ones(n, np.uint8)}


class Crops:
    """Crop k of a mix under one run seed, from a stream of its own."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)

    def crop(self, k: int) -> Dict[str, np.ndarray]:
        return crop(_rng(self.seed, ITEM, k), self.mix)

    def tokens(self, k: int) -> int:
        return int(self.mix["crop_tokens"])
