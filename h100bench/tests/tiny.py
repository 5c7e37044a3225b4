"""A tiny preset of each cell for the CPU tests: the cell's configuration
and mix with small widths, depth, buckets and batches, run in float32
through the same drivers and reference as on the card."""
from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import torch

from h100bench import harness
from h100bench import run as runmod

TRAIN = "tgt_at_dp.train_pcqm"
SERVE = "tgt_agx2_dp.serve_single_vmap"


def bench_for(cell: str) -> harness.Bench:
    """The benchmark with the cell's configuration and mix cut to the
    tiny preset."""
    bench = harness.Bench()
    c = bench.cell(cell)
    cfg = copy.deepcopy(bench.config(c["config"]))
    cfg["config"].update(node_width=32, edge_width=16, num_heads=4,
                         triplet_heads=4, model_height=3, buckets=[8, 12, 16],
                         batch_size=4, global_batch_size=4,
                         mixed_precision=False)
    mix = copy.deepcopy(bench.mix(c["traffic"]))
    mix.update(clip=[4, 16], pool_items=4, pool_seed=0)
    if mix["driver"] == "train":
        mix.update(item_molecules=4, mix=[
            {"kind": "lognormal", "mu": 2.0, "sigma": 0.3, "count": 16}])
    else:
        mix.update(batch_size=4, check_requests=3, mix=[
            {"kind": "lognormal", "mu": 2.0, "sigma": 0.3, "count": 3},
            {"kind": "uniform", "low": 10, "high": 16, "count": 1}])
    bench.config = lambda name: cfg
    bench.mix = lambda name: mix
    return bench


def run(cell: str, seed: int = 2_147_483_711, seconds: float = 1.0,
        reference_cast=None) -> dict:
    """One run of the cell's tiny preset on the CPU, the harness's look
    for a card skipped."""
    args = SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                           trace=0)
    return runmod.execute(bench_for(cell), args, torch.device("cpu"),
                          time.perf_counter(), reference_cast=reference_cast)
