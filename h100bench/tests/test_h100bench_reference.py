"""The plain reference against the port at a tiny size on the CPU, in
float32 with dropout on: one forward of each family, draw-stacked or not,
and the whole of a run of each cell (its check steps or judged requests)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench import generator, program
from h100bench.reference import data as ref_data
from h100bench.reference import model as ref_model
from h100bench.tests import tiny


def _tiny_cfg(family: str) -> dict:
    bench = tiny.bench_for(tiny.TRAIN if family == "at" else tiny.SERVE)
    return bench.config("")["config"]


@pytest.mark.parametrize("family", ["at", "agx2"])
@pytest.mark.parametrize("draws", [1, 3])
def test_forward_matches_port(family, draws):
    cfg = _tiny_cfg(family)
    device = torch.device("cpu")
    weights = ref_model.run_weights(cfg, 5, device)
    scheme = program.scheme(cfg, "evaluate")
    model = program.distance_model(scheme.model_cfg, weights, device)
    mols = [generator.molecule(np.random.default_rng(i), n)
            for i, n in enumerate([5, 9, 12])]
    rows = 4
    batch = ref_data.collate(mols, cfg["buckets"], rows, device)
    batch["dist_input"] = ref_data.coords2dist(batch["rdkit_coords"])
    feed = {k: batch[k] for k in ("node_features", "distance_matrix",
                                  "feature_matrix", "node_mask", "edge_mask",
                                  "dist_input")}
    seeds = [11 + s for s in range(draws)]
    stacked = {k: v.repeat(draws, *(1,) * (v.dim() - 1))
               for k, v in feed.items()}
    with torch.no_grad():
        got = model(stacked, deterministic=False,
                    seed=seeds if draws > 1 else seeds[0]).float()
        want = ref_model.forward(
            weights, cfg, stacked, seeds=seeds,
            draw_of=[s for s in range(draws) for _ in range(rows)],
            rows=list(range(rows)) * draws, program_batch=rows)
    valid = batch["edge_mask"].repeat(draws, 1, 1).bool()
    err = (got - want).abs()[valid].max().item()
    assert err <= 1e-4 * want[valid].abs().max().item()


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SERVE])
def test_run_matches_reference(cell):
    rec = tiny.run(cell)
    assert rec["result"]["correct"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    for name, value in rec["numbers"].items():
        assert value < 1e-3, (name, value)
