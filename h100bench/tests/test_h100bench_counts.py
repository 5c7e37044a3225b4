"""The benchmark's operation and byte counts: the model FLOPs against
PyTorch's FlopCounterMode on the plain reference at a tiny unpadded size,
and the triplet cores' byte bounds against chip_smoke.py's arithmetic."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import generator
from h100bench.reference import data as ref_data
from h100bench.reference import model as ref_model
from h100bench.tests import tiny
from h100bench.yardstick import bounds, flops


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SERVE])
@pytest.mark.parametrize("n", [5, 11])
def test_forward_flops_match_flop_counter(cell, n):
    cfg = dict(tiny.bench_for(cell).config("")["config"], buckets=[n])
    weights = ref_model.run_weights(cfg, 3, torch.device("cpu"))
    mol = generator.molecule(np.random.default_rng(n), n)
    batch = ref_data.collate([mol], [n], 1, torch.device("cpu"))
    batch["dist_input"] = ref_data.coords2dist(batch["rdkit_coords"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref_model.forward(weights, cfg, batch)
    counted = counter.get_total_flops()
    assert abs(flops.forward_flops(cfg, n) - counted) <= 1e-9 * counted


def test_training_counts_three_forwards():
    cfg = tiny.bench_for(tiny.TRAIN).config("")["config"]
    assert flops.train_flops(cfg, [5, 7]) == pytest.approx(
        3 * (flops.forward_flops(cfg, 5) + flops.forward_flops(cfg, 7)))


def test_bounds_agree_with_chip_smoke():
    """chip_smoke.py's byte and operation bounds at b=16, N=48, bf16, on
    the cores' shapes (meta tensors: only sizes are read)."""
    import chip_smoke

    b, n, d, h = 16, 48, 16, 16
    bf = torch.bfloat16

    def t(*shape):
        return torch.empty(*shape, dtype=bf, device="meta")

    q, k, v = t(b, n, n, d, h), t(b, n, n, d, h), t(b, n, n, d, h)
    bias, gate, out = t(b, n, n, h), t(b, n, n, h), t(b, n, n, d, h)
    ms, _ = chip_smoke.bound((q, k, v, bias, gate), out, bf)
    assert bounds.call_seconds("dense_fwd", b, n, d, h, 2) * 1e3 == \
        pytest.approx(ms, rel=1e-12)
    ms, _ = chip_smoke.bwd_bound((q, k, v, bias, gate), out,
                                 (q, k, v, bias, gate), bf)
    assert bounds.call_seconds("dense_bwd", b, n, d, h, 2) * 1e3 == \
        pytest.approx(ms, rel=1e-12)
    a = t(b, n, n, h)
    ms, _ = chip_smoke.agg_bound((a, v, out), 2.0, bf)
    assert bounds.call_seconds("agg_fwd", b, n, d, h, 2) * 1e3 == \
        pytest.approx(ms, rel=1e-12)
    ms, _ = chip_smoke.agg_bound((a, v, out, a, v), 4.0, bf)
    assert bounds.call_seconds("agg_bwd", b, n, d, h, 2) * 1e3 == \
        pytest.approx(ms, rel=1e-12)
