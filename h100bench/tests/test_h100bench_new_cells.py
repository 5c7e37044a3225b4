"""The Pairformer's training cell at a tiny preset on the CPU, through the
same driver and reference as on the card; its crops; its operation count
against the publication's widths."""
from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h100bench import harness, structures
from h100bench import run as runmod
from h100bench.yardstick import pairformer

PAIRFORMER = "pairformer_af3.train_crop384"


def tiny_bench() -> harness.Bench:
    """The Pairformer cell at 2 blocks and small widths, 12-token crops."""
    bench = harness.Bench()
    c = bench.cell(PAIRFORMER)
    cfg = copy.deepcopy(bench.config(c["config"]))
    mix = copy.deepcopy(bench.mix(c["traffic"]))
    cfg["config"].update(num_blocks=2, single_width=24, pair_width=16,
                         tri_mul_width=16, tri_att_heads=2,
                         tri_att_head_width=8, single_heads=2,
                         single_head_width=12, buckets=[12],
                         mixed_precision=False)
    mix.update(crop_tokens=12, chain_tokens=[12, 30])
    bench.config = lambda name: cfg
    bench.mix = lambda name: mix
    return bench


def test_run_matches_reference():
    args = SimpleNamespace(workload=PAIRFORMER, seed=2_147_483_711, seconds=1.0,
                           trace=0)
    rec = runmod.execute(tiny_bench(), args, torch.device("cpu"),
                         time.perf_counter())
    assert rec["result"]["correct"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    for name, value in rec["numbers"].items():
        assert value < 1e-3, (name, value)


def test_crops_are_contiguous_windows():
    mix = {"crop_tokens": 20, "chain_tokens": [20, 60]}
    crops = structures.Crops(mix, 9)
    a, b = crops.crop(4), crops.crop(4)
    assert all(np.array_equal(a[k], b[k]) for k in a if k != "num_nodes")
    assert np.array_equal(np.diff(a["residue_index"]), np.ones(19))
    step = np.linalg.norm(np.diff(a["coords"], axis=0), axis=1)
    assert np.allclose(step, structures.STEP_A, atol=1e-4)


def test_pairformer_operations_at_the_published_widths():
    """One forward of one block at 384 tokens is about 254 GFLOP, of which
    the triangle updates take about 194."""
    cfg = harness.Bench().config("pairformer_af3")["config"]
    one = dict(cfg, num_blocks=1)
    none = dict(cfg, num_blocks=0)
    block = (pairformer.pair_forward_flops(one, 384)
             - pairformer.pair_forward_flops(none, 384)
             + pairformer.single_forward_flops(one, 384))
    assert 250e9 < block < 258e9
    step = pairformer.train_flops(cfg, [384])
    assert 34e12 < step < 37e12


def test_single_gap():
    ref = torch.ones(4, 6)
    assert pairformer.single_gap(ref.clone(), ref) == 0.0
    assert pairformer.single_gap(ref * 1.01, ref) == pytest.approx(0.01)
    assert pairformer.single_gap(ref * float("nan"), ref) == float("inf")
