"""The Evoformer's training cell at a tiny preset on the CPU, through the
same driver and reference as on the card; its files found by name; its
alignments and features against the program's own source; its operation
count and the outer product mean's bound against hand counts; its metrics
silent under the other drivers."""
from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h100bench import harness, msa
from h100bench import run as runmod
from h100bench.yardstick import bounds, evoformer

CELL = "evoformer_af2.train_crop256"
METRICS = ("train_mfu.evoformer", "device_idle.evoformer",
           "launches_per_mol.evoformer", "evoformer_msa_host_ms_per_crop",
           "outer_product_mean_fwd_roofline")
TINY = dict(num_blocks=2, num_extra_blocks=1, msa_width=16,
            extra_msa_width=8, pair_width=8, msa_heads=2, msa_head_width=4,
            extra_msa_heads=2, extra_msa_head_width=4, opm_width=4,
            tri_mul_width=8, tri_att_heads=2, tri_att_head_width=4)


def tiny_bench() -> harness.Bench:
    """The Evoformer cell at 2 + 1 blocks and small widths, 12-residue crops
    with 6 cluster rows and 10 extra rows."""
    bench = harness.Bench()
    c = bench.cell(CELL)
    cfg = copy.deepcopy(bench.config(c["config"]))
    mix = copy.deepcopy(bench.mix(c["traffic"]))
    cfg["config"].update(TINY, buckets=[12], mixed_precision=False)
    mix.update(crop_tokens=12, chain_tokens=[12, 30], msa_clusters=6,
               msa_extra=10)
    bench.config = lambda name: cfg
    bench.mix = lambda name: mix
    return bench


def test_run_matches_reference():
    args = SimpleNamespace(workload=CELL, seed=2_147_483_711, seconds=1.0,
                           trace=0)
    rec = runmod.execute(tiny_bench(), args, torch.device("cpu"),
                         time.perf_counter())
    assert rec["result"]["correct"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert set(rec["numbers"]) == {"loss_gap", "grad_gap", "change_gap"}
    for name, value in rec["numbers"].items():
        assert value < 1e-3, (name, value)


def test_cell_files_found_by_name():
    bench = harness.Bench()
    cell = bench.cell(CELL)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    assert cfg["config"]["scheme"] == "structure.evoformer"
    assert (mix["crop_tokens"], mix["msa_clusters"], mix["msa_extra"]) == \
        (256, 128, 1024)
    assert set(bench.limits(CELL)) <= {"loss_gap", "grad_gap", "change_gap"}
    assert hasattr(bench.driver(mix["driver"]), "run")
    assert {m["name"] for m in bench.per_layer(CELL)} == set(METRICS)
    assert {m["name"] for m in bench.end_to_end(CELL)} == {
        "train_molecules_per_s", "setup_s"}
    assert bench.marked_calls(CELL) == [
        "tgt_torch.ops.msa:OuterProductMean.forward"]


def test_crops_and_features_match_the_program_source():
    """A crop is deterministic, row 0 its query; the benchmark's features
    of an alignment equal the program's source's of the same alignment."""
    from tgt_torch.data import synthetic
    mix = dict(harness.Bench().mix("train_crop256_msa"), crop_tokens=20,
               chain_tokens=[20, 40], msa_clusters=12, msa_extra=30)
    crops = msa.MSACrops(mix, 3)
    a, b = crops.crop(2), crops.crop(2)
    assert all(np.array_equal(a[k], b[k]) for k in a if k != "num_nodes")
    assert np.array_equal(a["true_msa"][0], a["restype"])
    assert a["msa_feat"].shape == (12, 20, 49)
    assert a["extra_msa_feat"].shape == (30, 20, 25)
    rng = np.random.default_rng(0)
    query = rng.integers(0, 20, 20).astype(np.int32)
    ali, dels = msa.alignment(rng, query, 42, mix)
    profile = np.eye(22)[ali].mean(0)
    bert, _ = msa.corrupt(rng, ali[:12], profile, mix["masked_msa"])
    got = msa.features(bert, dels[:12], ali[12:], dels[12:])
    want = synthetic.msa_features(bert, dels[:12], ali[12:], dels[12:])
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.allclose(g, w, atol=1e-6)


def test_operations_against_a_hand_count():
    """r = 4 residues, s = 3 cluster rows, S = 5 extra rows, one block of
    each stack at small widths, every product counted by hand."""
    cfg = dict(TINY, num_blocks=1, num_extra_blocks=1,
               transition_multiplier=4, max_relative_offset=2,
               num_dist_bins=8)
    r, s, S = 4, 3, 5

    def msa_block(cm, h, c, rows, glob):
        hc = h * c
        proj = 2 * rows * r * cm * (3 * hc + hc) + 2 * rows * r * hc * cm
        row = proj + 2 * r * r * 8 * h + 2 * 2 * rows * h * r * r * c
        if glob:
            col = (2 * r * cm * hc + 2 * rows * r * cm * 2 * c
                   + 2 * rows * r * cm * hc + 2 * rows * r * hc * cm
                   + 2 * 2 * r * h * rows * c)
        else:
            col = proj + 2 * 2 * r * h * rows * rows * c
        ffn = 2 * rows * r * cm * 4 * cm * 2
        opm = 2 * rows * r * cm * 8 + 2 * rows * (r * 4) ** 2 \
            + 2 * r * r * 16 * 8
        return row + col + ffn + opm

    tri_mul = 2 * r * r * 8 * 32 + 2 * r * r * 64 + 2 * r ** 3 * 8 \
        + 2 * r * r * 64
    tri_att = 2 * r * r * 8 * (24 + 2 + 8) + 4 * r ** 3 * 8 + 2 * r * r * 64
    pair = 2 * tri_mul + 2 * tri_att + 2 * r * r * 8 * 32 * 2
    embed = (2 * 2 * r * 22 * 8 + 2 * r * r * 5 * 8 + 2 * s * r * 49 * 16
             + 2 * r * 22 * 16 + 2 * S * r * 25 * 8)
    heads = 2 * r * r * 8 * 8 + 2 * s * r * 16 * 23
    want = (embed + msa_block(16, 2, 4, s, False) + msa_block(8, 2, 4, S, True)
            + 2 * pair + heads)
    assert evoformer.forward_flops(cfg, r, s, S) == want
    assert evoformer.train_flops(cfg, [(r, s, S)] * 2) == 6 * want


def test_operations_at_the_published_widths():
    """One main block's forward at 256 residues and 128 clusters is about
    216 GFLOP, 126 of it the MSA track; a crop's three forwards ~35 TFLOP."""
    cfg = harness.Bench().config("evoformer_af2")["config"]
    msa_track = evoformer.msa_track_flops(cfg, 256, 128, False)
    assert 120e9 < msa_track < 130e9
    assert 210e9 < msa_track + evoformer.pair_track_flops(cfg, 256) < 220e9
    assert 34e12 < evoformer.train_flops(cfg, [(256, 128, 1024)]) < 36e12


def test_outer_product_mean_bound():
    """Operations: 2 s (r c)^2 for the sum, 2 r^2 c^2 c_z for the
    projection; bytes: a, b, the outer products twice, the weight, the
    output; the roofline over the marked call's device time."""
    cfg = {"opm_width": 4, "pair_width": 8, "num_blocks": 2,
           "num_extra_blocks": 1, "mixed_precision": True}
    nbytes, flops = evoformer.opm_bound(cfg, 10, 6, 2)
    assert flops == 2 * 6 * 40 ** 2 + 2 * 100 * 16 * 8
    assert nbytes == (2 * 6 * 10 * 4 + 2 * 100 * 16 + 8 * 16 + 100 * 8) * 2
    item = {"tokens": 10, "sequences": 6, "extra": 20,
            "counters": {"msa.outer_product_mean": 6}}      # two passes
    bound = 2 * (2 * bounds.seconds(*evoformer.opm_bound(cfg, 10, 6, 2), 2)
                 + bounds.seconds(*evoformer.opm_bound(cfg, 10, 20, 2), 2))
    rec = {"cfg": cfg, "mix": {"driver": "train_evoformer"},
           "trace": {"items": [item],
                     "calls": {"OuterProductMean.forward": 4 * bound}}}
    assert evoformer.opm_roofline(rec) == pytest.approx(25.0)


@pytest.mark.parametrize("driver", ["train", "serve", "train_pairformer"])
def test_metrics_silent_under_other_drivers(driver):
    bench = harness.Bench()
    trace = {"span_s": 1.0, "busy_s": 0.5, "launches": 10, "kernels": {},
             "calls": {"OuterProductMean.forward": 1.0},
             "items": [{"tokens": 8, "sizes": [8], "rows": 1,
                        "counters": {}}]}
    rec = {"cfg": {}, "mix": {"driver": driver}, "trace": trace,
           "window": {"seconds": 1.0, "sizes": [8], "crops": [(8, 2, 4)]}}
    for name in METRICS:
        assert bench._reader(name).read(rec) is None, name
