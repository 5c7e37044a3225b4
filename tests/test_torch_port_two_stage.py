"""The published four-stage chain through tgt_torch's CLI, against tgt_tpu
(CPU, float32, small shapes as ``tests/test_three_stage_pipeline.py``, on
PCQM-format parquet written by the port's ``write_synthetic_dataset``):

  dist_pred (train, predict bins) -> pretrain -> finetune (stage-1 bins,
  stage-2 weights) -> gap_pred (trim, evaluate, predict)

- every command runs through ``tgt_torch.cli.execute.main`` with a yaml
  and ``--device cpu``, and leaves the artifacts tgt_tpu's would;
- every stage's checkpoint loads strictly into tgt_tpu's templates
  (structure from ``jax.eval_shape``), the optimizer state too;
- tgt_tpu's and the port's ``TwoStagePredictor.from_model_dirs`` on the
  same model dirs (every dropout rate 0) give the same bins samples and
  gaps within 1e-4 relative;
- ``evaluate`` of the gap_pred dir in both packages gives the same MAE
  within 1e-5 relative;
- finetune: 1 + 1 epochs equal 2 in every bit, and both read bins sample
  ``epoch % S``;
- all of it for both published families: TGT-At, and TGT-Agx2 (the
  aggregate variant with ``layer_multiplier=2``).
"""
import functools
import json
import os

import numpy as np
import pytest
import yaml

import jax
import torch

from tgt_tpu.cli.execute import execute as jax_execute
from tgt_tpu.data.synthetic import make_molecule
from tgt_tpu.models.heads import make_model as jax_make_model
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.serving import TwoStagePredictor as JaxTwoStage
from tgt_tpu.training import checkpoint as jckpt
from tgt_tpu.training import harness as jharness
from tgt_torch.cli.execute import main
from tgt_torch.data.prepare import write_synthetic_dataset
from tgt_torch.schemes import get_scheme
from tgt_torch.serving import TwoStagePredictor
from tgt_torch.training import Trainer

torch.set_num_threads(1)

COMMON = dict(
    dataset_source="pcqm", batch_size=4, buckets=[12],
    model_height=2, node_width=16, edge_width=8, num_heads=4,
    triplet_heads=2, triplet_type="attention", use_pallas="dense",
    evaluation_samples=2, prediction_samples=3, mixed_precision=False,
    max_lr=1e-3, lr_warmup_steps=2, lr_total_steps=10_000, num_epochs=1,
    num_dist_bins=16, range_dist_bins=8)


# the two published families: TGT-At, and TGT-Agx2 (the aggregate variant,
# each layer applied twice)
FAMILIES = {"attention": {},
            "aggregate": dict(triplet_type="aggregate", layer_multiplier=2)}


def stage_configs(root, data, family="attention"):
    models = os.path.join(root, "models")
    dirs = {k: os.path.join(models, k) for k in ("dp", "pt", "ft", "gp")}
    bins = os.path.join(dirs["dp"], "predictions", "bins3")
    common = dict(COMMON, save_path_prefix=models, dataset_path=data,
                  **FAMILIES[family])
    return dirs, bins, {
        "dp": dict(common, scheme="pcqm.dist_pred", model_name="dp",
                   coords_input="rdkit"),
        "pt": dict(common, scheme="pcqm.pretrain", model_name="pt",
                   coords_noise=0.2, coords_noise_smooth=1.0,
                   dist_loss_weight=0.1),
        "ft": dict(common, scheme="pcqm.finetune", model_name="ft",
                   dist_loss_weight=0.1, bins_input_path=bins,
                   pretrained_weights_file=os.path.join(
                       dirs["pt"], "checkpoint", "model.npz")),
        "gp": dict(common, scheme="pcqm.gap_pred", model_name="gp",
                   bins_input_path=bins, predict_on=["val", "test"],
                   pretrained_weights_file=os.path.join(
                       dirs["ft"], "checkpoint", "model.npz")),
    }


def cli(command, cfg, path):
    """``python -m tgt_torch.cli.<command> <yaml> --device cpu``, in this
    process."""
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    main(command, [str(path), "--device", "cpu"])


@pytest.fixture(scope="module", params=list(FAMILIES))
def chain(tmp_path_factory, request):
    root = tmp_path_factory.mktemp(f"chain_{request.param}")
    data = str(root / "data")
    write_synthetic_dataset(data, num_samples=24, max_nodes=10, seed=3)
    dirs, bins, cfgs = stage_configs(str(root), data, request.param)
    for name, command in (("dp", "train"), ("dp", "predict"),
                          ("pt", "train"), ("ft", "train"), ("gp", "train"),
                          ("gp", "evaluate"), ("gp", "predict")):
        cli(command, cfgs[name], root / f"{name}_{command}.yaml")
    return dirs, bins, cfgs


def test_cli_runs_the_four_stage_chain(chain):
    dirs, bins, _ = chain
    with open(os.path.join(bins, "meta.json")) as f:
        assert json.load(f) == {"num_bins": 16, "range_bins": 8,
                                "num_samples": 3}
    for stage in ("pt", "ft"):
        for f in ("checkpoint/model.npz", "checkpoint/optimizer.npz",
                  "checkpoint/training_state.json", "logs/history.yaml"):
            assert os.path.exists(os.path.join(dirs[stage], f)), (stage, f)
        with open(os.path.join(dirs[stage], "logs", "history.yaml")) as f:
            history = yaml.safe_load(f)
        assert np.isfinite(history[-1]["loss"])
        assert np.isfinite(history[-1]["val_loss"])
    # the trim writes only the model; evaluate and predict read it
    assert sorted(os.listdir(os.path.join(dirs["gp"], "checkpoint"))) == \
        ["model.npz"]
    pred = os.path.join(dirs["gp"], "predictions")
    with open(os.path.join(pred, "results.yaml")) as f:
        results = yaml.safe_load(f)
    assert np.isfinite(results["val"]["loss"]) and results["val"]["loss"] > 0
    assert np.isnan(results["test"]["loss"])
    with np.load(os.path.join(pred, "val_000.npz")) as val:
        assert val["gap_pred"].shape == (6,)
        assert val["gap_samples"].shape == (6, 3)        # prediction_samples
        mae = np.abs(val["gap_pred"] - val["gap_target"]).mean()
        assert abs(mae - results["val"]["loss"]) <= 1e-6 * mae
    test = np.load(os.path.join(pred, "y_pred_test_dev.npy"))
    with np.load(os.path.join(pred, "test_000.npz")) as t:
        np.testing.assert_array_equal(test, t["gap_pred"])


@pytest.mark.parametrize("stage", ["dp", "pt", "ft", "gp"])
def test_every_stage_checkpoint_loads_strictly_in_tgt_tpu(chain, stage):
    dirs, _, cfgs = chain
    jscheme = jax_get_scheme(cfgs[stage]["scheme"])(
        dict(cfgs[stage], use_mesh=False), command="evaluate")
    init, _ = jax_make_model(jscheme.MODEL)
    params = jax.eval_shape(functools.partial(init, cfg=jscheme.model_cfg),
                            jax.random.PRNGKey(0))
    manager = jckpt.CheckpointManager(dirs[stage])
    if stage == "gp":                   # the trimmed model only
        loaded = manager.load_model_only(params)
    else:
        opt_init, _ = jharness.make_optimizer(jscheme.cfg, None)
        loaded, opt, counters = manager.load(
            params, jax.eval_shape(opt_init, params))
        assert counters["epoch"] == 1
        assert int(opt["count"]) == counters["global_step"] > 0
    for got, want in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        assert got.shape == want.shape and np.isfinite(got).all()


def molecules(sizes, seed=11):
    rs = np.random.RandomState(seed)
    out = []
    for n in sizes:
        m = make_molecule(rs, int(n))
        for k in ("dft_coords", "target"):
            m.pop(k)
        out.append(m)
    return out


def test_two_stage_predictor_matches_tgt_tpu(chain):
    dirs, _, _ = chain
    kw = dict(mc_samples=3, batch_size=4, buckets=(12,))
    ours = TwoStagePredictor.from_model_dirs(dirs["dp"], dirs["gp"],
                                             device="cpu", **kw)
    ref = JaxTwoStage.from_model_dirs(dirs["dp"], dirs["gp"], **kw)
    assert ours.range_bins == ref.range_bins == 8.0
    assert ours.gap.bins_meta == ref.gap.bins_meta == {"num_bins": 16,
                                                       "range_bins": 8.0}
    mols = molecules((5, 9, 12, 4, 7, 11, 10))
    rows = ours.distance._prepare_rows(mols)
    bins = ours.distance.predict_bins(rows)
    np.testing.assert_array_equal(bins, ref.distance.predict_bins(rows))
    assert bins.shape == (7, 3, 12, 12) and bins.max() < 16
    got, want = ours.predict(mols), ref.predict(mols)
    assert got.shape == want.shape == (7,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # input order: each molecule alone gives its own gap
    alone = ours.predict([mols[3]])
    np.testing.assert_allclose(alone, got[3:4], rtol=1e-6)
    assert ours.predict([]).shape == (0,)


def test_gap_pred_evaluate_matches_tgt_tpu(chain):
    dirs, _, cfgs = chain
    with open(os.path.join(dirs["gp"], "predictions", "results.yaml")) as f:
        ours = yaml.safe_load(f)["val"]["loss"]
    ref = jax_execute("evaluate", dict(cfgs["gp"], predict_on=["val"]),
                      rank=0, world_size=1)["val"]["loss"]
    assert abs(ours - ref) <= 1e-5 * abs(ref)


def test_finetune_resume_equals_uninterrupted_run(chain, tmp_path):
    """2 epochs straight against 1 + 1 with a resume: the checkpoints equal
    in every bit, and every training batch read bins sample epoch % 3."""
    _, _, cfgs = chain
    runs = {}
    for name, epochs in (("straight", (2,)), ("resumed", (1, 2))):
        seen = []
        for num_epochs in epochs:
            scheme = get_scheme("pcqm.finetune")(dict(
                cfgs["ft"], model_name=name, num_epochs=num_epochs,
                save_path_prefix=str(tmp_path)))
            loss_fn = scheme.loss_fn

            def recorded(model, batch, seed, loss_fn=loss_fn, scheme=scheme):
                seen.append((scheme.current_epoch,
                             int(batch["bins_sample"])))
                return loss_fn(model, batch, seed)

            scheme.loss_fn = recorded
            Trainer(scheme, device="cpu").fit()
        with np.load(tmp_path / name / "checkpoint" / "model.npz") as a, \
                np.load(tmp_path / name / "checkpoint" / "optimizer.npz") as o:
            runs[name] = ({k: a[k] for k in a.files},
                          {k: o[k] for k in o.files}, seen)
    (a, oa, seen_a), (b, ob, seen_b) = runs["straight"], runs["resumed"]
    # 18 training molecules in batches of 4: 5 steps an epoch
    assert seen_a == seen_b == [(0, 0)] * 5 + [(1, 1)] * 5
    for x, y in ((a, b), (oa, ob)):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
