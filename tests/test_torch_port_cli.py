"""tgt_torch's CLI, ``Trainer.fit`` and the dist_pred evaluation against
tgt_tpu's (CPU, float32, tiny widths, PCQM-format parquet written by the
port's ``write_synthetic_dataset``).

- the config grammar of ``tests/test_cli.py``; every published yaml, of
  all four schemes, resolves to tgt_tpu's model, model config and keys; a
  world size above 1 without a rendezvous raises naming its keys;
- ``python -m tgt_torch.cli.run_training <published yaml> ... --device
  cpu``, then ``do_evaluations`` and ``make_predictions`` on its model
  dir: the artifacts ``test_cli.py`` asserts, the bins parquet read back
  through both packages' ``Bins`` column with every idx present;
- resume: 1 + 1 epochs equal 2 epochs bitwise (checkpoint and history);
- NaN rollback to the last checkpoint, bounded by ``max_recovery_tries``;
- the dist_pred ``eval_fn`` with ``predict_in_train: false`` against
  tgt_tpu's on the same weights and batch (1e-5 relative);
- ``mc_sample`` skips non-finite draws, under ``mc_eval_mode`` map and
  vmap alike.

``dataset_source: pcqm`` and ``size_bucketed_batching: true`` against
tgt_tpu's batches are tested in ``test_torch_port_training.py``.
"""
import dataclasses
import glob
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import torch

from tgt_tpu.data.pcqm import Bins as JaxBins
from tgt_tpu.data.pcqm import PCQM4Mv2Dataset as JaxPCQM
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_torch.cli.execute import configs_from_args, execute
from tgt_torch.data.pcqm import Bins, PCQM4Mv2Dataset
from tgt_torch.data.prepare import write_synthetic_dataset
from tgt_torch.models.convert import jax_params_from_state_dict
from tgt_torch.schemes import get_scheme
from tgt_torch.training import Trainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP_YAML = REPO / "configs/pcqm/tgt_at_200m/dist_pred/tgt_at_dp_rdkit.yaml"

# the flagship's keys at a tiny width; its dropouts stay on
TINY = dict(global_batch_size=8, batch_size=4, model_height=2, node_width=16,
            edge_width=16, num_heads=4, triplet_heads=4, num_dist_bins=8,
            buckets=[12], evaluation_samples=2, prediction_samples=2,
            mixed_precision=False, lr_warmup_steps=2)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pcqm")
    write_synthetic_dataset(str(d), num_samples=32, max_nodes=10, seed=0)
    return str(d)


def flagship(tmp_path, data_dir, **extra):
    with open(FLAGSHIP_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg.update(TINY, dataset_path=data_dir, save_path_prefix=str(tmp_path),
               **extra)
    return cfg


def write_yaml(path, d):
    with open(path, "w") as f:
        yaml.safe_dump(d, f)


class TestConfigGrammar:
    def test_yaml_file_plus_overrides(self, tmp_path):
        p = tmp_path / "cfg.yaml"
        write_yaml(p, {"scheme": "pcqm.dist_pred", "batch_size": 4})
        cfg = configs_from_args([str(p), "batch_size: 8", "max_lr: 0.01"])
        assert cfg["batch_size"] == 8        # later args win
        assert cfg["max_lr"] == 0.01

    def test_model_dir_shorthand(self, tmp_path):
        d = tmp_path / "model"
        d.mkdir()
        write_yaml(d / "config.yaml", {"scheme": "pcqm.pretrain"})
        cfg = configs_from_args([str(d)])
        assert cfg["scheme"] == "pcqm.pretrain"

    def test_missing_scheme_raises(self):
        with pytest.raises(ValueError, match="scheme"):
            configs_from_args(["batch_size: 4"])

    def test_override_must_be_a_mapping(self):
        with pytest.raises(ValueError, match="key: value"):
            configs_from_args(["scheme: pcqm.dist_pred", "just_a_word"])

    def test_unknown_key_rejected(self, tmp_path, data_dir):
        cfg = flagship(tmp_path, data_dir, definitely_not_a_key=1)
        with pytest.raises(KeyError):
            execute("train", cfg, device="cpu")

    def test_world_size_above_one_raises(self, tmp_path, data_dir,
                                         monkeypatch):
        """Two processes without a rendezvous: the error names the keys
        that give one."""
        for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(ValueError, match="jax_coordinator.*"
                           "jax_num_processes.*jax_process_id"):
            execute("train", flagship(tmp_path, data_dir), world_size=2,
                    device="cpu")


PUBLISHED = sorted(glob.glob(str(REPO / "configs/pcqm/**/*.yaml"),
                             recursive=True))


@pytest.mark.parametrize("path", PUBLISHED,
                         ids=[os.path.relpath(p, REPO) for p in PUBLISHED])
def test_published_configs(path):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    keys = {"pcqm.dist_pred": ("save_pred_dir", "coords_input"),
            "pcqm.pretrain": ("coords_noise", "dist_loss_weight"),
            "pcqm.finetune": ("bins_input_path", "pretrained_weights_file",
                              "dist_loss_weight", "bins_shift_half"),
            "pcqm.gap_pred": ("bins_input_path", "pretrained_weights_file",
                              "bins_zero_diag")}[cfg["scheme"]]
    for command in ("train", "evaluate", "predict"):
        ours = get_scheme(cfg["scheme"])(cfg, command=command)
        ref = jax_get_scheme(cfg["scheme"])(cfg, command=command)
        assert ours.MODEL == ref.MODEL
        assert dataclasses.asdict(ours.model_cfg) == \
            dataclasses.asdict(ref.model_cfg)
        for key in ("train_split", "val_split", "predict_on", "save_path",
                    "precompile_buckets", "num_dist_bins",
                    "range_dist_bins") + keys:
            assert getattr(ours.cfg, key) == getattr(ref.cfg, key), key
        assert sorted(vars(ours.cfg)) == sorted(vars(ref.cfg)), \
            set(vars(ours.cfg)) ^ set(vars(ref.cfg))
        assert ours.nb_draw_samples == ref.nb_draw_samples


def run_module(module, args):
    """``python -m module args`` in this process, as the shell runs it."""
    argv = sys.argv
    sys.argv = [module] + list(args)
    try:
        runpy.run_module(module, run_name="__main__")
    finally:
        sys.argv = argv


def test_cli_trains_evaluates_and_predicts(tmp_path, data_dir):
    args = [str(FLAGSHIP_YAML), f"dataset_path: {data_dir}",
            f"save_path_prefix: {tmp_path}", "num_epochs: 1"] + [
                f"{k}: {v}" for k, v in TINY.items()]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "tgt_torch.cli.run_training",
                          *args, "--device", "cpu"], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    model_dir = tmp_path / "tgt_at_200m" / "tgt_at_dp_rdkit"
    for f in ("checkpoint/model.npz", "checkpoint/optimizer.npz",
              "checkpoint/training_state.json", "best/model.npz",
              "config.yaml", "all_config.yaml", "model_summary.txt",
              "logs/history.yaml"):
        assert (model_dir / f).exists(), f
    assert "TOTAL" in (model_dir / "model_summary.txt").read_text()

    run_module("tgt_torch.cli.do_evaluations", [str(model_dir), "--device",
                                                "cpu"])
    with open(model_dir / "predictions" / "results.yaml") as f:
        results = yaml.safe_load(f)
    assert np.isfinite(results["val"]["loss"])

    run_module("tgt_torch.cli.make_predictions", [str(model_dir),
                                                  "--device", "cpu"])
    bins_dir = model_dir / "predictions" / "bins2"
    assert (bins_dir / "meta.json").exists()
    for split, name in (("train", "train"), ("val", "valid")):
        assert (bins_dir / "data" / f"{split}_000.parquet").exists()
        # the bins join back onto the split through either package's Bins
        # column, every row present, each draw a symmetric bin matrix
        for ds_cls, col in ((PCQM4Mv2Dataset, Bins), (JaxPCQM, JaxBins)):
            ds = ds_cls(name, data_dir, return_idx=True,
                        additional_columns=[col(str(bins_dir), 2)])
            assert ds.records.num_rows == len(ds) > 0
            for i in range(len(ds)):
                row = ds[i]
                n = row["num_nodes"]
                assert row["dist_bins"].shape == (2, n, n)
                assert row["dist_bins"].max() < 8


def history_without_times(path):
    with open(path) as f:
        return [{k: v for k, v in h.items() if not k.endswith("_time")}
                for h in yaml.safe_load(f)]


def checkpoint_arrays(model_dir):
    out = {}
    for part in ("model", "optimizer"):
        with np.load(model_dir / "checkpoint" / f"{part}.npz") as a:
            out.update({f"{part}:{k}": a[k] for k in a.files})
    return out


def test_resume_equals_an_uninterrupted_run(tmp_path, data_dir):
    runs = {}
    for name, epochs in (("straight", (2,)), ("resumed", (1, 2))):
        for num_epochs in epochs:
            cfg = flagship(tmp_path, data_dir, model_name=name,
                           num_epochs=num_epochs)
            execute("train", cfg, device="cpu")
        model_dir = tmp_path / "tgt_at_200m" / name
        runs[name] = (checkpoint_arrays(model_dir),
                      history_without_times(model_dir / "logs" /
                                            "history.yaml"))
    (a, ha), (b, hb) = runs["straight"], runs["resumed"]
    assert ha == hb and len(ha) == 2 and ha[1]["global_step"] == 6
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def nan_after(scheme, bad):
    """Make ``scheme.loss_fn`` return NaN while ``bad()`` holds."""
    loss_fn = scheme.loss_fn

    def poisoned(model, batch, seed):
        loss, aux = loss_fn(model, batch, seed)
        return (loss * float("nan") if bad() else loss), aux

    scheme.loss_fn = poisoned


def test_nan_epoch_rolls_back_to_the_checkpoint(tmp_path, data_dir):
    """21 training molecules (train-3d) in batches of 2: 11 steps an epoch,
    so an epoch of NaN losses ends in a streak of 11, and the trainer reloads
    epoch 1's checkpoint and runs the epoch again."""
    cfg = flagship(tmp_path, data_dir, global_batch_size=2, batch_size=2,
                   num_epochs=1)
    Trainer(get_scheme(cfg["scheme"])(cfg), device="cpu").fit()
    trainer = Trainer(get_scheme(cfg["scheme"])(dict(cfg, num_epochs=2)),
                      device="cpu")
    with np.load(trainer.ckpt.ckpt_dir + "/model.npz") as a:
        saved = {k: a[k] for k in a.files}
    poison = [True]
    nan_after(trainer.scheme, lambda: poison[0])
    loads = []
    load_or_init = trainer.load_or_init

    def load_and_check():
        state = load_or_init()
        loads.append((trainer.epoch, trainer.global_step))
        if len(loads) == 2:                  # the rollback
            got = trainer.params_tree(state["model"])
            for k, v in saved.items():
                node = got
                for p in k.split("/"):
                    node = node[p]
                np.testing.assert_array_equal(node, v, err_msg=k)
            poison[0] = False                # the retried epoch is finite
        return state

    trainer.load_or_init = load_and_check
    history = trainer.fit()["history"]
    assert loads == [(1, 11), (1, 11)] and trainer.recovery_tries == 1
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert (trainer.epoch, trainer.global_step) == (2, 22)


def test_nan_rollback_is_bounded(tmp_path, data_dir):
    cfg = flagship(tmp_path, data_dir, global_batch_size=2, batch_size=2,
                   num_epochs=1, max_recovery_tries=1)
    trainer = Trainer(get_scheme(cfg["scheme"])(cfg), device="cpu")
    nan_after(trainer.scheme, lambda: True)
    with pytest.raises(RuntimeError, match="max_recovery_tries"):
        trainer.fit()
    assert trainer.recovery_tries == 1


def test_eval_fn_matches_tgt_tpu(tmp_path, data_dir):
    over = flagship(tmp_path, data_dir, predict_in_train=False,
                    use_pallas=False)
    scheme = get_scheme(over["scheme"])(over, command="evaluate")
    jscheme = jax_get_scheme(over["scheme"])(dict(over, use_mesh=False),
                                             command="evaluate")
    model = scheme.init_model(0, "cpu")
    params = jax_params_from_state_dict(model.state_dict(), scheme.model_cfg)
    host = next(iter(scheme.val_loader(0, 1)))
    jhost = next(iter(jscheme.val_loader(0, 1)))
    for k, v in jhost.items():
        np.testing.assert_array_equal(host[k], v, err_msg=k)
    db = scheme.device_batch(host, training=False)
    assert db["node_mask"].shape[0] == 8       # batch_size * prediction_bmult
    out = scheme.eval_fn(model, {k: torch.from_numpy(v)
                                 for k, v in db.items()}, seed=0)
    ref = jax.jit(jscheme.eval_fn)(params, jscheme.device_batch(
        jhost, training=False), jax.random.PRNGKey(0))
    assert int(out["valid_samples"]) == int(ref["valid_samples"]) == 2
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(ref["loss"]),
                               rtol=1e-5, atol=0)
    got = scheme.evaluate_predictions(scheme.postprocess_eval(
        {k: v.numpy() for k, v in out.items()}, host))["loss"]
    want = jscheme.evaluate_predictions(jscheme.postprocess_eval(
        {k: np.asarray(v) for k, v in ref.items()}, jhost))["loss"]
    assert abs(got - want) <= 1e-5 * abs(want)


def test_mc_sample_skips_non_finite_draws(tmp_path, data_dir):
    # mc_eval_mode: map calls the one-seed draw per seed; vmap calls the
    # draw-stacked form once, with the same sums and valid count
    bad = set()

    def draw(seed):
        v = torch.full((3,), float(seed % 7))
        if seed % 2:
            bad.add(seed)
            v[1] = float("nan")
        return {"a": v, "b": torch.ones(2)}

    def stacked(seeds):
        draws = [draw(s) for s in seeds]
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}

    runs = {}
    for mode in ("map", "vmap"):
        scheme = get_scheme("pcqm.dist_pred")(flagship(
            tmp_path, data_dir, mc_eval_mode=mode))
        bad.clear()
        runs[mode] = scheme.mc_sample(draw, 5, 8, stacked)
        sums, valid = runs[mode]
        good = 8 - len(bad)
        assert 0 < len(bad) < 8 and int(valid) == good
        assert torch.equal(sums["b"], torch.full((2,), float(good)))
        none, zero = scheme.mc_sample(
            lambda s: {"a": torch.full((2,), np.nan)}, 5, 3,
            lambda seeds: {"a": torch.full((len(seeds), 2), np.nan)})
        assert int(zero) == 0 and torch.equal(none["a"], torch.zeros(2))
    assert int(runs["map"][1]) == int(runs["vmap"][1])
    for k in ("a", "b"):
        assert torch.equal(runs["map"][0][k], runs["vmap"][0][k])
