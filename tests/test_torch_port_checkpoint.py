"""tgt_torch's checkpoints, plateau controller and condition strings against
tgt_tpu's (CPU, float32).

- ``jax_params_from_state_dict`` inverts ``state_dict_from_jax_params`` on
  tgt_tpu's params tree, key for key and bit for bit (Gaussian and Fourier
  3D embeddings);
- a checkpoint the port's Trainer writes (model, optimizer after a step,
  counters) loads strictly into tgt_tpu's templates; one tgt_tpu writes
  resumes in the port's Trainer; logits equal after both crossings
  (bitwise in the port, 1e-4 of max|ref| against tgt_tpu's apply). The
  templates' structure comes from ``jax.eval_shape`` of tgt_tpu's init;
- ``load_pretrained`` gives the same missing and unexpected lists;
- ``PlateauController`` follows the same sequence; ``eval_condition``
  agrees on a table of expressions and rejects the same unsafe ones.
"""
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.models.heads import distance_model_apply, distance_model_init
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.training import checkpoint as jckpt
from tgt_tpu.training import harness as jharness
from tgt_tpu.training.schedules import PlateauController as JaxPlateau
from tgt_torch.models.convert import (jax_params_from_state_dict,
                                      state_dict_from_jax_params)
from tgt_torch.schemes import get_scheme
from tgt_torch.training import checkpoint as ckpt
from tgt_torch.training.harness import Trainer, eval_condition
from tgt_torch.training.schedules import PlateauController

torch.set_num_threads(1)

SMALL = dict(
    scheme="pcqm.dist_pred", dataset_source="synthetic",
    synth_train_samples=8, synth_max_nodes=10, batch_size=4,
    global_batch_size=8, buckets=[12], model_height=3, node_width=32,
    edge_width=32, num_heads=4, triplet_heads=4, triplet_type="attention",
    num_dist_bins=16, max_lr=1e-3, lr_warmup_steps=1, lr_total_steps=100)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_trees(jscheme, seed):
    """tgt_tpu's params and Adam-state trees, their structure, shapes and
    dtypes from ``jax.eval_shape`` of its init functions (nothing is
    compiled), filled with small random values."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(functools.partial(distance_model_init,
                                              cfg=jscheme.model_cfg),
                            jax.random.PRNGKey(0))
    opt_init, _ = jharness.make_optimizer(jscheme.cfg, None)
    fill = lambda x: (rs.standard_normal(x.shape) * 0.2).astype(x.dtype)
    params = jax.tree.map(fill, shapes)
    opt = jax.tree.map(fill, jax.eval_shape(opt_init, shapes))
    opt["count"] = np.asarray(1, np.int32)
    return params, opt


def assert_trees_equal(got, want):
    """Same '/'-joined keys, shapes, dtypes and values."""
    g, w = ckpt.flatten_tree(got), ckpt.flatten_tree(want)
    assert list(g) == list(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def schemes(tmp_path, **extra):
    over = dict(SMALL, save_path_prefix=str(tmp_path), **extra)
    return (jax_get_scheme("pcqm.dist_pred")(dict(over, use_mesh=False)),
            get_scheme("pcqm.dist_pred")(over))


def feed_of(scheme):
    db = scheme.device_batch(next(iter(scheme.train_loader(0, 0, 1))))
    feed = {k: db[k] for k in ("node_features", "distance_matrix",
                               "feature_matrix", "node_mask")}
    nm = db["node_mask"].astype(np.float32) * db["sample_mask"][:, None]
    feed["edge_mask"] = nm[:, :, None] * nm[:, None, :]
    c = db["rdkit_coords"]
    feed["dist_input"] = np.sqrt(((c[:, :, None] - c[:, None]) ** 2).sum(-1)
                                 + 1e-24).astype(np.float32)
    return feed


@pytest.mark.parametrize("embed", ["gaussian", "fourier"])
def test_reverse_bridge_inverts_the_forward_one(tmp_path, embed):
    jscheme, scheme = schemes(tmp_path, embed_3d_type=embed)
    params, _ = jax_trees(jscheme, 0)
    back = jax_params_from_state_dict(
        state_dict_from_jax_params(params, scheme.model_cfg), scheme.model_cfg)
    assert_trees_equal(back, params)


def test_checkpoints_cross_both_ways_with_equal_logits(tmp_path):
    """The port's checkpoint after a step loads strictly into tgt_tpu's
    templates; tgt_tpu saves what it loaded into another model dir, and the
    port resumes from that: the same values, counters and logits."""
    jscheme, scheme = schemes(tmp_path)
    trainer = Trainer(scheme, device="cpu")
    state = trainer.init_state()
    db = trainer.to_device(trainer.pad_device_batch(scheme.device_batch(
        next(iter(scheme.train_loader(0, 0, 1))))))
    state, m = trainer.train_step(state, db, 0, 0)
    assert bool(m["ok"])
    trainer.epoch, trainer.global_step = 1, 1
    trainer.checkpoint(state)

    ptmpl, otmpl = jax_trees(jscheme, 1)
    params, opt, counters = jckpt.CheckpointManager(trainer.model_path).load(
        ptmpl, otmpl)                                       # strict
    assert counters["epoch"] == 1 and counters["global_step"] == 1
    assert int(opt["count"]) == 1
    sd = state["model"].state_dict()
    for k, v in state_dict_from_jax_params(params, scheme.model_cfg).items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    for moment in ("mu", "nu"):
        got = state_dict_from_jax_params(opt[moment], scheme.model_cfg)
        for k, v in state["opt_state"][moment].items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)

    _, scheme2 = schemes(tmp_path, model_name="from_tgt_tpu")
    jckpt.CheckpointManager(scheme2.cfg.save_path).save(
        params, opt, dict(counters, global_step=7), epoch=1)
    trainer2 = Trainer(scheme2, device="cpu")
    state2 = trainer2.load_or_init()
    assert (trainer2.epoch, trainer2.global_step) == (1, 7)
    for moment in ("mu", "nu"):
        for k, v in state["opt_state"][moment].items():
            torch.testing.assert_close(state2["opt_state"][moment][k], v,
                                       rtol=0, atol=0)
    assert int(state2["opt_state"]["count"]) == 1

    feed = feed_of(scheme)
    ref = np.asarray(jax.jit(lambda p, x: distance_model_apply(
        p, x, jscheme.model_cfg, deterministic=True))(
            params, {k: jnp.asarray(v) for k, v in feed.items()}))
    with torch.no_grad():
        tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
        got = state["model"](tfeed)
        assert torch.equal(state2["model"](tfeed), got)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_tgt_tpu_checkpoint_resumes_in_the_port(tmp_path):
    """tgt_tpu's Trainer checkpoint (params, moments, count, counters)
    resumes in the port's Trainer, and the port writes it back bitwise."""
    jscheme, scheme = schemes(tmp_path)
    params, opt = jax_trees(jscheme, 2)
    jtrainer = jharness.Trainer(jscheme)
    jtrainer.epoch, jtrainer.global_step, jtrainer.monitor_best = 1, 1, 2.5
    jtrainer.checkpoint({"params": params, "opt_state": opt})

    trainer = Trainer(scheme, device="cpu")
    state = trainer.load_or_init()
    assert (trainer.epoch, trainer.global_step, trainer.monitor_best) == \
        (1, 1, 2.5)
    assert_trees_equal(trainer.params_tree(state["model"]), params)
    got = state["opt_state"]
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 1
    for moment in ("mu", "nu"):
        want = state_dict_from_jax_params(opt[moment], scheme.model_cfg)
        assert set(got[moment]) == set(want)
        for k, v in got[moment].items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    trainer.checkpoint(state)
    for part, want in (("model", params), ("optimizer", opt)):
        with np.load(f"{trainer.model_path}/checkpoint/{part}.npz") as a:
            saved = {k: a[k] for k in a.files}
        assert sorted(saved) == sorted(ckpt.flatten_tree(want))
        assert_trees_equal(ckpt._unflatten_like(want, saved), want)


def test_load_pretrained_reports_the_same_keys(tmp_path):
    jscheme, _ = schemes(tmp_path)
    template, _ = jax_trees(jscheme, 3)
    saved = dict(ckpt.flatten_tree(template))
    del saved["dist_pred/b"]                            # missing
    saved["dist_pred/w"] = np.zeros((3, 3), np.float32)  # another shape
    saved["gap_head/w"] = np.ones((2,), np.float32)     # unexpected
    path = str(tmp_path / "pre.npz")
    np.savez(path, **saved)
    tree, missing, unexpected = ckpt.load_pretrained(template, path)
    jtree, jmissing, junexpected = jckpt.load_pretrained(template, path)
    assert missing == jmissing and unexpected == junexpected
    assert missing == ["dist_pred/b",
                       "dist_pred/w (shape mismatch, kept template)"]
    assert unexpected == ["gap_head/w"]
    assert_trees_equal(tree, np_tree(jtree))
    with pytest.raises(KeyError):
        ckpt.load_pytree(template, path, strict=True)


def test_save_pytree_writes_tgt_tpu_keys(tmp_path):
    tree = {"b": {"y": np.ones(2, np.float32), "x": np.zeros((2, 3))},
            "a": np.arange(3), "count": np.asarray(4, np.int32)}
    ckpt.save_pytree(tree, str(tmp_path / "port.npz"))
    jckpt.save_pytree(tree, str(tmp_path / "ref.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert a.files == b.files
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert not list(tmp_path.glob("*.tmp"))


def test_plateau_controller_follows_tgt_tpu():
    rs = np.random.RandomState(0)
    ours = PlateauController(factor=0.5, patience=2, stopping_lr=1e-5)
    ref = JaxPlateau(factor=0.5, patience=2, stopping_lr=1e-5)
    metric = 1.0
    for epoch in range(40):
        metric += rs.choice([-0.1, 0.05, 0.2])
        assert ours.update(metric, 1e-3) == ref.update(metric, 1e-3), epoch
        assert ours.state_dict() == ref.state_dict(), epoch
    assert ours.scale < 1.0
    again = PlateauController()
    again.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert again.state_dict() == ours.state_dict()


CONTEXT = {"epoch": 12, "val_loss": 0.25, "loss": 1.5, "global_step": 600}


@pytest.mark.parametrize("expr", [
    None, "", "epoch > 10", "epoch > 10 and epoch % 5 == 0",
    "epoch >= 12 or val_loss < 0.1", "not epoch < 3", "val_loss * 4 == 1",
    "-loss < -1", "1 < epoch < 20", "global_step // 100 == 6",
    "epoch - 2 != 10", "loss / 3 <= 0.5", "epoch > 10 and val_loss > 1"])
def test_eval_condition_agrees(expr):
    assert eval_condition(expr, CONTEXT) == \
        jharness.eval_condition(expr, CONTEXT)


@pytest.mark.parametrize("expr", [
    "__import__('os')", "epoch.real > 1", "[1][0]", "epoch ** 2 > 1",
    "unknown_name > 1", "+epoch", "epoch in (1, 2)", "lambda: 1"])
def test_eval_condition_rejects_the_same(expr):
    with pytest.raises(Exception) as ref:
        jharness.eval_condition(expr, CONTEXT)
    with pytest.raises(type(ref.value)):
        eval_condition(expr, CONTEXT)


def test_progress_prints_plain_lines(capsys):
    from tgt_tpu.training.progress import Progress as JaxProgress
    from tgt_torch.training.progress import Progress
    assert list(Progress(range(10), desc="t", miniters=5)) == list(range(10))
    ours = capsys.readouterr().out.splitlines()
    list(JaxProgress(range(10), desc="t", miniters=5))
    ref = capsys.readouterr().out.splitlines()
    strip = lambda lines: [ln.split(" eta")[0] for ln in lines]
    assert strip(ours) == strip(ref) == ["t: 5/10 (50%)", "t: 10/10 (100%)"]
