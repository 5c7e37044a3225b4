"""tgt_torch's stage-2 modules against tgt_tpu's (CPU, small shapes: 2
layers, node 16, edge 8, 4 heads, 2 triplet heads, as
``tests/test_three_stage_pipeline.py``'s ``COMMON``).

- ``bins2dist`` and ``masked_l1`` bit for bit;
- the gap and multi models' deterministic forwards through the dense core
  (its plain version on the CPU; tgt_tpu takes its jnp path at these
  widths, which are not 128-lane dense): 1e-5 of max|ref| in f32, 1e-2 in
  bf16;
- the weight bridge for both models, both ways, and against tgt_tpu's own
  converter and templates;
- ``trim_checkpoint``: the same missing and unexpected lists and the same
  trimmed arrays;
- each new scheme's ``loss_fn`` and ``eval_fn`` on the same host batch
  (dropout rates 0; pretrain's coordinate noise injected into both);
  gap_pred's ``evaluate_predictions`` and its raising ``loss_fn``.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.models.convert import convert_torch_state_dict
from tgt_tpu.models.heads import make_model as jax_make_model
from tgt_tpu.models.model_config import TGTConfig as JaxTGTConfig
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.schemes.commons import bins2dist as jax_bins2dist
from tgt_tpu.schemes.commons import masked_l1 as jax_masked_l1
from tgt_tpu.training import checkpoint as jckpt
from tgt_torch.models.convert import (jax_params_from_state_dict,
                                      state_dict_from_jax_params)
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.schemes import get_scheme
from tgt_torch.schemes.commons import bins2dist, masked_l1
from tgt_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

COMMON = dict(model_height=2, node_width=16, edge_width=8, num_heads=4,
              triplet_heads=2, triplet_type="attention")
SCHEME = dict(COMMON, dataset_source="synthetic", synth_train_samples=8,
              synth_val_samples=8, synth_max_nodes=10, batch_size=4,
              buckets=[12], num_dist_bins=16, range_dist_bins=8.0,
              evaluation_samples=3, use_pallas="dense", max_lr=1e-3,
              lr_warmup_steps=1, lr_total_steps=100)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree):
    return ckpt.flatten_tree(np_tree(tree))


# -- task math ----------------------------------------------------------------

@pytest.mark.parametrize("shift_half,zero_diag",
                         [(True, True), (False, True), (True, False)])
def test_bins2dist_bit_for_bit(shift_half, zero_diag):
    rs = np.random.RandomState(0)
    bins = np.triu(rs.randint(0, 512, (3, 5, 11, 11)), k=1)
    for arr in (bins.astype(np.float32), bins.astype(np.uint16)):
        got = bins2dist(torch.from_numpy(arr), 512, 8.0, shift_half,
                        zero_diag).numpy()
        want = np.asarray(jax_bins2dist(jnp.asarray(arr), 512, 8.0,
                                        shift_half, zero_diag))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))


@pytest.mark.parametrize("masked", [False, True])
def test_masked_l1_bit_for_bit(masked):
    rs = np.random.RandomState(1)
    pred = rs.standard_normal(64).astype(np.float32) + 5.7
    target = rs.standard_normal(64).astype(np.float32) + 5.7
    mask = (rs.rand(64) < 0.7).astype(np.float32) if masked else None
    got = masked_l1(torch.from_numpy(pred), torch.from_numpy(target),
                    None if mask is None else torch.from_numpy(mask))
    want = jax_masked_l1(jnp.asarray(pred), jnp.asarray(target),
                         None if mask is None else jnp.asarray(mask))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


# -- the models ---------------------------------------------------------------

def model_batch(b, n, seed):
    """A feed with a padded sample and a sample of 3 atoms."""
    rs = np.random.RandomState(seed)
    nm = np.ones((b, n), np.float32)
    nm[1, n - 4:] = 0
    nm[2, 3:] = 0
    coords = rs.standard_normal((b, n, 3)).astype(np.float32) * 1.5
    featm = rs.randint(0, 5, size=(b, n, n, 3))
    return {
        "node_features": (rs.randint(0, 60, size=(b, n, 9))
                          * nm[..., None]).astype(np.int32),
        "distance_matrix": rs.randint(0, 34, size=(b, n, n)).astype(np.int32),
        "feature_matrix": featm.astype(np.int32),
        "node_mask": nm,
        "edge_mask": nm[:, :, None] * nm[:, None, :],
        "dist_input": np.linalg.norm(coords[:, :, None] - coords[:, None],
                                     axis=-1).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gap", "multi"])
def test_model_forward_matches_tgt_tpu(kind, dtype):
    kw = dict(COMMON, num_dist_bins=16, compute_dtype=dtype,
              use_pallas="dense", dense_min_nodes=0, dense_min_exact_nodes=0)
    cfg, jcfg = TGTConfig(**kw), JaxTGTConfig(**kw)
    model = make_model(kind, cfg, device="cpu", seed=1).requires_grad_(False)
    params = jax_params_from_state_dict(model.state_dict(), cfg, kind)
    batch = model_batch(3, 12, seed=2)
    _, apply = jax_make_model(kind)
    ref = jax.jit(lambda p, x: apply(p, x, jcfg, deterministic=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    if kind == "gap":
        got, ref = (got,), (ref,)
    assert len(got) == len(ref)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for g, r in zip(got, ref):
        r = np.asarray(r.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        assert np.abs(g - r).max() <= tol * np.abs(r).max(), \
            (np.abs(g - r).max(), np.abs(r).max())
    assert got[0].shape == (3,)


def test_gap_head_bias_and_last_layer():
    cfg = TGTConfig(**COMMON)
    gap = make_model("gap", cfg, device="cpu", seed=0)
    multi = make_model("multi", cfg, device="cpu", seed=0)
    assert float(gap.pred.bias.detach()) == float(multi.pred.bias.detach()) == \
        float(np.float32(5.6894608))
    names = set(gap.state_dict())
    assert not any(k.startswith(("encoder.TGT_layers.1.tria",
                                 "encoder.TGT_layers.1.edge_ffn",
                                 "encoder.TGT_layers.1.update.lin_O_e",
                                 "final_ln_edge", "dist_pred"))
                   for k in names)
    assert set(multi.state_dict()) > names
    with pytest.raises(ValueError, match="unknown model"):
        make_model("nope", cfg, device="cpu")


def jax_template(kind, jcfg, seed):
    """tgt_tpu's params tree of ``kind`` (structure from jax.eval_shape of
    its init), filled with small random values."""
    init, _ = jax_make_model(kind)
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(functools.partial(init, cfg=jcfg),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.2)
                        .astype(x.dtype), shapes)


@pytest.mark.parametrize("kind", ["gap", "multi"])
def test_weight_bridge_round_trips(kind):
    kw = dict(COMMON, num_dist_bins=16)
    cfg, jcfg = TGTConfig(**kw), JaxTGTConfig(**kw)
    params = jax_template(kind, jcfg, seed=3)
    # tgt_tpu's tree -> the port -> tgt_tpu's tree, by kind and by module
    model = make_model(kind, cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    for by in (kind, model):
        back = jax_params_from_state_dict(model.state_dict(), cfg, by)
        assert list(flat(back)) == list(flat(params))
        for k, v in flat(params).items():
            np.testing.assert_array_equal(flat(back)[k], v, err_msg=k)
    # the port's state_dict read by tgt_tpu's own converter
    again = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, params, jcfg)
    for k, v in flat(params).items():
        np.testing.assert_array_equal(flat(again)[k], v, err_msg=k)
    # the optimizer state's moments take the same map
    from tgt_torch.models.convert import opt_state_to_jax
    named = dict(model.named_parameters())
    opt = {"mu": {k: p.detach() * 2 for k, p in named.items()},
           "nu": {k: p.detach() ** 2 for k, p in named.items()},
           "count": torch.tensor(3, dtype=torch.int32)}
    jopt = opt_state_to_jax(opt, cfg, kind)
    assert list(flat(jopt["mu"])) == list(flat(params))
    np.testing.assert_array_equal(
        flat(jopt["mu"])["encoder/last/update/lin_QKV/w"],
        2 * flat(params)["encoder/last/update/lin_QKV/w"])


def test_trim_checkpoint_matches_tgt_tpu(tmp_path):
    over = dict(SCHEME, scheme="pcqm.gap_pred")
    scheme = get_scheme("pcqm.gap_pred")(over, command="train")
    jscheme = jax_get_scheme("pcqm.gap_pred")(dict(over, use_mesh=False),
                                              command="train")
    multi = jax_template("multi", jscheme.model_cfg, seed=4)
    src = str(tmp_path / "multi.npz")
    jckpt.save_pytree(multi, src)
    got = scheme.trim_checkpoint(src, str(tmp_path / "ours.npz"),
                                 device="cpu")
    want = jscheme.trim_checkpoint(src, str(tmp_path / "ref.npz"))
    assert got == want
    missing, unexpected = got
    assert missing == []
    assert "dist_pred/w" in unexpected and "final_ln_edge/scale" in unexpected
    assert any(k.startswith("encoder/last/tria/") for k in unexpected)
    with np.load(tmp_path / "ours.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert a.files == b.files
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the schemes ----------------------------------------------------------------

def scheme_pair(name, command="train", **extra):
    over = dict(SCHEME, scheme=name, **extra)
    ours = get_scheme(name)(over, command=command)
    ref = jax_get_scheme(name)(dict(over, use_mesh=False), command=command)
    assert dataclasses.asdict(ours.model_cfg) == \
        dataclasses.asdict(ref.model_cfg)
    return ours, ref


def same_device_batch(ours, ref, training):
    """The first batch of both packages' loaders, equal key for key, as
    each package's device batch (the port's as CPU tensors)."""
    if training:
        host = next(iter(ours.train_loader(0, 0, 1)))
        jhost = next(iter(ref.train_loader(0, 0, 1)))
    else:
        host = next(iter(ours.val_loader(0, 1)))
        jhost = next(iter(ref.val_loader(0, 1)))
    assert sorted(host) == sorted(jhost)
    for k, v in jhost.items():
        np.testing.assert_array_equal(host[k], v, err_msg=k)
    db = ours.device_batch(host, training)
    jdb = ref.device_batch(jhost, training)
    assert sorted(db) == sorted(jdb)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in db.items()}, jdb


def weights(ours, seed=0):
    model = ours.init_model(seed, "cpu")
    return model, jax_params_from_state_dict(model.state_dict(),
                                             ours.model_cfg, model)


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), \
        (got, want)


def inject_noise(monkeypatch, shape, seed=5):
    """The same standard-normal coordinate noise for both packages'
    ``add_coords_noise``."""
    noise = np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)

    def jax_normal(key, shape_, dtype=jnp.float32):
        assert tuple(shape_) == noise.shape
        return jnp.asarray(noise, dtype)

    def torch_randn(size, generator=None, device=None, dtype=None):
        assert tuple(size) == noise.shape and generator is not None
        return torch.from_numpy(noise).to(device=device, dtype=dtype)

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(torch, "randn", torch_randn)


def test_pretrain_loss_and_eval_match(monkeypatch):
    ours, ref = scheme_pair("pcqm.pretrain", coords_noise=0.2,
                            coords_noise_smooth=1.0, dist_loss_weight=0.1)
    assert ours.MODEL == "multi" and ours.cfg.train_split == "train-3d"
    model, params = weights(ours)
    db, jdb = same_device_batch(ours, ref, training=True)
    inject_noise(monkeypatch, db["dft_coords"].shape)
    loss, aux = ours.loss_fn(model, db, seed=0)
    jloss, jaux = jax.jit(ref.loss_fn)(params, jdb, jax.random.PRNGKey(0))
    assert_close(loss.detach(), jloss)
    for k in ("gap_loss", "dist_loss"):
        assert_close(aux[k].detach(), jaux[k])
    db, jdb = same_device_batch(ours, ref, training=False)
    out = ours.eval_fn(model, db, seed=0)
    jout = jax.jit(ref.eval_fn)(params, jdb, jax.random.PRNGKey(0))
    assert int(out["valid_samples"]) == int(jout["valid_samples"]) == 3
    for k in ("gap_loss", "dist_loss"):
        assert_close(out[k], jout[k])
    host = next(iter(ours.val_loader(0, 1)))
    got = ours.evaluate_predictions(ours.postprocess_eval(
        {k: v.numpy() for k, v in out.items()}, host))
    want = ref.evaluate_predictions(ref.postprocess_eval(
        {k: np.asarray(v) for k, v in jout.items()}, host))
    assert sorted(got) == sorted(want) == ["dist_loss", "gap_loss", "loss"]
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k])


def test_finetune_loss_and_eval_match():
    # trial_run: the datasets are Subset views, which the synthetic bins
    # must see through
    ours, ref = scheme_pair("pcqm.finetune", dist_loss_weight=0.1,
                            trial_run=True)
    assert ours.bins_num_samples == ref.bins_num_samples == 4
    model, params = weights(ours)
    for epoch in (1, 6):
        ours.current_epoch = ref.current_epoch = epoch
        db, jdb = same_device_batch(ours, ref, training=True)
        assert int(db["bins_sample"]) == epoch % 4
        loss, aux = ours.loss_fn(model, db, seed=0)
        jloss, jaux = jax.jit(ref.loss_fn)(params, jdb, jax.random.PRNGKey(0))
        assert_close(loss.detach(), jloss)
        for k in ("gap_loss", "dist_loss"):
            assert_close(aux[k].detach(), jaux[k])
    # 3 draws over 4 stored samples: samples 0, 1, 2
    db, jdb = same_device_batch(ours, ref, training=False)
    assert "dft_coords" not in db
    out = ours.eval_fn(model, db, seed=0)
    jout = jax.jit(ref.eval_fn)(params, jdb, jax.random.PRNGKey(0))
    assert int(out["valid_samples"]) == int(jout["valid_samples"]) == 3
    assert_close(out["gap_loss"], jout["gap_loss"])


def test_gap_pred_eval_and_metrics_match(tmp_path):
    ours, ref = scheme_pair("pcqm.gap_pred", command="evaluate",
                            evaluation_samples=6)
    assert ours.MODEL == "gap"
    model, params = weights(ours, seed=2)
    db, jdb = same_device_batch(ours, ref, training=False)
    out = ours.eval_fn(model, db, seed=0)
    jout = jax.jit(ref.eval_fn)(params, jdb, jax.random.PRNGKey(0))
    assert sorted(out) == sorted(jout)
    assert out["gap_samples"].shape == (4, 6)
    assert int(out["valid_samples"]) == int(jout["valid_samples"]) == 6
    for k in ("gap_pred", "gap_target", "gap_samples"):
        assert_close(out[k], jout[k])
    # draws 0 and 4 read the same bins sample, deterministic: equal
    np.testing.assert_array_equal(out["gap_samples"][:, 0],
                                  out["gap_samples"][:, 4])
    preds = {k: v.numpy() for k, v in out.items()}
    jpreds = {k: np.asarray(v) for k, v in jout.items()}
    mae = ours.evaluate_predictions(preds, "val")["loss"]
    assert abs(mae - ref.evaluate_predictions(jpreds, "val")["loss"]) <= \
        1e-5 * mae
    for pkg, p in (("ours", preds), ("ref", jpreds)):
        s = ours if pkg == "ours" else ref
        res = s.evaluate_predictions(p, "test", str(tmp_path / pkg))
        assert np.isnan(res["loss"])
    assert_close(np.load(tmp_path / "ours" / "y_pred_test_dev.npy"),
                 np.load(tmp_path / "ref" / "y_pred_test_dev.npy"))
    with pytest.raises(NotImplementedError, match="trims"):
        ours.loss_fn(model, db, 0)
