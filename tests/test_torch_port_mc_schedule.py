"""The MC-draw schedule of tgt_torch's serving and evaluation (CPU, float32).

- ``mc_mode="vmap"``: the S draws of a device batch as one forward of S*b
  rows, draw-major, equal to ``map``'s draws for ``DistancePredictor``
  (``predict``, ``predict_bins``), ``GapPredictor`` on bins input (draw i
  on stored sample i % S) and ``TwoStagePredictor``, with every dropout
  on: the dense core at ``triplet_dropout > 0`` (its per-row seeds), the
  plain core's weight dropout, the legacy pair, the aggregate variant's
  weight dropout;
- ``auto`` choosing per bucket by ``mc_vmap_max_nodes`` (1 forward per
  batch against S), a bad mode's ``ValueError``, both keys through
  ``from_model_dir`` and ``from_model_dirs``;
- ``mc_eval_mode: vmap`` in ``mc_sample`` and in the dist_pred and
  pretrain ``eval_fn``: the same sums and valid count as the loop, with a
  non-finite draw skipped;
- the port's vmap against tgt_tpu's ``mc_mode="vmap"`` on one checkpoint,
  every dropout rate 0;
- the mutation check: per-draw masks drawn from draw 0's generator alone
  must fail the vmap-against-map comparison;
- ``warmup``: one dummy request per bucket through the schedule, and a
  RuntimeError after ``retries + 1`` failures.
"""
import numpy as np
import pytest
import torch
import yaml

import jax

from tgt_tpu.models.heads import distance_model_init
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.serving import DistancePredictor as JaxDistancePredictor
from tgt_tpu.training.checkpoint import save_pytree as jax_save_pytree
from tgt_torch.data.collate import add_edge_mask, padded_collate
from tgt_torch.data.synthetic import make_molecule
from tgt_torch.models.convert import jax_params_from_state_dict
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops import common
from tgt_torch.schemes import get_scheme
from tgt_torch.schemes.commons import stack_draws
from tgt_torch.serving import (DistancePredictor, GapPredictor,
                               TwoStagePredictor)
from tgt_torch.training.checkpoint import save_pytree

torch.set_num_threads(1)

TOL = 1e-6          # of max|ref|, f32
DROPOUTS = dict(source_dropout=0.2, drop_path=0.2, node_act_dropout=0.1,
                edge_act_dropout=0.1)
SMALL = dict(node_width=16, edge_width=32, num_heads=4, model_height=2,
             triplet_heads=4, num_dist_bins=8, **DROPOUTS)
# the triplet paths whose random draws differ: the dense core's per-row
# seeds, the plain core's PyTorch dropout, the legacy pair (no triplet
# dropout) and the aggregate variant's weight dropout, applied twice
VARIANTS = {
    "dense": dict(triplet_type="attention", use_pallas="dense",
                  triplet_dropout=0.2),
    "plain": dict(triplet_type="attention", use_pallas=False,
                  triplet_dropout=0.2),
    "legacy": dict(triplet_type="attention", use_pallas=True),
    "aggregate": dict(triplet_type="aggregate", use_pallas="dense",
                      triplet_dropout=0.2, layer_multiplier=2),
}
SIZES = (5, 11, 7, 14, 3, 9)        # buckets 8 and 16 at batch 2


def molecules(sizes=SIZES, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for n in sizes:
        m = make_molecule(rs, int(n))
        m["coords"] = m.pop("rdkit_coords")
        for k in ("dft_coords", "target"):
            m.pop(k)
        out.append(m)
    return out


def config(variant, **kw):
    return TGTConfig(**dict(SMALL, **VARIANTS[variant], **kw))


def predictors(kind, cfg, modes=("map", "vmap"), **kw):
    """One predictor per mode around one model (seed 0): the same
    per-batch draw seeds in each."""
    cls = {"distance": DistancePredictor, "gap": GapPredictor}[kind]
    model = make_model(kind, cfg, device="cpu", seed=0)
    kw = dict(dict(mc_samples=3, batch_size=2, buckets=(8, 16), seed=4),
              **kw)
    return [cls(model, cfg, mc_mode=m, device="cpu", **kw) for m in modes]


def assert_close(got, ref, tol=TOL):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def assert_bins_equal(got, ref, probs):
    """Equal bins where the argmax is decided (top-two margin > 1e-5)."""
    top2 = np.sort(probs * 2.0, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-5
    assert decided.mean() > 0.5
    for s in range(ref.shape[1]):
        np.testing.assert_array_equal(got[:, s][decided], ref[:, s][decided])


def assert_distance_vmap_equals_map(variant):
    cfg = config(variant, node_ended=False, edge_ended=True)
    by_map, by_vmap = predictors("distance", cfg)
    mols = molecules()
    p_map, p_vmap = by_map.predict(mols), by_vmap.predict(mols)
    assert p_map.shape == (6, 16, 16, 8) and np.isfinite(p_map).all()
    assert_close(p_vmap, p_map)
    b_map, b_vmap = by_map.predict_bins(mols), by_vmap.predict_bins(mols)
    assert b_map.shape == b_vmap.shape == (6, 3, 16, 16)
    assert b_vmap.dtype == np.int32
    assert_bins_equal(b_vmap, b_map, p_map)
    # the draws differ from each other: dropout is on
    assert (b_map[:, 0] != b_map[:, 1]).any()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_distance_predictor_vmap_equals_map(variant):
    assert_distance_vmap_equals_map(variant)


def bins_molecules(sizes=SIZES, stored=2, num_bins=8, seed=1):
    """Gap-model rows on stored bins samples (strict upper triangles)."""
    rs = np.random.RandomState(seed)
    mols = molecules(sizes, seed)
    for m in mols:
        n = m["num_nodes"]
        m.pop("coords")
        m["dist_bins"] = np.triu(rs.randint(0, num_bins, size=(stored, n, n)),
                                 k=1).astype(np.float32)
    return mols


@pytest.mark.parametrize("variant", ["dense", "aggregate"])
def test_gap_predictor_on_bins_vmap_equals_map(variant):
    cfg = config(variant, node_ended=True, edge_ended=False)
    meta = {"num_bins": 8, "range_bins": 8.0}
    by_map, by_vmap = predictors("gap", cfg, bins_meta=meta)
    mols = bins_molecules()
    g_map, g_vmap = by_map.predict(mols), by_vmap.predict(mols)
    assert g_map.shape == (6,) and np.isfinite(g_map).all()
    assert_close(g_vmap, g_map)
    # draw i reads sample i % 2: a request whose second sample differs
    # gives another gap
    other = bins_molecules(seed=1)
    for m in other:
        m["dist_bins"][1] = m["dist_bins"][0]
    fresh, = predictors("gap", cfg, modes=("vmap",), bins_meta=meta)
    assert not np.allclose(fresh.predict(other), g_vmap)


def test_two_stage_predictor_vmap_equals_map():
    dcfg = config("dense", node_ended=False, edge_ended=True)
    gcfg = config("dense", node_ended=True, edge_ended=False)
    runs = {}
    for mode in ("map", "vmap"):
        dist, = predictors("distance", dcfg, modes=(mode,))
        gap, = predictors("gap", gcfg, modes=(mode,))
        runs[mode] = TwoStagePredictor(dist, gap, range_bins=8.0).predict(
            molecules())
    assert runs["map"].shape == (6,) and np.isfinite(runs["map"]).all()
    assert_close(runs["vmap"], runs["map"])


def test_one_seed_list_is_the_one_seed_forward():
    """A draw-stacked forward of one draw is the one-seed forward, bit for
    bit; and S draws stacked are the S one-seed forwards, row block by
    row block."""
    cfg = config("dense", node_ended=False, edge_ended=True)
    model = make_model("distance", cfg, device="cpu", seed=0)
    pred, = predictors("distance", cfg, modes=("map",))
    feed = pred._feed_of(add_edge_mask(padded_collate(
        pred._prepare_rows(molecules((5, 7))), buckets=(8,))))
    with torch.inference_mode():
        one = model(feed, deterministic=False, seed=11)
        listed = model(feed, deterministic=False, seed=[11])
        stacked = model(stack_draws(feed, 2), deterministic=False,
                        seed=[11, 12])
        other = model(feed, deterministic=False, seed=12)
    assert torch.equal(one, listed)
    torch.testing.assert_close(stacked[:2], one, rtol=0,
                               atol=TOL * float(one.abs().max()))
    torch.testing.assert_close(stacked[2:], other, rtol=0,
                               atol=TOL * float(other.abs().max()))


# -- the schedule -------------------------------------------------------------

def counted_forwards(pred):
    """Rows of every model forward the predictor runs."""
    rows = []
    pred.model.register_forward_hook(
        lambda mod, args, kw, out: rows.append(
            kw.get("batch", args[0] if args else None)["node_features"]
            .shape[:2]), with_kwargs=True)
    return rows


def test_auto_chooses_per_bucket():
    cfg = config("dense", node_ended=False, edge_ended=True)
    pred, = predictors("distance", cfg, modes=("auto",),
                       mc_vmap_max_nodes=8)
    rows = counted_forwards(pred)
    pred.predict(molecules((5, 7, 12, 14)))     # one batch at 8, one at 16
    # bucket 8: one forward of S*b = 6 rows; bucket 16: S forwards of 2
    assert rows == [(6, 8), (2, 16), (2, 16), (2, 16)]
    rows.clear()
    by_map, by_vmap = predictors("distance", cfg, modes=("auto", "vmap"))
    for pred, want in ((by_map, [(2, 8)] * 3), (by_vmap, [(6, 8)])):
        rows = counted_forwards(pred)
        pred.predict(molecules((5, 7)))
        assert rows == want
    assert pred._mc_schedule({"node_features": torch.zeros(2, 64, 9)}) == \
        "vmap"


def test_bad_mode_raises():
    cfg = config("dense", node_ended=False, edge_ended=True)
    model = make_model("distance", cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="mc_mode"):
        DistancePredictor(model, cfg, mc_mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="mc_mode"):
        GapPredictor(model, cfg, mc_mode="scan", device="cpu")


def write_model_dir(path, kind, scheme, seed=0):
    """A model dir as tgt_tpu reads it: config.yaml and the port's weights
    at ``seed`` in checkpoint/model.npz."""
    over = dict(SMALL, **VARIANTS["dense"], scheme=scheme, model_name=kind,
                num_dist_bins=8)
    path.mkdir(parents=True)
    with open(path / "config.yaml", "w") as f:
        yaml.safe_dump(over, f)
    cfg = get_scheme(scheme)(over, command="evaluate").model_cfg
    model = make_model(kind, cfg, device="cpu", seed=seed)
    save_pytree(jax_params_from_state_dict(model.state_dict(), cfg, kind),
                str(path / "checkpoint" / "model.npz"))
    return str(path)


def test_keys_pass_through_from_model_dir(tmp_path):
    dp = write_model_dir(tmp_path / "dp", "distance", "pcqm.dist_pred")
    gp = write_model_dir(tmp_path / "gp", "gap", "pcqm.gap_pred")
    pred = DistancePredictor.from_model_dir(
        dp, mc_mode="vmap", mc_vmap_max_nodes=12, device="cpu")
    assert (pred.mc_mode, pred.mc_vmap_max_nodes) == ("vmap", 12)
    two = TwoStagePredictor.from_model_dirs(
        dp, gp, mc_samples=2, batch_size=2, buckets=(8, 16), mc_mode="auto",
        mc_vmap_max_nodes=8, device="cpu")
    for stage in (two.distance, two.gap):
        assert (stage.mc_mode, stage.mc_vmap_max_nodes) == ("auto", 8)
    gaps = two.predict(molecules((5, 12)))
    assert gaps.shape == (2,) and np.isfinite(gaps).all()
    with pytest.raises(ValueError, match="mc_mode"):
        GapPredictor.from_model_dir(gp, mc_mode="bogus", device="cpu")


# -- mc_sample and the schemes' evaluation ------------------------------------

def test_mc_sample_vmap_equals_loop_with_a_non_finite_draw():
    """The loop and the draw-stacked form give the same sums and valid
    count; a draw with a NaN in one value is skipped whole
    (tests/test_training.py:408-420)."""
    s_map = get_scheme("pcqm.pretrain")(dict(dataset_source="synthetic"))
    s_vmap = get_scheme("pcqm.pretrain")(dict(dataset_source="synthetic",
                                              mc_eval_mode="vmap"))
    calls = {"one": 0, "stacked": 0}

    def fn(seed):
        calls["one"] += 1
        g = torch.Generator().manual_seed(seed)
        val = torch.randn(3, generator=g)
        a = val.clone()
        if seed % 3 == 0:
            a[1] = float("nan")
        return {"a": a, "b": val.sum()}

    def stacked(seeds):
        calls["stacked"] += 1
        draws = [fn(s) for s in seeds]
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}

    acc1, v1 = s_map.mc_sample(fn, 3, 8, stacked)
    assert calls == {"one": 8, "stacked": 0}
    acc2, v2 = s_vmap.mc_sample(fn, 3, 8, stacked)
    assert calls == {"one": 16, "stacked": 1}
    assert 0 < int(v1) < 8 and int(v1) == int(v2)
    for k in acc1:
        assert torch.equal(acc1[k], acc2[k])
    # a caller without the draw-stacked form runs the loop in either mode
    acc3, v3 = s_vmap.mc_sample(fn, 3, 8)
    assert int(v3) == int(v1) and torch.equal(acc3["a"], acc1["a"])


EVAL = dict(dataset_source="synthetic", model_height=2, node_width=16,
            edge_width=32, num_heads=4, triplet_heads=4,
            triplet_type="attention", num_dist_bins=16, batch_size=4,
            global_batch_size=4, buckets=[16], synth_max_nodes=12,
            use_pallas="dense", triplet_dropout=0.2, predict_in_train=True,
            evaluation_samples=3, **DROPOUTS)


@pytest.mark.parametrize("scheme,kind", [("pcqm.dist_pred", "distance"),
                                         ("pcqm.pretrain", "multi")])
def test_eval_fn_vmap_equals_map(scheme, kind):
    outs = {}
    for mode in ("map", "vmap"):
        sc = get_scheme(scheme)(dict(EVAL, mc_eval_mode=mode))
        model = make_model(kind, sc.model_cfg, device="cpu", seed=0)
        rows = counted_forwards_model(model)
        batch = next(iter(sc.val_loader(0, 1)))
        db = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in sc.device_batch(batch, training=False).items()}
        outs[mode] = sc.eval_fn(model, db, seed=3)
        b = db["node_mask"].shape[0]
        assert rows == ([b] * 3 if mode == "map" else [3 * b])
    assert int(outs["vmap"]["valid_samples"]) == 3
    for k, ref in outs["map"].items():
        torch.testing.assert_close(outs["vmap"][k], ref, rtol=0,
                                   atol=TOL * float(ref.float().abs().max()))


def counted_forwards_model(model):
    rows = []
    model.register_forward_hook(
        lambda mod, args, out: rows.append(args[0]["node_features"].shape[0]))
    return rows


# -- against tgt_tpu ------------------------------------------------------------

def test_vmap_matches_tgt_tpu_vmap(tmp_path):
    """Every dropout rate 0: the port's vmap and tgt_tpu's on one
    checkpoint (the port's dense core on its plain version; tgt_tpu takes
    its jnp path at this width, whose kernel needs 128-lane-dense
    shapes)."""
    over = dict(node_width=16, edge_width=64, num_heads=4, model_height=2,
                triplet_heads=8, triplet_type="attention", num_dist_bins=8,
                use_pallas="dense", dense_min_nodes=0,
                dense_min_exact_nodes=0, scheme="pcqm.dist_pred",
                model_name="srv")
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.safe_dump(over, f)
    jcfg = jax_get_scheme("pcqm.dist_pred")(over,
                                             command="evaluate").model_cfg
    params = distance_model_init(jax.random.PRNGKey(2), jcfg)
    jax_save_pytree(params, str(tmp_path / "checkpoint" / "model.npz"))
    kw = dict(mc_samples=2, batch_size=4, buckets=(16,), mc_mode="vmap")
    mols = molecules((5, 9, 14, 16, 4))
    ref = JaxDistancePredictor.from_model_dir(str(tmp_path), **kw)
    ours = DistancePredictor.from_model_dir(str(tmp_path), device="cpu", **kw)
    p_ref, p_got = ref.predict(mols), ours.predict(mols)
    assert p_got.shape == p_ref.shape == (5, 16, 16, 8)
    np.testing.assert_allclose(p_got, p_ref, rtol=0,
                               atol=1e-4 * np.abs(p_ref).max())
    assert_bins_equal(ours.predict_bins(mols), ref.predict_bins(mols), p_ref)


# -- the mutation check ----------------------------------------------------------

def draw0_only(shape, generators, device, dtype, fill):
    """The fault: the whole (S*b, ...) draw from draw 0's generator."""
    out = torch.empty(tuple(shape), device=device, dtype=dtype)
    fill(out, generators[0])
    return out


@pytest.mark.parametrize("variant", ["dense", "aggregate"])
def test_draw0_generator_fails_the_check(variant, monkeypatch):
    monkeypatch.setattr(common, "_per_draw", draw0_only)
    with pytest.raises(AssertionError):
        assert_distance_vmap_equals_map(variant)


# -- warmup ----------------------------------------------------------------------

@pytest.mark.parametrize("mode,per_bucket", [("map", 3), ("vmap", 1)])
def test_warmup_runs_each_bucket_once(mode, per_bucket):
    cfg = config("dense", node_ended=False, edge_ended=True)
    pred, = predictors("distance", cfg, modes=(mode,))
    rows = counted_forwards(pred)
    pred.warmup()
    rows_per = 2 * (3 if mode == "vmap" else 1)
    assert rows == [(rows_per, 8)] * per_bucket + [(rows_per, 16)] * per_bucket
    gap, = predictors("gap", config("dense", node_ended=True,
                                    edge_ended=False), modes=(mode,))
    gap.warmup(per_bucket_timeout=None, retries=0)


def test_warmup_retries_then_raises(monkeypatch):
    cfg = config("dense", node_ended=False, edge_ended=True)
    pred, = predictors("distance", cfg, modes=("vmap",))
    tries = []

    def flaky(nb):
        tries.append(nb)
        if nb == 16 or len(tries) == 1:
            raise MemoryError(f"bucket {nb}")

    monkeypatch.setattr(pred, "_warmup_one", flaky)
    with pytest.raises(RuntimeError, match="bucket 16 after 3") as err:
        pred.warmup(retries=2)
    assert tries == [8, 8, 16, 16, 16]          # bucket 8 recovered
    assert isinstance(err.value.__cause__, MemoryError)
