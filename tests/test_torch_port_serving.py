"""tgt_torch's distance-model serving path against tgt_tpu (CPU, float32).

- the weight bridge: both directions reproduce the weights exactly;
- the model config parsed from the flagship YAML equals tgt_tpu's;
- a 2-layer distance model against ``distance_model_apply`` (tgt_tpu runs
  its dense Pallas kernel in interpret mode on every bucket);
- ``DistancePredictor.from_model_dir`` on a checkpoint written by
  tgt_tpu's ``save_pytree`` against ``tgt_tpu.serving.DistancePredictor``;
- MC-dropout draws, the device rule, the host-side data path, and the rule
  that the package never imports jax or tgt_tpu.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.data import collate as jcollate
from tgt_tpu.data import structural as jstructural
from tgt_tpu.data.synthetic import make_molecule
from tgt_tpu.models.convert import convert_torch_state_dict
from tgt_tpu.models.heads import distance_model_apply, distance_model_init
from tgt_tpu.models.model_config import TGTConfig as JaxTGTConfig
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.schemes.commons import coords2dist as jax_coords2dist
from tgt_tpu.serving import DistancePredictor as JaxDistancePredictor
from tgt_tpu.training.checkpoint import save_pytree
from tgt_torch.core.config import load_yaml
from tgt_torch.data import collate, structural
from tgt_torch.models.convert import load_jax_npz, state_dict_from_jax_params
from tgt_torch.models.heads import DistanceModel, make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.schemes import get_scheme
from tgt_torch.schemes.commons import coords2dist
from tgt_torch.serving import DistancePredictor

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP_YAML = REPO / "configs/pcqm/tgt_at_200m/dist_pred/tgt_at_dp_rdkit.yaml"

# 2-layer, small-width TGT-At distance model; H=8 keeps N*H % 128 == 0 at
# buckets 16 and 32, so tgt_tpu runs its dense kernel there
SMALL = dict(node_width=64, edge_width=128, num_heads=8, model_height=2,
             triplet_heads=8, triplet_type="attention", num_dist_bins=16,
             use_pallas="dense", dense_min_nodes=0, dense_min_exact_nodes=0)


def small_cfgs(**kw):
    kw = dict(SMALL, node_ended=False, edge_ended=True, **kw)
    return JaxTGTConfig(**kw), TGTConfig(**kw)


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def molecules(sizes, seed=0):
    rs = np.random.RandomState(seed)
    mols = []
    for n in sizes:
        m = make_molecule(rs, int(n))
        m["coords"] = m.pop("rdkit_coords")
        m.pop("dft_coords")
        m.pop("target")
        mols.append(m)
    return mols


class TestWeightBridge:
    def test_jax_params_round_trip(self):
        jcfg, cfg = small_cfgs()
        params = distance_model_init(jax.random.PRNGKey(0), jcfg)
        model = DistanceModel(cfg)
        model.load_state_dict(state_dict_from_jax_params(np_tree(params), cfg))
        back = convert_torch_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, params, jcfg)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_port_state_dict_round_trip(self):
        jcfg, cfg = small_cfgs(embed_3d_type="fourier")
        model = make_model("distance", cfg, device="cpu", seed=3)
        template = distance_model_init(jax.random.PRNGKey(0), jcfg)
        params = convert_torch_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, template,
            jcfg)
        again = state_dict_from_jax_params(np_tree(params), cfg)
        assert set(again) == set(model.state_dict())
        for k, v in model.state_dict().items():
            torch.testing.assert_close(again[k], v, rtol=0, atol=0)

    def test_reference_state_dict_names(self):
        names = set(DistanceModel(small_cfgs()[1]).state_dict())
        for key in ("encoder.TGT_layers.0.update.lin_QKV.weight",
                    "encoder.TGT_layers.0.tria.lin_QKV_in.weight",
                    "encoder.TGT_layers.1.update.lin_QK.weight",
                    "input_embed.m3d_embed.gbf.means.weight",
                    "input_embed.m3d_embed.gbf_proj.layer2.bias",
                    "final_ln_edge.weight", "dist_pred.bias"):
            assert key in names
        assert not any(k.startswith("encoder.TGT_layers.1.node_ffn")
                       for k in names)   # the last layer has no node update


class TestConfig:
    def test_flagship_model_cfg_matches_tgt_tpu(self):
        raw = load_yaml(str(FLAGSHIP_YAML))
        ours = get_scheme(raw["scheme"])(raw, command="evaluate")
        ref = jax_get_scheme(raw["scheme"])(raw, command="evaluate")
        assert dataclasses.asdict(ours.model_cfg) == \
            dataclasses.asdict(ref.model_cfg)
        assert ours.model_cfg.compute_dtype == "bfloat16"
        assert ours.model_cfg.num_dist_bins == 256
        assert ours.cfg.evaluation_samples == 10
        assert ours.cfg.buckets == [24, 32, 40, 48, 56]

    def test_dist_pred_defaults(self):
        ours = get_scheme("pcqm.dist_pred")({}, command="evaluate")
        ref = jax_get_scheme("pcqm.dist_pred")({}, command="evaluate")
        assert ours.cfg.num_dist_bins == 512 == ref.cfg.num_dist_bins
        assert dataclasses.asdict(ours.model_cfg) == \
            dataclasses.asdict(ref.model_cfg)
        with pytest.raises(KeyError):
            get_scheme("pcqm.dist_pred")({"no_such_key": 1})


def model_batch(b, n, seed):
    rs = np.random.RandomState(seed)
    nm = np.zeros((b, n), np.float32)
    for i, c in enumerate([n] + list(rs.randint(3, n, size=b - 1))):
        nm[i, :c] = 1
    nodef = np.stack([rs.randint(1, 33, size=(b, n)) + k * 128
                      for k in range(9)], axis=-1) * nm[..., None].astype(int)
    featm = np.stack([rs.randint(1, 8, size=(b, n, n)) + k * 8
                      for k in range(3)], axis=-1)
    coords = rs.randn(b, n, 3).astype(np.float32) * 2
    return {
        "node_features": nodef.astype(np.int32),
        "distance_matrix": rs.randint(0, 34, size=(b, n, n)).astype(np.int32),
        "feature_matrix": featm.astype(np.int32),
        "node_mask": nm,
        "edge_mask": nm[:, :, None] * nm[:, None, :],
        "dist_input": np.linalg.norm(coords[:, :, None] - coords[:, None],
                                     axis=-1).astype(np.float32),
    }


class TestDistanceModel:
    def test_matches_distance_model_apply(self):
        # dropouts set but deterministic: both sides must ignore them
        jcfg, cfg = small_cfgs(source_dropout=0.3, drop_path=0.2,
                               node_act_dropout=0.1, edge_act_dropout=0.1)
        params = distance_model_init(jax.random.PRNGKey(1), jcfg)
        batch = model_batch(2, 16, seed=1)
        ref = np.asarray(jax.jit(lambda p, x: distance_model_apply(
            p, x, jcfg, deterministic=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()}))
        model = DistanceModel(cfg).requires_grad_(False)
        model.load_state_dict(state_dict_from_jax_params(np_tree(params), cfg))
        got = model({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
        assert got.shape == (2, 16, 16, 16)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model dir as tgt_tpu writes it: config.yaml + checkpoint/model.npz
    from save_pytree, every dropout rate 0."""
    path = tmp_path_factory.mktemp("dist_model")
    over = dict(SMALL, scheme="pcqm.dist_pred", model_name="srv")
    with open(path / "config.yaml", "w") as f:
        yaml.safe_dump(over, f)
    jcfg = jax_get_scheme("pcqm.dist_pred")(over, command="evaluate").model_cfg
    params = distance_model_init(jax.random.PRNGKey(2), jcfg)
    save_pytree(params, str(path / "checkpoint" / "model.npz"))
    return path


class TestDistancePredictor:
    SIZES = (5, 9, 14, 16, 4, 21, 30, 12, 27, 7)   # buckets 16 and 32

    def test_from_model_dir_matches_tgt_tpu(self, model_dir):
        kw = dict(mc_samples=2, batch_size=4, buckets=(16, 32))
        mols = molecules(self.SIZES)
        ref = JaxDistancePredictor.from_model_dir(str(model_dir), **kw)
        ours = DistancePredictor.from_model_dir(str(model_dir), device="cpu",
                                                **kw)
        assert ours.cfg.use_pallas == "dense"
        p_ref = ref.predict(mols)
        p_got = ours.predict(mols)
        assert p_got.shape == p_ref.shape == (10, 32, 32, 16)
        np.testing.assert_allclose(p_got, p_ref, rtol=0,
                                   atol=1e-4 * np.abs(p_ref).max())

        b_ref = ref.predict_bins(mols)
        b_got = ours.predict_bins(mols)
        assert b_got.shape == b_ref.shape == (10, 2, 32, 32)
        assert b_got.dtype == np.int32
        # compare where the argmax is decided: top-two margin > 1e-4
        top2 = np.sort(p_ref * 2.0, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 1e-4
        assert decided.mean() > 0.5
        for s in range(2):
            np.testing.assert_array_equal(b_got[:, s][decided],
                                          b_ref[:, s][decided])

    def test_loads_checkpoint_keys_exactly(self, model_dir):
        tree = load_jax_npz(str(model_dir / "checkpoint" / "model.npz"))
        assert set(tree) == {"input_embed", "encoder", "final_ln_edge",
                             "dist_pred"}
        assert tree["encoder"]["layers"]["update"]["lin_QKV"]["w"].shape == \
            (1, 64, 192)

    def test_mc_draws_finite_and_reproducible(self):
        _, cfg = small_cfgs(source_dropout=0.3, drop_path=0.2,
                            node_act_dropout=0.1, edge_act_dropout=0.1,
                            node_width=16, edge_width=32, num_heads=4,
                            triplet_heads=4, model_height=3)
        model = make_model("distance", cfg, device="cpu", seed=0)
        mols = molecules((5, 11, 7), seed=4)

        def run(seed):
            pred = DistancePredictor(model, cfg, mc_samples=3, batch_size=2,
                                     buckets=(16,), seed=seed, device="cpu")
            return pred.predict(mols), pred.predict_bins(mols)

        (p1, b1), (p2, b2), (p3, _) = run(5), run(5), run(6)
        assert np.isfinite(p1).all()
        np.testing.assert_allclose(p1.sum(-1)[0, :5, :5], 1.0, rtol=1e-5)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(b1, b2)
        assert not np.array_equal(p1, p3)
        assert (b1[:, 0] != b1[:, 1]).any() or (b1[:, 1] != b1[:, 2]).any()

    def test_empty_request(self):
        _, cfg = small_cfgs()
        pred = DistancePredictor(DistanceModel(cfg), cfg, device="cpu")
        assert pred.predict([]).shape == (0,)

    def test_cuda_is_the_default_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, cfg = small_cfgs()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DistancePredictor(DistanceModel(cfg), cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_model("distance", cfg)

    def test_trainer_needs_the_card_unless_told(self, monkeypatch):
        from tgt_torch.training import Trainer
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        scheme = get_scheme("pcqm.dist_pred")(dict(SMALL,
                                                   dataset_source="synthetic"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(scheme)
        assert Trainer(scheme, device="cpu").device == torch.device("cpu")


class TestHostData:
    def test_structural_and_collate_match_tgt_tpu(self):
        rows_j, rows_t = [], []
        for m in molecules((4, 13, 9), seed=7):
            rows_j.append(jstructural.AddStructuralData()(dict(m)))
            rows_t.append(structural.AddStructuralData()(dict(m)))
        for rj, rt in zip(rows_j, rows_t):
            for k in rj:
                np.testing.assert_array_equal(np.asarray(rt[k]),
                                              np.asarray(rj[k]))
        for rows in (rows_j, rows_t):
            for r in rows:
                r["node_mask"] = np.ones(r["num_nodes"], np.uint8)
        bj = jcollate.add_edge_mask(jcollate.padded_collate(rows_j, (8, 16)))
        bt = collate.add_edge_mask(collate.padded_collate(rows_t, (8, 16)))
        bj, mj = jcollate.pad_batch_dim(bj, 5)
        bt, mt = collate.pad_batch_dim(bt, 5)
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])
        np.testing.assert_array_equal(mt, mj)
        assert collate.pick_bucket(17, (8, 16)) == 17

    def test_coords2dist(self):
        c = np.random.RandomState(8).randn(2, 6, 3).astype(np.float32)
        np.testing.assert_allclose(coords2dist(torch.from_numpy(c)).numpy(),
                                   np.asarray(jax_coords2dist(jnp.asarray(c))),
                                   rtol=1e-6, atol=1e-6)


class TestImportRule:
    def test_import_leaves_jax_out(self):
        code = ("import sys, tgt_torch, tgt_torch.serving, "
                "tgt_torch.ops.kernels.triplet_dense, "
                "tgt_torch.ops.kernels.triplet_attention, tgt_torch.profiling, "
                "tgt_torch.ops.remat, "
                "tgt_torch.training, "
                "tgt_torch.training.harness, tgt_torch.data.loader, "
                "tgt_torch.data.synthetic, tgt_torch.schemes.dist_pred, "
                "tgt_torch.data.bins, tgt_torch.data.pcqm, "
                "tgt_torch.data.prepare, tgt_torch.training.checkpoint, "
                "tgt_torch.training.progress, tgt_torch.cli, "
                "tgt_torch.cli.execute, tgt_torch.cli.run_training, "
                "tgt_torch.cli.make_predictions, tgt_torch.cli.do_evaluations, "
                "tgt_torch.data._native, tgt_torch.data.structural, "
                "tgt_torch.utils.profiling, tgt_torch.models.convert, "
                "tgt_torch.parallel, tgt_torch.parallel.mesh, "
                "tgt_torch.parallel.ring, tgt_torch.parallel.pair_layer; "
                "assert tgt_torch.data.structural.backend() == 'native'; "
                "from tgt_torch.models.convert import main\n"
                "try:\n    main(['--help'])\nexcept SystemExit:\n    pass\n"
                "bad = [m for m in sys.modules "
                "if m.split('.')[0] in ('jax', 'jaxlib', 'tgt_tpu')]; "
                "print(bad); sys.exit(1 if bad else 0)")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr

    def test_no_source_names_jax_or_tgt_tpu_in_an_import(self):
        files = sorted((REPO / "tgt_torch").rglob("*.py"))
        files.append(REPO / "chip_smoke.py")
        assert len(files) > 10
        for new in ("data/_native.py", "data/prepare.py",
                    "utils/profiling.py", "models/convert.py",
                    "parallel/__init__.py", "parallel/mesh.py",
                    "parallel/ring.py", "parallel/pair_layer.py"):
            assert REPO / "tgt_torch" / new in files
        for path in files:
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                for name in names:
                    assert name.split(".")[0] not in ("jax", "jaxlib",
                                                      "tgt_tpu"), \
                        f"{path}: imports {name}"
