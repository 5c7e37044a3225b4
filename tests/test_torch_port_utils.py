"""tgt_torch's import of released reference checkpoints and its profiling
utilities against tgt_tpu's (CPU).

- ``python -m tgt_torch.models.convert`` (three cases in a subprocess, the
  others through its ``main``) writes an ``.npz`` equal key by key and
  bitwise to tgt_tpu's
  ``convert_torch_state_dict`` + ``save_pytree`` of the same state_dict, for
  the distance, gap and multi models of small TGT-At and TGT-Agx2 configs
  and under IndivConfig; the state_dict is the port's model's, whose names
  are the reference's; a missing key, an extra key and a wrong shape each
  fail;
- ``StepTimer.summary`` equals tgt_tpu's on the same clock; ``count_params``
  equals tgt_tpu's on bridged parameters; ``flops_estimate`` of ``x @ w`` is
  2mnk, as tgt_tpu's XLA cost analysis; ``trace`` writes a Chrome trace on
  the CPU.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import torch

from tgt_tpu.models import convert as jconvert
from tgt_tpu.models.heads import make_model as jax_make_model
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.training import checkpoint as jckpt
from tgt_tpu.utils import profiling as jprofiling
from tgt_torch.models.convert import main as convert_main
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.heads import make_model
from tgt_torch.schemes import get_scheme
from tgt_torch.training import harness
from tgt_torch.utils import profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(model_height=3, node_width=16, edge_width=8, num_heads=4,
             triplet_heads=2, num_dist_bins=8, num_3d_kernels=8)
FAMILIES = {
    "TGT-At": dict(triplet_type="attention"),
    "TGT-Agx2": dict(triplet_type="aggregate", layer_multiplier=2),
    "IndivConfig": dict(triplet_type=["attention", "aggregate", "aggregate"],
                        triplet_heads=[2, 4, 0], num_heads=[4, 2, 4],
                        activation=["gelu", "relu", "gelu"]),
}
# model kind -> the scheme whose yaml converts it, and whether the command
# names the kind (--model) or takes the scheme's
KINDS = {"distance": ("pcqm.dist_pred", False),
         "gap": ("pcqm.gap_pred", False),
         "multi": ("pcqm.pretrain", True)}
# the cases converted by ``python -m tgt_torch.models.convert`` in a
# subprocess (each family and each kind once; ~4 s each); the others call
# its ``main`` in this process
SUBPROCESS = {("TGT-At", "distance"), ("TGT-Agx2", "gap"),
              ("IndivConfig", "multi")}


def write_case(tmp_path, family, kind, seed=3):
    """A yaml, and the state_dict of the port's model of that kind saved as
    a reference ``model_state.pt``; returns (yaml, checkpoint, config)."""
    scheme_name, _ = KINDS[kind]
    cfg = dict(SMALL, **FAMILIES[family], scheme=scheme_name,
               dataset_source="synthetic", save_path_prefix=str(tmp_path))
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    scheme = get_scheme(scheme_name)(cfg)
    model = make_model(kind, scheme.model_cfg, device="cpu", seed=seed)
    ckpt = tmp_path / "model_state.pt"
    torch.save(model.state_dict(), ckpt)
    return path, ckpt, cfg


def tgt_tpu_npz(cfg, kind, ckpt, out):
    """tgt_tpu's conversion of the checkpoint: its converter over a
    template of the model's structure, then its ``save_pytree``."""
    jscheme = jax_get_scheme(cfg["scheme"])(dict(cfg, use_mesh=False))
    init, _ = jax_make_model(kind)
    shapes = jax.eval_shape(functools.partial(init, cfg=jscheme.model_cfg),
                            jax.random.PRNGKey(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = {k: v.numpy() for k, v in torch.load(ckpt).items()}
    params = jconvert.convert_torch_state_dict(state, template,
                                               jscheme.model_cfg)
    jckpt.save_pytree(params, str(out))
    return params


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_cli_equals_tgt_tpu(tmp_path, family, kind):
    yaml_path, ckpt, cfg = write_case(tmp_path, family, kind)
    out = tmp_path / "port.npz"
    args = [str(ckpt), str(out), "--config", str(yaml_path)]
    if KINDS[kind][1]:
        args += ["--model", kind]
    if (family, kind) in SUBPROCESS:
        res = subprocess.run(
            [sys.executable, "-m", "tgt_torch.models.convert", *args],
            cwd=str(REPO), capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert res.returncode == 0, res.stdout + res.stderr
        assert f"-> {out}" in res.stdout
    else:
        assert convert_main(args) == 0
    tgt_tpu_npz(cfg, kind, ckpt, tmp_path / "ref.npz")
    with np.load(out) as got, np.load(tmp_path / "ref.npz") as want:
        assert got.files == want.files
        if family == "IndivConfig":
            assert any(k.startswith("encoder/indiv/2/") for k in got.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_convert_rejects_a_state_dict_that_does_not_fit(tmp_path, change):
    yaml_path, ckpt, _ = write_case(tmp_path, "TGT-At", "distance")
    state = torch.load(ckpt)
    key = "encoder.TGT_layers.1.tria.lin_QKV_in.weight"
    assert key in state
    if change == "missing":
        del state[key]
    elif change == "extra":
        state["encoder.TGT_layers.1.tria.lin_extra.weight"] = torch.zeros(2)
    else:
        state[key] = state[key][:-1]
    torch.save(state, ckpt)
    match = {"missing": "Missing key", "extra": "Unexpected key",
             "shape": "size mismatch"}[change]
    with pytest.raises(RuntimeError, match=match):
        convert_main([str(ckpt), str(tmp_path / "out.npz"), "--config",
                      str(yaml_path)])
    assert not (tmp_path / "out.npz").exists()


# -- utilities ------------------------------------------------------------------

def test_step_timer_summary_equals_tgt_tpu(monkeypatch):
    """Both timers on the same injected clock: 7 steps, 2 discarded."""
    durations = [0.5, 0.25, 0.125, 0.375, 0.0625, 0.75, 0.1875]
    summaries = []
    for module in (profiling, jprofiling):
        ticks = iter(np.cumsum([0.0] + [x for d in durations
                                        for x in (d, 1.0)]).tolist())
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer(warmup=2)
        for _ in durations:
            with timer:
                pass
        monkeypatch.undo()
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 5 and summaries[0]["min_s"] == 0.0625
    empty = profiling.StepTimer(warmup=3)
    with empty:
        pass
    got, want = empty.summary(), jprofiling.StepTimer().summary()
    assert got["steps"] == want["steps"] == 0
    assert np.isnan(got["mean_s"]) and np.isnan(want["mean_s"])


@pytest.mark.parametrize("family", ["TGT-At", "IndivConfig"])
def test_count_params_equals_tgt_tpu(tmp_path, family):
    cfg = dict(SMALL, **FAMILIES[family], scheme="pcqm.dist_pred",
               dataset_source="synthetic", save_path_prefix=str(tmp_path))
    jscheme = jax_get_scheme("pcqm.dist_pred")(dict(cfg, use_mesh=False))
    init, _ = jax_make_model("distance")
    shapes = jax.eval_shape(functools.partial(init, cfg=jscheme.model_cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
    want = jprofiling.count_params(params)
    scheme = get_scheme("pcqm.dist_pred")(cfg)
    model = make_model("distance", scheme.model_cfg, device="cpu")
    state = state_dict_from_jax_params(params, scheme.model_cfg)
    model.load_state_dict(state)
    assert profiling.count_params(model) == want
    assert profiling.count_params(state) == want
    assert profiling.count_params(params) == want
    assert profiling.model_summary is harness.model_summary


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (48, 256, 96)])
def test_flops_estimate_of_a_product(m, k, n):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((m, k)).astype(np.float32)
    w = rs.standard_normal((k, n)).astype(np.float32)
    got = profiling.flops_estimate(lambda a, b: a @ b, torch.from_numpy(x),
                                   torch.from_numpy(w))
    want = jprofiling.flops_estimate(jax.jit(lambda a, b: a @ b), x, w)
    assert got["flops"] == 2 * m * n * k == want["flops"]
    assert np.isnan(got["bytes_accessed"])


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / "logs")):
        torch.mm(x, x)
    files = list((tmp_path / "logs").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
