"""tgt_torch's pair axis against tgt_tpu (CPU, float32, gloo ranks;
``tests/torch_pair_worker.py`` is one rank).

One run of two ranks and one of four, started together, and tgt_tpu's
references computed meanwhile:
- the pair collectives ``ring_pass``, ``_pair_transpose`` and
  ``_gather_rows`` at P = 2 and 4 (N = 8) against their definitions,
  forward and gradient;
- ``triplet_attention_ring`` and ``triplet_aggregate_ring``, gated and
  ungated, with a padded node (and the gated aggregate's unmasked out
  direction), against ``tgt_tpu.ops.triplet``'s unsharded ops on the same
  weights at P = 2 and 4: the output, and the gradients with respect to e
  and the weights, to 1e-5 of max|ref|, the bound of ``tests/test_ring.py``;
- the pair-sharded distance models (attention and aggregate,
  ``layer_multiplier = 2``, the edge-only last layer) against tgt_tpu's
  ``distance_model_apply`` on the whole graph;
- ``Trainer.train_step``, 3 steps at ``num_pair_devices: 2`` by (D=1, P=2)
  and (D=2, P=2) ranks, on ``dist_pred`` (TGT-At, gated attention) and
  ``pretrain`` (the multi model, gated aggregate) against tgt_tpu's
  single-process step on the global batch, under the bound of
  ``test_torch_port_distributed.py``'s three-step test, and at (D=1, P=2)
  with two micro-batches a step; the second step's bucket, 15, is one that
  P does not divide;
- witnesses, each missing its bound by more than 100x: a ring that places
  block t at ``my`` instead of ``(my - t) mod P``, an out direction without
  its pair transpose, and a gap loss counted on every pair rank;
- stochastic training (every dropout and drop-path on): the loss history
  and the node state equal on both ranks of the pair group.

Also the raises (Pallas with a pair mesh, the variants without a pair
path, a world size that P does not divide), and the CLI by (D=1, P=2)
ranks: identical histories, rank 0 alone writes, ``do_evaluations``
equals one process's, and ``make_predictions`` writes one bins shard, the
bytes of one process's. Every process bounds its rendezvous and collectives
at 60 s and is killed after 120 s.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.core.graph import additive_mask_from_node_mask
from tgt_tpu.models.heads import distance_model_apply, distance_model_init
from tgt_tpu.models.model_config import TGTConfig as JaxTGTConfig
from tgt_tpu.ops.triplet import get_triplet_apply, get_triplet_init
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.training import harness as jharness
from tgt_torch.cli.execute import execute
from tgt_torch.data.collate import padded_collate
from tgt_torch.data.pcqm import Bins, PCQM4Mv2Dataset
from tgt_torch.data.prepare import write_synthetic_dataset
from tgt_torch.data.structural import AddStructuralData
from tgt_torch.data.synthetic import make_molecule
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.schemes import get_scheme
from tgt_torch.training import Trainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_pair_worker.py"
DIST_WORKER = REPO / "tests" / "torch_dist_worker.py"
FLAGSHIP_YAML = REPO / "configs/pcqm/tgt_at_200m/dist_pred/tgt_at_dp_rdkit.yaml"
PROC_TIMEOUT = 120
TOL = 1e-5              # of max|ref|, as tests/test_ring.py
LOSS_RTOL = 1e-4
WITNESS = 100           # a witness misses its bound by more than this

RING_KINDS = {"attention": (True, False), "attention_ungated": (False, False),
              "aggregate": (True, True), "aggregate_ungated": (False, True)}
B, N, W, H = 2, 8, 16, 4          # the ring cases

SMALL = dict(
    dataset_source="synthetic", buckets=[16], model_height=2, node_width=32,
    edge_width=32, num_heads=4, triplet_heads=4, num_dist_bins=16,
    use_pallas=False, max_lr=1e-3, min_lr=1e-6, lr_warmup_steps=1,
    lr_total_steps=100, batch_size=8, coords_noise=0.0)
SCHEMES = {"dist_pred": ("pcqm.dist_pred", dict(triplet_type="attention")),
           "pretrain": ("pcqm.pretrain", dict(triplet_type="aggregate"))}
# accumulation at (D=1, P=2): the micro-batches are tgt_tpu's contiguous
# chunks of the global batch
ACCUM = ("dist_pred_accum2", "pcqm.dist_pred",
         dict(triplet_type="attention", grad_accum_steps=2))
BUCKETS = (16, 15, 16)          # per step; P = 2 does not divide 15
STOCHASTIC = dict(drop_path=0.1, source_dropout=0.1, node_act_dropout=0.1,
                  edge_act_dropout=0.1, triplet_dropout=0.1, remat=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO)
    return env


def start(args_by_rank):
    return [subprocess.Popen([sys.executable, *map(str, args)], cwd=str(REPO),
                             env=clean_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for args in args_by_rank]


def start_world(world, workdir):
    port = free_port()
    return start([(WORKER, r, world, port, workdir) for r in range(world)])


def start_cli(workdir, args_by_rank):
    port = free_port()
    return start([(DIST_WORKER, "cli", r, port, workdir, *args)
                  for r, args in enumerate(args_by_rank)])


def wait(procs) -> None:
    """Fails with the ranks' output if one fails or outlives
    PROC_TIMEOUT; every rank is killed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def module_state(params):
    """A triplet module's state dict from its tgt_tpu parameters."""
    sd = state_dict_from_jax_params({"m": np_tree(params)}, TGTConfig())
    return {k[2:]: v for k, v in sd.items()}


# -- inputs and tgt_tpu's references ------------------------------------------

def collective_case(world, rs):
    x = rs.randn(B, N, N, 3).astype(np.float32)
    blk = N // world
    return {"x": x, "cot": {
        "ring_pass": rs.randn(world, B, blk, N, 3).astype(np.float32),
        "transpose": rs.randn(world, B, blk, N, 3).astype(np.float32),
        "gather": rs.randn(world, B, N, N, 3).astype(np.float32)}}


def ring_case(name, rs, seed):
    gated, aggregate = RING_KINDS[name]
    params = get_triplet_init(name)(jax.random.PRNGKey(seed), W, H)
    node_mask = np.ones((B, N), np.float32)
    node_mask[1, 6:] = 0                           # a padded sample
    mask = np.asarray(additive_mask_from_node_mask(jnp.asarray(node_mask)))
    e = rs.randn(B, N, N, W).astype(np.float32)
    cot = rs.randn(B, N, N, W).astype(np.float32)
    apply = get_triplet_apply(name)

    def reference():
        out, vjp = jax.vjp(lambda p, e_: apply(p, e_, jnp.asarray(mask),
                                               num_heads=H),
                           params, jnp.asarray(e))
        gp, ge = vjp(jnp.asarray(cot))
        return {"out": np.asarray(out), "e_grad": np.asarray(ge),
                "w_grad": {k: v.numpy() for k, v in module_state(gp).items()}}

    return ({"e": e, "mask": mask, "cot": cot, "heads": H,
             "weights": module_state(params)}, reference)


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
    return {"node_features": nodef.astype(np.int32),
            "distance_matrix": rs.randint(0, 34, size=(b, n, n)).astype(
                np.int32),
            "feature_matrix": featm.astype(np.int32), "node_mask": nm,
            "edge_mask": nm[:, :, None] * nm[:, None, :],
            "dist_input": np.linalg.norm(coords[:, :, None] - coords[:, None],
                                         axis=-1).astype(np.float32)}


def model_case(triplet_type, seed):
    kw = dict(node_width=32, edge_width=16, num_heads=4, model_height=2,
              layer_multiplier=2, triplet_heads=4, triplet_type=triplet_type,
              num_dist_bins=16, node_ended=False, edge_ended=True)
    jcfg, cfg = JaxTGTConfig(**kw), TGTConfig(**kw)
    params = distance_model_init(jax.random.PRNGKey(seed), jcfg)
    batch = model_batch(2, N, seed)

    def reference():
        return np.asarray(jax.jit(lambda p, x: distance_model_apply(
            p, x, jcfg, deterministic=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()}))

    return ({"cfg": cfg, "batch": batch,
             "weights": state_dict_from_jax_params(np_tree(params), cfg)},
            reference)


def molecules(rs, sizes):
    transform = AddStructuralData()
    rows = []
    for n in sizes:
        row = make_molecule(rs, int(n))
        row["node_mask"] = np.ones(n, np.uint8)
        rows.append(transform(row))
    return rows


def global_batch(scheme, rs, bucket):
    """8 rows: 7 molecules of 3 to ``bucket`` atoms and one padding row."""
    host = padded_collate(molecules(rs, rs.randint(3, bucket + 1, 7)),
                          buckets=(bucket,))
    db = scheme.device_batch(host)
    pad = 8 - db["sample_mask"].shape[0]
    return {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            for k, v in db.items()}


def trainer_case(name, root, rs, scheme_name, extra):
    """The scheme's config, tgt_tpu's initial weights, 3 global batches,
    and tgt_tpu's single-process steps on them."""
    over = dict(SMALL, **extra, save_path_prefix=str(root / name))
    jtrainer = jharness.Trainer(jax_get_scheme(scheme_name)(
        dict(over, use_mesh=False)))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    scheme = get_scheme(scheme_name)(over)
    case = {"scheme": scheme_name, "cfg": dict(over, num_pair_devices=2),
            "weights": state_dict_from_jax_params(
                np_tree(jstate["params"]), scheme.model_cfg),
            "steps": [global_batch(scheme, rs, n) for n in BUCKETS]}
    return case, (jtrainer, jstate, scheme.model_cfg)


def trainer_reference(case, jtrainer, jstate, cfg):
    jstep = jtrainer.build_train_step()
    ref = []
    for i, batch in enumerate(case["steps"]):
        jstate, jm = jstep(jstate, jtrainer.shard_device_batch(batch),
                           jnp.asarray(i), jax.random.PRNGKey(i),
                           jnp.asarray(1.0))
        ref.append((float(jm["loss"]), bool(jm["ok"]), float(jm["lr"]),
                    state_dict_from_jax_params(
                        np_tree(jstate["params"]), cfg)))
    return ref


TINY = dict(global_batch_size=16, batch_size=8, model_height=2,
            node_width=16, edge_width=16, num_heads=4, triplet_heads=4,
            num_dist_bins=8, buckets=[12], evaluation_samples=2,
            prediction_samples=2, mixed_precision=False, lr_warmup_steps=1,
            num_epochs=2, predict_in_train=False, use_pallas=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two- and four-rank runs and the CLI's two ranks, started
    together; tgt_tpu's references meanwhile."""
    root = tmp_path_factory.mktemp("pair")
    rs = np.random.RandomState(0)
    inputs = {"collectives": {w: collective_case(w, rs) for w in (2, 4)},
              "ring_kinds": RING_KINDS, "rings": {}, "models": {},
              "trainer": {}}
    ref = {"rings": {}, "models": {}, "trainer": {}}
    later = {"rings": {}, "models": {}}     # computed while the ranks run
    for i, name in enumerate(RING_KINDS):
        inputs["rings"][name], later["rings"][name] = ring_case(name, rs, i)
    for i, kind in enumerate(("attention", "aggregate")):
        inputs["models"][kind], later["models"][kind] = model_case(kind,
                                                                   10 + i)
    jax_steps = {}
    for name, (scheme_name, extra) in SCHEMES.items():
        inputs["trainer"][name], jax_steps[name] = trainer_case(
            name, root, rs, scheme_name, extra)
    inputs["accum"], jax_steps[ACCUM[0]] = trainer_case(*ACCUM[:1], root, rs,
                                                        *ACCUM[1:])
    dp = get_scheme("pcqm.dist_pred")(dict(SMALL, triplet_type="attention",
                                           save_path_prefix=str(root)))
    inputs["stochastic"] = {
        "scheme": "pcqm.dist_pred",
        "cfg": dict(SMALL, **STOCHASTIC, triplet_type="attention",
                    num_pair_devices=2, save_path_prefix=str(root / "st")),
        "steps": [global_batch(dp, rs, 16) for _ in range(2)]}
    torch.save(inputs, root / "inputs.pt")

    # the CLI's data and config
    data = root / "pcqm"
    write_synthetic_dataset(str(data), num_samples=96, max_nodes=12, seed=0)
    with open(FLAGSHIP_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg.update(TINY, dataset_path=str(data),
               save_path_prefix=str(root / "rank0"))
    cfg_path = root / "cfg.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    model_dir = root / "rank0" / cfg["model_prefix"] / cfg["model_name"]
    pair = "num_pair_devices: 2"
    cli = {"train": root / "cli_train", "evaluate": root / "cli_evaluate",
           "predict": root / "cli_predict"}
    for d in cli.values():
        d.mkdir()

    for w in (2, 4):
        (root / f"world{w}").mkdir()
        (root / f"world{w}" / "inputs.pt").symlink_to(root / "inputs.pt")
    worlds = {w: start_world(w, root / f"world{w}") for w in (2, 4)}
    train = start_cli(cli["train"], [
        ("tgt_torch.cli.run_training", cfg_path, pair),
        ("tgt_torch.cli.run_training", cfg_path, pair,
         f"save_path_prefix: {root / 'rank1'}")])
    try:
        for part, thunks in later.items():
            ref[part] = {name: thunk() for name, thunk in thunks.items()}
        for name, args in jax_steps.items():
            ref["trainer"][name] = trainer_reference(
                inputs["accum"] if name == ACCUM[0]
                else inputs["trainer"][name], *args)
    finally:
        wait(train)
    evaluate = start_cli(cli["evaluate"], [
        ("tgt_torch.cli.do_evaluations", model_dir, pair)] * 2)
    predict = start_cli(cli["predict"], [
        ("tgt_torch.cli.make_predictions", model_dir, pair)] * 2)
    try:
        wait(evaluate)
        wait(predict)
    finally:
        for procs in worlds.values():
            wait(procs)
    bins = model_dir / "predictions" / "bins2" / "data"
    pair_bins = {p.name: p.read_bytes() for p in sorted(bins.iterdir())}
    one = execute("evaluate", dict(cfg), device="cpu")
    execute("predict", dict(cfg), device="cpu")
    one_bins = {p.name: p.read_bytes() for p in sorted(bins.iterdir())}
    got = {w: [torch.load(root / f"world{w}" / f"out_{r}.pt",
                          weights_only=False) for r in range(w)]
           for w in worlds}
    cli_out = {k: [json.loads((d / f"cli_{r}.json").read_text())
                   for r in (0, 1)] for k, d in cli.items()
               if k != "predict"}
    return {"got": got, "ref": ref, "inputs": inputs, "root": root,
            "model_dir": model_dir, "cli": cli_out, "one": one,
            "bins": (pair_bins, one_bins)}


# -- the collectives ----------------------------------------------------------

def expected_collective(name, case, world, p):
    """(output, gradient) of rank p by the collective's definition."""
    x, cot = case["x"], case["cot"][name]
    blk = N // world

    def rows(a, q):
        return a[:, q * blk:(q + 1) * blk]

    if name == "ring_pass":         # rank p receives p - 1's block
        return rows(x, (p - 1) % world), cot[(p + 1) % world]
    if name == "transpose":
        full_cot = np.concatenate(list(cot), axis=1)
        return (rows(x.transpose(0, 2, 1, 3), p),
                rows(full_cot.transpose(0, 2, 1, 3), p))
    return x, rows(cot.sum(axis=0), p)  # gather: every rank uses all rows


@pytest.mark.parametrize("name", ["ring_pass", "transpose", "gather"])
@pytest.mark.parametrize("world", [2, 4])
def test_collectives_against_their_definitions(runs, world, name):
    case = runs["inputs"]["collectives"][world]
    for p, out in enumerate(runs["got"][world]):
        y, grad = out["collectives"][name]
        want_y, want_grad = expected_collective(name, case, world, p)
        np.testing.assert_array_equal(y.numpy(), want_y)
        np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                                   atol=1e-6 * np.abs(want_grad).max())


# -- the triplet rings against tgt_tpu's unsharded ops ------------------------

def shift_entries(name, kind):
    """Bias entries that add one value to every logit of a softmax row:
    their gradient is zero in exact arithmetic, so both sides hold float
    noise (the key bias of the attention variants and the E bias)."""
    if kind.startswith("attention"):
        if name.startswith("lin_QKV_") and name.endswith(".bias"):
            return np.r_[W:2 * W]
        if name.startswith(("lin_EG_", "lin_E_")) and name.endswith(".bias"):
            return np.r_[0:H]
    elif name == "lin_EG.bias":
        return np.r_[0:H, 2 * H:3 * H]
    elif name == "lin_E.bias":
        return np.r_[0:2 * H]
    return None


def ring_errors(got_ranks, ref, world):
    """max|diff| / max|ref| of the output, the e gradient and the worst
    weight gradient (shift entries held to the noise of their weight)."""
    blk = N // world
    rows = [slice(p * blk, (p + 1) * blk) for p in range(world)]
    out = np.concatenate([g["out"].numpy() for g in got_ranks], axis=1)
    e_grad = np.concatenate([g["e_grad"].numpy() for g in got_ranks], axis=1)
    errs = {"out": np.abs(out - ref["out"]).max() / np.abs(ref["out"]).max(),
            "e_grad": np.abs(e_grad - ref["e_grad"]).max()
            / np.abs(ref["e_grad"]).max()}
    del rows
    for k, r in ref["w_grad"].items():
        for g in got_ranks:         # the sums over the ranks agree
            np.testing.assert_array_equal(g["w_grad"][k].numpy(),
                                          got_ranks[0]["w_grad"][k].numpy())
        errs[k] = r, got_ranks[0]["w_grad"][k].numpy()
    return errs


@pytest.mark.parametrize("kind", sorted(RING_KINDS))
@pytest.mark.parametrize("world", [2, 4])
def test_triplet_ring_matches_unsharded(runs, world, kind):
    ref = runs["ref"]["rings"][kind]
    errs = ring_errors([g["rings"][kind] for g in runs["got"][world]], ref,
                       world)
    assert errs.pop("out") <= TOL and errs.pop("e_grad") <= TOL
    for name, (r, g) in errs.items():
        shift = shift_entries(name, kind)
        if shift is not None:
            noise = TOL * np.abs(ref["w_grad"][name[:-4] + "weight"]).max()
            assert np.abs(g[shift]).max() <= noise, name
            assert np.abs(r[shift]).max() <= noise, name
            keep = np.ones(r.shape, bool)
            keep[shift] = False
            r, g = r[keep], g[keep]
            if r.size == 0:
                continue
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("fault", ["fault_block", "fault_transpose"])
def test_ring_witnesses_miss_the_bound(runs, fault):
    """A ring that places block t at ``my``, and an out direction without
    its pair transpose, miss the output bound by more than 100x."""
    ref = runs["ref"]["rings"]["attention"]
    errs = ring_errors([g["rings"][fault] for g in runs["got"][2]], ref, 2)
    assert errs["out"] > WITNESS * TOL, errs["out"]


# -- the pair-sharded models --------------------------------------------------

@pytest.mark.parametrize("kind", ["attention", "aggregate"])
def test_pair_distance_model_matches_tgt_tpu(runs, kind):
    ref = runs["ref"]["models"][kind]
    got = np.concatenate([g["models"][kind].numpy()
                          for g in runs["got"][2]], axis=1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


# -- the Trainer --------------------------------------------------------------

def train_shift_entries(name, cfg):
    """As in ``test_torch_port_distributed.py``: triplet-bias entries whose
    gradient is zero in exact arithmetic, so both packages hold float
    noise there, which Adam turns into steps of up to lr."""
    h, w = cfg.triplet_heads, cfg.edge_width
    if ".tria.lin_QKV_" in name and name.endswith(".bias"):
        return slice(w, 2 * w)
    if ".tria.lin_EG_" in name and name.endswith(".bias"):
        return slice(0, h)
    if name.endswith(".tria.lin_EG.bias"):
        return np.r_[0:h, 2 * h:3 * h]
    return None


def step_errors(got_ranks, ref, cfg):
    """Per step: every rank holds the same loss and weights; the largest
    weight error over its bound, and the loss's relative error."""
    out = []
    lr_sum = 0.0
    for i, (jloss, jok, jlr, jweights) in enumerate(ref):
        r0 = got_ranks[0][i]
        for g in got_ranks[1:]:
            assert g[i]["loss"] == r0["loss"]
            for k, v in r0["weights"].items():
                assert torch.equal(v, g[i]["weights"][k]), k
        assert r0["ok"] and jok
        assert abs(r0["lr"] - jlr) <= 1e-9
        lr_sum += r0["lr"]
        worst = 0.0
        for k, v in r0["weights"].items():
            r = jweights[k].numpy()
            bound = 1e-3 * lr_sum + (i + 1) * np.spacing(np.abs(r))
            shift = train_shift_entries(k, cfg)
            if shift is not None:
                bound[shift] += lr_sum
            worst = max(worst, float((np.abs(v.numpy() - r) / bound).max()))
        out.append((abs(r0["loss"] - jloss) / abs(jloss), worst))
    return out


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("world", [2, 4])
def test_pair_trainer_step_equals_tgt_tpu_global_step(runs, world, scheme):
    """(D=1, P=2) at world 2 and (D=2, P=2) at world 4."""
    cfg = get_scheme(SCHEMES[scheme][0])(runs["inputs"]["trainer"][scheme][
        "cfg"]).model_cfg
    for i, (loss_err, weight_err) in enumerate(step_errors(
            [g["trainer"][scheme] for g in runs["got"][world]],
            runs["ref"]["trainer"][scheme], cfg)):
        assert loss_err <= LOSS_RTOL, (i, loss_err)
        assert weight_err <= 1.0, (i, weight_err)


def test_pair_trainer_with_accumulation_equals_tgt_tpu(runs):
    """Two micro-batches a step at (D=1, P=2), held as above."""
    case = runs["inputs"]["accum"]
    cfg = get_scheme(case["scheme"])(case["cfg"]).model_cfg
    for i, (loss_err, weight_err) in enumerate(step_errors(
            [g["accum"] for g in runs["got"][2]],
            runs["ref"]["trainer"][ACCUM[0]], cfg)):
        assert loss_err <= LOSS_RTOL, (i, loss_err)
        assert weight_err <= 1.0, (i, weight_err)


def test_gap_counted_on_every_pair_rank_misses(runs):
    cfg = get_scheme("pcqm.pretrain")(runs["inputs"]["trainer"]["pretrain"][
        "cfg"]).model_cfg
    errs = step_errors([g["witness_gap"] for g in runs["got"][2]],
                       runs["ref"]["trainer"]["pretrain"], cfg)
    assert errs[0][0] > WITNESS * LOSS_RTOL, errs


def test_stochastic_training_agrees_across_the_pair_group(runs):
    r0, r1 = (g["stochastic"] for g in runs["got"][2])
    assert r0["losses"] == r1["losses"]
    assert all(np.isfinite(r0["losses"]))
    assert torch.equal(r0["h"], r1["h"])
    assert not torch.equal(r0["h"], torch.zeros_like(r0["h"]))


# -- what raises --------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("use_pallas_dense", dict(num_pair_devices=2, use_pallas="dense"), 2,
     ValueError, "shard_map"),
    ("use_pallas_true", dict(num_pair_devices=2, use_pallas=True), 2,
     ValueError, "use_pallas"),
    ("use_pallas_true_data_axis", dict(use_pallas=True), 2, ValueError,
     "shard_map"),
    ("triangular_update", dict(num_pair_devices=2,
                               triplet_type="triangular_update"), 2,
     NotImplementedError, "triangular_update"),
    ("axial_attention", dict(num_pair_devices=2,
                             triplet_type="axial_attention"), 2,
     NotImplementedError, "axial_attention"),
    ("world_size", dict(num_pair_devices=2), 3, ValueError,
     "num_pair_devices"),
], ids=lambda c: c[0])
def test_pair_axis_raises_where_tgt_tpu_does(tmp_path, case):
    """tgt_tpu/training/harness.py:241-265 (tests/test_training.py:565-590),
    tgt_tpu/parallel/pair_layer.py:168-170 and mesh.py:34-36."""
    _, over, world, error, match = case
    scheme = get_scheme("pcqm.dist_pred")(dict(
        SMALL, save_path_prefix=str(tmp_path),
        **{"triplet_type": "attention", **over}))
    with pytest.raises(error, match=match):
        Trainer(scheme, rank=0, world_size=world, device="cpu")


# -- the CLI by (D=1, P=2) ranks ----------------------------------------------

def test_cli_pair_ranks_train_identical_histories(runs):
    h0, h1 = (t["history"] for t in runs["cli"]["train"])
    assert len(h0) == len(h1) == 2
    for e0, e1 in zip(h0, h1):
        assert e0.keys() == e1.keys()
        for k, v in e0.items():
            if k in ("train_time", "val_time"):     # wall clocks, per rank
                continue
            assert v == e1[k], k
            if isinstance(v, float):
                assert np.isfinite(v), k


def test_cli_pair_rank_zero_alone_writes(runs):
    model_dir = runs["model_dir"]
    for name in ("config.yaml", "logs/history.yaml", "checkpoint/model.npz",
                 "predictions/results.yaml"):
        assert (model_dir / name).exists(), name
    written = [p for p in (runs["root"] / "rank1").rglob("*") if p.is_file()]
    assert written == []


def test_cli_pair_evaluate_equals_one_process(runs):
    m0, m1 = (e["metrics"] for e in runs["cli"]["evaluate"])
    assert m0 == m1 and np.isfinite(m0["val"]["loss"])
    assert runs["one"]["val"]["loss"] == pytest.approx(m0["val"]["loss"],
                                                       rel=1e-5)


def test_cli_pair_predict_writes_one_shard_per_data_index(runs):
    """A pair group is one data index: one bins shard per split, which
    ``Bins`` reads back, and the same bytes as one process's predict."""
    pair_bins, one_bins = runs["bins"]
    assert sorted(pair_bins) == ["train_000.parquet", "val_000.parquet"]
    assert pair_bins == one_bins
    data = runs["root"] / "pcqm"
    ds = PCQM4Mv2Dataset("valid", str(data), return_idx=True,
                         additional_columns=[Bins(str(
                             runs["model_dir"] / "predictions" / "bins2"), 2)])
    row = ds[0]
    n = row["num_nodes"]
    assert row["dist_bins"].shape == (2, n, n)
