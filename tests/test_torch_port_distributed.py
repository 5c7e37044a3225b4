"""tgt_torch's data parallelism against tgt_tpu (CPU, float32, two ranks
over gloo; ``tests/torch_dist_worker.py`` is one rank).

- ``gather_predictions`` at world size 1 and 2 (shards 5/4, 0-d and 2-d
  values: the rank-ordered concatenation, the same on both ranks);
- ``initialize_distributed`` from tgt_tpu's yaml keys, from torchrun's
  environment and with neither; a device index out of range raises;
- two ranks' ``Trainer.train_step`` on their halves of a global batch
  (unequal valid-edge counts, a padding row on rank 1) against tgt_tpu's
  single-process step on the concatenated batch, for 3 steps, at
  accumulation 1 and 2 (tgt_tpu on the global batch reordered so that its
  contiguous micro-batches are the port's unions of the ranks' chunks),
  under the bound of ``test_torch_port_training.py``'s three-step test;
  the batches are witnesses: the mean of the ranks' own losses misses
  the global loss by more than 100x the tolerance;
- a NaN on one rank skips the step on both; a rank drawn from another
  seed ends with rank 0's weights; the ranks' step seeds differ, and at
  world size 1 they are the single-process seeds;
- ``size_bucketed_batching`` at world size 2 and ``num_pair_devices: 3``
  at world size 2 raise;
- the CLI in two processes (``python -m tgt_torch.cli.run_training`` with
  ``jax_coordinator``, ``jax_num_processes: 2``, ``jax_process_id``):
  identical histories with an ``lr_scale`` the plateau moved, rank 0 alone
  writes, ``do_evaluations`` by two ranks equals one process's,
  ``make_predictions`` writes two bins shards that ``Bins`` joins.

Every process bounds its rendezvous and collectives at 60 s and is killed
after 120 s, so a hang fails a test instead of the suite.
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

from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.training import harness as jharness
from tgt_torch.cli.execute import execute
from tgt_torch.data.collate import padded_collate
from tgt_torch.data.pcqm import Bins, PCQM4Mv2Dataset
from tgt_torch.data.prepare import write_synthetic_dataset
from tgt_torch.data.structural import AddStructuralData
from tgt_torch.data.synthetic import make_molecule
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.parallel import gather_predictions, initialize_distributed, mesh
from tgt_torch.schemes import get_scheme
from tgt_torch.training import Trainer
from tgt_torch.training.harness import derive_seed

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
FLAGSHIP_YAML = REPO / "configs/pcqm/tgt_at_200m/dist_pred/tgt_at_dp_rdkit.yaml"
PROC_TIMEOUT = 120

SMALL = dict(
    dataset_source="synthetic", synth_train_samples=32, synth_max_nodes=16,
    buckets=[16], model_height=2, node_width=32, edge_width=32, num_heads=4,
    triplet_heads=4, triplet_type="attention", num_dist_bins=16,
    use_pallas="dense", max_lr=1e-3, min_lr=1e-6, lr_warmup_steps=1,
    lr_total_steps=100)
LOSS_RTOL = 1e-4
STEPS = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(mode, workdir, args_by_rank=((), ())):
    """Both ranks of ``tests/torch_dist_worker.py`` as subprocesses."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO)
    return [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(r), str(port), str(workdir),
         *args], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r, args in enumerate(args_by_rank)]


def wait_ranks(procs) -> None:
    """Fails with the ranks' output if either fails or outlives
    PROC_TIMEOUT; both are killed."""
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


# -- gather_predictions and initialize_distributed ---------------------------

def test_gather_predictions_world_size_one_is_identity():
    preds = {"loss": np.arange(4.0), "valid": np.asarray(3)}
    assert gather_predictions(preds, 1) is preds


class TestInitialize:
    @pytest.fixture
    def calls(self, monkeypatch):
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        made = []
        monkeypatch.setattr(mesh.dist, "init_process_group",
                            lambda backend, **kw: made.append((backend, kw)))
        return made

    def test_from_tgt_tpu_keys(self, calls):
        assert initialize_distributed("localhost:1234", 2, 1,
                                      device="cpu") == (1, 2)
        (backend, kw), = calls
        assert backend == "gloo"
        assert kw == {"init_method": "tcp://localhost:1234",
                      "world_size": 2, "rank": 1}

    def test_from_torchrun_environment(self, calls, monkeypatch):
        for var, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                           ("LOCAL_RANK", "1"), ("MASTER_ADDR", "host"),
                           ("MASTER_PORT", "29500")):
            monkeypatch.setenv(var, value)
        assert initialize_distributed(device="cpu", backend="gloo") == (1, 2)
        (backend, kw), = calls
        assert kw["init_method"] == "tcp://host:29500"
        assert (kw["world_size"], kw["rank"]) == (2, 1)

    def test_with_neither_is_one_process(self, calls):
        assert initialize_distributed() == (0, 1)
        assert initialize_distributed(None, 1, 0) == (0, 1)
        assert calls == []

    def test_two_processes_without_rendezvous_raise(self, calls):
        with pytest.raises(ValueError, match="jax_coordinator"):
            initialize_distributed(num_processes=2, device="cpu")
        assert calls == []

    def test_device_out_of_range_raises(self, calls):
        count = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"cuda:{count} does not exist"):
            mesh.rank_device(f"cuda:{count}")
        # the default device of rank 1 is cuda:1, never the CPU
        with pytest.raises(ValueError, match="does not exist"):
            initialize_distributed("localhost:1234", 2, 1 + count)
        assert mesh.rank_device("cpu") == torch.device("cpu")
        assert calls == []


# -- the Trainer on two ranks against tgt_tpu ------------------------------------

def molecules(rs, sizes):
    transform = AddStructuralData()
    rows = []
    for n in sizes:
        row = make_molecule(rs, int(n))
        row["node_mask"] = np.ones(n, np.uint8)
        rows.append(transform(row))
    return rows


def halves_of(scheme, rs, per_rank):
    """This step's device batches of the two ranks: rank 0 small molecules
    (2-3 atoms), rank 1 large ones (14-16) and one padding row. Their
    valid pairs and their mean losses differ."""
    small = molecules(rs, rs.randint(2, 4, per_rank))
    large = molecules(rs, rs.randint(14, 17, per_rank - 1))
    out = []
    for rows in (small, large):
        host = padded_collate(rows, buckets=(16,))
        db = scheme.device_batch(host)
        pad = per_rank - db["sample_mask"].shape[0]
        assert pad >= 0
        out.append({k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                                   v.dtype)])
                    for k, v in db.items()})
    assert out[1]["sample_mask"][-1] == 0 and out[0]["sample_mask"].all()
    return out


def global_batch(halves, accum):
    """The ranks' halves as one batch whose ``accum`` contiguous
    micro-batches are the unions of the ranks' m-th chunks."""
    chunk = halves[0]["sample_mask"].shape[0] // accum
    return {k: np.concatenate([h[k][m * chunk:(m + 1) * chunk]
                               for m in range(accum) for h in halves])
            for k in halves[0]}


def softmax_shift_entries(name, cfg):
    """As in ``test_torch_port_training.py``: triplet-bias entries whose
    gradient is zero in exact arithmetic, so both packages hold float
    noise there, which Adam turns into steps of up to lr."""
    if ".tria.lin_QKV_" in name and name.endswith(".bias"):
        return slice(cfg.edge_width, 2 * cfg.edge_width)
    if ".tria.lin_EG_" in name and name.endswith(".bias"):
        return slice(0, cfg.triplet_heads)
    return None


PARITY = {"accum1": (1, 4), "accum2": (2, 8)}   # accum, rows per rank


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One two-rank run of the Trainer scenarios (workers started
    first), and tgt_tpu's steps on the global batches meanwhile."""
    root = tmp_path_factory.mktemp("ddp")
    over = dict(SMALL, save_path_prefix=str(root))
    jscheme = jax_get_scheme("pcqm.dist_pred")(dict(over, use_mesh=False))
    params = jharness.Trainer(jscheme).init_state(
        jax.random.PRNGKey(0))["params"]
    scheme = get_scheme("pcqm.dist_pred")(over)
    weights = state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                         scheme.model_cfg)
    rs = np.random.RandomState(0)
    inputs = {"weights": weights, "parity": {},
              "seeds_cfg": dict(over, batch_size=4, global_batch_size=8)}
    for name, (accum, rows) in PARITY.items():
        cfg = dict(over, batch_size=4, global_batch_size=8 * accum)
        inputs["parity"][name] = {
            "cfg": cfg, "accum": accum,
            "steps": [halves_of(get_scheme("pcqm.dist_pred")(cfg), rs, rows)
                      for _ in range(STEPS)]}
        inputs["parity"][name]["halves"] = [
            [s[r] for s in inputs["parity"][name]["steps"]] for r in (0, 1)]
    nan_cfg = dict(over, batch_size=4, global_batch_size=8)
    nan_steps = [halves_of(get_scheme("pcqm.dist_pred")(nan_cfg), rs, 4)
                 for _ in range(2)]
    inputs["nan"] = {"cfg": nan_cfg,
                     "halves": [[s[r] for s in nan_steps] for r in (0, 1)]}
    torch.save(inputs, root / "inputs.pt")
    procs = start_ranks("trainer", root)
    try:
        ref = {}
        for name, case in inputs["parity"].items():
            jcfg = dict(over, use_mesh=False, grad_accum_steps=case["accum"],
                        batch_size=8 * case["accum"])
            jtrainer = jharness.Trainer(
                jax_get_scheme("pcqm.dist_pred")(jcfg))
            assert jtrainer.grad_accum == case["accum"]
            jstep = jtrainer.build_train_step()
            jstate = jtrainer.init_state(jax.random.PRNGKey(0))
            ref[name] = []
            for i, halves in enumerate(case["steps"]):
                jstate, jm = jstep(
                    jstate, jtrainer.shard_device_batch(
                        global_batch(halves, case["accum"])),
                    jnp.asarray(i), jax.random.PRNGKey(i), jnp.asarray(1.0))
                ref[name].append((float(jm["loss"]), bool(jm["ok"]),
                                  float(jm["lr"]), state_dict_from_jax_params(
                                      jax.tree.map(np.asarray,
                                                   jstate["params"]),
                                      scheme.model_cfg)))
    finally:
        wait_ranks(procs)
    got = [torch.load(root / f"out_{r}.pt", weights_only=False)
           for r in (0, 1)]
    return {"got": got, "ref": ref, "inputs": inputs, "scheme": scheme,
            "over": over}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_two_ranks_step_equals_tgt_tpu_global_step(two_ranks, case):
    got, ref = two_ranks["got"], two_ranks["ref"][case]
    cfg = two_ranks["scheme"].model_cfg
    lr_sum = 0.0
    for i, (jloss, jok, jlr, jweights) in enumerate(ref):
        r0, r1 = got[0][case][i], got[1][case][i]
        assert r0["ok"] and r1["ok"] and jok
        # both ranks hold the same step: loss and weights bit for bit
        assert r0["loss"] == r1["loss"]
        for k, v in r0["weights"].items():
            assert torch.equal(v, r1["weights"][k]), k
        np.testing.assert_allclose(r0["loss"], jloss, rtol=LOSS_RTOL)
        # a witness: the average of the ranks' own means, what plain DDP
        # computes, misses the global loss
        mean_of_means = (r0["local_loss"] + r1["local_loss"]) / 2
        assert abs(mean_of_means - jloss) > 100 * LOSS_RTOL * abs(jloss), \
            (i, mean_of_means, jloss)
        assert abs(r0["lr"] - jlr) <= 1e-9
        lr_sum += r0["lr"]
        for k, v in r0["weights"].items():
            r = jweights[k].numpy()
            bound = 1e-3 * lr_sum + (i + 1) * np.spacing(np.abs(r))
            shift = softmax_shift_entries(k, cfg)
            if shift is not None:
                bound[shift] += lr_sum
            err = np.abs(v.numpy() - r)
            assert np.all(err <= bound), (case, i, k, float(err.max()))


def test_nan_on_one_rank_skips_the_step_on_both(two_ranks):
    for r in (0, 1):
        first, second = two_ranks["got"][r]["nan"]
        assert first["ok"] and not second["ok"]
        assert not np.isfinite(second["loss"])
        for k, v in second["weights"].items():
            assert torch.equal(v, first["weights"][k]), (r, k)


def test_weights_start_as_rank_zeros(two_ranks):
    own = [g["own_init"] for g in two_ranks["got"]]
    assert any(not torch.equal(own[0][k], own[1][k]) for k in own[0])
    for r in (0, 1):
        for k, v in two_ranks["got"][r]["broadcast"].items():
            assert torch.equal(v, own[0][k]), (r, k)


def test_step_seeds(two_ranks, tmp_path):
    seed0 = 0
    seeds = [g["seeds"] for g in two_ranks["got"]]
    assert len(seeds[0]) == len(seeds[1]) == 4       # 16 molecules, 4 a step
    for r in (0, 1):
        assert seeds[r] == [derive_seed(seed0, step * 2 + r)
                            for step in range(4)]
    assert not set(seeds[0]) & set(seeds[1])
    # one process: the seeds of a run without ranks
    scheme = get_scheme("pcqm.dist_pred")(dict(
        SMALL, save_path_prefix=str(tmp_path), batch_size=4,
        global_batch_size=4))
    trainer = Trainer(scheme, device="cpu")
    recorded, step = [], trainer.train_step
    trainer.train_step = lambda state, batch, i, seed, lr_scale=1.0: (
        recorded.append(seed) or step(state, batch, i, seed, lr_scale))
    trainer.train_epoch(trainer.init_state(), scheme.train_loader(0, 0, 1))
    assert recorded == [derive_seed(seed0, s) for s in range(8)]


def test_gather_predictions_two_ranks(two_ranks):
    shards = [g["gather_in"] for g in two_ranks["got"]]
    assert [len(s["row"]) for s in shards] == [5, 4]
    for r in (0, 1):
        out = two_ranks["got"][r]["gather_out"]
        np.testing.assert_array_equal(out["row"], np.concatenate(
            [s["row"] for s in shards]))
        np.testing.assert_array_equal(out["mat"], np.concatenate(
            [s["mat"] for s in shards]))
        np.testing.assert_array_equal(out["scalar"], [7.0, 8.0])
        assert out["mat"].shape == (9, 3)
    # rank 1 held no rows of its split: rank 0's alone
    for r in (0, 1):
        empty = two_ranks["got"][r]["gather_empty"]
        np.testing.assert_array_equal(empty["row"], [0, 1])
        np.testing.assert_array_equal(empty["scalar"], [5.0])


@pytest.mark.parametrize("option", ["size_bucketed_batching",
                                    "num_pair_devices"])
def test_options_that_cannot_split_over_ranks_raise(tmp_path, option):
    """Size buckets would give the ranks different numbers of batches (and
    tgt_tpu's collectives hang there); a pair axis of 3 does not divide a
    world of 2 ranks (tgt_tpu's ``make_mesh`` raises there too)."""
    scheme = get_scheme("pcqm.dist_pred")(dict(
        SMALL, save_path_prefix=str(tmp_path),
        **{option: {"size_bucketed_batching": True,
                    "num_pair_devices": 3}[option]}))
    if option == "size_bucketed_batching":
        scheme.train_loader(0, 0, 1)         # one process may use them
        with pytest.raises(ValueError, match=option):
            scheme.train_loader(0, 0, 2)
    else:
        with pytest.raises(ValueError, match=option):
            Trainer(scheme, rank=0, world_size=2, device="cpu")


def test_world_size_two_without_group_raises(tmp_path):
    scheme = get_scheme("pcqm.dist_pred")(dict(
        SMALL, save_path_prefix=str(tmp_path)))
    with pytest.raises(ValueError, match="initialize_distributed"):
        Trainer(scheme, rank=1, world_size=2, device="cpu")


# -- the CLI in two processes ----------------------------------------------------

# a rate high enough that the val loss rises in epoch 3 (10.4, 9.2, 15.8
# on two ranks), so the plateau halves lr_scale
TINY = dict(global_batch_size=16, batch_size=8, model_height=2,
            node_width=16, edge_width=16, num_heads=4, triplet_heads=4,
            num_dist_bins=8, buckets=[12], evaluation_samples=2,
            prediction_samples=2, mixed_precision=False, lr_warmup_steps=1,
            max_lr=1.0, num_epochs=3, rlr_factor=0.5, rlr_patience=0,
            predict_in_train=False)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Train by two ranks (rank 1's save path apart, to show it writes
    nothing), then evaluate and predict by two ranks, on a synthetic PCQM
    parquet whose valid-3d split has 9 molecules (5/4)."""
    root = tmp_path_factory.mktemp("cli")
    data = root / "pcqm"
    write_synthetic_dataset(str(data), num_samples=96, max_nodes=12, seed=0)
    with open(FLAGSHIP_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg.update(TINY, dataset_path=str(data),
               save_path_prefix=str(root / "rank0"))
    path = root / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    model_dir = root / "rank0" / cfg["model_prefix"] / cfg["model_name"]
    out = {"root": root, "cfg": cfg, "model_dir": model_dir}
    train = root / "train"
    train.mkdir()
    wait_ranks(start_ranks("cli", train, [
        ("tgt_torch.cli.run_training", str(path)),
        ("tgt_torch.cli.run_training", str(path),
         f"save_path_prefix: {root / 'rank1'}")]))
    out["train"] = [json.loads((train / f"cli_{r}.json").read_text())
                    for r in (0, 1)]
    for name, module in (("evaluate", "tgt_torch.cli.do_evaluations"),
                         ("predict", "tgt_torch.cli.make_predictions")):
        d = root / name
        d.mkdir()
        wait_ranks(start_ranks("cli", d, [(module, str(model_dir))] * 2))
        out[name] = [json.loads((d / f"cli_{r}.json").read_text())
                     for r in (0, 1)]
    return out


def test_cli_two_ranks_train_identical_histories(cli_run):
    h0, h1 = (t["history"] for t in cli_run["train"])
    assert len(h0) == len(h1) == 3
    for e0, e1 in zip(h0, h1):
        assert e0.keys() == e1.keys()
        for k, v in e0.items():
            if k in ("train_time", "val_time"):     # wall clocks, per rank
                continue
            assert v == pytest.approx(e1[k], rel=1e-6, abs=1e-9), k
            if isinstance(v, float):
                assert np.isfinite(v), k
        assert e0["global_step"] == 4 * (e0["epoch"] + 1)   # 32 a rank, 8 a step
    scales = [e["lr_scale"] for e in h0]
    assert scales[0] == 1.0 and scales[-1] < 1.0, scales


def test_cli_rank_zero_alone_writes(cli_run):
    model_dir = cli_run["model_dir"]
    for name in ("config.yaml", "all_config.yaml", "model_summary.txt",
                 "logs/history.yaml", "checkpoint/model.npz",
                 "checkpoint/optimizer.npz",
                 "checkpoint/training_state.json"):
        assert (model_dir / name).exists(), name
    with open(model_dir / "logs" / "history.yaml") as f:
        assert len(yaml.safe_load(f)) == 3
    written = [p for p in (cli_run["root"] / "rank1").rglob("*")
               if p.is_file()]
    assert written == []


def test_cli_two_rank_evaluate_equals_one_process(cli_run):
    m0, m1 = (e["metrics"] for e in cli_run["evaluate"])
    assert m0 == m1 and np.isfinite(m0["val"]["loss"])
    with open(cli_run["model_dir"] / "predictions" / "results.yaml") as f:
        assert yaml.safe_load(f)["val"] == m0["val"]
    one = execute("evaluate", dict(cli_run["cfg"]), device="cpu")
    assert one["val"]["loss"] == pytest.approx(m0["val"]["loss"], rel=1e-5)


def test_cli_dist_pred_predict_two_bins_shards(cli_run):
    cfg = cli_run["cfg"]
    bins_dir = cli_run["model_dir"] / "predictions" / "bins2"
    data = cli_run["root"] / "pcqm"
    import pyarrow.parquet as pq
    splits = np.load(data / "splits.npz")
    for split in ("train", "valid"):
        split_key = "train" if split == "train" else "val"
        shards = sorted((bins_dir / "data").glob(f"{split_key}_*.parquet"))
        assert [s.name for s in shards] == [f"{split_key}_000.parquet",
                                            f"{split_key}_001.parquet"]
        idx = np.concatenate([pq.read_table(s)["idx"].to_numpy()
                              for s in shards])
        assert sorted(idx.tolist()) == sorted(splits[split].tolist())
        ds = PCQM4Mv2Dataset(split, str(data), return_idx=True,
                             additional_columns=[Bins(str(bins_dir), 2)])
        for i in range(len(ds)):
            row = ds[i]
            n = row["num_nodes"]
            assert row["dist_bins"].shape == (2, n, n)
            assert row["dist_bins"].max() < cfg["num_dist_bins"]
