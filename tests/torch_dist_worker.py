"""One rank of a two-process tgt_torch run on the CPU, over gloo, for
``tests/test_torch_port_distributed.py``. Imports torch and tgt_torch only.

    python tests/torch_dist_worker.py trainer <rank> <port> <workdir>
    python tests/torch_dist_worker.py cli <rank> <port> <workdir> <module> \
        [cli arguments]...

``trainer`` reads ``<workdir>/inputs.pt`` (written by the test), runs the
Trainer scenarios as rank ``rank`` of 2 and writes ``<workdir>/out_<rank>.pt``.
``cli`` runs ``python -m <module> <cli arguments> --device cpu`` as that
rank (the rendezvous in the yaml keys), with a 60 s bound on the
rendezvous and every collective, and writes what ``Trainer.fit`` and the
evaluate metrics returned on this rank to ``<workdir>/cli_<rank>.json``.
"""
import datetime
import functools
import json
import os
import runpy
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)
TIMEOUT = datetime.timedelta(seconds=60)
WORLD = 2


def steps(scheme_cfg, weights, halves, rank):
    """Trainer.train_step on this rank's halves; per step the global loss
    and metrics, the loss of this rank's half alone (its own mean), and
    the weights after the step."""
    from tgt_torch.schemes import get_scheme
    from tgt_torch.training import Trainer

    scheme = get_scheme("pcqm.dist_pred")(scheme_cfg)
    trainer = Trainer(scheme, rank=rank, world_size=WORLD, device="cpu")
    state = trainer.init_state()
    state["model"].load_state_dict(weights)
    out = []
    for i, half in enumerate(halves):
        db = trainer.to_device(trainer.pad_device_batch(half))
        local = float(scheme.loss_fn(state["model"], db, i)[0].detach())
        state, m = trainer.train_step(state, db, i, seed=i)
        out.append({"loss": float(m["loss"]), "ok": bool(m["ok"]),
                    "lr": m["lr"], "local_loss": local,
                    "weights": {k: v.clone() for k, v in
                                state["model"].state_dict().items()}})
    return out


def seeds_of_epoch(scheme_cfg, rank):
    """The seeds ``train_epoch`` gives its steps."""
    from tgt_torch.schemes import get_scheme
    from tgt_torch.training import Trainer

    scheme = get_scheme("pcqm.dist_pred")(scheme_cfg)
    trainer = Trainer(scheme, rank=rank, world_size=WORLD, device="cpu")
    seeds = []
    step = trainer.train_step

    def recorded(state, batch, i, seed, lr_scale=1.0):
        seeds.append(seed)
        return step(state, batch, i, seed, lr_scale)

    trainer.train_step = recorded
    trainer.train_epoch(trainer.init_state(),
                        scheme.train_loader(0, rank, WORLD))
    return seeds


def trainer_mode(rank, port, workdir):
    from tgt_torch.parallel import gather_predictions, initialize_distributed
    from tgt_torch.schemes import get_scheme
    from tgt_torch.training import Trainer

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    assert initialize_distributed(f"localhost:{port}", WORLD, rank,
                                  device="cpu", timeout=TIMEOUT) == (rank,
                                                                     WORLD)
    out = {}
    for name, case in inputs["parity"].items():
        out[name] = steps(case["cfg"], inputs["weights"],
                          case["halves"][rank], rank)

    # rank 1's second batch holds NaN coordinates
    nan = inputs["nan"]
    halves = [dict(h) for h in nan["halves"][rank]]
    if rank == 1:
        halves[1]["rdkit_coords"] = np.full_like(halves[1]["rdkit_coords"],
                                                 np.nan)
    out["nan"] = steps(nan["cfg"], inputs["weights"], halves, rank)

    # each rank draws its weights from its own seed; load_or_init gives
    # every rank rank 0's
    scheme = get_scheme("pcqm.dist_pred")(nan["cfg"])
    trainer = Trainer(scheme, rank=rank, world_size=WORLD, device="cpu")
    out["own_init"] = {k: v.clone() for k, v in
                       trainer.init_state(rank)["model"].state_dict().items()}
    out["broadcast"] = {k: v.clone() for k, v in trainer.load_or_init(
        rank)["model"].state_dict().items()}

    out["seeds"] = seeds_of_epoch(inputs["seeds_cfg"], rank)
    rs = np.random.RandomState(rank)
    n = 5 - rank                                  # np.array_split of 9
    out["gather_in"] = {"row": np.arange(n) + 10 * rank,
                        "mat": rs.randn(n, 3).astype(np.float32),
                        "scalar": np.asarray(float(rank + 7))}
    out["gather_out"] = gather_predictions(out["gather_in"], WORLD)
    out["gather_empty"] = gather_predictions(
        {"row": np.arange(2), "scalar": np.asarray(5.0)} if rank == 0
        else {}, WORLD)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.destroy_process_group()


def cli_mode(rank, port, workdir, module, args):
    """The CLI module as this rank, as ``python -m`` runs it."""
    import tgt_torch.cli.execute
    from tgt_torch.training import Trainer

    ex = sys.modules["tgt_torch.cli.execute"]  # the package exports execute()

    dist.init_process_group = functools.partial(dist.init_process_group,
                                                timeout=TIMEOUT)
    seen = {}
    fit, write_results = Trainer.fit, ex._write_results

    def recorded_fit(self, *a, **k):
        result = fit(self, *a, **k)
        seen["history"] = result["history"]
        return result

    def recorded_results(*a, **k):
        seen["metrics"] = write_results(*a, **k)
        return seen["metrics"]

    Trainer.fit, ex._write_results = recorded_fit, recorded_results
    sys.argv = [module] + args + [
        f"jax_coordinator: localhost:{port}", "jax_num_processes: 2",
        f"jax_process_id: {rank}", "--device", "cpu"]
    runpy.run_module(module, run_name="__main__")
    assert not dist.is_initialized(), "execute left its group behind"
    with open(os.path.join(workdir, f"cli_{rank}.json"), "w") as f:
        json.dump(seen, f)


if __name__ == "__main__":
    mode, rank, port, workdir = sys.argv[1:5]
    if mode == "trainer":
        trainer_mode(int(rank), int(port), workdir)
    else:
        cli_mode(int(rank), int(port), workdir, sys.argv[5], sys.argv[6:])
