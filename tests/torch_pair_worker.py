"""One rank of a tgt_torch run on the pair axis, on the CPU over gloo, for
``tests/test_torch_port_pair.py``. Imports torch and tgt_torch only.

    python tests/torch_pair_worker.py <rank> <world> <port> <workdir>

Reads ``<workdir>/inputs.pt`` (written by the test) and runs, as rank
``rank`` of ``world``:
- the pair collectives (``ring_pass``, ``_pair_transpose``,
  ``_gather_rows``) and the four triplet rings on a pair axis of all
  ``world`` ranks, forward and gradients; at world size 2 also with the
  planted faults (a misplaced ring block, no pair transpose in the out
  direction), the pair-sharded distance models, the stochastic check and
  the gap witness;
- ``Trainer.train_step`` at ``num_pair_devices: 2`` on this rank's data
  index's rows of each global batch (at world size 2 also with two
  micro-batches a step).

Writes ``<workdir>/out_<rank>.pt``. Every rendezvous and collective is
bounded at 60 s.
"""
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)
TIMEOUT = datetime.timedelta(seconds=60)

_new_group = dist.new_group
dist.new_group = lambda *a, **k: _new_group(*a, **dict(k, timeout=TIMEOUT))


def t(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


def pair_sum(x, axis):
    """A gradient summed over the ranks of ``axis``."""
    x = x.clone()
    dist.all_reduce(x, group=axis.group)
    return x


def collectives(axis, case):
    """Each collective's output and the gradient of <output, cot> with
    respect to this rank's rows (``cot`` this rank's own cotangent)."""
    from tgt_torch.parallel import ring

    rows = axis.rows(case["x"].shape[1])
    out = {}
    for name, fn in (("ring_pass", ring.ring_pass),
                     ("transpose", ring._pair_transpose),
                     ("gather", ring._gather_rows)):
        x = t(case["x"][:, rows], grad=True)
        y = fn(x, axis)
        (y * t(case["cot"][name][axis.index])).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def triplet_ring(axis, case, gated, aggregate):
    """A triplet ring's output rows, its gradient with respect to this
    rank's e rows, and its weights' gradients summed over the ranks."""
    from tgt_torch.ops.triplet import TripletAggregate, TripletAttention
    from tgt_torch.parallel import ring

    w, h = case["e"].shape[-1], case["heads"]
    module = (TripletAggregate if aggregate else TripletAttention)(
        w, h, gated=gated)
    module.load_state_dict(case["weights"])
    fn = ring.triplet_aggregate_ring if aggregate else \
        ring.triplet_attention_ring
    rows = axis.rows(case["e"].shape[1])
    e = t(case["e"][:, rows], grad=True)
    out = fn(module, e, t(case["mask"][:, rows]), axis)
    (out * t(case["cot"][:, rows])).sum().backward()
    return {"out": out.detach(), "e_grad": e.grad,
            "w_grad": {k: pair_sum(p.grad, axis)
                       for k, p in module.named_parameters()}}


def rings(axis, inputs, faults=False):
    from tgt_torch.parallel import ring

    out = {name: triplet_ring(axis, inputs["rings"][name], *kind)
           for name, kind in inputs["ring_kinds"].items()}
    if faults:
        # a ring that places block t at ``my``; an out direction without
        # its pair transpose
        saved = ring._block_source, ring._pair_transpose
        ring._block_source = lambda my, t, p: my
        out["fault_block"] = triplet_ring(axis, inputs["rings"]["attention"],
                                          True, False)
        ring._block_source = saved[0]
        ring._pair_transpose = lambda x, axis: x
        out["fault_transpose"] = triplet_ring(
            axis, inputs["rings"]["attention"], True, False)
        ring._pair_transpose = saved[1]
    return out


def models(axis, inputs):
    """The pair-sharded distance models' logits rows, deterministic."""
    from tgt_torch.models import make_model
    from tgt_torch.parallel import pair_scope

    out = {}
    for name, case in inputs["models"].items():
        model = make_model("distance", case["cfg"], device="cpu")
        model.load_state_dict(case["weights"])
        with torch.no_grad(), pair_scope(axis):
            out[name] = model({k: t(v) for k, v in case["batch"].items()})
    return out


def steps(case, rank, world, witness=None):
    """``Trainer.train_step`` on this data index's rows of each global
    batch: per step the loss, ``ok``, lr and the weights after it."""
    from tgt_torch.schemes import get_scheme
    from tgt_torch.training import Trainer

    scheme = get_scheme(case["scheme"])(case["cfg"])
    trainer = Trainer(scheme, rank=rank, world_size=world, device="cpu")
    assert trainer.grad_accum == case["cfg"].get("grad_accum_steps", 1)
    state = trainer.init_state()
    state["model"].load_state_dict(case["weights"])
    per = case["steps"][0]["sample_mask"].shape[0] // trainer.num_data
    part = slice(trainer.data_index * per, (trainer.data_index + 1) * per)
    out = []
    with witness() if witness else _nothing():
        for i, batch in enumerate(case["steps"]):
            db = trainer.to_device(trainer.pad_device_batch(
                {k: v[part] for k, v in batch.items()}))
            state, m = trainer.train_step(state, db, i, seed=i)
            out.append({"loss": float(m["loss"]), "ok": bool(m["ok"]),
                        "lr": m["lr"], "weights": {
                            k: v.clone() for k, v in
                            state["model"].state_dict().items()}})
    return out


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class gap_on_every_rank:
    """The witness: each pair rank adds the gap term, while the count
    stays pair index 0's."""

    def __enter__(self):
        from tgt_torch.parallel import current_pair_axis
        from tgt_torch.schemes.base import TGTScheme

        self.saved = TGTScheme.own_samples, TGTScheme.loss_counts

        def counts(scheme, batch):
            axis = current_pair_axis()
            mine = axis is None or axis.index == 0
            return {"pair_count": scheme.pair_rows(
                        scheme.edge_mask_of(batch)).sum(),
                    "sample_count": batch["sample_mask"].float().sum() * mine}

        TGTScheme.own_samples = staticmethod(lambda b: b["sample_mask"])
        TGTScheme.loss_counts = counts

    def __exit__(self, *exc):
        from tgt_torch.schemes.base import TGTScheme
        TGTScheme.own_samples = staticmethod(self.saved[0])
        TGTScheme.loss_counts = self.saved[1]
        return False


def stochastic(case, rank, world):
    """Two steps with every dropout and drop-path on: the loss history,
    and the node state of a stochastic forward after them."""
    from tgt_torch.parallel import pair_scope
    from tgt_torch.schemes import get_scheme
    from tgt_torch.training import Trainer

    scheme = get_scheme(case["scheme"])(case["cfg"])
    trainer = Trainer(scheme, rank=rank, world_size=world, device="cpu")
    state = trainer.init_state()
    losses = []
    for i, batch in enumerate(case["steps"]):
        db = trainer.to_device(batch)
        state, m = trainer.train_step(state, db, i, seed=i)
        losses.append(float(m["loss"]))
    feed = dict(trainer.to_device(case["steps"][0]))
    feed["edge_mask"] = scheme.edge_mask_of(feed)
    feed["dist_input"] = torch.ones_like(feed["edge_mask"])
    with torch.no_grad(), pair_scope(trainer.pair):
        g = state["model"]._encode(feed, deterministic=False, seed=11)
    return {"losses": losses, "h": g.h}


def main(rank, world, port, workdir):
    from tgt_torch.parallel import initialize_distributed, pair_groups

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    assert initialize_distributed(f"localhost:{port}", world, rank,
                                  device="cpu", timeout=TIMEOUT) == (rank,
                                                                     world)
    _, _, axis = pair_groups(world, world)
    out = {"collectives": collectives(axis, inputs["collectives"][world]),
           "rings": rings(axis, inputs, faults=world == 2)}
    if world == 2:
        out["models"] = models(axis, inputs)
        out["stochastic"] = stochastic(inputs["stochastic"], rank, world)
        out["witness_gap"] = steps(inputs["trainer"]["pretrain"], rank,
                                   world, gap_on_every_rank)
        out["accum"] = steps(inputs["accum"], rank, world)
    out["trainer"] = {name: steps(case, rank, world)
                      for name, case in inputs["trainer"].items()}
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*map(int, sys.argv[1:4]), sys.argv[4])
