"""Training harness: one process per device, one or many ranks
(counterpart of tgt_tpu/training/harness.py).

Ported: ``make_optimizer`` (adam with L2 weight decay folded into the
gradients, adamw, sgd; value and norm clipping), ``resolve_grad_accum``,
``eval_condition``, and a ``Trainer`` with ``init_state`` and
``load_or_init`` (resume, or non-strict pretrained weights), the
accumulation padding of the device batch, ``train_step`` (micro-batch
accumulation weighted by ``sample_mask``, the plateau ``lr_scale``, the
NaN-step guard), ``train_epoch`` (delayed metric drain, NaN streak, step
budget), ``eval_epoch`` and ``fit`` (validation, best-model monitor,
plateau stop, NaN rollback to the last checkpoint, checkpoints in
tgt_tpu's format, history.yaml). The XLA compile cache and ``precompile``
have no counterpart in an eager port.

Where tgt_tpu jits one pure step, the port runs eagerly and updates the
parameters and the optimizer moments in place. The guard is still decided
on the device: a non-finite loss selects the old values with
``torch.where``, so the step never waits for the host. Every random draw
of a step or an eval batch comes from a seed that is a pure function of
(``random_seed``, step or batch index, rank), so a resumed run repeats an
uninterrupted one.

Data parallelism (tgt_tpu's data axis): each rank trains on its own rows,
and a step equals one process's step on the global batch, the ranks'
batches concatenated, as tgt_tpu's GSPMD step does. Before each
micro-batch's forward the counts that the loss's masked means divide by
(valid pairs, real samples) are summed over the ranks, so each rank's loss
is its share of the global mean; one sum all-reduce per step of one flat
f32 buffer (gradients, loss, aux) then gives the global gradient exactly.
``torch.autograd.grad`` does not drive ``DistributedDataParallel``'s
hooks, hence no DDP wrapper. With accumulation, micro-batch m is the union
of every rank's m-th chunk (tgt_tpu cuts the global rows into contiguous
chunks instead; ROADMAP.md section 3). The weights after ``load_or_init``
are rank 0's, evaluation gathers every rank's predictions before a metric
is computed, and rank 0 alone writes.

The pair axis (tgt_tpu's ``num_pair_devices = P``): the world is the
row-major grid of ``D x P`` ranks (``parallel/mesh.py``); the ``P`` ranks
of a data index load the same samples (the samplers split over the ``D``
data indices), share their step seeds, and each holds its own i-rows of
the edge channel (``pair_scope``: ``parallel/pair_layer.py``). A
micro-batch's pair count sums the rows of every rank, and its per-sample
terms count on pair index 0 alone; a bucket that ``P`` does not divide
runs on whole rows on every rank, and only pair index 0 counts it. Each
rank's gradient holds its own rows' share, so the one sum all-reduce over
the world gives the global gradient, as at ``P = 1``. Evaluation gathers
the pair rows, then the data indices' shards (pair index 0's). tgt_tpu
refuses its Pallas kernels under a pair mesh, and the port raises where
it does.

Spans (``tgt_torch.utils.tracing``, recorded while torch's profiler runs;
``step`` is the global step they belong to): in ``train_epoch``
``train.input_wait`` (the next batch from the loader), ``train.batch_prep``
(``device_batch``, ``pad_device_batch``, ``to_device``; ``rows``,
``rows_real``, ``bucket``) and ``train.drain`` (the delayed metric read);
in ``train_step`` ``train.step`` with ``train.grad`` (the forwards and
backwards) and ``train.update`` (the optimizer, the NaN guard's selects
and copies, the state rebuild).
"""
from __future__ import annotations

import ast
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import yaml

from tgt_torch.core.device import resolve_device
from tgt_torch.models.convert import (jax_params_from_state_dict,
                                      opt_state_from_jax, opt_state_to_jax,
                                      state_dict_from_jax_params)
from tgt_torch.parallel.mesh import (gather_predictions, pair_groups,
                                     pair_scope)
from tgt_torch.parallel.pair_layer import check_pair_config
from tgt_torch.training.checkpoint import (CheckpointManager, flatten_tree,
                                           load_pretrained)
from tgt_torch.training.progress import progbar
from tgt_torch.training.schedules import PlateauController
from tgt_torch.utils import tracing

Tensors = Dict[str, torch.Tensor]


def derive_seed(*words: int) -> int:
    """A seed in [0, 2**62) mixed from ``words`` (the port's
    ``jax.random.fold_in``): the same words give the same seed."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(2))


class StopTraining(Exception):
    pass


_END = object()     # the end of a loader


_COND_OPS = {
    "Eq": lambda a, b: a == b, "NotEq": lambda a, b: a != b,
    "Lt": lambda a, b: a < b, "LtE": lambda a, b: a <= b,
    "Gt": lambda a, b: a > b, "GtE": lambda a, b: a >= b,
    "Add": lambda a, b: a + b, "Sub": lambda a, b: a - b,
    "Mult": lambda a, b: a * b, "Div": lambda a, b: a / b,
    "FloorDiv": lambda a, b: a // b, "Mod": lambda a, b: a % b,
}


def eval_condition(expr: Optional[str], context: Dict[str, Any]) -> bool:
    """Evaluate a config condition such as ``"epoch > 10 and epoch % 5 ==
    0"`` against log values. The reference eval()s these with full
    builtins (training.py:648-649); here a small AST interpreter allows
    boolean, comparison and arithmetic operators, names bound to the
    context and literal constants, and nothing else (no calls, attributes
    or subscripts), so a typo fails loud and a hostile string does
    nothing."""
    if not expr:
        return True

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.BoolOp):
            vals = (ev(v) for v in node.values)
            return (all(map(bool, vals)) if isinstance(node.op, ast.And)
                    else any(map(bool, vals)))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return not ev(node.operand)
            if isinstance(node.op, ast.USub):
                return -ev(node.operand)
            raise ValueError(f"operator not allowed in condition: "
                             f"{type(node.op).__name__}")
        if isinstance(node, ast.Compare):
            left = ev(node.left)
            for op, rhs in zip(node.ops, node.comparators):
                right = ev(rhs)
                fn = _COND_OPS.get(type(op).__name__)
                if fn is None:
                    raise ValueError(f"comparison not allowed in condition: "
                                     f"{type(op).__name__}")
                if not fn(left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.BinOp):
            fn = _COND_OPS.get(type(node.op).__name__)
            if fn is None:
                raise ValueError(f"operator not allowed in condition: "
                                 f"{type(node.op).__name__}")
            return fn(ev(node.left), ev(node.right))
        if isinstance(node, ast.Name):
            if node.id not in context:
                raise NameError(f"unknown name in condition: {node.id!r}")
            return context[node.id]
        if isinstance(node, ast.Constant):
            return node.value
        raise ValueError(
            f"syntax not allowed in condition: {type(node).__name__}")

    return bool(ev(ast.parse(expr, mode="eval")))


def model_summary(params: Dict[str, Any], path: Optional[str] = None) -> str:
    """Parameter counts per top-level group of a params tree, as tgt_tpu
    writes model_summary.txt (reference training.py:267-282)."""
    lines = []
    total = 0
    for key, sub in params.items():
        n = sum(int(np.size(v)) for v in flatten_tree(sub).values())
        total += n
        lines.append(f"{key:30s} {n/1e6:10.3f}M")
    lines.append(f"{'TOTAL':30s} {total/1e6:10.3f}M")
    text = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(text + "\n")
    return text


def make_optimizer(cfg) -> Tuple[Callable, Callable]:
    """Optimizer by ``cfg.optimizer`` name; returns ``(init_fn, update_fn)``
    over dicts of tensors keyed by parameter name.

    ``update_fn(grads, opt_state, params, lr) -> (updates, new_opt_state)``
    returns new tensors and leaves its arguments alone. The state is
    tgt_tpu's: ``{"mu", "nu", "count"}`` (sgd: ``{"mu", "count"}``), f32
    moments over the f32 parameters and an int32 step count on the device.
    'adam' folds weight decay into the gradients as L2 (torch.optim.Adam's
    rule), 'adamw' decouples it, 'sgd' takes ``cfg.sgd_momentum``."""
    name = (getattr(cfg, "optimizer", "adam") or "adam").lower()
    b1 = getattr(cfg, "adam_beta1", 0.9)
    b2 = getattr(cfg, "adam_beta2", 0.999)
    eps = getattr(cfg, "adam_eps", 1e-8)
    wd = getattr(cfg, "weight_decay", 0.0)
    momentum = getattr(cfg, "sgd_momentum", 0.0)
    clip_value = getattr(cfg, "clip_grad_value", None)
    clip_norm = getattr(cfg, "clip_grad_norm", None)
    if name not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {name!r} "
                         "(supported: adam, adamw, sgd)")

    def init_fn(params: Tensors) -> Dict[str, Any]:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        count = torch.zeros((), dtype=torch.int32,
                            device=next(iter(params.values())).device)
        if name == "sgd":
            return {"mu": zeros, "count": count}
        return {"mu": zeros,
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": count}

    def clip_and_decay(g: List[torch.Tensor], p: List[torch.Tensor]):
        if clip_value is not None:
            g = torch._foreach_clamp_max(
                torch._foreach_clamp_min(g, -clip_value), clip_value)
        if clip_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(x)) for x in g))
            scale = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
            g = torch._foreach_mul(g, scale)
        if wd and name != "adamw":    # adamw decouples wd from the moments
            g = torch._foreach_add(g, torch._foreach_mul(p, wd))
        return g

    def update_fn(grads: Tensors, opt_state: Dict[str, Any], params: Tensors,
                  lr: float) -> Tuple[Tensors, Dict[str, Any]]:
        keys = list(params)
        p = [params[k] for k in keys]
        g = clip_and_decay([grads[k] for k in keys], p)
        m = [opt_state["mu"][k] for k in keys]
        count = opt_state["count"] + 1
        if name == "sgd":
            mu = torch._foreach_add(torch._foreach_mul(m, momentum), g)
            updates = torch._foreach_mul(mu, -lr)
            return (dict(zip(keys, updates)),
                    {"mu": dict(zip(keys, mu)), "count": count})
        v = [opt_state["nu"][k] for k in keys]
        cf = count.float()
        mu = torch._foreach_add(torch._foreach_mul(m, b1),
                                torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(torch._foreach_mul(v, b2),
                                torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, cf))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, cf))
        updates = torch._foreach_div(
            torch._foreach_mul(torch._foreach_mul(mu, mu_hat_scale), -lr),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_mul(nu, nu_hat_scale)), eps))
        if name == "adamw" and wd:
            updates = torch._foreach_sub(updates,
                                         torch._foreach_mul(p, lr * wd))
        return (dict(zip(keys, updates)),
                {"mu": dict(zip(keys, mu)), "nu": dict(zip(keys, nu)),
                 "count": count})

    return init_fn, update_fn


def resolve_grad_accum(cfg, world_size: int) -> int:
    """Micro-batch accumulation factor: the explicit ``grad_accum_steps``,
    or ``global_batch_size / (batch_size * world_size)`` when that is set,
    so that the published global batch runs on any topology. The optimizer
    batch of one process is ``batch_size * accum``; ``batch_size`` stays
    the micro-batch that must fit in memory."""
    explicit = max(1, int(getattr(cfg, "grad_accum_steps", 1) or 1))
    gbs = getattr(cfg, "global_batch_size", None)
    if not gbs:
        return explicit
    gbs = int(gbs)
    per_pass = int(cfg.batch_size) * max(1, world_size)
    if gbs % per_pass != 0:
        raise ValueError(
            f"global_batch_size={gbs} is not a multiple of "
            f"batch_size*world_size = {cfg.batch_size}*{world_size} "
            f"= {per_pass}")
    derived = max(1, gbs // per_pass)
    if explicit != 1 and explicit != derived:
        raise ValueError(
            f"grad_accum_steps={explicit} contradicts "
            f"global_batch_size={gbs} (which derives accum={derived} at "
            f"batch_size={cfg.batch_size}, world_size={world_size}); "
            f"set only one")
    return derived


class Trainer:
    """Epoch and step loop around a scheme's task functions, on one device
    (the card unless the caller passes ``device="cpu"``) of rank ``rank``
    of ``world_size``. A world size above 1 needs the process group
    (``tgt_torch.parallel.initialize_distributed``); whenever a group
    exists, of any size, the step's collectives run through it."""

    def __init__(self, scheme, rank: int = 0, world_size: int = 1,
                 device=None):
        self.scheme = scheme
        self.cfg = scheme.cfg
        self.num_pair = int(self.cfg.num_pair_devices or 1)
        if self.num_pair < 1 or world_size % self.num_pair:
            raise ValueError(
                f"num_pair_devices={self.num_pair} does not divide the "
                f"world size {world_size}")
        use_pallas = self.cfg.use_pallas
        # tgt_tpu/training/harness.py:241-265: Mosaic kernels cannot be
        # partitioned by GSPMD; only the dense pair has a data-axis wrapper
        if use_pallas == "dense" and self.num_pair > 1:
            raise ValueError(
                "use_pallas='dense' does not compose with num_pair_devices "
                "> 1 (the shard_map wrapper covers the data axis only) - "
                "use the plain triplet path (use_pallas: false) for "
                "pair-sharded configs")
        if use_pallas is True and (world_size > 1 or self.num_pair > 1):
            raise ValueError(
                "use_pallas=True (legacy fused kernel) does not compose "
                "with several ranks (only use_pallas='dense' ships the "
                "shard_map data-parallel wrapper) - switch to use_pallas: "
                "dense, or the plain triplet path")
        if self.num_pair > 1:
            check_pair_config(scheme.model_cfg)
        self.group = dist.is_initialized()
        group = ((dist.get_rank(), dist.get_world_size()) if self.group
                 else (0, 1))
        if (rank, world_size) != group:
            raise ValueError(
                f"rank {rank} of {world_size} is not this process's (rank, "
                f"world size) {group}: a world size above 1 needs the "
                "process group (tgt_torch.parallel.initialize_distributed)")
        self.rank = rank
        self.world_size = world_size
        self.is_main = rank == 0
        self.num_data = world_size // self.num_pair
        # this rank's place on the (data, pair) grid, and its pair groups
        self.data_index, self.pair_index = divmod(rank, self.num_pair)
        self.pair = (pair_groups(world_size, self.num_pair)[2]
                     if self.num_pair > 1 else None)
        self.device = resolve_device(device)
        self.model_path = self.cfg.save_path
        self.log_path = os.path.join(self.model_path, "logs")
        self.ckpt = CheckpointManager(
            self.model_path, save_backups=self.cfg.save_all_checkpoints)
        self.schedule = scheme.make_lr_schedule()
        self.opt_init, self.opt_update = make_optimizer(self.cfg)
        # ReduceLR-on-plateau (reference training_mixins.py:170-255), on
        # when rlr_factor is set
        self.plateau = None
        if self.cfg.rlr_factor:
            self.plateau = PlateauController(
                factor=self.cfg.rlr_factor, patience=self.cfg.rlr_patience,
                stopping_lr=self.cfg.stopping_lr)
        # host counters (reference state dict, training.py:246-248)
        self.epoch = 0
        self.global_step = 0
        self.recovery_tries = 0
        self.monitor_best = float("inf")
        self.monitor_best_epoch = -1
        self.grad_accum = resolve_grad_accum(self.cfg, self.num_data)

    def log(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)

    # -- state and batches ------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """``{"model": nn.Module, "opt_state": ...}`` with weights drawn
        from ``seed`` (default ``cfg.random_seed``)."""
        if seed is None:
            seed = getattr(self.cfg, "random_seed", 0) or 0
        model = self.scheme.init_model(seed, self.device)
        with torch.no_grad():
            opt_state = self.opt_init(
                {k: p.detach() for k, p in model.named_parameters()})
        return {"model": model, "opt_state": opt_state}

    # -- tgt_tpu's trees of the state -----------------------------------------
    def params_tree(self, model) -> Dict[str, Any]:
        return jax_params_from_state_dict(model.state_dict(),
                                          self.scheme.model_cfg, model)

    def load_params_tree(self, model, params: Dict[str, Any]) -> None:
        model.load_state_dict(state_dict_from_jax_params(
            params, self.scheme.model_cfg))

    def load_or_init(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """A fresh state, then the model dir's checkpoint over it (params,
        optimizer, counters, plateau state), or else the non-strict
        ``pretrained_weights_file`` (reference tgt_training.py:174-187)."""
        state = self.init_state(seed)
        model, cfg = state["model"], self.scheme.model_cfg
        if self.ckpt.has_checkpoint():
            params, opt_state, counters = self.ckpt.load(
                self.params_tree(model),
                opt_state_to_jax(state["opt_state"], cfg, model))
            self.load_params_tree(model, params)
            state["opt_state"] = opt_state_from_jax(
                opt_state, cfg, list(state["opt_state"]["mu"]), self.device)
            self.epoch = counters.get("epoch", 0)
            self.global_step = counters.get("global_step", 0)
            self.monitor_best = counters.get("monitor_best", float("inf"))
            self.monitor_best_epoch = counters.get("monitor_best_epoch", -1)
            self.recovery_tries = counters.get("recovery_tries", 0)
            if self.plateau is not None and "plateau" in counters:
                self.plateau.load_state_dict(counters["plateau"])
                self.scheme.lr_scale = self.plateau.scale
            self.log(f"Resumed from checkpoint @ epoch {self.epoch}, "
                     f"step {self.global_step}")
        elif self.cfg.pretrained_weights_file:
            params, missing, unexpected = load_pretrained(
                self.params_tree(model), self.cfg.pretrained_weights_file)
            self.load_params_tree(model, params)
            self.log(f"Loaded pretrained weights from "
                     f"{self.cfg.pretrained_weights_file}")
            self.log(f"missing keys: {missing[:8]}")
            self.log(f"unexpected keys: {unexpected[:8]}")
        if self.group:
            self.broadcast_weights(model)
        return state

    def broadcast_weights(self, model) -> None:
        """Rank 0's parameters and buffers on every rank, as
        ``DistributedDataParallel`` does at construction: one broadcast of
        one flat buffer per dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in list(model.parameters()) + list(model.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for tensors in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in tensors])
                dist.broadcast(flat, src=0)
                for t, v in zip(tensors, flat.split(
                        [t.numel() for t in tensors])):
                    t.copy_(v.view_as(t))

    def pad_device_batch(self, device_batch: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        """Zero-pad the batch axis up to a multiple of ``grad_accum``, so
        that an uneven final batch splits into equal micro-batches; padded
        rows carry sample_mask 0 and weigh nothing (the meshless branch of
        tgt_tpu's ``shard_device_batch``)."""
        lead = [np.shape(v)[0] for v in device_batch.values()
                if np.ndim(v) >= 1]
        b = max(lead) if lead else 0
        odd = {k: np.shape(v) for k, v in device_batch.items()
               if np.ndim(v) >= 1 and np.shape(v)[0] != b}
        if odd:
            raise ValueError(
                f"device batch entries with non-batch leading dims {odd} "
                f"(batch={b}): per-sample arrays must lead with the batch "
                "dim")
        target = -(-b // self.grad_accum) * self.grad_accum if b else 0
        if target == b:
            return device_batch
        return {k: (np.concatenate([v, np.zeros((target - b,) + v.shape[1:],
                                                v.dtype)])
                    if np.ndim(v) >= 1 else v)
                for k, v in ((k, np.asarray(v))
                             for k, v in device_batch.items())}

    def to_device(self, device_batch: Dict[str, np.ndarray]) -> Tensors:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in device_batch.items()}

    # -- the step -----------------------------------------------------------
    def batch_axis(self, batch: Tensors):
        """The pair axis a device batch runs on: None off the pair axis,
        and for a bucket that ``P`` does not divide (tgt_tpu replicates
        such a batch's pair tensors), which runs on whole rows."""
        n = batch["node_mask"].shape[1]
        return self.pair if self.pair is not None and \
            self.pair.shards(n) else None

    def counts_here(self, batch: Tensors) -> bool:
        """Whether this rank's terms of ``batch`` count: every rank's do,
        except on a bucket run on whole rows by a pair group, whose pair
        index 0 alone counts it."""
        return self.pair_index == 0 or self.batch_axis(batch) is not None

    def global_counts(self, batch: Tensors) -> Tensors:
        """The scheme's ``loss_counts`` of this micro-batch summed over the
        ranks: the denominators of the global batch's masked means. Call
        it inside the batch's ``pair_scope``."""
        counts = self.scheme.loss_counts(batch)
        summed = torch.stack([c.float() for c in counts.values()])
        if not self.counts_here(batch):
            summed = torch.zeros_like(summed)
        dist.all_reduce(summed)
        return dict(zip(counts, summed))

    def sum_over_ranks(self, flat: torch.Tensor, loss: torch.Tensor,
                       aux: Tensors):
        """One sum all-reduce of one flat f32 buffer: the gradient, the
        loss and the aux values."""
        keys = list(aux)
        buf = torch.cat([flat, loss.detach().float().reshape(1)]
                        + [aux[k].detach().float().reshape(1) for k in keys])
        dist.all_reduce(buf)
        n = flat.numel()
        return buf[:n], buf[n], {k: buf[n + 1 + i] for i, k in enumerate(keys)}

    def accumulated_grad(self, model, batch: Tensors, seed: int):
        """(loss, aux, grads): the batch splits into ``grad_accum``
        micro-batches run in turn, each under its own seed; their losses
        and gradients average weighted by their real samples
        (``sample_mask``), and an all-padding micro-batch weighs 0. Under a
        process group each micro-batch's loss divides by the counts of
        every rank's micro-batch, its weight is their real samples, and the
        ranks' sums are added up: the result is the global batch's on
        every rank."""
        with pair_scope(self.batch_axis(batch)):
            return self._accumulated_grad(model, batch, seed)

    def _accumulated_grad(self, model, batch: Tensors, seed: int):
        params = [p for p in model.parameters()]
        sizes = [p.numel() for p in params]
        here = self.counts_here(batch)

        def grad_of(mb, s):
            loss, aux = self.scheme.loss_fn(model, mb, s)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return loss, aux, [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, params)]

        def flat_of(grads):
            return torch.cat([g.reshape(-1).float() for g in grads])

        def unflat(flat):
            return [g.view_as(p) for g, p in zip(flat.split(sizes), params)]

        accum = self.grad_accum
        if accum <= 1:
            if not self.group:
                return grad_of(batch, seed)
            counts = self.global_counts(batch)
            loss, aux, grads = grad_of({**batch, **counts}, seed)
            # a rank whose rows are all padding adds nothing
            mine = (batch["sample_mask"].float().sum() > 0) & here
            flat, loss, aux = self.sum_over_ranks(
                torch.where(mine, flat_of(grads), 0.0),
                torch.where(mine, loss.float(), 0.0),
                {k: torch.where(mine, x.float(), 0.0) for k, x in aux.items()})
            return loss, aux, unflat(flat)
        batch_size = batch["node_features"].shape[0]
        if batch_size % accum != 0:
            raise ValueError(
                f"grad_accum_steps={accum} must divide the (padded) batch "
                f"size {batch_size}")
        if "sample_mask" not in batch:
            raise ValueError(
                "grad_accum_steps>1 needs 'sample_mask' in the device batch "
                "(the scheme's device_batch provides it)")
        micro = batch_size // accum
        splittable = {k for k, v in batch.items()
                      if v.dim() >= 1 and v.shape[0] == batch_size}
        loss_sum = torch.zeros((), device=self.device)
        w_sum = torch.zeros((), device=self.device)
        grad_sum = None
        aux_sum: Dict[str, torch.Tensor] = {}
        for m in range(accum):
            mb = {k: v[m * micro:(m + 1) * micro] if k in splittable else v
                  for k, v in batch.items()}
            mine = mb["sample_mask"].float().sum() * here
            w = mine
            if self.group:
                counts = self.global_counts(mb)
                mb = {**mb, **counts}
                w = counts["sample_count"]
            loss, aux, grads = grad_of(mb, derive_seed(seed, m))
            # an all-padding micro-batch (on every rank): drop its terms;
            # a rank whose part of it is all padding adds nothing
            ok, keep = w > 0, mine > 0
            wz = torch.where(ok, w, 0.0)
            flat = wz * torch.where(keep, flat_of(grads), 0.0)
            grad_sum = flat if grad_sum is None else grad_sum + flat
            loss_sum = loss_sum + wz * torch.where(keep, loss.float(), 0.0)
            for k, x in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + wz * torch.where(
                    keep, x.float(), 0.0)
            w_sum = w_sum + wz
        if self.group:
            grad_sum, loss_sum, aux_sum = self.sum_over_ranks(
                grad_sum, loss_sum, aux_sum)
        inv = 1.0 / torch.clamp(w_sum, min=1.0)
        return (loss_sum * inv, {k: v * inv for k, v in aux_sum.items()},
                unflat(grad_sum * inv))

    def train_step(self, state: Dict[str, Any], batch: Tensors, step: int,
                   seed: int, lr_scale: float = 1.0):
        """One optimizer step on a device batch at the schedule's rate
        times ``lr_scale`` (the plateau controller's); updates ``state`` in
        place and returns ``(state, metrics)``. A non-finite loss leaves
        the parameters and the optimizer state as they were."""
        with tracing.span("train.step") as span:
            if span is not None:
                span["step"] = step
            # the step's temporaries (gradients, updates, the replaced
            # optimizer state) are freed inside the span, as _step returns
            return self._step(state, batch, step, seed, lr_scale)

    def _step(self, state, batch, step, seed, lr_scale):
        model = state["model"]
        with tracing.span("train.grad"):
            loss, aux, grads = self.accumulated_grad(model, batch, seed)
        # f32, as tgt_tpu multiplies them inside its step
        lr = float(np.float32(self.schedule(step)) * np.float32(lr_scale))
        named = dict(model.named_parameters())
        with tracing.span("train.update"), torch.no_grad():
            params = {k: p.detach() for k, p in named.items()}
            updates, new_opt = self.opt_update(
                dict(zip(named, grads)), state["opt_state"], params, lr)
            ok = torch.isfinite(loss)
            for k, p in params.items():
                p.copy_(torch.where(ok, p + updates[k], p))
            old = state["opt_state"]
            state["opt_state"] = {
                key: ({k: torch.where(ok, v, old[key][k])
                       for k, v in val.items()} if isinstance(val, dict)
                      else torch.where(ok, val, old[key]))
                for key, val in new_opt.items()}
        metrics = {"loss": loss.detach(), "lr": lr, "ok": ok}
        metrics.update(aux)
        return state, metrics

    # -- the loop -----------------------------------------------------------
    def train_epoch(self, state: Dict[str, Any], loader):
        """Run one epoch. Returns ``(state, logs, stop_reason)``;
        stop_reason is None, 'nan' (more than 10 non-finite steps in a row)
        or 'budget' (``lr_total_steps`` exhausted). Each step's metrics are
        read back two steps later, so the host never waits on the step it
        has just queued."""
        total_loss = 0.0
        total_samples = 0.0
        nan_streak = 0
        last_lr = 0.0
        pending = []  # (metrics, n_samples)

        def drain(flush=False):
            nonlocal total_loss, total_samples, nan_streak, last_lr
            limit = 0 if flush else 2
            with tracing.span("train.drain") as span:
                if span is not None:
                    span["step"] = self.global_step
                while len(pending) > limit:
                    m, n = pending.pop(0)
                    loss = float(m["loss"])
                    last_lr = float(m["lr"])
                    if np.isfinite(loss):
                        nan_streak = 0
                        total_loss += loss * n
                        total_samples += n
                    else:
                        nan_streak += 1
                        # tolerate up to 10 consecutive NaN steps
                        # (reference tgt_training.py:159-168)
                        if nan_streak > 10:
                            return "nan"
            return None

        stop_reason = None
        seed0 = getattr(self.cfg, "random_seed", 0) or 0
        batches = iter(self.progress(loader, f"epoch {self.epoch + 1}"))
        while True:
            with tracing.span("train.input_wait") as span:
                if span is not None:
                    span["step"] = self.global_step
                batch = next(batches, _END)
            if batch is _END:
                break
            with tracing.span("train.batch_prep") as span:
                n = self.scheme.batch_num_samples(batch)
                device_batch = self.to_device(
                    self.pad_device_batch(self.scheme.device_batch(batch)))
                if span is not None:
                    span.update(step=self.global_step, rows_real=n,
                                rows=int(device_batch["sample_mask"].shape[0]),
                                bucket=int(device_batch["node_mask"].shape[1]))
            # each data index draws its own masks for its own rows; the
            # ranks of a pair group share them
            state, metrics = self.train_step(
                state, device_batch, self.global_step,
                derive_seed(seed0, self.global_step * self.num_data
                            + self.data_index), self.scheme.lr_scale)
            pending.append((metrics, n))
            stop_reason = drain()
            if stop_reason:
                break
            self.global_step += 1
            if self.global_step > self.cfg.lr_total_steps:
                stop_reason = drain(flush=True) or "budget"
                break
        if stop_reason is None:
            stop_reason = drain(flush=True)
        logs = {"loss": total_loss / max(total_samples, 1e-12), "lr": last_lr}
        return state, logs, stop_reason

    def eval_epoch(self, model, loader, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
        """The scheme's ``eval_fn`` over ``loader``, batch i under
        ``derive_seed(seed + 1000, i)`` (tgt_tpu: ``fold_in(seed + 1000,
        i)``), padded rows stripped; outputs concatenated per key."""
        collected: Dict[str, list] = {}
        for i, batch in enumerate(self.progress(loader, "eval")):
            device_batch = self.to_device(
                self.scheme.device_batch(batch, training=False))
            with pair_scope(self.batch_axis(device_batch)):
                out = self.scheme.eval_fn(model, device_batch,
                                          derive_seed(seed + 1000, i))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if "valid_samples" in out and np.all(out["valid_samples"] == 0):
                # reference: 'All predictions were NaN'
                # (dist_pred/scheme.py:158-159)
                print(f"WARNING: all MC draws non-finite in eval batch {i}",
                      flush=True)
            out = self.scheme.postprocess_eval(out, batch)
            for k, v in out.items():
                collected.setdefault(k, []).append(v)
        return {k: np.concatenate(v, axis=0) if np.ndim(v[0]) > 0
                else np.asarray(v) for k, v in collected.items()}

    def gather(self, preds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Every data index's predictions, joined in order on every rank
        (pair index 0's: its pair group holds the same ones)."""
        return gather_predictions(preds, self.world_size,
                                  contribute=self.pair_index == 0)

    def progress(self, loader, desc: str):
        """The loader, with a progress bar on rank 0."""
        return progbar(loader, desc=desc) if self.is_main else loader

    # -- the whole run ----------------------------------------------------------
    def fit(self, num_epochs: Optional[int] = None) -> Dict[str, Any]:
        """Train to ``num_epochs``; every rank returns the same history."""
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        state = self.load_or_init()
        if self.is_main:
            os.makedirs(self.log_path, exist_ok=True)
            self._quarantine_corrupted_history()
            self.save_config()
            model_summary(self.params_tree(state["model"]),
                          os.path.join(self.model_path, "model_summary.txt"))

        history = []
        while self.epoch < num_epochs:
            t0 = time.time()
            # finetune picks its bins sample by the epoch, a resumed one too
            self.scheme.current_epoch = self.epoch
            loader = self.scheme.train_loader(self.epoch, self.data_index,
                                              self.num_data)
            state, train_logs, stop_reason = self.train_epoch(state, loader)
            if stop_reason == "nan":
                if self.recovery_tries >= cfg.max_recovery_tries:
                    raise RuntimeError(
                        "NaN loss persisted past max_recovery_tries")
                self.recovery_tries += 1
                self.log(f"NaN epoch — rolling back to checkpoint "
                         f"(try {self.recovery_tries})")
                tries = self.recovery_tries
                state = self.load_or_init()
                self.recovery_tries = max(self.recovery_tries, tries)
                continue
            if stop_reason == "budget":
                self.checkpoint(state)
                break
            logs = {"epoch": self.epoch, "global_step": self.global_step,
                    "train_time": time.time() - t0, **train_logs}

            if (self.epoch + 1) % cfg.validation_frequency == 0 and \
                    eval_condition(cfg.validation_condition, logs):
                t0 = time.time()
                preds = self.eval_epoch(
                    state["model"],
                    self.scheme.val_loader(self.data_index, self.num_data),
                    seed=self.epoch)
                # the monitor and the plateau act on the whole split's
                # metric, the same on every rank
                preds = self.gather(preds)
                val_metrics = self.scheme.evaluate_predictions(preds)
                logs.update({f"val_{k}": float(v)
                             for k, v in val_metrics.items()})
                logs["val_time"] = time.time() - t0
                self.update_monitor(logs, state)
                if self.plateau is not None and "val_loss" in logs:
                    should_stop = self.plateau.update(
                        logs["val_loss"], train_logs.get("lr", 0.0))
                    self.scheme.lr_scale = self.plateau.scale
                    logs["lr_scale"] = self.plateau.scale
                    if should_stop:
                        self.log("STOP: lr fell below stopping_lr")
                        self.epoch += 1
                        self.checkpoint(state)
                        history.append(logs)
                        self.append_history(logs)
                        break

            self.epoch += 1
            self.checkpoint(state)
            history.append(logs)
            self.append_history(logs)
            msg = ", ".join(f"{k}={v:.5g}" if isinstance(v, float) else
                            f"{k}={v}" for k, v in logs.items())
            self.log(f"[epoch {self.epoch}] {msg}")
        if self.group:
            dist.barrier()      # rank 0's checkpoint is written
        return {"state": state, "history": history}

    # -- artifacts --------------------------------------------------------------
    def update_monitor(self, logs: Dict, state: Dict) -> None:
        monitor = self.cfg.monitor
        if monitor in logs:
            v = logs[monitor]
            if v < self.monitor_best:
                self.log(f"MONITOR BEST: {monitor} improved "
                         f"{self.monitor_best:0.5f} -> {v:0.5f}")
                self.monitor_best = v
                self.monitor_best_epoch = logs["epoch"]
                # conditional best-model saving (reference
                # training_mixins.py:60-103)
                if self.is_main and eval_condition(
                        self.cfg.save_model_condition, logs):
                    self.ckpt.save_best(self.params_tree(state["model"]))
            logs[f"best_{monitor}"] = self.monitor_best

    def checkpoint(self, state: Dict) -> None:
        if not self.is_main:
            return
        if self.cfg.trial_run:
            return  # trial runs skip checkpoint io (training.py:292-293)
        counters = {"epoch": self.epoch, "global_step": self.global_step,
                    "monitor_best": self.monitor_best,
                    "monitor_best_epoch": self.monitor_best_epoch,
                    "recovery_tries": self.recovery_tries}
        if self.plateau is not None:
            counters["plateau"] = self.plateau.state_dict()
        self.ckpt.save(self.params_tree(state["model"]),
                       opt_state_to_jax(state["opt_state"],
                                        self.scheme.model_cfg, state["model"]),
                       counters, epoch=self.epoch)

    def _quarantine_corrupted_history(self) -> None:
        """Rename an unparseable history.yaml to ``.corrupted`` and go on
        with a fresh one (reference training.py:570-582): a history cut
        by a killed run would stay a broken YAML document."""
        path = os.path.join(self.log_path, "history.yaml")
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                parsed = yaml.safe_load(f)
            if parsed is None or isinstance(parsed, list):
                return
        except yaml.YAMLError:
            pass
        corrupted = path + ".corrupted"
        os.replace(path, corrupted)
        print(f"WARNING: corrupted history file moved to {corrupted}")

    def append_history(self, logs: Dict) -> None:
        if not self.is_main:
            return
        path = os.path.join(self.log_path, "history.yaml")
        with open(path, "a") as f:
            yaml.safe_dump([{k: (float(v) if isinstance(v, (int, float,
                                                            np.floating))
                                 else v)
                             for k, v in logs.items()}], f)

    def save_config(self) -> None:
        os.makedirs(self.model_path, exist_ok=True)
        cfg_dict = {k: v for k, v in vars(self.cfg).items()
                    if isinstance(v, (str, int, float, bool, list, type(None)))}
        with open(os.path.join(self.model_path, "all_config.yaml"), "w") as f:
            yaml.safe_dump(cfg_dict, f)
