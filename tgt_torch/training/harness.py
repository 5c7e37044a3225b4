"""Training harness on one device (counterpart of
tgt_tpu/training/harness.py).

Ported: ``make_optimizer`` (adam with L2 weight decay folded into the
gradients, adamw, sgd; value and norm clipping), ``resolve_grad_accum``, and
a ``Trainer`` with ``init_state``, the accumulation padding of the device
batch, ``train_step`` (micro-batch accumulation weighted by ``sample_mask``
and the NaN-step guard) and ``train_epoch`` (delayed metric drain, NaN
streak, step budget). The data mesh, the compile cache, checkpoints,
validation, ``fit`` and the plateau controller come with ROADMAP.md items
1k and 1m.

Where tgt_tpu jits one pure step, the port runs eagerly and updates the
parameters and the optimizer moments in place. The guard is still decided
on the device: a non-finite loss selects the old values with
``torch.where``, so the step never waits for the host.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tgt_torch.core.device import resolve_device

Tensors = Dict[str, torch.Tensor]


def derive_seed(*words: int) -> int:
    """A seed in [0, 2**62) mixed from ``words`` (the port's
    ``jax.random.fold_in``): the same words give the same seed."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(2))


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
    """Epoch and step loop around a scheme's task functions, on one device:
    the card unless the caller passes ``device="cpu"``."""

    def __init__(self, scheme, device=None):
        self.device = resolve_device(device)
        self.scheme = scheme
        self.cfg = scheme.cfg
        self.schedule = scheme.make_lr_schedule()
        self.opt_init, self.opt_update = make_optimizer(self.cfg)
        self.epoch = 0
        self.global_step = 0
        self.grad_accum = resolve_grad_accum(self.cfg, 1)

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
    def accumulated_grad(self, model, batch: Tensors, seed: int):
        """(loss, aux, grads): the batch splits into ``grad_accum``
        micro-batches run in turn, each under its own seed; their losses
        and gradients average weighted by their real samples
        (``sample_mask``), and an all-padding micro-batch weighs 0."""
        params = [p for p in model.parameters()]

        def grad_of(mb, s):
            loss, aux = self.scheme.loss_fn(model, mb, s)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return loss, aux, [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, params)]

        accum = self.grad_accum
        if accum <= 1:
            return grad_of(batch, seed)
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
            loss, aux, grads = grad_of(mb, derive_seed(seed, m))
            w = mb["sample_mask"].float().sum()
            ok = w > 0          # an all-padding micro-batch: drop its terms
            wz = torch.where(ok, w, 0.0)
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            flat = wz * torch.where(ok, flat, 0.0)
            grad_sum = flat if grad_sum is None else grad_sum + flat
            loss_sum = loss_sum + wz * torch.where(ok, loss.float(), 0.0)
            for k, x in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + wz * torch.where(
                    ok, x.float(), 0.0)
            w_sum = w_sum + wz
        inv = 1.0 / torch.clamp(w_sum, min=1.0)
        grads = [g.view_as(p) for g, p in zip(
            (grad_sum * inv).split([p.numel() for p in params]), params)]
        return (loss_sum * inv, {k: v * inv for k, v in aux_sum.items()},
                grads)

    def train_step(self, state: Dict[str, Any], batch: Tensors, step: int,
                   seed: int):
        """One optimizer step on a device batch; updates ``state`` in place
        and returns ``(state, metrics)``. A non-finite loss leaves the
        parameters and the optimizer state as they were."""
        model = state["model"]
        loss, aux, grads = self.accumulated_grad(model, batch, seed)
        lr = self.schedule(step)
        named = dict(model.named_parameters())
        with torch.no_grad():
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
        for batch in loader:
            n = self.scheme.batch_num_samples(batch)
            device_batch = self.to_device(
                self.pad_device_batch(self.scheme.device_batch(batch)))
            state, metrics = self.train_step(
                state, device_batch, self.global_step,
                derive_seed(seed0, self.global_step))
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
