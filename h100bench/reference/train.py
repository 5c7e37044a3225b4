"""Plain version of the training step: the masked bin cross-entropy of one
stochastic forward, its gradient by autograd in float32, and Adam (L2 weight
decay folded into the gradient, bias-corrected moments, eps outside the
square root) at the warmup-cosine learning rate of the published recipe.

Seeds follow the published protocol as the trainer mixes them: a step's
seed is ``derive_seed(run seed, step)``; within it, draw 0 of the step seed
fixes the coordinate noise and draw 1 the model's dropout.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from h100bench.reference import data, model


derive_seed = model.derive_seed


def warmup_cosine(cfg: dict, step: int) -> float:
    """The learning rate of optimizer step ``step``, in float32: linear
    warmup from ``min_lr`` to ``max_lr``, then a cosine down to
    ``min_lr``."""
    f = np.float32
    lo, hi = cfg["min_lr"], cfg["max_lr"]
    warm, total = cfg["lr_warmup_steps"], cfg["lr_total_steps"]
    s = f(step)
    if s <= warm:
        return float(f(lo) + f(hi - lo) * s / f(max(warm, 1)))
    p = np.clip((s - f(warm)) / f(max(total - warm, 1)), f(0), f(1))
    return float(f(lo) + f(hi - lo) * f(0.5) * (f(1) + np.cos(f(math.pi) * p)))


def loss_of(p, cfg: dict, batch: Dict[str, torch.Tensor], step_seed: int,
            cast=model.identity) -> torch.Tensor:
    """Masked mean over the valid pairs of the cross-entropy of the binned
    target distances."""
    b = batch["node_features"].shape[0]
    feed = dict(batch)
    feed["edge_mask"] = (batch["node_mask"] * batch["sample_mask"][:, None])
    feed["edge_mask"] = feed["edge_mask"][:, :, None] * feed["edge_mask"][:, None]
    feed["dist_input"] = data.coords2dist(batch["rdkit_coords"])
    logits = model.forward(p, cfg, feed, seeds=[derive_seed(step_seed, 1)],
                           draw_of=[0] * b, rows=list(range(b)),
                           program_batch=b, cast=cast, remat=True)
    targ = data.distance_bins(data.coords2dist(batch["dft_coords"]),
                              cfg["num_dist_bins"], cfg["range_dist_bins"])
    logp = torch.log_softmax(logits, dim=-1)
    xent = -torch.gather(logp, -1, targ[..., None])[..., 0]
    m = feed["edge_mask"]
    return (xent * m).sum() / (m.sum() + 1e-9)


def adam_step(p, grads, state, lr: float, cfg: dict) -> None:
    """One Adam update of ``p`` in place."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    wd = cfg.get("weight_decay", 0.0) or 0.0
    state["count"] += 1
    t = state["count"]
    for k in p:
        g = grads[k] + wd * p[k] if wd else grads[k]
        state["mu"][k] = b1 * state["mu"][k] + (1 - b1) * g
        state["nu"][k] = b2 * state["nu"][k] + (1 - b2) * g * g
        mu_hat = state["mu"][k] / (1 - b1 ** t)
        nu_hat = state["nu"][k] / (1 - b2 ** t)
        p[k] -= lr * mu_hat / (torch.sqrt(nu_hat) + eps)


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                batches: List[Dict[str, torch.Tensor]], run_seed: int,
                first_step: int = 0, cast=model.identity) -> dict:
    """Steps ``first_step``, ... on ``batches`` from ``weights`` (left
    unchanged). Returns each step's loss, each leaf's norm of the first
    gradient, and each leaf's norm of the change after the last step."""
    p = {k: v.detach().clone().float() for k, v in weights.items()}
    state = {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
             "nu": {k: torch.zeros_like(v) for k, v in p.items()},
             "count": 0}
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        step = first_step + i
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_of(leaves, cfg, batch, derive_seed(run_seed, step), cast)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g.detach())
                 for (k, v), g in zip(leaves.items(), grads)}
        p = {k: v.detach() for k, v in leaves.items()}
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            adam_step(p, grads, state, warmup_cosine(cfg, step), cfg)
        del grads, loss
    change = {k: float((p[k] - weights[k].float()).norm()) for k in p}
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change}
