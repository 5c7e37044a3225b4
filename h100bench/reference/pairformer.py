"""Plain float32 Pairformer trunk of AlphaFold 3 with its distogram head and
training step: the reference that decides whether the port's Pairformer
training is correct.

Written from the publication (Abramson et al., Nature 630:493, 2024,
doi:10.1038/s41586-024-07487-w, Supplementary Algorithms 1-3, 11-15, 17
and 24), in plain ``torch`` operations, with no kernel, cache or batching
of the program under test; it imports nothing of the program. Parameters
are a ``{name: tensor}`` dict whose names are the program's
``state_dict`` keys, so that one set of weights made by the benchmark
loads into both. Every block runs under ``torch.utils.checkpoint``, so that
48 blocks at 384 tokens fit on the card; a block makes its generator
inside the checkpoint, so that the replay draws the same masks.

Departures from the publication, each also the program's:
- the input embedder is cut down to a one-hot of the residue type for the
  single representation, and the outer sum of two projections of it plus
  the relative position of Algorithm 3 (residue offset clipped at
  +-``max_relative_offset`` and one bin for another chain; no token,
  entity or bond features) for the pair; no MSA or template module, no
  recycling, no diffusion module or confidence heads;
- the distogram's 64 bins take 63 evenly spaced edges from 2 to 22 A, a
  distance's bin the count of edges below it;
- the triangle multiplications mask a and b by the pair mask, and the
  attentions add -1e9 to the logits of keys past the structure's tokens,
  as the open implementations do for padding;
- layer norms use eps 1e-5, and every projection that the publication
  writes as Linear or LinearNoBias is bias-free except the single
  attention's query (Algorithm 24, line 3).

Dropout is reproduced, not approximated: a forward seed gives a table of
per-block seeds (a host generator, as the program's ``seed_table``), each
block draws its four masks from a generator on the device seeded with its
entry, in the order of Algorithm 17 and with the shapes of the program's
batch: row-wise (b, 1, n, c_z) after the two triangle multiplications and
the starting-node attention, column-wise (b, n, 1, c_z) after the
ending-node attention.

``cast`` is applied to both operands of every matrix product; the
identity gives float32, ``h100bench.reference.model.fp8_cast`` the
control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MASK_VALUE = -1e9
LN_EPS = 1e-5

Params = Dict[str, torch.Tensor]
Cast = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class no_tf32:
    """float32 matrix products in full float32 (TF32 off) inside the
    block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def derive_seed(*words: int) -> int:
    """A seed in [0, 2**62) mixed from ``words`` by numpy's SeedSequence."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(2))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every parameter in the program's state_dict
    order; init ("uniform", bound) or ("const", value)."""
    cs, cz, ct = cfg["single_width"], cfg["pair_width"], cfg["tri_mul_width"]
    ha, da = cfg["tri_att_heads"], cfg["tri_att_head_width"]
    hs, ds = cfg["single_heads"], cfg["single_head_width"]
    mult = cfg["transition_multiplier"]
    specs: List[tuple] = []

    def lin(name, fan_in, fan_out, bias=False):
        specs.append((f"{name}.weight", (fan_out, fan_in),
                      ("uniform", fan_in ** -0.5)))
        if bias:
            specs.append((f"{name}.bias", (fan_out,),
                          ("uniform", fan_in ** -0.5)))

    def ln(name, width):
        specs.append((f"{name}.weight", (width,), ("const", 1.0)))
        specs.append((f"{name}.bias", (width,), ("const", 0.0)))

    lin("embed_s", cfg["num_residue_types"], cs)
    lin("embed_zi", cs, cz)
    lin("embed_zj", cs, cz)
    lin("embed_rel", 2 * cfg["max_relative_offset"] + 2, cz)
    for i in range(cfg["num_blocks"]):
        p = f"blocks.{i}"
        for m in ("tri_mul_out", "tri_mul_in"):
            ln(f"{p}.{m}.ln_in", cz)
            lin(f"{p}.{m}.lin_ab", cz, 4 * ct)
            lin(f"{p}.{m}.lin_g", cz, cz)
            ln(f"{p}.{m}.ln_out", ct)
            lin(f"{p}.{m}.lin_out", ct, cz)
        for m in ("tri_att_start", "tri_att_end"):
            ln(f"{p}.{m}.ln", cz)
            lin(f"{p}.{m}.lin_QKV", cz, 3 * ha * da)
            lin(f"{p}.{m}.lin_B", cz, ha)
            lin(f"{p}.{m}.lin_G", cz, ha * da)
            lin(f"{p}.{m}.lin_O", ha * da, cz)
        ln(f"{p}.pair_transition.ffn_ln", cz)
        lin(f"{p}.pair_transition.lin_W1", cz, 2 * mult * cz)
        lin(f"{p}.pair_transition.lin_W2", mult * cz, cz)
        a = f"{p}.single_att"
        ln(f"{a}.ln_s", cs)
        lin(f"{a}.lin_Q", cs, hs * ds, bias=True)
        lin(f"{a}.lin_KV", cs, 2 * hs * ds)
        ln(f"{a}.ln_z", cz)
        lin(f"{a}.lin_B", cz, hs)
        lin(f"{a}.lin_G", cs, hs * ds)
        lin(f"{a}.lin_O", hs * ds, cs)
        ln(f"{p}.single_transition.ffn_ln", cs)
        lin(f"{p}.single_transition.lin_W1", cs, 2 * mult * cs)
        lin(f"{p}.single_transition.lin_W2", mult * cs, cs)
    lin("distogram", cz, cfg["num_dist_bins"])
    return specs


def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every parameter drawn from ``seed`` on ``device`` in float32: one
    uniform draw over all leaves, Linear U(+-1/sqrt(fan_in)), LayerNorm ones
    and zeros."""
    specs = param_specs(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0,
                                                          generator=gen)
    out = {}
    for (name, shape, init), piece in zip(specs, flat.split(sizes)):
        if init[0] == "uniform":
            out[name] = (piece * init[1]).view(shape)
        else:
            out[name] = torch.full(shape, float(init[1]), device=device)
    return out


WEIGHTS = 11          # the stream of a run seed that draws the weights


def run_weights(cfg: dict, run_seed: int, device) -> Params:
    """The weights of a benchmark run, drawn from its seed."""
    return make_weights(cfg, derive_seed(run_seed, WEIGHTS), device)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def linear(p: Params, name: str, x, cast: Cast):
    y = cast(x) @ cast(p[f"{name}.weight"]).t()
    bias = p.get(f"{name}.bias")
    return y if bias is None else y + bias


def layernorm(p: Params, name: str, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def swiglu_transition(p, pre, x, cast):
    """Algorithm 11: LayerNorm, a and b, swish(a) * b, back."""
    a, b = linear(p, f"{pre}.lin_W1", layernorm(p, f"{pre}.ffn_ln", x),
                  cast).chunk(2, dim=-1)
    return linear(p, f"{pre}.lin_W2", F.silu(a) * b, cast)


def triangle_multiplication(p, pre, z, pair_mask, outgoing: bool, cast):
    """Algorithms 12 (outgoing: sum_k a_ik b_jk) and 13 (incoming:
    sum_k a_ki b_kj)."""
    x = layernorm(p, f"{pre}.ln_in", z)
    ag, a, bg, b = linear(p, f"{pre}.lin_ab", x, cast).chunk(4, dim=-1)
    a = torch.sigmoid(ag) * a * pair_mask
    b = torch.sigmoid(bg) * b * pair_mask
    if outgoing:
        t = torch.einsum("bikc,bjkc->bijc", cast(a), cast(b))
    else:
        t = torch.einsum("bkic,bkjc->bijc", cast(a), cast(b))
    g = torch.sigmoid(linear(p, f"{pre}.lin_g", x, cast))
    return g * linear(p, f"{pre}.lin_out", layernorm(p, f"{pre}.ln_out", t),
                      cast)


def triangle_attention(p, pre, z, key_mask, starting: bool, cfg, cast):
    """Algorithms 14 (starting node: a_ijk = softmax_k(q_ij.k_ik + b_jk),
    values v_ik) and 15 (ending node: softmax_k(q_ij.k_kj + b_ki), values
    v_kj), with the gate g_ij on the output. Channels split as (d, h)."""
    b, n, _, _ = z.shape
    h, d = cfg["tri_att_heads"], cfg["tri_att_head_width"]
    x = layernorm(p, f"{pre}.ln", z)
    q, k, v = (t.reshape(b, n, n, d, h)
               for t in linear(p, f"{pre}.lin_QKV", x, cast).chunk(3, dim=-1))
    bias = linear(p, f"{pre}.lin_B", x, cast)                  # (b, ., ., h)
    mask = key_mask[:, None, None, :, None]                    # over k
    if starting:
        logits = (torch.einsum("bijdh,bikdh->bijkh", cast(q), cast(k))
                  * d ** -0.5 + bias[:, None] + mask)
        a = torch.softmax(logits, dim=3)
        o = torch.einsum("bijkh,bikdh->bijdh", cast(a), cast(v))
    else:
        logits = (torch.einsum("bijdh,bkjdh->bijkh", cast(q), cast(k))
                  * d ** -0.5 + bias.transpose(1, 2)[:, :, None] + mask)
        a = torch.softmax(logits, dim=3)
        o = torch.einsum("bijkh,bkjdh->bijdh", cast(a), cast(v))
    g = torch.sigmoid(linear(p, f"{pre}.lin_G", x, cast)).reshape(b, n, n, d, h)
    return linear(p, f"{pre}.lin_O", (o * g).reshape(b, n, n, d * h), cast)


def attention_pair_bias(p, pre, s, z, key_mask, cfg, cast):
    """Algorithm 24 without conditioning: heads split the channels as (h,
    c); the logits take a bias projected from the normalised pair; a
    sigmoid gate on the output."""
    b, n, _ = s.shape
    h, c = cfg["single_heads"], cfg["single_head_width"]
    a = layernorm(p, f"{pre}.ln_s", s)
    q = linear(p, f"{pre}.lin_Q", a, cast).reshape(b, n, h, c)
    k, v = (t.reshape(b, n, h, c)
            for t in linear(p, f"{pre}.lin_KV", a, cast).chunk(2, dim=-1))
    bias = linear(p, f"{pre}.lin_B", layernorm(p, f"{pre}.ln_z", z), cast)
    logits = (torch.einsum("bihc,bjhc->bhij", cast(q), cast(k)) / math.sqrt(c)
              + bias.permute(0, 3, 1, 2) + key_mask[:, None, None, :])
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhij,bjhc->bihc", cast(w), cast(v)).reshape(b, n, h * c)
    g = torch.sigmoid(linear(p, f"{pre}.lin_G", a, cast))
    return linear(p, f"{pre}.lin_O", o * g, cast)


def _drop(x, rate, shape, gen):
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def block(p, i, s, z, pair_mask, key_mask, seed: Optional[int], cfg,
          cast: Cast):
    """Algorithm 17, one block; masks from a generator seeded with
    ``seed`` (None: dropout off)."""
    pre = f"blocks.{i}"
    gen = None
    if seed is not None:
        gen = torch.Generator(device=z.device)
        gen.manual_seed(int(seed))
    b, n, _, cz = z.shape
    rate = cfg["pair_dropout"]
    rows, cols = (b, 1, n, cz), (b, n, 1, cz)
    z = z + _drop(triangle_multiplication(p, f"{pre}.tri_mul_out", z,
                                          pair_mask, True, cast),
                  rate, rows, gen)
    z = z + _drop(triangle_multiplication(p, f"{pre}.tri_mul_in", z,
                                          pair_mask, False, cast),
                  rate, rows, gen)
    z = z + _drop(triangle_attention(p, f"{pre}.tri_att_start", z, key_mask,
                                     True, cfg, cast), rate, rows, gen)
    z = z + _drop(triangle_attention(p, f"{pre}.tri_att_end", z, key_mask,
                                     False, cfg, cast), rate, cols, gen)
    z = z + swiglu_transition(p, f"{pre}.pair_transition", z, cast)
    s = s + attention_pair_bias(p, f"{pre}.single_att", s, z, key_mask, cfg,
                                cast)
    s = s + swiglu_transition(p, f"{pre}.single_transition", s, cast)
    return s, z


def seed_table(seed: int, count: int) -> List[int]:
    """The per-block seeds of one forward seed, drawn in block order from a
    host generator."""
    return torch.randint(0, 2 ** 62, (count,),
                         generator=torch.Generator().manual_seed(int(seed))
                         ).tolist()


def embed(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], cast: Cast):
    """s (b, n, c_s), z (b, n, n, c_z), the pair mask (b, n, n, 1) and the
    additive key mask (b, n)."""
    r_max = cfg["max_relative_offset"]
    onehot = F.one_hot(batch["restype"].long().clamp(
        0, cfg["num_residue_types"] - 1), cfg["num_residue_types"]).float()
    s = linear(p, "embed_s", onehot, cast)
    res = batch["residue_index"].long()
    chain = batch["asym_id"].long()
    d = torch.clamp(res[:, :, None] - res[:, None, :] + r_max, 0, 2 * r_max)
    d = torch.where(chain[:, :, None] == chain[:, None, :], d,
                    torch.full_like(d, 2 * r_max + 1))
    rel = F.one_hot(d, 2 * r_max + 2).float()
    z = (linear(p, "embed_zi", s, cast)[:, :, None]
         + linear(p, "embed_zj", s, cast)[:, None]
         + linear(p, "embed_rel", rel, cast))
    nm = batch["node_mask"].float()
    pair_mask = (nm[:, :, None] * nm[:, None, :])[..., None]
    return s, z, pair_mask, (1.0 - nm) * MASK_VALUE


def trunk(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], *,
          seed: Optional[int] = None, cast: Cast = identity):
    """The single (b, n, c_s) and pair (b, n, n, c_z) representations after
    the last block, in float32; ``seed`` the forward seed (None: dropout
    off)."""
    s, z, pair_mask, key_mask = embed(p, cfg, batch, cast)
    seeds = ([None] * cfg["num_blocks"] if seed is None
             else seed_table(seed, cfg["num_blocks"]))
    for i, block_seed in enumerate(seeds):
        if torch.is_grad_enabled():
            s, z = checkpoint(block, p, i, s, z, pair_mask, key_mask,
                              block_seed, cfg, cast, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            s, z = block(p, i, s, z, pair_mask, key_mask, block_seed, cfg,
                         cast)
    return s, z


def forward(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], *,
            seed: Optional[int] = None, cast: Cast = identity) -> torch.Tensor:
    """Distogram logits (b, n, n, bins) in float32; ``seed`` the forward
    seed (None: dropout off)."""
    _, z = trunk(p, cfg, batch, seed=seed, cast=cast)
    return linear(p, "distogram", z + z.transpose(1, 2), cast)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def distogram_bins(dist: torch.Tensor, cfg: dict) -> torch.Tensor:
    edges = torch.linspace(cfg["dist_min"], cfg["dist_max"],
                           cfg["num_dist_bins"] - 1, device=dist.device)
    return (dist[..., None] > edges).sum(-1)


def loss_of(p: Params, cfg: dict, batch: Dict[str, torch.Tensor],
            step_seed: int, cast: Cast = identity) -> torch.Tensor:
    """The mean over the valid pairs of the cross-entropy of the binned
    distances of the representative atoms; dropout from draw 1 of the step
    seed."""
    logits = forward(p, cfg, batch, seed=derive_seed(step_seed, 1), cast=cast)
    x = batch["coords"].float()
    dist = torch.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    targ = distogram_bins(dist, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    xent = -torch.gather(logp, -1, targ[..., None])[..., 0]
    nm = batch["node_mask"].float()
    m = nm[:, :, None] * nm[:, None, :]
    return (xent * m).sum() / (m.sum() + 1e-9)


def learning_rate(cfg: dict, step: int) -> float:
    """Linear warm-up to ``max_lr`` over ``lr_warmup_steps``, then
    constant, in float32."""
    f = np.float32
    return float(f(cfg["max_lr"]) * min(f(step) / f(max(
        cfg["lr_warmup_steps"], 1)), f(1)))


def clip_by_global_norm(grads: Params, clip: Optional[float]) -> Params:
    """Every leaf scaled by min(1, clip / (the norm over all leaves +
    1e-12)); None leaves the gradient as it is."""
    if clip is None:
        return grads
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(clip / (norm + 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def adam_step(p, grads, state, lr: float, cfg: dict) -> None:
    """One Adam update of ``p`` in place: bias-corrected moments, eps
    outside the square root."""
    b1, b2, eps = cfg["adam_beta1"], cfg["adam_beta2"], cfg["adam_eps"]
    state["count"] += 1
    t = state["count"]
    for k in p:
        g = grads[k]
        state["mu"][k] = b1 * state["mu"][k] + (1 - b1) * g
        state["nu"][k] = b2 * state["nu"][k] + (1 - b2) * g * g
        mu_hat = state["mu"][k] / (1 - b1 ** t)
        nu_hat = state["nu"][k] / (1 - b2 ** t)
        p[k] -= lr * mu_hat / (torch.sqrt(nu_hat) + eps)


def train_steps(weights: Params, cfg: dict,
                batches: List[Dict[str, torch.Tensor]], run_seed: int,
                cast: Cast = identity) -> dict:
    """Steps 0, 1, ... on ``batches`` from ``weights`` (left unchanged),
    step t under the seed ``derive_seed(run_seed, t)``, each gradient
    clipped by its global norm at ``clip_grad_norm`` before Adam takes it.
    Returns each step's loss, each leaf's norm of the first gradient as
    Adam takes it, and each leaf's norm of the change after the last
    step."""
    p = {k: v.detach().clone().float() for k, v in weights.items()}
    state = {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
             "nu": {k: torch.zeros_like(v) for k, v in p.items()},
             "count": 0}
    losses, first_grad = [], None
    for step, batch in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_of(leaves, cfg, batch, derive_seed(run_seed, step), cast)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g.detach())
                 for (k, v), g in zip(leaves.items(), grads)}
        grads = clip_by_global_norm(grads, cfg.get("clip_grad_norm"))
        p = {k: v.detach() for k, v in leaves.items()}
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            adam_step(p, grads, state, learning_rate(cfg, step), cfg)
        del grads, loss
    change = {k: float((p[k] - weights[k].float()).norm()) for k in p}
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change}
