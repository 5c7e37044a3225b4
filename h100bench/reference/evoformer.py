"""Plain float32 Evoformer of AlphaFold 2, with its extra-MSA stack, its
input embedder, its distogram and masked-MSA losses and its training step:
the reference that decides whether the port's Evoformer training is
correct.

Written from the publication (Jumper et al., Nature 596:583, 2021,
doi:10.1038/s41586-021-03819-2, Supplementary Algorithms 3, 4, 6-15, 18
and 19, sections 1.9.8 and 1.9.9), in plain ``torch`` operations, with no
kernel, fused attention or batching of the program under test; it imports
nothing of the program. Every attention writes its logits out and takes an
explicit softmax. Parameters are a ``{name: tensor}`` dict whose names are
the program's ``state_dict`` keys, so that one set of weights made by the
benchmark loads into both. The triangle updates are those of the
Pairformer's reference (``reference/pairformer.py``), whose projections
take a bias wherever the weights hold one: AlphaFold 2's Algorithms 11-14
are AlphaFold 3's with biases on the triangle multiplication's
projections and the triangle attention's gate and output. Every block runs
under ``torch.utils.checkpoint``, so that 4 + 48 blocks at 256 residues,
128 clusters and 1,024 extra sequences fit on the card; a block makes its
generator inside the checkpoint, so that the replay draws the same masks.

Departures from the publication, each also the program's:
- one pass, no recycling, no template stack, no structure module: the
  loss is the distogram's and the masked MSA's alone;
- the input features (``target_feat``, ``msa_feat``, ``extra_msa_feat``)
  and the masked MSA arrive made, in the program's layout;
- the outer product mean divides after its output projection, bias
  included, as AlphaFold's code and OpenFold do (Algorithm 10 writes the
  mean before it);
- the masks: keys of a padded sequence row or residue get -1e9 in the
  column attentions; the row attention's keys take -1e9 past the
  structure's residues (the program masks them by residue alone, which
  agrees on every real row); global column attention's query is the mean
  over the real rows (OpenFold's, + 1e-10); the outer product mean and the
  triangle multiplications mask their projections;
- the distogram's 64 bins take 63 evenly spaced edges from 2.3125 to
  21.6875 A of the representative atoms' distances, a distance's bin the
  count of edges below it;
- layer norms use eps 1e-5.

Dropout is reproduced, not approximated: a forward seed gives a table of
per-block seeds (the extra-MSA blocks' first), each block draws its five
masks from a generator on the device seeded with its entry, in the order of
Algorithm 6: the MSA row attention's (b, 1, r, c), one for every sequence,
then the pair's, row-wise (b, 1, r, c_z) after both triangle
multiplications and the starting-node attention, column-wise (b, r, 1,
c_z) after the ending-node attention.

``cast`` is applied to both operands of every matrix product; the
identity gives float32, ``h100bench.reference.model.fp8_cast`` the
control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench.reference.pairformer import (MASK_VALUE, Cast, Params,
                                            adam_step, clip_by_global_norm,
                                            derive_seed, distogram_bins,
                                            identity, layernorm,
                                            learning_rate, linear, no_tf32,
                                            seed_table, triangle_attention,
                                            triangle_multiplication)

__all__ = ["derive_seed", "identity", "no_tf32", "run_weights", "trunk",
           "forward", "loss_of", "train_steps"]

OPM_EPS = 1e-3
GLOBAL_EPS = 1e-10
# AlphaFold 2's feature and class widths (Supplementary Table 1, 1.9.9)
TARGET_FEAT, MSA_FEAT, EXTRA_MSA_FEAT, MSA_CLASSES = 22, 49, 25, 23
# the first training stage's loss weights (Supplementary section 1.9)
DISTOGRAM_WEIGHT, MASKED_MSA_WEIGHT = 0.3, 2.0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every parameter in the program's state_dict
    order; init ("uniform", bound) or ("const", value)."""
    cz, ct = cfg["pair_width"], cfg["tri_mul_width"]
    ha, da = cfg["tri_att_heads"], cfg["tri_att_head_width"]
    mult, co = cfg["transition_multiplier"], cfg["opm_width"]
    specs: List[tuple] = []

    def lin(name, fan_in, fan_out, bias=True):
        specs.append((f"{name}.weight", (fan_out, fan_in),
                      ("uniform", fan_in ** -0.5)))
        if bias:
            specs.append((f"{name}.bias", (fan_out,),
                          ("uniform", fan_in ** -0.5)))

    def ln(name, width):
        specs.append((f"{name}.weight", (width,), ("const", 1.0)))
        specs.append((f"{name}.bias", (width,), ("const", 0.0)))

    def gated(pre, cm, h, c):
        lin(f"{pre}.lin_QKV", cm, 3 * h * c, bias=False)
        lin(f"{pre}.lin_G", cm, h * c)
        lin(f"{pre}.lin_O", h * c, cm)
        ln(f"{pre}.ln_m", cm)

    def block(p, extra):
        if extra:
            cm, h, c = (cfg["extra_msa_width"], cfg["extra_msa_heads"],
                        cfg["extra_msa_head_width"])
        else:
            cm, h, c = (cfg["msa_width"], cfg["msa_heads"],
                        cfg["msa_head_width"])
        gated(f"{p}.msa_row", cm, h, c)
        ln(f"{p}.msa_row.ln_z", cz)
        lin(f"{p}.msa_row.lin_B", cz, h, bias=False)
        if extra:
            g = f"{p}.msa_col"
            ln(f"{g}.ln_m", cm)
            lin(f"{g}.lin_Q", cm, h * c, bias=False)
            lin(f"{g}.lin_KV", cm, 2 * c, bias=False)
            lin(f"{g}.lin_G", cm, h * c)
            lin(f"{g}.lin_O", h * c, cm)
        else:
            gated(f"{p}.msa_col", cm, h, c)
        ln(f"{p}.msa_transition.ffn_ln", cm)
        lin(f"{p}.msa_transition.lin_W1", cm, mult * cm)
        lin(f"{p}.msa_transition.lin_W2", mult * cm, cm)
        ln(f"{p}.opm.ln", cm)
        lin(f"{p}.opm.lin_ab", cm, 2 * co)
        lin(f"{p}.opm.lin_out", co * co, cz)
        for m in ("tri_mul_out", "tri_mul_in"):
            ln(f"{p}.{m}.ln_in", cz)
            lin(f"{p}.{m}.lin_ab", cz, 4 * ct)
            lin(f"{p}.{m}.lin_g", cz, cz)
            ln(f"{p}.{m}.ln_out", ct)
            lin(f"{p}.{m}.lin_out", ct, cz)
        for m in ("tri_att_start", "tri_att_end"):
            ln(f"{p}.{m}.ln", cz)
            lin(f"{p}.{m}.lin_QKV", cz, 3 * ha * da, bias=False)
            lin(f"{p}.{m}.lin_B", cz, ha, bias=False)
            lin(f"{p}.{m}.lin_G", cz, ha * da)
            lin(f"{p}.{m}.lin_O", ha * da, cz)
        ln(f"{p}.pair_transition.ffn_ln", cz)
        lin(f"{p}.pair_transition.lin_W1", cz, mult * cz)
        lin(f"{p}.pair_transition.lin_W2", mult * cz, cz)

    tf, cm = TARGET_FEAT, cfg["msa_width"]
    lin("embed_tf_zi", tf, cz)
    lin("embed_tf_zj", tf, cz)
    lin("embed_tf_m", tf, cm)
    lin("embed_msa", MSA_FEAT, cm)
    lin("embed_relpos", 2 * cfg["max_relative_offset"] + 1, cz)
    lin("embed_extra", EXTRA_MSA_FEAT, cfg["extra_msa_width"])
    for i in range(cfg["num_extra_blocks"]):
        block(f"extra_blocks.{i}", True)
    for i in range(cfg["num_blocks"]):
        block(f"blocks.{i}", False)
    lin("distogram", cz, cfg["num_dist_bins"])
    lin("masked_msa", cm, MSA_CLASSES)
    return specs


def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every parameter drawn from ``seed`` on ``device`` in float32: one
    uniform draw over all leaves, Linear U(+-1/sqrt(fan_in)) for weights
    and biases, LayerNorm ones and zeros."""
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

def _heads(p, pre, x, h, c, cast):
    """q, k, v (..., h, c) of Algorithms 7 and 8."""
    q, k, v = linear(p, f"{pre}.lin_QKV", x, cast).chunk(3, dim=-1)
    return (t.reshape(*t.shape[:-1], h, c) for t in (q, k, v))


def _gated_out(p, pre, x, o, cast):
    g = torch.sigmoid(linear(p, f"{pre}.lin_G", x, cast))
    return linear(p, f"{pre}.lin_O", g * o.flatten(-2), cast)


def msa_row_attention(p, pre, m, z, msa_mask, h, c, cast):
    """Algorithm 7: ``softmax_j(q_si.k_sj / sqrt(c) + b_ij)`` along each
    sequence, the pair bias ``b_ij = LinearNoBias(LN(z_ij))``, keys of
    padding masked, the gate on the output."""
    x = layernorm(p, f"{pre}.ln_m", m)
    q, k, v = _heads(p, pre, x, h, c, cast)
    bias = linear(p, f"{pre}.lin_B", layernorm(p, f"{pre}.ln_z", z), cast)
    logits = (torch.einsum("bsihc,bsjhc->bshij", cast(q), cast(k))
              / math.sqrt(c) + bias.permute(0, 3, 1, 2)[:, None]
              + ((1.0 - msa_mask) * MASK_VALUE)[:, :, None, None, :])
    a = torch.softmax(logits, dim=-1)
    o = torch.einsum("bshij,bsjhc->bsihc", cast(a), cast(v))
    return _gated_out(p, pre, x, o, cast)


def msa_column_attention(p, pre, m, msa_mask, h, c, cast):
    """Algorithm 8: ``softmax_t(q_si.k_ti / sqrt(c))`` along each column,
    keys of padding masked, the gate on the output."""
    x = layernorm(p, f"{pre}.ln_m", m)
    q, k, v = _heads(p, pre, x, h, c, cast)
    logits = (torch.einsum("bsihc,btihc->bihst", cast(q), cast(k))
              / math.sqrt(c)
              + ((1.0 - msa_mask) * MASK_VALUE).transpose(1, 2)[:, :, None,
                                                                None, :])
    a = torch.softmax(logits, dim=-1)
    o = torch.einsum("bihst,btihc->bsihc", cast(a), cast(v))
    return _gated_out(p, pre, x, o, cast)


def msa_global_column_attention(p, pre, m, msa_mask, h, c, cast):
    """Algorithm 19: per column, the query of each head is the mean over
    the real sequences of ``q_si = LinearNoBias(m_si)``; one key and one
    value ``k_ti``, ``v_ti`` for all heads; a gate per sequence."""
    x = layernorm(p, f"{pre}.ln_m", m)
    mask = msa_mask[..., None]
    q_s = linear(p, f"{pre}.lin_Q", x, cast)
    q = ((q_s * mask).sum(1) / (mask.sum(1) + GLOBAL_EPS))
    q = q.reshape(*q.shape[:-1], h, c)                         # (b, i, h, c)
    k, v = linear(p, f"{pre}.lin_KV", x, cast).chunk(2, dim=-1)
    logits = (torch.einsum("bihc,btic->biht", cast(q), cast(k))
              / math.sqrt(c)
              + ((1.0 - msa_mask) * MASK_VALUE).transpose(1, 2)[:, :, None])
    a = torch.softmax(logits, dim=-1)
    o = torch.einsum("biht,btic->bihc", cast(a), cast(v))      # per column
    g = torch.sigmoid(linear(p, f"{pre}.lin_G", x, cast))
    g = g.reshape(*g.shape[:-1], h, c)                      # (b, s, i, h, c)
    return linear(p, f"{pre}.lin_O", (g * o[:, None]).flatten(-2), cast)


def transition(p, pre, x, cast):
    """Algorithms 9 and 15: LN, Linear to 4x, ReLU, Linear."""
    y = linear(p, f"{pre}.lin_W1", layernorm(p, f"{pre}.ffn_ln", x), cast)
    return linear(p, f"{pre}.lin_W2", torch.relu(y), cast)


def outer_product_mean(p, pre, m, msa_mask, cast):
    """Algorithm 10: ``o_ij = flatten(sum_s a_si (x) b_sj)``, its output
    projection, then the division by ``1e-3 + sum_s mask_si mask_sj``."""
    x = layernorm(p, f"{pre}.ln", m)
    mask = msa_mask[..., None]
    a, b = (t * mask for t in linear(p, f"{pre}.lin_ab", x, cast).chunk(2, -1))
    o = torch.einsum("bsic,bsje->bijce", cast(a), cast(b)).flatten(-2)
    norm = torch.einsum("bsi,bsj->bij", msa_mask, msa_mask)[..., None]
    return linear(p, f"{pre}.lin_out", o, cast) / (OPM_EPS + norm)


def _drop(x, rate, shape, gen):
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def block(p, pre, extra: bool, m, z, msa_mask, pair_mask, key_mask,
          seed: Optional[int], cfg, cast: Cast):
    """Algorithm 6 (Algorithm 18's block with ``extra``); masks from a
    generator seeded with ``seed`` (None: dropout off)."""
    gen = None
    if seed is not None:
        gen = torch.Generator(device=z.device)
        gen.manual_seed(int(seed))
    b, s, r, cm = m.shape
    cz = z.shape[-1]
    if extra:
        h, c = cfg["extra_msa_heads"], cfg["extra_msa_head_width"]
    else:
        h, c = cfg["msa_heads"], cfg["msa_head_width"]
    rate = cfg["pair_dropout"]
    rows, cols = (b, 1, r, cz), (b, r, 1, cz)
    m = m + _drop(msa_row_attention(p, f"{pre}.msa_row", m, z, msa_mask, h,
                                    c, cast),
                  cfg["msa_dropout"], (b, 1, r, cm), gen)
    col = msa_global_column_attention if extra else msa_column_attention
    m = m + col(p, f"{pre}.msa_col", m, msa_mask, h, c, cast)
    m = m + transition(p, f"{pre}.msa_transition", m, cast)
    z = z + outer_product_mean(p, f"{pre}.opm", m, msa_mask, cast)
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
    z = z + transition(p, f"{pre}.pair_transition", z, cast)
    return m, z


def embed(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], cast: Cast):
    """Algorithms 3 and 4, and the extra MSA's projection: m (b, s, r,
    c_m), e (b, S, r, c_e), z (b, r, r, c_z), the pair mask (b, r, r, 1)
    and the additive key mask (b, r)."""
    r_max = cfg["max_relative_offset"]
    tf = batch["target_feat"].float()
    res = batch["residue_index"].long()
    d = torch.clamp(res[:, :, None] - res[:, None, :], -r_max, r_max) + r_max
    rel = F.one_hot(d, 2 * r_max + 1).float()
    z = (linear(p, "embed_tf_zi", tf, cast)[:, :, None]
         + linear(p, "embed_tf_zj", tf, cast)[:, None]
         + linear(p, "embed_relpos", rel, cast))
    m = (linear(p, "embed_msa", batch["msa_feat"].float(), cast)
         + linear(p, "embed_tf_m", tf, cast)[:, None])
    e = linear(p, "embed_extra", batch["extra_msa_feat"].float(), cast)
    nm = batch["node_mask"].float()
    pair_mask = (nm[:, :, None] * nm[:, None, :])[..., None]
    return m, e, z, pair_mask, (1.0 - nm) * MASK_VALUE


def _stack(p, cfg, prefix, extra, m, z, msa_mask, pair_mask, key_mask,
           seeds, cast):
    for i, block_seed in enumerate(seeds):
        args = (p, f"{prefix}.{i}", extra, m, z, msa_mask, pair_mask,
                key_mask, block_seed, cfg, cast)
        if torch.is_grad_enabled():
            m, z = checkpoint(block, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            m, z = block(*args)
    return m, z


def trunk(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], *,
          seed: Optional[int] = None, cast: Cast = identity):
    """The MSA (b, s, r, c_m) and pair (b, r, r, c_z) representations
    after the last block, in float32; ``seed`` the forward seed (None:
    dropout off)."""
    m, e, z, pair_mask, key_mask = embed(p, cfg, batch, cast)
    extra, main = cfg["num_extra_blocks"], cfg["num_blocks"]
    seeds = ([None] * (extra + main) if seed is None
             else seed_table(seed, extra + main))
    _, z = _stack(p, cfg, "extra_blocks", True, e, z,
                  batch["extra_msa_mask"].float(), pair_mask, key_mask,
                  seeds[:extra], cast)
    return _stack(p, cfg, "blocks", False, m, z, batch["msa_mask"].float(),
                  pair_mask, key_mask, seeds[extra:], cast)


def forward(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], *,
            seed: Optional[int] = None, cast: Cast = identity):
    """Distogram logits ``Linear(z_ij) + Linear(z_ji)`` (b, r, r, bins)
    and masked-MSA logits (b, s, r, classes), in float32."""
    m, z = trunk(p, cfg, batch, seed=seed, cast=cast)
    d = linear(p, "distogram", z, cast)
    return d + d.transpose(1, 2), linear(p, "masked_msa", m, cast)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def losses(p: Params, cfg: dict, batch: Dict[str, torch.Tensor],
           seed: Optional[int], cast: Cast = identity):
    """The distogram's mean cross-entropy over the valid pairs and the
    masked MSA's over the replaced positions of the real rows, of one
    forward under ``seed``."""
    dist_logits, msa_logits = forward(p, cfg, batch, seed=seed, cast=cast)
    x = batch["coords"].float()
    dist = torch.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    targ = distogram_bins(dist, cfg)
    xent = -torch.gather(torch.log_softmax(dist_logits, dim=-1), -1,
                         targ[..., None])[..., 0]
    nm = batch["node_mask"].float()
    pairs = nm[:, :, None] * nm[:, None, :]
    distogram = (xent * pairs).sum() / (pairs.sum() + 1e-9)
    msa_xent = -torch.gather(torch.log_softmax(msa_logits, dim=-1), -1,
                             batch["true_msa"].long()[..., None])[..., 0]
    bert = batch["bert_mask"].float() * batch["msa_mask"].float()
    masked_msa = (msa_xent * bert).sum() / (bert.sum() + 1e-8)
    return distogram, masked_msa


def loss_of(p: Params, cfg: dict, batch: Dict[str, torch.Tensor],
            step_seed: int, cast: Cast = identity) -> torch.Tensor:
    """``DISTOGRAM_WEIGHT`` x the distogram's loss + ``MASKED_MSA_WEIGHT``
    x the masked MSA's (sections 1.9.8, 1.9.9); dropout from draw 1 of the
    step seed."""
    distogram, masked_msa = losses(p, cfg, batch, derive_seed(step_seed, 1),
                                   cast)
    return DISTOGRAM_WEIGHT * distogram + MASKED_MSA_WEIGHT * masked_msa


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
    out_losses, first_grad = [], None
    for step, batch in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_of(leaves, cfg, batch, derive_seed(run_seed, step), cast)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g.detach())
                 for (k, v), g in zip(leaves.items(), grads)}
        grads = clip_by_global_norm(grads, cfg.get("clip_grad_norm"))
        p = {k: v.detach() for k, v in leaves.items()}
        out_losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            adam_step(p, grads, state, learning_rate(cfg, step), cfg)
        del grads, loss
    change = {k: float((p[k] - weights[k].float()).norm()) for k in p}
    return {"losses": out_losses, "grad_norms": first_grad,
            "change_norms": change}
