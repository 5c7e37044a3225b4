"""Plain float32 TGT distance predictor: the reference that decides whether
the port's outputs are correct.

Written from the published equations of TGT (arXiv:2402.04538) and the
layer semantics of the reference code (lib/tgt/layers/{layers,triplet}.py,
lib/models/pcqm/layers.py), in plain ``torch`` operations, with no kernel,
cache or batching of the program under test. It imports nothing of the
program: parameters are a plain ``{name: tensor}`` dict whose names are the
port's ``state_dict`` keys, so that one set of weights made by the
benchmark loads into both.

Dropout is reproduced, not approximated: each layer application draws its
masks from a ``torch.Generator`` seeded from a per-application seed table,
in the order the layer's equations use them, with the shapes of the whole
batch the program ran (``Draws``). A reference batch may hold a subset of
the program's rows, from several MC draws: row ``t`` is row ``rows[t]`` of
draw ``draw_of[t]``.

``cast`` is applied to both operands of every matrix product; the identity
gives float32, :func:`fp8_cast` the control (per-tensor scaled float8 e4m3).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MASK_VALUE = -1e9
NODE_OFFSET = 128          # per-feature offset of the node feature ids
NUM_NODE_FEATURES = 9
EDGE_OFFSET = 8
NUM_EDGE_FEATURES = 3
LN_EPS = 1e-5
REF_PI = 3.14159           # the published Gaussian basis uses this literal

Params = Dict[str, torch.Tensor]
Cast = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 ``dtype`` under a per-tensor scale that maps
    its largest magnitude to the format's largest value ``top``."""
    amax = x.abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """The float8 recipe of mixed-precision training: operands rounded to
    e4m3 in the forward, gradients to e5m2 in the backward, each under a
    per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """A matrix product's operand in float8 (see ``_Fp8``)."""
    return _Fp8.apply(x)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def triplet_gated(cfg: dict) -> bool:
    return cfg["triplet_type"] in ("attention", "aggregate")


def layer_updates(cfg: dict, i: int):
    """(node_update, edge_update) of layer i of the distance model, whose
    stack ends on the edge channel: the last layer updates edges only."""
    last = i == cfg["model_height"] - 1
    return (not last), True


def param_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every parameter, in the port's state_dict
    order. ``init`` is ("uniform", bound), ("normal", padding_row or None),
    ("const", value) or ("range", low, high)."""
    wh, we, heads = cfg["node_width"], cfg["edge_width"], cfg["num_heads"]
    th, kk = cfg["triplet_heads"], cfg.get("num_3d_kernels", 128)
    specs: List[tuple] = []

    def lin(name, fan_in, fan_out):
        bound = fan_in ** -0.5
        specs.append((f"{name}.weight", (fan_out, fan_in), ("uniform", bound)))
        specs.append((f"{name}.bias", (fan_out,), ("uniform", bound)))

    def ln(name, width):
        specs.append((f"{name}.weight", (width,), ("const", 1.0)))
        specs.append((f"{name}.bias", (width,), ("const", 0.0)))

    e = "input_embed"
    specs.append((f"{e}.nodef_embed.weight",
                  (NUM_NODE_FEATURES * NODE_OFFSET + 1, wh), ("normal", 0)))
    specs.append((f"{e}.dist_embed.weight", (cfg["upto_hop"] + 2, we),
                  ("normal", None)))
    specs.append((f"{e}.featm_embed.weight",
                  (NUM_EDGE_FEATURES * EDGE_OFFSET + 1, we), ("normal", 0)))
    g = f"{e}.m3d_embed"
    specs.append((f"{g}.gbf.means.weight", (1, kk), ("range", 0.0, 3.0)))
    specs.append((f"{g}.gbf.stds.weight", (1, kk), ("range", 0.0, 3.0)))
    specs.append((f"{g}.gbf.mul.weight", (2 * NODE_OFFSET + 1, 1),
                  ("const", 1.0)))
    specs.append((f"{g}.gbf.bias.weight", (2 * NODE_OFFSET + 1, 1),
                  ("const", 0.0)))
    lin(f"{g}.gbf_proj.layer1", kk, kk)
    lin(f"{g}.gbf_proj.layer2", kk, we)
    for i in range(cfg["model_height"]):
        p = f"encoder.TGT_layers.{i}"
        node_update, _ = layer_updates(cfg, i)
        ln(f"{p}.update.mha_ln_h", wh)
        ln(f"{p}.update.mha_ln_e", we)
        if node_update:
            lin(f"{p}.update.lin_QKV", wh, 3 * wh)
            lin(f"{p}.update.lin_EG", we, 2 * heads)
            lin(f"{p}.update.lin_O_h", wh, wh)
            lin(f"{p}.update.lin_O_e", heads, we)
            ln(f"{p}.node_ffn.ffn_ln", wh)
            inner = round(wh * cfg["node_ffn_multiplier"])
            lin(f"{p}.node_ffn.lin_W1", wh, inner)
            lin(f"{p}.node_ffn.lin_W2", inner, wh)
        else:
            lin(f"{p}.update.lin_QK", wh, 2 * wh)
            lin(f"{p}.update.lin_E", we, heads)
            lin(f"{p}.update.lin_O_e", heads, we)
        if th:
            t = f"{p}.tria"
            ln(f"{t}.tri_ln_e", we)
            gated = triplet_gated(cfg)
            if cfg["triplet_type"].startswith("attention"):
                bias = "lin_EG" if gated else "lin_E"
                bdim = 2 * th if gated else th
                lin(f"{t}.lin_QKV_in", we, 3 * we)
                lin(f"{t}.{bias}_in", we, bdim)
                lin(f"{t}.lin_QKV_out", we, 3 * we)
                lin(f"{t}.{bias}_out", we, bdim)
            else:
                lin(f"{t}.lin_V", we, 2 * we)
                if gated:
                    lin(f"{t}.lin_EG", we, 4 * th)
                else:
                    lin(f"{t}.lin_E", we, 2 * th)
            lin(f"{t}.lin_O", 2 * we, we)
        ln(f"{p}.edge_ffn.ffn_ln", we)
        inner = round(we * cfg["edge_ffn_multiplier"])
        lin(f"{p}.edge_ffn.lin_W1", we, inner)
        lin(f"{p}.edge_ffn.lin_W2", inner, we)
    ln("final_ln_edge", we)
    lin("dist_pred", we, cfg["num_dist_bins"])
    return specs


def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every parameter drawn from ``seed`` on ``device`` in float32 with the
    published initialisation (Linear U(+-1/sqrt(fan_in)), Embedding N(0, 1)
    with the padding row zeroed, LayerNorm ones and zeros, the Gaussian
    basis' means and stds U(0, 3), its per-type affine 1 and 0): one
    uniform and one normal draw over all leaves, then one affine map."""
    specs = param_specs(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(sizes)
    uni = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=gen)
    nrm = torch.empty(total, device=device).normal_(generator=gen)
    # per leaf: value = a * (u or n) + c, chosen by is_normal
    a, c, is_normal = [], [], []
    for (_, _, init) in specs:
        kind = init[0]
        if kind == "uniform":
            a.append(init[1]); c.append(0.0); is_normal.append(0.0)
        elif kind == "normal":
            a.append(1.0); c.append(0.0); is_normal.append(1.0)
        elif kind == "const":
            a.append(0.0); c.append(init[1]); is_normal.append(0.0)
        else:                                   # "range", low, high
            a.append((init[2] - init[1]) / 2); c.append((init[2] + init[1]) / 2)
            is_normal.append(0.0)
    counts = torch.tensor(sizes, device=device)
    a, c, is_normal = (torch.repeat_interleave(
        torch.tensor(x, device=device), counts) for x in (a, c, is_normal))
    flat = a * torch.where(is_normal > 0, nrm, uni) + c
    del uni, nrm, a, c, is_normal
    out = {}
    for (name, shape, init), piece in zip(specs, flat.split(sizes)):
        w = piece.view(shape)
        if init[0] == "normal" and init[1] is not None:
            w[init[1]].zero_()
        out[name] = w
    return out


WEIGHTS = 11          # the stream of a run seed that draws the weights


def run_weights(cfg: dict, run_seed: int, device) -> Params:
    """The weights of a benchmark run, drawn from its seed."""
    return make_weights(cfg, derive_seed(run_seed, WEIGHTS), device)


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


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------

def derive_seed(*words: int) -> int:
    """A seed in [0, 2**62) mixed from ``words`` by numpy's SeedSequence."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(2))


class Draws:
    """The masks of one layer application for a reference batch whose row
    ``t`` is row ``rows[t]`` of MC draw ``draw_of[t]`` of a program batch of
    ``batch`` rows per draw: each draw's generator draws the whole
    program batch's shape, and the reference keeps its own rows."""

    def __init__(self, seeds: Sequence[int], draw_of: Sequence[int],
                 rows: Sequence[int], batch: int, device):
        self.gens = []
        for s in seeds:
            g = torch.Generator(device=device)
            g.manual_seed(int(s))
            self.gens.append(g)
        self.draw_of = list(draw_of)
        self.rows = list(rows)
        self.batch = batch
        self.device = device

    def rand(self, tail: Sequence[int]) -> torch.Tensor:
        full = [torch.rand((self.batch, *tail), generator=g,
                           device=self.device) for g in self.gens]
        return torch.stack([full[d][r] for d, r in
                            zip(self.draw_of, self.rows)])


def dropout(x, rate: float, draws: Optional[Draws]):
    if draws is None or rate == 0.0:
        return x
    keep = draws.rand(x.shape[1:]) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def drop_path(x, rate: float, draws: Optional[Draws]):
    if draws is None or rate == 0.0:
        return x
    u = draws.rand((1,) * (x.dim() - 1))
    return x / (1.0 - rate) * (u < 1.0 - rate).to(x.dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def linear(p: Params, name: str, x, cast: Cast):
    return cast(x) @ cast(p[f"{name}.weight"]).t() + p[f"{name}.bias"]


def layernorm(p: Params, name: str, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def embed(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], cast: Cast):
    """h (b, N, Wh), e (b, N, N, We), additive mask (b, N, N, 1)."""
    nodef = batch["node_features"].long()
    node_tab = p["input_embed.nodef_embed.weight"]
    h = node_tab[nodef.clamp(0, node_tab.shape[0] - 1)].sum(dim=2)
    dm = batch["distance_matrix"].long().clamp(0, cfg["upto_hop"] + 1)
    featm = batch["feature_matrix"].long()
    feat_tab = p["input_embed.featm_embed.weight"]
    e = (p["input_embed.dist_embed.weight"][dm]
         + feat_tab[featm.clamp(0, feat_tab.shape[0] - 1)].sum(dim=-2))
    g = "input_embed.m3d_embed"
    b, n = nodef.shape[:2]
    ni = nodef[:, :, 0]
    types = torch.stack([ni[:, :, None].expand(b, n, n),
                         (ni + NODE_OFFSET)[:, None, :].expand(b, n, n)], -1)
    types = types.clamp(0, 2 * NODE_OFFSET)
    mul = p[f"{g}.gbf.mul.weight"][types].sum(dim=-2)
    bias = p[f"{g}.gbf.bias.weight"][types].sum(dim=-2)
    x = mul * batch["dist_input"][..., None] + bias
    mean = p[f"{g}.gbf.means.weight"].reshape(-1)
    std = p[f"{g}.gbf.stds.weight"].reshape(-1).abs() + 1e-2
    feat = torch.exp(-0.5 * ((x - mean) / std) ** 2) / ((2 * REF_PI) ** 0.5
                                                         * std)
    y = F.gelu(linear(p, f"{g}.gbf_proj.layer1", feat, cast))
    e = e + linear(p, f"{g}.gbf_proj.layer2", y, cast)
    mask = (1.0 - batch["edge_mask"].float()[..., None]) * MASK_VALUE
    return h, e, mask


def egt_attention(p, pre, h, e, mask, cfg, draws, cast):
    b, n, wh = h.shape
    heads = cfg["num_heads"]
    d = wh // heads
    h_ln = layernorm(p, f"{pre}.mha_ln_h", h)
    e_ln = layernorm(p, f"{pre}.mha_ln_e", e)
    q, k, v = linear(p, f"{pre}.lin_QKV", h_ln, cast).chunk(3, dim=-1)
    e_bias, g_bias = linear(p, f"{pre}.lin_EG", e_ln, cast).chunk(2, dim=-1)
    rate = cfg["source_dropout"]
    if draws is not None and rate > 0.0:
        drop = draws.rand((1, n, 1)) < rate
        mask = mask + drop.float() * MASK_VALUE
    q = q.reshape(b, n, d, heads) * d ** -0.5
    k = k.reshape(b, n, d, heads)
    v = v.reshape(b, n, d, heads)
    gates = torch.sigmoid(g_bias + mask)
    h_hat = torch.einsum("bldh,bmdh->blmh", cast(q), cast(k)) + e_bias
    a = torch.softmax(h_hat + mask, dim=2) * gates
    v_att = torch.einsum("blmh,bmdh->bldh", cast(a), cast(v))
    if cfg["scale_degree"]:
        v_att = v_att * torch.log1p(gates.sum(dim=2, keepdim=True))
    h_out = linear(p, f"{pre}.lin_O_h", v_att.reshape(b, n, wh), cast)
    return h_out, linear(p, f"{pre}.lin_O_e", h_hat, cast)


def edge_update(p, pre, h, e, cfg, cast):
    b, n, wh = h.shape
    heads = cfg["num_heads"]
    d = wh // heads
    h_ln = layernorm(p, f"{pre}.mha_ln_h", h)
    e_ln = layernorm(p, f"{pre}.mha_ln_e", e)
    q, k = linear(p, f"{pre}.lin_QK", h_ln, cast).chunk(2, dim=-1)
    e_bias = linear(p, f"{pre}.lin_E", e_ln, cast)
    q = q.reshape(b, n, d, heads) * d ** -0.5
    k = k.reshape(b, n, d, heads)
    h_hat = torch.einsum("bldh,bmdh->blmh", cast(q), cast(k)) + e_bias
    return linear(p, f"{pre}.lin_O_e", h_hat, cast)


def ffn(p, pre, x, rate, draws, cast):
    y = F.gelu(linear(p, f"{pre}.lin_W1", layernorm(p, f"{pre}.ffn_ln", x),
                      cast))
    return linear(p, f"{pre}.lin_W2", dropout(y, rate, draws), cast)


def _out_weight(p, pre, dtype, d, heads):
    # (W_out, 2W) -> (2W, W_out) -> (d, 2 heads, W_out): row (d, 2h)
    return p[f"{pre}.lin_O.weight"].t().reshape(d, 2 * heads, -1)


def triplet_attention(p, pre, e, mask, cfg, cast):
    """Triplet attention: for pair (i, j), softmax over k of
    q_ij.k_jk + b_ik, times sigmoid(g_ik), over v_jk ("in"); the same on the
    pair-transposed tensors ("out")."""
    b, n, _, w = e.shape
    heads = cfg["triplet_heads"]
    gated = triplet_gated(cfg)
    d = w // heads
    e_ln = layernorm(p, f"{pre}.tri_ln_e", e)
    w_o = _out_weight(p, pre, e.dtype, d, heads)
    bias_name = "lin_EG" if gated else "lin_E"

    def direction(which, w_dir, transpose):
        qkv = linear(p, f"{pre}.lin_QKV_{which}", e_ln, cast)
        q, k, v = (t.reshape(b, n, n, d, heads) for t in qkv.chunk(3, -1))
        q = q * d ** -0.5
        eg = linear(p, f"{pre}.{bias_name}_{which}", e_ln, cast)
        e_b, g_b = eg.chunk(2, dim=-1) if gated else (eg, None)
        m = mask
        if transpose:
            k, v, e_b, m = (t.transpose(1, 2) for t in (k, v, e_b, m))
            g_b = None if g_b is None else g_b.transpose(1, 2)
        logits = (torch.einsum("bijdh,bjkdh->bjhik", cast(q), cast(k))
                  + (e_b + m).permute(0, 3, 1, 2)[:, None])
        a = torch.softmax(logits, dim=-1)
        if g_b is not None:
            a = a * torch.sigmoid(g_b + m).permute(0, 3, 1, 2)[:, None]
        va = torch.einsum("bjhik,bjkdh->bjidh", cast(a), cast(v))
        return torch.einsum("bjidh,dhw->bjiw", cast(va), cast(w_dir))

    out_t = (direction("in", w_o[:, :heads], False)
             + direction("out", w_o[:, heads:], True))
    return out_t.transpose(1, 2) + p[f"{pre}.lin_O.bias"]


def triplet_aggregate(p, pre, e, mask, cfg, cast):
    """Triplet aggregation: for pair (i, j), the sum over k of
    softmax_k(e_ik) sigmoid(g_ik) v_jk ("in", masked); the same on the
    pair-transposed tensors ("out", unmasked in the gated variant as
    published)."""
    b, n, _, w = e.shape
    heads = cfg["triplet_heads"]
    gated = triplet_gated(cfg)
    d = w // heads
    e_ln = layernorm(p, f"{pre}.tri_ln_e", e)
    v_in, v_out = linear(p, f"{pre}.lin_V", e_ln, cast).chunk(2, dim=-1)
    if gated:
        e_in, g_in, e_out, g_out = linear(p, f"{pre}.lin_EG", e_ln,
                                          cast).chunk(4, dim=-1)
    else:
        e_in, e_out = linear(p, f"{pre}.lin_E", e_ln, cast).chunk(2, dim=-1)
        g_in = g_out = None
    w_o = _out_weight(p, pre, e.dtype, d, heads)

    def direction(e_l, g_l, v, w_dir, transpose, masked):
        v = v.reshape(b, n, n, d, heads)
        m = mask
        if transpose:
            e_l, v, m = e_l.transpose(1, 2), v.transpose(1, 2), m.transpose(1, 2)
            g_l = None if g_l is None else g_l.transpose(1, 2)
        if masked:
            e_l = e_l + m
            g_l = None if g_l is None else g_l + m
        a = torch.softmax(e_l, dim=2)
        if g_l is not None:
            a = a * torch.sigmoid(g_l)
        va = torch.einsum("bikh,bjkdh->bjidh", cast(a), cast(v))
        return torch.einsum("bjidh,dhw->bjiw", cast(va), cast(w_dir))

    out_t = (direction(e_in, g_in, v_in, w_o[:, :heads], False, True)
             + direction(e_out, g_out, v_out, w_o[:, heads:], True,
                         not gated))
    return out_t.transpose(1, 2) + p[f"{pre}.lin_O.bias"]


def tgt_layer(p, i, h, e, mask, cfg, rate_dp, draws, cast):
    pre = f"encoder.TGT_layers.{i}"
    node_update, _ = layer_updates(cfg, i)

    def dp(x):
        return drop_path(x, rate_dp, draws)

    if node_update:
        h_up, e_up = egt_attention(p, f"{pre}.update", h, e, mask, cfg,
                                   draws, cast)
        h = h + dp(h_up)
        h = h + dp(ffn(p, f"{pre}.node_ffn", h, cfg["node_act_dropout"],
                       draws, cast))
    else:
        e_up = edge_update(p, f"{pre}.update", h, e, cfg, cast)
    e = e + dp(e_up)
    if cfg["triplet_heads"]:
        fn = (triplet_attention if cfg["triplet_type"].startswith("attention")
              else triplet_aggregate)
        e = e + dp(fn(p, f"{pre}.tria", e, mask, cfg, cast))
    e = e + dp(ffn(p, f"{pre}.edge_ffn", e, cfg["edge_act_dropout"], draws,
                   cast))
    return h, e


def seed_table(seed: int, count: int) -> List[int]:
    """The per-layer-application seeds of one forward seed, drawn in layer
    order from a host generator."""
    return torch.randint(0, 2 ** 62, (count,),
                         generator=torch.Generator().manual_seed(int(seed))
                         ).tolist()


def forward(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], *,
            seeds: Optional[Sequence[int]] = None,
            draw_of: Optional[Sequence[int]] = None,
            rows: Optional[Sequence[int]] = None, program_batch: int = 0,
            cast: Cast = identity, remat: bool = False) -> torch.Tensor:
    """Distance-bin logits (b, N, N, bins) in float32.

    ``seeds``: the forward seed of each MC draw (None: dropout off);
    ``draw_of[t]``, ``rows[t]``: the draw and program row of reference row
    t; ``program_batch``: the program's rows per draw. ``remat``
    recomputes each layer in the backward, drawing its masks again."""
    height, reps = cfg["model_height"], cfg.get("layer_multiplier", 1)
    tables = (None if seeds is None else
              [seed_table(s, height * reps) for s in seeds])
    h, e, mask = embed(p, cfg, batch, cast)
    device = e.device

    def apply(i, h, e):
        rate_dp = (cfg["drop_path"] * i / (height - 1)) if height > 1 else 0.0
        for m in range(reps):
            draws = None
            if tables is not None:
                draws = Draws([t[i * reps + m] for t in tables], draw_of,
                              rows, program_batch, device)
            h, e = tgt_layer(p, i, h, e, mask, cfg, rate_dp, draws, cast)
        return h, e

    for i in range(height):
        if remat and torch.is_grad_enabled():
            h, e = checkpoint(apply, i, h, e, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, e = apply(i, h, e)
    return linear(p, "dist_pred", layernorm(p, "final_ln_edge", e), cast)
