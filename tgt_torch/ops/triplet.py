"""Triplet interaction layers on the edge channel (counterpart of
tgt_tpu/ops/triplet.py): all six variants of the reference registry
(lib/tgt/layers/triplet.py:6-20). For a pair (i, j) the "in" direction
works through the edges (j, k), weighted by (i, k); the "out" direction is
the same computation on pair-transposed tensors.

- ``attention``, ``attention_ungated`` (:class:`TripletAttention`): the
  N^3 core (QK + bias, softmax over k, sigmoid gate, triplet dropout, sum
  over k of a*V) is ``ops/kernels/triplet_dense.triplet_dense`` with
  ``use_pallas='dense'`` (every published TGT-At config): on the card the
  CUDA forward and backward kernels joined by ``TripletDenseCore``, with
  the dropout mask drawn in the kernels from per-row seeds; on the CPU
  their plain versions. ``use_pallas=True`` runs tgt_tpu's legacy fused
  pair, ``ops/kernels/triplet_attention.triplet_attention_fused`` (one
  launch for both directions), which has no dropout: with dropout in
  training it warns and takes the plain path, as tgt_tpu does.
  ``use_pallas=False`` takes the plain forward, differentiated by
  autograd, with PyTorch's dropout on the weights.
- ``aggregate``, ``aggregate_ungated`` (:class:`TripletAggregate`, the
  TGT-Agx2 family): the N^2 weights (softmax over k, sigmoid gate, dropout)
  are plain PyTorch; the O(N^3) k-aggregation is
  ``ops/kernels/triplet_aggregate.triplet_aggregate_core`` with
  ``use_pallas='dense'`` (the CUDA kernels of ``_agg_core`` on the card),
  the plain einsum otherwise (``False``, ``None`` or ``True``: tgt_tpu's
  aggregate runs its jnp path for ``True``).
- ``triangular_update`` (:class:`TriangularUpdate`) and
  ``axial_attention`` (:class:`AxialAttention`): plain PyTorch, as in
  tgt_tpu, which has no kernel for them; they take ``use_pallas`` and
  ignore it.

``lin_O`` is applied split where the reference splits it: its (2W, W)
weight, rows indexed (d, 2h), is cut into the in-heads ``[:, :h]`` and
out-heads ``[:, h:]`` and contracted straight out of each direction's
(b, j, i, d, h) output; one transpose of axes 1 and 2 at the end restores
(b, i, j, W).

The attention variants name their values for selective remat where
tgt_tpu does (``ops/remat.py``): q, k, v, bias and gate ``tri_proj`` and
the plain path's weights ``tri_a``; the dense core names its output
``tri_va``. The aggregate variants name nothing, as in tgt_tpu.

The registry accepts the reference's ``tiangular_update`` typo.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, Optional

import torch
from torch import nn

from tgt_torch.ops.common import (Generators, dropout, layernorm, linear,
                                  randint, siglin)
from tgt_torch.ops.remat import checkpoint_name
from tgt_torch.ops.kernels.triplet_aggregate import (
    triplet_aggregate_core, triplet_aggregate_fwd_reference)
from tgt_torch.ops.kernels.triplet_attention import triplet_attention_fused
from tgt_torch.ops.kernels.triplet_dense import (dense_weights, triplet_dense,
                                                 triplet_dense_fwd_reference)


def dropout_seeds(b: int, generator: Generators,
                  device) -> Dict[str, torch.Tensor]:
    """One (b, 1) int32 seed tensor per direction, "in" then "out", in
    [0, 2**31 - 1), from the layer's generator: the counterpart of the rng
    split of ``triplet_attention_dense`` (``triplet_dense.py:700-705``).
    Drawn inside the layer, so a remat replay draws the same seeds. For a
    draw-stacked batch (a tuple of S generators, ``b`` = S*b rows) row
    block s comes from generator s, "in" before "out" as in one draw."""
    return {which: randint(2 ** 31 - 1, (b, 1), generator, device,
                           dtype=torch.int32)
            for which in ("in", "out")}


class TripletAttention(nn.Module):
    def __init__(self, edge_width: int, num_heads: int, gated: bool = True,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.gated = gated
        bias_dim = num_heads * 2 if gated else num_heads
        bias_name = "lin_EG" if gated else "lin_E"
        self.bias_name = bias_name
        self.tri_ln_e = nn.LayerNorm(edge_width, device=device)
        self.lin_QKV_in = nn.Linear(edge_width, edge_width * 3, device=device)
        self.add_module(f"{bias_name}_in",
                        nn.Linear(edge_width, bias_dim, device=device))
        self.lin_QKV_out = nn.Linear(edge_width, edge_width * 3, device=device)
        self.add_module(f"{bias_name}_out",
                        nn.Linear(edge_width, bias_dim, device=device))
        self.lin_O = nn.Linear(edge_width * 2, edge_width, device=device)

    def forward(self, e: torch.Tensor, mask: torch.Tensor, *,
                attention_dropout: float = 0.0, deterministic: bool = True,
                generator: Generators = None,
                use_pallas=False) -> torch.Tensor:
        # the routing of tgt_tpu/ops/triplet.py:274-371
        rate = 0.0 if deterministic else float(attention_dropout)
        seeds = {"in": None, "out": None}
        dense = use_pallas == "dense"
        if dense:
            core = triplet_dense
            if rate > 0.0:
                seeds = dropout_seeds(e.shape[0], generator, e.device)
        elif use_pallas and rate == 0.0:
            return triplet_attention_fused(self, e, mask, self.gated)
        else:
            if use_pallas:
                warnings.warn(
                    f"use_pallas requested but the triplet kernel fell back "
                    f"to the plain path: triplet attention_dropout="
                    f"{attention_dropout} > 0 in training mode (the legacy "
                    f"fused kernel runs without in-kernel dropout; set "
                    f"triplet_dropout: 0 or use_pallas: dense to keep a "
                    f"kernel)", RuntimeWarning, stacklevel=2)
            core = functools.partial(_plain_core, generator=generator)

        b, n, _, w = e.shape
        h = self.num_heads
        d = w // h
        scale = d ** -0.5
        e_ln = layernorm(self.tri_ln_e, e)
        # torch weight (W_out, 2W) -> tgt_tpu's (2W, W_out) -> (d, 2h, W_out)
        w_o = self.lin_O.weight.to(e.dtype).t().reshape(d, 2 * h, -1)

        def direction(which: str, w_dir: torch.Tensor,
                      transpose_pair: bool) -> torch.Tensor:
            qkv = linear(getattr(self, f"lin_QKV_{which}"), e_ln)
            q, k, v = (t.reshape(b, n, n, d, h) for t in qkv.chunk(3, dim=-1))
            q = q * scale
            eg = linear(getattr(self, f"{self.bias_name}_{which}"), e_ln)
            e_b, g_b = eg.chunk(2, dim=-1) if self.gated else (eg, None)
            # the projections are named for selective remat where tgt_tpu
            # names them: on the plain path before the pair transpose and
            # the mask (triplet.py:333-343), on the dense path after them
            # (ops/pallas/triplet_dense.py:744-749)
            if not dense:
                q, k, v, e_b, g_b = _name_projections(q, k, v, e_b, g_b)
            m = mask
            if transpose_pair:
                k = k.transpose(1, 2)
                v = v.transpose(1, 2)
                e_b = e_b.transpose(1, 2)
                g_b = None if g_b is None else g_b.transpose(1, 2)
                m = mask.transpose(1, 2)
            bias = e_b + m
            gate = None if g_b is None else g_b + m
            if dense:
                q, k, v, bias, gate = _name_projections(q, k, v, bias, gate)
            va = core(q, k, v, bias, gate, seed=seeds[which],
                      rate=rate)                        # (b, j, i, d, h)
            return torch.einsum("bjidh,dhw->bjiw", va, w_dir)

        out_t = (direction("in", w_o[:, :h], False)
                 + direction("out", w_o[:, h:], True))
        return out_t.transpose(1, 2) + self.lin_O.bias.to(e.dtype)


def _name_projections(q, k, v, bias, gate):
    """q, k, v, bias and gate marked ``tri_proj`` for selective remat."""
    q, k, v, bias = (checkpoint_name(t, "tri_proj") for t in (q, k, v, bias))
    return q, k, v, bias, None if gate is None else checkpoint_name(
        gate, "tri_proj")


def _plain_core(q, k, v, bias, gate, seed=None, rate=0.0, generator=None):
    """The plain path's core: at rate 0 the dense kernel's plain version; at
    rate > 0 the same with PyTorch's dropout on the gated (b, j, h, i, k)
    weights, drawn from ``generator`` (``seed`` is unused: the masks match
    tgt_tpu's jnp path in distribution only). The weights are named
    ``tri_a`` for selective remat (tgt_tpu/ops/triplet.py:363)."""
    if rate == 0.0:
        return triplet_dense_fwd_reference(q, k, v, bias, gate,
                                           weights_name="tri_a")
    a = dropout(dense_weights(q, k, bias, gate), rate, False, generator)
    a = checkpoint_name(a, "tri_a")
    return torch.einsum("bjhik,bjkdh->bjidh", a, v.float()).to(q.dtype)


class TripletAggregate(nn.Module):
    """Gated (``lin_EG``) or ungated (``lin_E``) triplet aggregation
    (tgt_tpu/ops/triplet.py:109-214, triplet_dense.py:543-610).

    ``mask_out`` says whether the out direction's weights are masked: the
    reference leaves them unmasked in the gated variant (triplet.py:162,
    kept for checkpoint parity, so padded rows contribute) and masks both
    directions in the ungated one."""

    def __init__(self, edge_width: int, num_heads: int, gated: bool = True,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.gated = gated
        self.mask_out = not gated
        self.tri_ln_e = nn.LayerNorm(edge_width, device=device)
        self.lin_V = nn.Linear(edge_width, edge_width * 2, device=device)
        if gated:
            self.lin_EG = nn.Linear(edge_width, num_heads * 4, device=device)
        else:
            self.lin_E = nn.Linear(edge_width, num_heads * 2, device=device)
        self.lin_O = nn.Linear(edge_width * 2, edge_width, device=device)

    def forward(self, e: torch.Tensor, mask: torch.Tensor, *,
                attention_dropout: float = 0.0, deterministic: bool = True,
                generator: Generators = None,
                use_pallas=False) -> torch.Tensor:
        core = (triplet_aggregate_core if use_pallas == "dense"
                else triplet_aggregate_fwd_reference)
        b, n, _, w = e.shape
        h = self.num_heads
        d = w // h
        e_ln = layernorm(self.tri_ln_e, e)
        v_in, v_out = linear(self.lin_V, e_ln).chunk(2, dim=-1)
        if self.gated:
            e_in, g_in, e_out, g_out = linear(self.lin_EG, e_ln).chunk(4, dim=-1)
        else:
            e_in, e_out = linear(self.lin_E, e_ln).chunk(2, dim=-1)
            g_in = g_out = None
        # torch weight (W_out, 2W) -> tgt_tpu's (2W, W_out) -> (d, 2h, W_out)
        w_o = self.lin_O.weight.to(e.dtype).t().reshape(d, 2 * h, -1)

        def direction(e_l, g_l, v, w_dir, transpose_pair, masked):
            v = v.reshape(b, n, n, d, h)
            m = mask
            if transpose_pair:
                e_l = e_l.transpose(1, 2)
                g_l = None if g_l is None else g_l.transpose(1, 2)
                v = v.transpose(1, 2)
                m = mask.transpose(1, 2)
            if masked:
                e_l = e_l + m
                g_l = None if g_l is None else g_l + m
            a = torch.softmax(e_l, dim=2)                   # (b, i, k, h)
            if g_l is not None:
                a = a * torch.sigmoid(g_l)
            a = dropout(a, attention_dropout, deterministic, generator)
            va = core(a, v)                                 # (b, j, i, d, h)
            return torch.einsum("bjidh,dhw->bjiw", va, w_dir)

        out_t = (direction(e_in, g_in, v_in, w_o[:, :h], False, True)
                 + direction(e_out, g_out, v_out, w_o[:, h:], True,
                             self.mask_out))
        return out_t.transpose(1, 2) + self.lin_O.bias.to(e.dtype)


class TriangularUpdate(nn.Module):
    """Gated linear triangle multiplication (tgt_tpu/ops/triplet.py:221-252;
    reference triplet.py:134-176). No dropout and no kernel."""

    def __init__(self, edge_width: int, num_heads: int, device=None):
        super().__init__()
        self.tri_ln_e = nn.LayerNorm(edge_width, device=device)
        self.lin_V = nn.Linear(edge_width, num_heads * 4, device=device)
        self.lin_E = nn.Linear(edge_width, num_heads * 4, device=device)
        self.lin_O = nn.Linear(num_heads * 2, edge_width * 2, device=device)

    def forward(self, e: torch.Tensor, mask: torch.Tensor, *,
                attention_dropout: float = 0.0, deterministic: bool = True,
                generator: Generators = None,
                use_pallas=False) -> torch.Tensor:
        e_ln = layernorm(self.tri_ln_e, e)
        v_in_g, v_in_l, v_out_g, v_out_l = linear(self.lin_V, e_ln).chunk(4, -1)
        e_in_g, e_in_l, e_out_g, e_out_l = linear(self.lin_E, e_ln).chunk(4, -1)
        v_in = siglin(v_in_g + mask, v_in_l)
        v_out = siglin(v_out_g + mask, v_out_l)
        e_in = siglin(e_in_g + mask, e_in_l)
        e_out = siglin(e_out_g + mask, e_out_l)
        va_in = torch.einsum("bikh,bjkh->bijh", e_in, v_in)
        va_out = torch.einsum("bkih,bkjh->bijh", e_out, v_out)
        va = torch.cat([va_in, va_out], dim=-1)
        out_g, out_l = linear(self.lin_O, va).chunk(2, dim=-1)
        return siglin(out_g, out_l)


class AxialAttention(nn.Module):
    """Row/column attention without the E/G bias (tgt_tpu/ops/triplet.py:
    392-436; reference triplet.py:325-387). Plain PyTorch."""

    def __init__(self, edge_width: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.tri_ln_e = nn.LayerNorm(edge_width, device=device)
        self.lin_QKV_in = nn.Linear(edge_width, edge_width * 3, device=device)
        self.lin_QKV_out = nn.Linear(edge_width, edge_width * 3, device=device)
        self.lin_O = nn.Linear(edge_width * 2, edge_width, device=device)

    def forward(self, e: torch.Tensor, mask: torch.Tensor, *,
                attention_dropout: float = 0.0, deterministic: bool = True,
                generator: Generators = None,
                use_pallas=False) -> torch.Tensor:
        b, n, _, w = e.shape
        h = self.num_heads
        d = w // h
        scale = d ** -0.5
        e_ln = layernorm(self.tri_ln_e, e)
        w_o = self.lin_O.weight.to(e.dtype).t().reshape(d, 2 * h, -1)

        def direction(which: str, w_dir: torch.Tensor,
                      transpose_pair: bool) -> torch.Tensor:
            qkv = linear(getattr(self, f"lin_QKV_{which}"), e_ln)
            q, k, v = (t.reshape(b, n, n, d, h) for t in qkv.chunk(3, dim=-1))
            q = q * scale
            m = mask
            if transpose_pair:
                k = k.transpose(1, 2)
                v = v.transpose(1, 2)
                m = mask.transpose(1, 2)
            # mask (b, i, k, 1) -> (b, 1, 1, i, k), broadcast over (j, h)
            s = (torch.einsum("bijdh,bjkdh->bjhik", q, k)
                 + m.permute(0, 3, 1, 2)[:, None])
            a = dropout(torch.softmax(s, dim=-1), attention_dropout,
                        deterministic, generator)
            va = torch.einsum("bjhik,bjkdh->bjhid", a, v)
            return torch.einsum("bjhid,dhw->bjiw", va, w_dir)

        out_t = (direction("in", w_o[:, :h], False)
                 + direction("out", w_o[:, h:], True))
        return out_t.transpose(1, 2) + self.lin_O.bias.to(e.dtype)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

TRIPLET_VARIANTS = ("aggregate", "aggregate_ungated", "attention",
                    "attention_ungated", "triangular_update", "axial_attention")

_CONSTRUCTORS = {
    "aggregate": functools.partial(TripletAggregate, gated=True),
    "aggregate_ungated": functools.partial(TripletAggregate, gated=False),
    "attention": functools.partial(TripletAttention, gated=True),
    "attention_ungated": functools.partial(TripletAttention, gated=False),
    "triangular_update": TriangularUpdate,
    "axial_attention": AxialAttention,
}


def _canon(variant: str) -> str:
    # accept the reference's registry typo (lib/tgt/layers/triplet.py:15)
    if variant == "tiangular_update":
        return "triangular_update"
    if variant not in TRIPLET_VARIANTS:
        raise ValueError(f"invalid triplet variant: {variant}")
    return variant


def get_triplet_module(variant: str) -> Callable[..., nn.Module]:
    """Constructor ``(edge_width, num_heads, device=None) -> nn.Module`` of
    a triplet variant."""
    return _CONSTRUCTORS[_canon(variant)]
