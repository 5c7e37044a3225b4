"""Shared primitive ops: linear, layernorm, embedding, dropout, drop-path,
initialisers (counterpart of tgt_tpu/ops/common.py).

Parameters live in ``torch.nn`` modules (``nn.Linear`` weights are
(out, in)); these functions apply them with tgt_tpu's numerics:
- ``linear`` casts the f32 weight to the input's dtype;
- ``layernorm`` normalises in f32 with eps 1e-5 and casts back;
- ``embedding`` clamps ids into [0, vocab-1] (``F.embedding`` would raise).

Initialisation follows torch.nn's defaults, as tgt_tpu's does: Linear
U(+-1/sqrt(fan_in)) for weight and bias, Embedding N(0, 1) with the padding
row zeroed, LayerNorm ones and zeros. Every draw takes an explicit
``torch.Generator``.

A forward's random draws (:func:`rand`, :func:`randint`) take one
generator, or a tuple of S generators for a draw-stacked batch: S MC draws
of b molecules as one batch of S*b rows, row ``s*b + r`` draw s of molecule
r. Row block s of every draw of shape (S*b, ...) then comes from generator
s with the shape (b, ...) that draw s alone draws, so every mask equals the
one-draw forward's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch.nn.LayerNorm default

# one generator, or one per draw of a draw-stacked batch
Generators = Union[torch.Generator, Tuple[torch.Generator, ...], None]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def linear_init_(lin: nn.Linear, generator: torch.Generator) -> None:
    bound = lin.in_features ** -0.5
    lin.weight.uniform_(-bound, bound, generator=generator)
    lin.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def layernorm_init_(ln: nn.LayerNorm) -> None:
    ln.weight.fill_(1.0)
    ln.bias.fill_(0.0)


@torch.no_grad()
def embedding_init_(emb: nn.Embedding, generator: torch.Generator) -> None:
    emb.weight.normal_(generator=generator)
    if emb.padding_idx is not None:
        emb.weight[emb.padding_idx].fill_(0.0)


@torch.no_grad()
def init_module_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``module`` from ``generator``, in
    module order. A submodule with its own ``init_from_(generator)`` (the 3D
    embeddings) initialises itself and its children."""
    own = []
    for name, m in module.named_modules():
        if any(p == "" or name.startswith(p + ".") for p in own):
            continue
        if hasattr(m, "init_from_"):
            m.init_from_(generator)
            own.append(name)
        elif isinstance(m, nn.Linear):
            linear_init_(m, generator)
        elif isinstance(m, nn.LayerNorm):
            layernorm_init_(m)
        elif isinstance(m, nn.Embedding):
            embedding_init_(m, generator)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def layernorm(ln: nn.LayerNorm, x: torch.Tensor,
              eps: float = LN_EPS) -> torch.Tensor:
    # normalise in f32 whatever the compute dtype
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), eps)
    return y.to(x.dtype)


def embedding(emb: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    # out-of-vocab ids clamp to the first/last row (tgt_tpu: mode='clip')
    return F.embedding(ids.long().clamp(0, emb.num_embeddings - 1),
                       emb.weight)


def _per_draw(shape: Sequence[int], generators: Tuple[torch.Generator, ...],
              device, dtype, fill) -> torch.Tensor:
    """A (S*b, ...) buffer whose row block s ``fill(block, generator s)``
    writes: one contiguous (b, ...) slice per draw, no concatenation."""
    draws = len(generators)
    if shape[0] % draws:
        raise ValueError(f"a draw-stacked batch of {shape[0]} rows does not "
                         f"split into {draws} draws")
    out = torch.empty(tuple(shape), device=device, dtype=dtype)
    for block, gen in zip(out.view(draws, -1, *shape[1:]), generators):
        fill(block, gen)
    return out


def rand(shape: Sequence[int], generator: Generators,
         device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``, or per row block from a
    tuple of generators (see the module note)."""
    if not isinstance(generator, tuple):
        return torch.rand(shape, generator=generator, device=device)
    return _per_draw(shape, generator, device, torch.get_default_dtype(),
                     lambda block, gen: block.uniform_(generator=gen))


def randint(high: int, shape: Sequence[int], generator: Generators, device,
            dtype=torch.int64) -> torch.Tensor:
    """``torch.randint(0, high, shape)`` from ``generator``, or per row
    block from a tuple of generators (see the module note)."""
    if not isinstance(generator, tuple):
        return torch.randint(0, high, shape, generator=generator,
                             device=device, dtype=dtype)
    return _per_draw(shape, generator, device, dtype,
                     lambda block, gen: block.random_(0, high, generator=gen))


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Generators) -> torch.Tensor:
    """Inverted dropout (scale by 1/keep at train time)."""
    if deterministic or rate == 0.0:
        return x
    keep = rand(x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Generators) -> torch.Tensor:
    """Per-sample stochastic depth (reference: lib/tgt/layers/layers.py:163-174)."""
    if deterministic or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = rand(shape, generator, x.device)
    keep = (u < keep_prob).to(x.dtype)
    return x / keep_prob * keep


def siglin(gates: torch.Tensor, lins: torch.Tensor) -> torch.Tensor:
    """sigmoid(gates) * lins (reference: lib/tgt/layers/triplet.py:130-132)."""
    return torch.sigmoid(gates) * lins
