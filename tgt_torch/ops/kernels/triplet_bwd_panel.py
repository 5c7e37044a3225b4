"""The bf16 backward body shared by the dense and the legacy triplet
attention backward (``tgt_torch/csrc/triplet_bwd_mma.cuh``): its plain
version on head-major panels, and what both wrappers need to launch it.

The body takes q, k, v and the cotangent as (b, h, nj, n, dp) panels with a
head width dp of 16 or 32 (:func:`pad_head_dim` pads a narrower head with
zero columns, which change no product), and splits the rows j of each
(b, h) into chunks (:func:`j_chunks`) so that the card has enough blocks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# blocks of the body resident on one SM at n <= 48 (its launch bounds
# promise four): the chunks of j fill one wave of them
BLOCKS_PER_SM = 4


def padded_head_dim(d: int) -> int:
    """The body's head width for a head of ``d``: 16 or 32."""
    return 16 if d <= 16 else 32


def pad_head_dim(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` contiguous, its last axis zero-padded to ``dp``."""
    d = x.shape[-1]
    if d == dp:
        return x.contiguous()
    out = x.new_zeros(*x.shape[:-1], dp)
    out[..., :d] = x
    return out


def j_chunks(pairs: int, nj: int, sms: int,
             per_sm: int = BLOCKS_PER_SM) -> Tuple[int, int]:
    """(rows j per chunk, chunks) for ``pairs`` (b, h) pairs of ``nj`` rows
    on a card of ``sms`` SMs: as many chunks as fit one wave of ``per_sm``
    blocks per SM, at least one."""
    want = max(1, min(nj, per_sm * sms // pairs))
    jc = -(-nj // want)
    return jc, -(-nj // jc)


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_weights(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``hi + lo`` in f32, with hi = ``a`` rounded to ``dtype`` and lo = the
    rest rounded to ``dtype``: the weights the legacy instantiation of the
    body feeds dV in two products, within about 2^-16 of ``a`` in bf16."""
    hi = a.to(dtype).float()
    return hi + (a - hi).to(dtype).float()


def panel_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, gate: Optional[torch.Tensor],
                        dout: torch.Tensor, scale: float,
                        keep: Optional[torch.Tensor] = None,
                        split_dv: bool = False):
    """Plain version of the body on head-major panels: q, k, v, dout
    (b, h, nj, n, d), bias and gate (b, h, n, n) or ``gate=None``, ``keep``
    the (b, h, nj, n, n) float keep mask or None. In f32 math, ds rounded to
    q's dtype before the dQ and dK products as the body rounds it; the
    weights a rounded once before dV (the dense instantiation), or with
    ``split_dv`` split into a high and a low part (:func:`split_weights`,
    the legacy instantiation, which keeps tgt_tpu's f32 weights). Returns
    ``(dq, dk, dv, dbias, dgate)`` in q's dtype; ``dgate`` is None when
    ungated."""
    s = (torch.einsum("bhjid,bhjkd->bhjik", q.float(), k.float()) * scale
         + bias.float()[:, :, None])
    pn = torch.softmax(s, dim=-1)
    do32 = dout.float()
    da = torch.einsum("bhjid,bhjkd->bhjik", do32, v.float())
    a = pn
    if keep is not None:
        da = da * keep
        a = a * keep
    dgate = None
    if gate is not None:
        g = torch.sigmoid(gate.float())
        dgate = (da * pn).sum(2) * g * (1.0 - g)
        dp = da * g[:, :, None]
        a = a * g[:, :, None]
    else:
        dp = da
    ds = pn * (dp - (dp * pn).sum(-1, keepdim=True))
    dt = q.dtype
    dsr = ds.to(dt).float()
    ar = split_weights(a, dt) if split_dv else a.to(dt).float()
    dq = torch.einsum("bhjik,bhjkd->bhjid", dsr, k.float()) * scale
    dk = torch.einsum("bhjik,bhjid->bhjkd", dsr, q.float()) * scale
    dv = torch.einsum("bhjik,bhjid->bhjkd", ar, do32)
    return (dq.to(dt), dk.to(dt), dv.to(dt), ds.sum(2).to(dt),
            None if dgate is None else dgate.to(dt))
