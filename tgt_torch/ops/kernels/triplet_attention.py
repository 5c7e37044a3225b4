"""The legacy fused triplet attention pair: the CUDA kernels' wrappers, their
plain versions, the autograd function that joins them, and the model-facing
entry that runs both directions through one launch.

Counterpart of ``tgt_tpu/ops/pallas/triplet_attention.py``, reached with
``use_pallas: true``: its ``_fwd_kernel`` is
``tgt_torch/csrc/triplet_attention_fwd.cu`` and its ``_bwd_kernel`` is
``tgt_torch/csrc/triplet_attention_bwd.cu``; the custom VJP
``_triplet_core`` is :class:`TripletCore`. The kernels read the head-major
layout in place (a head narrower than 16 padded with zero columns in bf16).

Contract of :func:`triplet_biased_attention` (and :func:`triplet_attention_fwd`):
  q_t, k_t, v_t  (b, h, Nj, N, d), contiguous, q not scaled
  bias, gate     (b, h, N, N) (i, k), the additive mask folded in
  scale          applied in the core to q.k, and to dq and dk
  ->             (b, h, Nj, N, d) = sum_k a[i,k] v_t[b,h,j,k], where
                 a = softmax_k(q.k * scale + bias) * sigmoid(gate), cast to
                 v's dtype before the product; returned in q's dtype

Unlike the dense core the softmax has no denominator clamp (its row max
makes the sum at least 1) and no dropout; the ungated variant passes a
constant gate of 30.0, whose sigmoid is exactly 1.0 in float32.
:func:`triplet_attention_bwd` takes the same inputs and the cotangent
``do`` and returns ``dq``, ``dk``, ``dv`` (contiguous, in q's dtype) and
``dbias``, ``dgate``, summed over j in float32 and cast to bias's dtype. In
bf16 on the card the forward and the backward run the tensor-core bodies
shared with the dense pair (``tgt_torch/csrc/triplet_fwd_mma.cuh`` and
``triplet_bwd_mma.cuh``). The backward takes dv from the f32 weights as
``_bwd_kernel`` does (``triplet_attention.py:81-83``): its instantiation
splits them into a bf16 high and low part and adds both products.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
and what the kernel cannot take raises. There is no fallback.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tgt_torch.ops.common import layernorm, linear
from tgt_torch.ops.kernels._build import (FLOAT, INT, PTR, STREAM, Entry,
                                          count, counted, launch,
                                          records_grad)
from tgt_torch.ops.kernels.triplet_bwd_panel import (j_chunks, pad_head_dim,
                                                     padded_head_dim, sm_count)
from tgt_torch.ops.kernels.triplet_fwd_panel import FWD_BLOCKS_PER_SM

KERNEL_SOURCE = "tgt_torch/csrc/triplet_attention_fwd.cu"
REPLACES = "tgt_tpu/ops/pallas/triplet_attention.py:35"
BWD_KERNEL_SOURCE = "tgt_torch/csrc/triplet_attention_bwd.cu"
BWD_REPLACES = "tgt_tpu/ops/pallas/triplet_attention.py:58"

MAX_NODES = 128
HEAD_DIMS = (1, 2, 4, 8, 16, 32)
UNGATED_GATE = 30.0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _probs(q_t, k_t, bias, scale):
    """(b, h, j, i, k) f32 softmax over k of q.k * scale + bias."""
    s = (torch.einsum("bhjid,bhjkd->bhjik", q_t.float(), k_t.float()) * scale
         + bias.float()[:, :, None])
    return torch.softmax(s, dim=-1)


def triplet_core_fwd_reference(q_t: torch.Tensor, k_t: torch.Tensor,
                               v_t: torch.Tensor, bias: torch.Tensor,
                               gate: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Plain version of ``_fwd_kernel`` (``triplet_attention.py:35-55``) in
    float32 math, the weights rounded to v's dtype before the product as
    the kernel rounds them (``:50``)."""
    a = _probs(q_t, k_t, bias, scale) * torch.sigmoid(gate.float())[:, :, None]
    return torch.einsum("bhjik,bhjkd->bhjid", a.to(v_t.dtype).float(),
                        v_t.float()).to(q_t.dtype)


def triplet_core_bwd_reference(q_t: torch.Tensor, k_t: torch.Tensor,
                               v_t: torch.Tensor, bias: torch.Tensor,
                               gate: torch.Tensor, do: torch.Tensor,
                               scale: float) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``_bwd_kernel`` (``triplet_attention.py:58-100``):
    dv from the f32 weights and the f32 cotangent; the logit gradient ds
    rounded to q's dtype before dq and dk, both scaled; dbias and dgate
    summed over j in f32, then cast. Returns ``(dq, dk, dv, dbias, dgate)``."""
    p = _probs(q_t, k_t, bias, scale)
    g = torch.sigmoid(gate.float())[:, :, None]
    do32 = do.float()
    dv = torch.einsum("bhjik,bhjid->bhjkd", p * g, do32)
    da = torch.einsum("bhjid,bhjkd->bhjik", do32, v_t.float())
    dgate = (da * p * g * (1.0 - g)).sum(2)
    dp = da * g
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(2)
    dsv = ds.to(q_t.dtype).float()
    dq = torch.einsum("bhjik,bhjkd->bhjid", dsv, k_t.float()) * scale
    dk = torch.einsum("bhjik,bhjid->bhjkd", dsv, q_t.float()) * scale
    dt = q_t.dtype
    return (dq.to(dt), dk.to(dt), dv.to(dt), dbias.to(bias.dtype),
            dgate.to(gate.dtype))


def _check(q_t, k_t, v_t, bias, gate, do=None) -> None:
    if q_t.dim() != 5:
        raise ValueError(f"q_t must be (b, h, Nj, N, d), got shape "
                         f"{tuple(q_t.shape)}")
    b, h, nj, n, d = q_t.shape
    for name, t, want in (("k_t", k_t, (b, h, nj, n, d)),
                          ("v_t", v_t, (b, h, nj, n, d)),
                          ("bias", bias, (b, h, n, n)),
                          ("gate", gate, (b, h, n, n)),
                          ("do", do, (b, h, nj, n, d))):
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q_t.dtype:
            raise TypeError(f"{name} is {t.dtype}, q_t is {q_t.dtype}")
        if t.device != q_t.device:
            raise ValueError(f"{name} is on {t.device}, q_t is on "
                             f"{q_t.device}")


def _check_kernel_limits(q_t, k_t, v_t, bias, gate, do=None) -> None:
    """What both kernels take; raises on anything else."""
    if q_t.device.type != "cuda":
        raise ValueError(f"the triplet kernels run on cpu or cuda, not "
                         f"{q_t.device}")
    b, h, nj, n, d = q_t.shape
    if q_t.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{q_t.dtype}")
    if n > MAX_NODES:
        raise ValueError(f"the kernel takes at most {MAX_NODES} nodes, got {n}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes a head width in {HEAD_DIMS}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError(f"the kernel takes at most 65535 (b, h) pairs, got "
                         f"{b * h}")
    for name, t in (("q_t", q_t), ("k_t", k_t), ("v_t", v_t), ("bias", bias),
                    ("gate", gate), ("do", do)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides "
                             f"{t.stride()}")


_FWD = Entry("triplet_attention_fwd", "triplet_attention_fwd",
             *[PTR] * 6, FLOAT, *[INT] * 6, STREAM)
_FWD_MMA = Entry("triplet_attention_fwd", "triplet_attention_fwd_mma",
                 *[PTR] * 6, FLOAT, *[INT] * 7, STREAM)
_BWD = Entry("triplet_attention_bwd", "triplet_attention_bwd",
             *[PTR] * 11, FLOAT, *[INT] * 6, STREAM)
_BWD_MMA = Entry("triplet_attention_bwd", "triplet_attention_bwd_mma",
                 *[PTR] * 12, FLOAT, *[INT] * 7, STREAM)


def _fwd_mma(q_t, k_t, v_t, bias, gate, scale):
    """The bf16 forward: the tensor-core body shared with the dense pair
    (``triplet_fwd_mma.cuh``: one launch) on the head-major panels in
    place, a head narrower than 16 padded."""
    b, h, nj, n, d = q_t.shape
    dp = padded_head_dim(d)
    q_p, k_p, v_p = (pad_head_dim(x, dp) for x in (q_t, k_t, v_t))
    out = torch.empty_like(q_p)
    jc, chunks = j_chunks(b * h, nj, sm_count(q_t.device), FWD_BLOCKS_PER_SM)
    launch(_FWD_MMA, q_t, q_p.data_ptr(), k_p.data_ptr(), v_p.data_ptr(),
           bias.data_ptr(), gate.data_ptr(), out.data_ptr(), scale, b, h, nj,
           n, dp, jc, chunks)
    return out if dp == d else out[..., :d].contiguous()


def _bwd_mma(q_t, k_t, v_t, bias, gate, do, scale):
    """The bf16 backward: the tensor-core body shared with the dense pair
    (``triplet_bwd_mma.cuh``: one panel launch and one ordered reduction)
    on the head-major panels in place, a head narrower than 16 padded; dv
    from the weights' high and low bf16 parts."""
    b, h, nj, n, d = q_t.shape
    dp = padded_head_dim(d)
    q_p, k_p, v_p, do_p = (pad_head_dim(x, dp) for x in (q_t, k_t, v_t, do))
    dq, dk, dv = (torch.empty_like(q_p) for _ in range(3))
    dbias, dgate = torch.empty_like(bias), torch.empty_like(gate)
    jc, chunks = j_chunks(b * h, nj, sm_count(q_t.device))
    partial = torch.empty((2, chunks, b, h, n, n), dtype=torch.float32,
                          device=q_t.device)
    launch(_BWD_MMA, q_t, q_p.data_ptr(), k_p.data_ptr(), v_p.data_ptr(),
           bias.data_ptr(), gate.data_ptr(), do_p.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), dgate.data_ptr(),
           partial.data_ptr(), scale, b, h, nj, n, dp, jc, chunks)
    if dp != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv, dbias, dgate


@counted("launches")
def triplet_attention_fwd(q_t: torch.Tensor, k_t: torch.Tensor,
                          v_t: torch.Tensor, bias: torch.Tensor,
                          gate: torch.Tensor, scale: float) -> torch.Tensor:
    """The legacy core's forward, with no gradient on the card: a caller
    that needs one takes :func:`triplet_biased_attention`. See the module
    docstring for the contract. On the card, bf16 runs the tensor-core body
    shared with the dense forward, f32 the CUDA-core kernel; either way one
    call counts once."""
    _check(q_t, k_t, v_t, bias, gate)
    if q_t.device.type == "cpu":
        return triplet_core_fwd_reference(q_t, k_t, v_t, bias, gate, scale)
    _check_kernel_limits(q_t, k_t, v_t, bias, gate)
    if records_grad((q_t, k_t, v_t, bias, gate)):
        raise RuntimeError("triplet_attention_fwd returns no gradient on "
                           "the card; call triplet_biased_attention, which "
                           "differentiates through the backward kernel")
    if q_t.dtype == torch.bfloat16:
        out = _fwd_mma(q_t, k_t, v_t, bias, gate, scale)
    else:
        b, h, nj, n, d = q_t.shape
        out = torch.empty_like(q_t)
        launch(_FWD, q_t, q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
               bias.data_ptr(), gate.data_ptr(), out.data_ptr(), scale,
               _DTYPE_CODES[q_t.dtype], b, h, nj, n, d)
    count(triplet_attention_fwd)
    return out


@counted("launches")
def triplet_attention_bwd(q_t: torch.Tensor, k_t: torch.Tensor,
                          v_t: torch.Tensor, bias: torch.Tensor,
                          gate: torch.Tensor, do: torch.Tensor,
                          scale: float) -> Tuple[torch.Tensor, ...]:
    """Gradients ``(dq, dk, dv, dbias, dgate)`` of the legacy core, given
    the cotangent ``do``. On the card, bf16 runs the tensor-core body shared
    with the dense backward, f32 the CUDA-core kernels; either way one call
    counts once."""
    _check(q_t, k_t, v_t, bias, gate, do)
    if q_t.device.type == "cpu":
        return triplet_core_bwd_reference(q_t, k_t, v_t, bias, gate, do,
                                          scale)
    _check_kernel_limits(q_t, k_t, v_t, bias, gate, do)
    if q_t.dtype == torch.bfloat16:
        grads = _bwd_mma(q_t, k_t, v_t, bias, gate, do, scale)
    else:
        b, h, nj, n, d = q_t.shape
        dq, dk, dv = (torch.empty_like(q_t) for _ in range(3))
        dbias, dgate = torch.empty_like(bias), torch.empty_like(gate)
        launch(_BWD, q_t, q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
               bias.data_ptr(), gate.data_ptr(), do.data_ptr(), dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
               dgate.data_ptr(), scale, _DTYPE_CODES[q_t.dtype], b, h, nj, n,
               d)
        grads = dq, dk, dv, dbias, dgate
    count(triplet_attention_bwd)
    return grads


class TripletCore(torch.autograd.Function):
    """The legacy core with its gradient, as the custom VJP ``_triplet_core``
    (``triplet_attention.py:109-156``): forward :func:`triplet_attention_fwd`,
    backward :func:`triplet_attention_bwd`, which recomputes the logits from
    the saved inputs. ``scale`` gets no gradient."""

    @staticmethod
    def forward(ctx, q_t, k_t, v_t, bias, gate, scale):
        ctx.save_for_backward(q_t, k_t, v_t, bias, gate)
        ctx.scale = scale
        return triplet_attention_fwd(q_t, k_t, v_t, bias, gate, scale)

    @staticmethod
    def backward(ctx, do):
        q_t, k_t, v_t, bias, gate = ctx.saved_tensors
        return (*triplet_attention_bwd(q_t, k_t, v_t, bias, gate,
                                       do.contiguous(), ctx.scale), None)


def triplet_biased_attention(q_t: torch.Tensor, k_t: torch.Tensor,
                             v_t: torch.Tensor, bias: torch.Tensor,
                             gate: torch.Tensor, scale: float) -> torch.Tensor:
    """Differentiable per-j biased gated attention on the head-major layout
    (see the module docstring for the contract)."""
    return TripletCore.apply(q_t, k_t, v_t, bias, gate, scale)


def triplet_attention_fused(module, e: torch.Tensor, mask: torch.Tensor,
                            gated: bool) -> torch.Tensor:
    """Both directions of a ``TripletAttention`` module through one launch
    of the legacy core (``triplet_attention_fused``,
    ``triplet_attention.py:182-246``): the projections in PyTorch, the
    operands moved to the head-major layout (the out direction's K, V, bias
    and gate pair-transposed), both directions stacked on the head axis,
    the output split back, the two directions concatenated on h and the
    whole ``lin_O`` applied. No dropout."""
    b, n, _, w = e.shape
    h = module.num_heads
    d = w // h
    e_ln = layernorm(module.tri_ln_e, e)
    mask3 = mask[..., 0]                                # (b, N, N) additive

    def operands(which: str, transpose_pair: bool):
        qkv = linear(getattr(module, f"lin_QKV_{which}"), e_ln)
        q, k, v = (t.reshape(b, n, n, d, h) for t in qkv.chunk(3, dim=-1))
        eg = linear(getattr(module, f"{module.bias_name}_{which}"), e_ln)
        e_b, g_b = eg.chunk(2, dim=-1) if gated else (eg, None)
        m = mask3
        if transpose_pair:
            e_b = e_b.transpose(1, 2)
            g_b = None if g_b is None else g_b.transpose(1, 2)
            m = mask3.transpose(1, 2)
        bias = (e_b + m[..., None]).permute(0, 3, 1, 2)
        gate = ((g_b + m[..., None]).permute(0, 3, 1, 2) if gated
                else torch.full_like(bias, UNGATED_GATE))
        kv_order = (0, 4, 2, 1, 3) if transpose_pair else (0, 4, 1, 2, 3)
        return (q.permute(0, 4, 2, 1, 3), k.permute(*kv_order),
                v.permute(*kv_order), bias, gate)

    stacked = [torch.cat(pair, dim=1).contiguous()
               for pair in zip(operands("in", False), operands("out", True))]
    out_t = triplet_biased_attention(*stacked, d ** -0.5)  # (b, 2h, j, i, d)
    va = torch.cat([out_t[:, :h].permute(0, 3, 2, 4, 1),
                    out_t[:, h:].permute(0, 3, 2, 4, 1)], dim=-1)
    return linear(module.lin_O, va.reshape(b, n, n, 2 * w))
