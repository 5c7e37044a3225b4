"""A residual junction in one pass, out = x + drop_path(y): the CUDA
kernel's wrapper and its plain version.

``tgt_torch/csrc/residual_fwd.cu`` replaces no TPU kernel: tgt_tpu's TGT
layer adds each sub-layer's update to the residual through a per-sample
drop-path (``tgt_tpu/ops/common.py`` ``drop_path``), a chain XLA fuses on
the TPU and PyTorch runs as a scalar multiply, a broadcast multiply and an
add. The kernel reads x and y once and writes out once.
``ops/common.residual`` sends it the calls that need no gradient
(:func:`tgt_torch.ops.common.residual_route`) and draws ``u`` itself, as
``drop_path`` does; the rest keep the composite.

Contract of :func:`residual_fwd`:
  x, y       (b, ..., W), one shape, bf16 or fp16, contiguous, 16-byte
             aligned, W a multiple of 8 (:func:`takes`)
  u          None (no draw: rate 0 or a deterministic call), or the (b, 1,
             ..., 1) f32 draw of ``drop_path``, contiguous, on x's device
  keep_prob  1 - the drop-path rate (read only with u)
  ->         out in x's dtype, a new tensor: x + y without u; else with
             kp = f32(keep_prob), keep = u < kp in f32 per sample, inv =
             f32(1 / keep_prob) (the reciprocal in double, then rounded),
             t = round(f32(y) * inv) and out = round(f32(x) + f32(t) *
             keep), bit for bit PyTorch's x + (y / keep_prob * keep) on the
             card; bitwise equal on repeat

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
and what the kernel cannot take raises. There is no fallback.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from tgt_torch.ops.kernels._build import (FLOAT, INT, LONG, PTR, STREAM,
                                          Entry, count, counted, launch,
                                          records_grad)

KERNEL_SOURCE = "tgt_torch/csrc/residual_fwd.cu"
REPLACES = None                   # XLA fused the chain on the TPU
PIECE = 8                         # elements of one 16-byte load
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}


def residual_fwd_reference(x: torch.Tensor, y: torch.Tensor,
                           u: Optional[torch.Tensor] = None,
                           keep_prob: float = 1.0) -> torch.Tensor:
    """Plain version: the kernel's arithmetic in PyTorch, in f32, returned
    in x's dtype."""
    if u is None:
        return (x.float() + y.float()).to(x.dtype)
    kp = torch.tensor(keep_prob, dtype=torch.float32)
    inv = torch.tensor(1.0 / keep_prob if keep_prob else math.inf,
                       dtype=torch.float32)
    keep = (u.float().reshape((-1,) + (1,) * (x.dim() - 1)) < kp).float()
    t = (y.float() * inv).to(x.dtype)
    return (x.float() + t.float() * keep).to(x.dtype)


def takes(dtype: torch.dtype, shape: Sequence[int]) -> bool:
    """Whether the kernel takes tensors of ``shape`` and ``dtype``: bf16 or
    fp16, a sample axis and rows of a multiple of 8 elements."""
    return dtype in _DTYPE_CODES and len(shape) >= 2 and shape[-1] % PIECE == 0


_KERNEL = Entry("residual_fwd", "residual_fwd", PTR, PTR, PTR, PTR, INT, INT,
                LONG, FLOAT, FLOAT, STREAM)


@counted("launches")
def residual_fwd(x: torch.Tensor, y: torch.Tensor,
                 u: Optional[torch.Tensor] = None,
                 keep_prob: float = 1.0) -> torch.Tensor:
    """x + drop_path(y) with no gradient on the card; one launch counts
    once in ``launches``. See the module docstring for the contract. Served
    forwards call it 120 times a request, so the checks are kept to cheap
    attribute reads."""
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"x and y must agree in shape and dtype, got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(y.shape)} "
                         f"{y.dtype}")
    b = x.shape[0] if x.dim() else 0
    if u is not None and u.numel() != b:
        raise ValueError(f"u must hold one draw per sample ({b}), got "
                         f"{tuple(u.shape)}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return residual_fwd_reference(x, y, u, keep_prob)
        raise ValueError(f"the residual kernel runs on cpu or cuda, not "
                         f"{x.device}")
    if records_grad((x, y)):
        raise RuntimeError("residual_fwd returns no gradient on the card; "
                           "the composite in ops/common.residual does")
    if not takes(x.dtype, x.shape):
        raise ValueError(f"the kernel takes bf16 or fp16 tensors of (b, ..., "
                         f"W) with W a multiple of {PIECE}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"x and y must be contiguous, strides {x.stride()} "
                         f"and {y.stride()}")
    device = x.get_device()
    if y.get_device() != device:
        raise ValueError(f"y is on {y.device}, x is on {x.device}")
    if u is not None and (u.dtype != torch.float32 or not u.is_contiguous()
                          or u.get_device() != device):
        raise ValueError(f"u must be contiguous f32 on {x.device}, got "
                         f"{u.dtype} on {u.device}")
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("x's and y's data must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    launch(_KERNEL, x, x.data_ptr(), y.data_ptr(),
           None if u is None else u.data_ptr(), out.data_ptr(),
           _DTYPE_CODES[x.dtype], b, x.numel() // (b * PIECE), keep_prob,
           1.0 / keep_prob if keep_prob else math.inf)
    count(residual_fwd)
    return out
