"""Layer norm forward in one pass: the CUDA kernel's wrapper and its plain
version.

``tgt_torch/csrc/layernorm_fwd.cu`` replaces no TPU kernel: tgt_tpu's
``layernorm`` (``tgt_tpu/ops/common.py:57``) widens to f32, normalises and
rounds back, a chain XLA fuses on the TPU and PyTorch runs as three
launches. The kernel reads bf16 (or fp16) once and writes it once, with the
f32 row in registers. ``ops/common.layernorm`` sends it the calls that need
no gradient (:func:`tgt_torch.ops.common.layernorm_route`); the rest keep
the composite.

Contract of :func:`layernorm_fwd`:
  x        (..., W), bf16 or fp16, contiguous, W a multiple of 256 up to
           1024 (:func:`takes`)
  weight   (W,), bias (W,): the f32 parameters
  ->       y (..., W) in x's dtype: (x - mean) * rsqrt(var + eps) * weight
           + bias in f32, the mean and then mean((x - mean)^2) over the
           last axis, rounded once; bitwise equal on repeat

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
and what the kernel cannot take raises. There is no fallback.
"""
from __future__ import annotations

import torch

from tgt_torch.ops.kernels._build import (FLOAT, INT, LONG, PTR, STREAM,
                                          Entry, count, counted, launch,
                                          records_grad)

KERNEL_SOURCE = "tgt_torch/csrc/layernorm_fwd.cu"
REPLACES = None                   # XLA fused the chain on the TPU
PIECE_SPAN = 256                  # elements of one 16-byte load of every lane
MAX_WIDTH = 1024
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}


def layernorm_fwd_reference(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version: the kernel's arithmetic (tgt_tpu's as written) in
    PyTorch, in f32, returned in x's dtype."""
    xf = x.float()
    centred = xf - xf.mean(dim=-1, keepdim=True)
    var = centred.square().mean(dim=-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def takes(dtype: torch.dtype, width: int) -> bool:
    """Whether the kernel takes rows of ``width`` elements of ``dtype``."""
    return (dtype in _DTYPE_CODES and width % PIECE_SPAN == 0
            and PIECE_SPAN <= width <= MAX_WIDTH)


_KERNEL = Entry("layernorm_fwd", "layernorm_fwd", PTR, PTR, PTR, PTR, INT,
                LONG, INT, FLOAT, STREAM)


@counted("launches")
def layernorm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """The layer norm of x's last axis, with no gradient on the card; one
    launch counts once in ``launches``. See the module docstring for the
    contract. Served forwards call it ~120 times a request, so the checks
    are kept to cheap attribute reads."""
    width = x.shape[-1]
    if weight.shape != (width,) or bias.shape != (width,):
        raise ValueError(f"weight and bias must have shape ({width},), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layernorm_fwd_reference(x, weight, bias, eps)
        raise ValueError(f"the layer-norm kernel runs on cpu or cuda, not "
                         f"{x.device}")
    if records_grad((x, weight, bias)):
        raise RuntimeError("layernorm_fwd returns no gradient on the card; "
                           "the composite in ops/common.layernorm does")
    if not takes(x.dtype, width):
        raise ValueError(f"the kernel takes bf16 or fp16 rows of a multiple "
                         f"of {PIECE_SPAN} elements up to {MAX_WIDTH}, got "
                         f"{x.dtype} rows of {width}")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous, strides {x.stride()}")
    if weight.dtype != torch.float32 or not weight.is_contiguous():
        weight = weight.float().contiguous()
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    device = x.get_device()
    if weight.get_device() != device or bias.get_device() != device:
        raise ValueError(f"weight is on {weight.device} and bias on "
                         f"{bias.device}, x is on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x's data must be 16-byte aligned")
    y = torch.empty_like(x)
    rows = x.numel() // width
    if rows == 0:
        return y
    launch(_KERNEL, x, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
           y.data_ptr(), _DTYPE_CODES[x.dtype], rows, width, eps)
    count(layernorm_fwd)
    return y
