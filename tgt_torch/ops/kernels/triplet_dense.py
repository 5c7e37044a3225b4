"""Forward dense triplet attention: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``tgt_tpu/ops/pallas/triplet_dense.py`` (its ``_fwd_kernel``
at dropout rate 0). The kernel is ``tgt_torch/csrc/triplet_dense_fwd.cu``;
its source note gives its bound on the H100 and its design. The TPU
machinery (lane packing, ``JBLK`` j-padding, ``_pick_jblk`` VMEM budgets,
the shard_map data mesh) has no counterpart: the kernel reads the natural
``(..., d, h)`` layouts and needs no padding.

Contract of :func:`triplet_dense_fwd`:
  q     (b, i, j, d, h), already scaled by d**-0.5
  k, v  (b, j, k, d, h)
  bias  (b, i, k, h) and gate (b, i, k, h) or None, in the compute dtype
  ->    va (b, j, i, d, h), float32 or bfloat16 like the inputs

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
and what the kernel cannot take raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tgt_torch.ops.kernels._build import load_library

KERNEL_SOURCE = "tgt_torch/csrc/triplet_dense_fwd.cu"
REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:222"

MAX_NODES = 128
HEAD_DIMS = (1, 2, 4, 8, 16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def triplet_dense_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor,
                                gate: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain version: the einsum form of ``tgt_tpu/ops/triplet.py:353-364``
    without ``lin_O``, computed in float32 like the kernel and returned in
    the input dtype. It materialises the (b, j, h, i, k) logits."""
    s = (torch.einsum("bijdh,bjkdh->bjhik", q.float(), k.float())
         + bias.float().permute(0, 3, 1, 2)[:, None])
    a = torch.softmax(s, dim=-1)
    if gate is not None:
        a = a * torch.sigmoid(gate.float().permute(0, 3, 1, 2))[:, None]
    return torch.einsum("bjhik,bjkdh->bjidh", a, v.float()).to(q.dtype)


def _check_shapes(q, k, v, bias, gate) -> None:
    if q.dim() != 5:
        raise ValueError(f"q must be (b, i, j, d, h), got shape {tuple(q.shape)}")
    b, n, nj, d, h = q.shape
    if nj != n:
        raise ValueError(f"q must be square in (i, j), got {tuple(q.shape)}")
    for name, t, want in (("k", k, (b, n, n, d, h)), ("v", v, (b, n, n, d, h)),
                          ("bias", bias, (b, n, n, h)),
                          ("gate", gate, (b, n, n, h))):
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")


@functools.cache
def _kernel():
    fn = load_library("triplet_dense_fwd").triplet_dense_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def triplet_dense_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor,
                      gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated (or, with ``gate=None``, ungated) dense triplet attention
    forward. See the module docstring for the contract."""
    _check_shapes(q, k, v, bias, gate)
    if q.device.type == "cpu":
        return triplet_dense_fwd_reference(q, k, v, bias, gate)
    if q.device.type != "cuda":
        raise ValueError(f"triplet_dense_fwd runs on cpu or cuda, not "
                         f"{q.device}")
    b, n, _, d, h = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if n > MAX_NODES:
        raise ValueError(f"the kernel takes at most {MAX_NODES} nodes, got {n}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes a head width in {HEAD_DIMS}, "
                         f"got {d}")
    if b > 65535:
        raise ValueError(f"the kernel takes at most 65535 batch rows, got {b}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(4) != 1 or t.stride(3) != h:
            raise ValueError(f"{name}'s (d, h) axes must be contiguous, "
                             f"strides {t.stride()}")
    gate_or_bias = bias if gate is None else gate
    for name, t in (("bias", bias), ("gate", gate_or_bias)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s h axis must be contiguous, strides "
                             f"{t.stride()}")

    out = torch.empty((b, n, n, d, h), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *bias.stride()[:3], *gate_or_bias.stride()[:3])
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                None if gate is None else gate.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[q.dtype], b, n, d, h, strides, stream)
    if rc != 0:
        raise RuntimeError(f"triplet_dense_fwd kernel launch failed with "
                           f"CUDA error {rc}")
    triplet_dense_fwd.launches += 1
    return out


triplet_dense_fwd.launches = 0  # kernel launches, read by chip_smoke.py
