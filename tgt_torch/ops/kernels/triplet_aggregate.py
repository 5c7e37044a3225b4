"""Dense triplet aggregation: the CUDA kernels' wrappers, their plain
versions, and the autograd function that joins forward and backward.

Counterpart of the aggregate part of ``tgt_tpu/ops/pallas/triplet_dense.py``
(``:448-540``): its ``_agg_fwd_kernel`` is
``tgt_torch/csrc/triplet_aggregate_fwd.cu`` and its ``_agg_bwd_kernel`` is
``tgt_torch/csrc/triplet_aggregate_bwd.cu`` (both built on the panel loop of
``triplet_aggregate_panel.cuh``: tensor cores in bf16, CUDA cores in f32);
the custom VJP ``_agg_core`` is :class:`TripletAggregateCore`. Only the O(N^3) k-aggregation runs in a
kernel: the N^2 weights (softmax, gate, dropout) are computed by the caller,
as ``triplet_aggregate_dense`` computes them. The TPU machinery (lane
packing, ``JBLK`` j-padding, ``_pick_jblk``, ``dense_unsupported_reason``)
has no counterpart.

Contract of :func:`triplet_aggregate_fwd`:
  a     (b, i, k, h), the weights
  v     (b, j, k, d, h), with (d, h) contiguous; the outer strides are free,
        so the out direction's pair-transposed view is read in place
  ->    va (b, j, i, d, h) = sum_k a[b,i,k,h] v[b,j,k,d,h], contiguous,
        summed in float32 and returned in v's dtype

:func:`triplet_aggregate_bwd` takes the same inputs and the cotangent ``dva``
(b, j, i, d, h) and returns ``da`` (b, i, k, h), summed over j and d in
float32 and cast to a's dtype, and ``dv`` (b, j, k, d, h), contiguous.

a and v share one dtype (float32 or bfloat16). A CPU tensor goes to the
plain version; a CUDA tensor goes to the kernel, and what the kernel cannot
take raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tgt_torch.ops.kernels._build import load_library

KERNEL_SOURCE = "tgt_torch/csrc/triplet_aggregate_fwd.cu"
REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:453"
BWD_KERNEL_SOURCE = "tgt_torch/csrc/triplet_aggregate_bwd.cu"
BWD_REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:468"

MAX_NODES = 128
MAX_SHARED_BYTES = 232448         # shared memory one block may use on Hopper
J_CHUNK = 12                      # rows j per partial sum of the dA kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def triplet_aggregate_fwd_reference(a: torch.Tensor,
                                    v: torch.Tensor) -> torch.Tensor:
    """Plain version: the k-aggregation of ``tgt_tpu/ops/triplet.py:159`` in
    the kernel's (b, j, i, d, h) output order, in float32 math, returned in
    v's dtype."""
    return torch.einsum("bikh,bjkdh->bjidh", a.float(), v.float()).to(v.dtype)


def triplet_aggregate_bwd_reference(a: torch.Tensor, v: torch.Tensor,
                                    dva: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward, the two products of ``_agg_bwd_kernel``
    (``tgt_tpu/ops/pallas/triplet_dense.py:468-489``) in float32 math:
    ``(da, dv)`` in the inputs' dtypes."""
    dva32 = dva.float()
    da = torch.einsum("bjidh,bjkdh->bikh", dva32, v.float())
    dv = torch.einsum("bikh,bjidh->bjkdh", a.float(), dva32)
    return da.to(a.dtype), dv.to(v.dtype)


def _check_shapes(a, v, dva=None) -> None:
    if v.dim() != 5:
        raise ValueError(f"v must be (b, j, k, d, h), got shape "
                         f"{tuple(v.shape)}")
    b, n, nk, d, h = v.shape
    if nk != n:
        raise ValueError(f"v must be square in (j, k), got {tuple(v.shape)}")
    for name, t, want in (("a", a, (b, n, n, h)), ("dva", dva, (b, n, n, d, h))):
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != v.dtype:
            raise TypeError(f"{name} is {t.dtype}, v is {v.dtype}")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v is on {v.device}")


def shared_bytes(n: int, d: int, h: int, itemsize: int) -> int:
    """Shared memory of the largest CUDA-core block the two sources launch:
    the panel loop (8 rows of weights in f32, padded to 12 floats per (k, h),
    and one (n, d*h) panel in the storage type) and the dA loop (8 rows of
    dva laid out the same way, and the V rows of 256 (k, h) columns, padded
    by h, in f32). The bf16 tensor-core panel loop runs only where its own
    tiles fit, and the CUDA-core loop otherwise."""
    panel = 4 * 12 * n * h + itemsize * n * d * h
    v_rows = min(n, -(-256 // h) + 1)
    return max(panel, 4 * (12 * d * h + v_rows * (d * h + h)))


def _check_kernel_limits(v) -> None:
    """What both kernels take; raises on anything else."""
    if v.device.type != "cuda":
        raise ValueError(f"the aggregate kernels run on cpu or cuda, not "
                         f"{v.device}")
    b, n, _, d, h = v.shape
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {v.dtype}")
    if n > MAX_NODES:
        raise ValueError(f"the kernel takes at most {MAX_NODES} nodes, got {n}")
    need = shared_bytes(n, d, h, v.element_size())
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"N={n}, d={d}, H={h} needs {need} bytes of shared "
                         f"memory per block, over the {MAX_SHARED_BYTES} a "
                         f"block may use")
    if b * -(-n // J_CHUNK) > 65535:
        raise ValueError(f"the kernel takes at most 65535 (batch row, chunk "
                         f"of {J_CHUNK} j) pairs, got b={b}, N={n}")
    if v.stride(4) != 1 or v.stride(3) != h:
        raise ValueError(f"v's (d, h) axes must be contiguous, strides "
                         f"{v.stride()}")


@functools.cache
def _fwd_kernel():
    fn = load_library("triplet_aggregate_fwd").triplet_aggregate_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = load_library("triplet_aggregate_bwd").triplet_aggregate_bwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def triplet_aggregate_fwd(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The k-aggregation forward, with no gradient on the card: a caller
    that needs one takes :func:`triplet_aggregate_core`. See the module
    docstring for the contract."""
    _check_shapes(a, v)
    if v.device.type == "cpu":
        return triplet_aggregate_fwd_reference(a, v)
    _check_kernel_limits(v)
    if torch.is_grad_enabled() and (a.requires_grad or v.requires_grad):
        raise RuntimeError("triplet_aggregate_fwd returns no gradient on the "
                           "card; call triplet_aggregate_core, which "
                           "differentiates through the backward kernel")
    b, n, _, d, h = v.shape
    a = a.contiguous()
    out = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    strides = (ctypes.c_longlong * 3)(*v.stride()[:3])
    with torch.cuda.device(v.device):
        rc = _fwd_kernel()(a.data_ptr(), v.data_ptr(), out.data_ptr(),
                           _DTYPE_CODES[v.dtype], b, n, d, h, strides,
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"triplet_aggregate_fwd kernel launch failed with "
                           f"CUDA error {rc}")
    triplet_aggregate_fwd.launches += 1
    return out


triplet_aggregate_fwd.launches = 0  # kernel launches, read by chip_smoke.py


def triplet_aggregate_bwd(a: torch.Tensor, v: torch.Tensor,
                          dva: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(da, dv)`` of the forward given the cotangent ``dva``.
    One call launches the backward's three kernels and counts once; dA's
    partial sums over chunks of ``J_CHUNK`` rows j go through a float32
    workspace."""
    _check_shapes(a, v, dva)
    if v.device.type == "cpu":
        return triplet_aggregate_bwd_reference(a, v, dva)
    _check_kernel_limits(v)
    dva = dva.contiguous()
    b, n, _, d, h = v.shape
    a = a.contiguous()
    da = torch.empty((b, n, n, h), dtype=a.dtype, device=v.device)
    dv = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    workspace = torch.empty((-(-n // J_CHUNK), b, n, n, h),
                            dtype=torch.float32, device=v.device)
    strides = (ctypes.c_longlong * 3)(*v.stride()[:3])
    with torch.cuda.device(v.device):
        rc = _bwd_kernel()(a.data_ptr(), v.data_ptr(), dva.data_ptr(),
                           da.data_ptr(), dv.data_ptr(), workspace.data_ptr(),
                           _DTYPE_CODES[v.dtype], b, n, d, h, J_CHUNK,
                           strides, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"triplet_aggregate_bwd kernel launch failed with "
                           f"CUDA error {rc}")
    triplet_aggregate_bwd.launches += 1
    return da, dv


triplet_aggregate_bwd.launches = 0  # one per call on the card, read by chip_smoke.py


class TripletAggregateCore(torch.autograd.Function):
    """The k-aggregation with its gradient: forward
    :func:`triplet_aggregate_fwd`, backward :func:`triplet_aggregate_bwd`, as
    ``_agg_core`` with its ``defvjp``
    (``tgt_tpu/ops/pallas/triplet_dense.py:492-540``). Only ``(a, v)`` are
    kept for the backward."""

    @staticmethod
    def forward(ctx, a, v):
        ctx.save_for_backward(a, v)
        return triplet_aggregate_fwd(a, v)

    @staticmethod
    def backward(ctx, dva):
        a, v = ctx.saved_tensors
        return triplet_aggregate_bwd(a, v, dva)


def triplet_aggregate_core(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable k-aggregation (see the module docstring for the
    contract)."""
    return TripletAggregateCore.apply(a, v)
