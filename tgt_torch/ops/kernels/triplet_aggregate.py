"""Dense triplet aggregation: the CUDA kernels' wrappers, their plain
versions, and the autograd function that joins forward and backward.

Counterpart of the aggregate part of ``tgt_tpu/ops/pallas/triplet_dense.py``
(``:448-540``): its ``_agg_fwd_kernel`` is
``tgt_torch/csrc/triplet_aggregate_fwd.cu`` and its ``_agg_bwd_kernel`` is
``tgt_torch/csrc/triplet_aggregate_bwd.cu``. Each has two routes, chosen
from the call's shapes by :func:`agg_fwd_route` and :func:`agg_bwd_route`:

- forward ``"body"``: bf16 with H a multiple of 8, d a multiple of 8 up to
  32, n <= 48 (64 at d <= 16) and 16-byte pieces of 8 heads: one
  tensor-core launch, one block per (b, 8 or 16 heads, chunk of rows j)
  that stages A once and keeps it in registers while it walks its j in
  order (:func:`agg_fwd_body_reference` is its partition in plain PyTorch,
  :func:`agg_fwd_blocks` picks the heads and rows j per block); A is read
  through its strides;
- forward ``"panel"``: f32 (the tensor cores' TF32 keeps too few bits) and
  any other bf16 shape: one block per (b, j) runs the panel loop of
  ``triplet_aggregate_panel.cuh`` (tensor cores in bf16, CUDA cores in f32)
  on a contiguous A;
- backward ``"body"``: bf16 with H a multiple of 8, d a multiple of 8 up to
  32, n <= 64 (128 at d <= 16) and 16-byte pieces of 8 heads: one
  tensor-core launch, one block per (b, 8 or 16 heads, 16 rows k) walking j
  in order, no workspace (:func:`agg_bwd_body_reference` is its partition
  in plain PyTorch, :func:`agg_bwd_heads_per_block` picks the heads per
  block);
- backward ``"panel"``: f32 and any other bf16 shape: dA on CUDA cores in
  chunks of ``J_CHUNK`` rows j through a float32 workspace, their ordered
  reduction, and dV on the panel loop.

The custom VJP ``_agg_core`` is :class:`TripletAggregateCore`. Only the
O(N^3) k-aggregation runs in a kernel: the N^2 weights (softmax, gate,
dropout) are computed by the caller, as ``triplet_aggregate_dense`` computes
them. The TPU machinery (lane packing, ``JBLK`` j-padding, ``_pick_jblk``,
``dense_unsupported_reason``) has no counterpart.

Contract of :func:`triplet_aggregate_fwd`:
  a     (b, i, k, h), the weights
  v     (b, j, k, d, h), with (d, h) contiguous; the outer strides are free,
        so the out direction's pair-transposed view is read in place
  out   optional (b, j, i, d, h) view of v's dtype and device to write into:
        h contiguous, the other four strides multiples of 8 elements, the
        data 16-byte aligned (else ValueError), so that 8 heads of one
        (b, j, i, d) stay one 16-byte piece. On the card only the body
        takes it (a call on the panel route raises): it stores its pieces
        through out's strides (named ``PairStore`` in a trace where out
        is not contiguous), as the aggregate layer's
        no-grad forward writes each direction into its half of one
        (b, i, j, 2, d, h) buffer; on the CPU the plain version writes it
  ->    va (b, j, i, d, h) = sum_k a[b,i,k,h] v[b,j,k,d,h], summed in
        float32 in a fixed order (bitwise equal on repeat) and returned in
        v's dtype: contiguous, or ``out`` itself

:func:`triplet_aggregate_bwd` takes the same inputs and the cotangent ``dva``
(b, j, i, d, h) and returns ``da`` (b, i, k, h), summed over j and d in
float32 in a fixed order and cast to a's dtype, and ``dv`` (b, j, k, d, h),
contiguous; both routes are bitwise deterministic on repeat.

a and v share one dtype (float32 or bfloat16). A CPU tensor goes to the
plain version; a CUDA tensor goes to the kernel, and what the kernel cannot
take raises. There is no fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tgt_torch.ops.kernels._build import (INT, LONGS, PTR, STREAM, Entry,
                                          count, counted, launch,
                                          records_grad, strides)
from tgt_torch.ops.kernels.triplet_bwd_panel import sm_count

KERNEL_SOURCE = "tgt_torch/csrc/triplet_aggregate_fwd.cu"
REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:453"
BWD_KERNEL_SOURCE = "tgt_torch/csrc/triplet_aggregate_bwd.cu"
BWD_REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:468"

MAX_NODES = 128
MAX_SHARED_BYTES = 232448         # shared memory one block may use on Hopper
J_CHUNK = 12                      # rows j per partial sum of the panel route's dA
BODY_GROUP = 8                    # heads per 16-byte piece: one block, one warp each
BODY_K_TILE = 16                  # rows k per block of the body
BODY_MAX_D = 32
FWD_BODY_MAX_N = 64               # the forward body's A fragments: n^2 / 64 registers
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


def agg_fwd_body_reference(a: torch.Tensor, v: torch.Tensor,
                           heads_per_block: int, j_chunk: int) -> torch.Tensor:
    """The forward body's partition in plain PyTorch: for each group of
    ``heads_per_block`` heads and each chunk of ``j_chunk`` rows j (one block
    of the kernel), walk its j in order and write ``va_j = A V_j`` for every
    row i, summed in float32 and cast to v's dtype once."""
    b, n, _, d, h = v.shape
    a32, v32 = a.float(), v.float()
    va = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    for h0 in range(0, h, heads_per_block):
        hs = slice(h0, min(h, h0 + heads_per_block))
        for j0 in range(0, n, j_chunk):
            for j in range(j0, min(n, j0 + j_chunk)):
                va[:, j, :, :, hs] = torch.einsum(
                    "bikh,bkdh->bidh", a32[..., hs], v32[:, j, :, :, hs]
                ).to(v.dtype)
    return va


def agg_fwd_route(dtype: torch.dtype, n: int, d: int, h: int,
                  v_strides: Tuple[int, int, int], aligned: bool) -> str:
    """Which route of ``triplet_aggregate_fwd.cu`` a call takes: ``"body"``
    (the bf16 tensor-core body) for bf16 with H a multiple of
    ``BODY_GROUP``, d a multiple of 8 up to ``BODY_MAX_D``, n <= 48 (n <=
    ``FWD_BODY_MAX_N`` at d <= 16, where the body's tiles still fit shared
    memory), V's three outer strides (elements) multiples of 8 and every
    data pointer 16-byte ``aligned``, so that 8 heads of one (row, d) are
    one 16-byte piece (the wrapper makes A contiguous where its strides are
    not multiples of 8); ``"panel"`` (the panel loop) otherwise."""
    if (dtype == torch.bfloat16 and h % BODY_GROUP == 0 and d % 8 == 0
            and d <= BODY_MAX_D and (n <= 48 or (n <= FWD_BODY_MAX_N and d <= 16))
            and aligned and all(s % 8 == 0 for s in v_strides)):
        return "body"
    return "panel"


def _copies_a(a: torch.Tensor) -> bool:
    """Whether the forward wrapper passes a contiguous copy of ``a``: where
    h is not contiguous or its outer strides are not multiples of 8."""
    return a.stride(3) != 1 or any(s % 8 for s in a.stride()[:3])


def fwd_route(a: torch.Tensor, v: torch.Tensor) -> str:
    """The route :func:`triplet_aggregate_fwd` takes for ``(a, v)``:
    ``"plain"`` on the CPU, else :func:`agg_fwd_route`'s, with ``a`` as the
    wrapper passes it (a copy, 16-byte aligned, where :func:`_copies_a`)."""
    if v.device.type == "cpu":
        return "plain"
    b, n, _, d, h = v.shape
    aligned = v.data_ptr() % 16 == 0 and (_copies_a(a) or a.data_ptr() % 16 == 0)
    return agg_fwd_route(v.dtype, n, d, h, v.stride()[:3], aligned)


def takes_pair_buffer(a: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a no-grad call of ``(a, v)`` can write both directions of the
    aggregate layer into one (b, i, j, 2, d, h) pair buffer through ``out``:
    H a multiple of ``BODY_GROUP`` (each half then meets ``out``'s contract)
    and a route that takes ``out``, the body on the card and the plain
    version on the CPU. The out direction's call (v's pair-transposed view,
    the same dtype, shape and set of strides, and new weights as a is)
    takes the same route."""
    return v.shape[-1] % BODY_GROUP == 0 and fwd_route(a, v) != "panel"


def agg_fwd_blocks(b: int, n: int, d: int, h: int, sms: int) -> Tuple[int, int]:
    """``(heads per block, rows j per block)`` of the forward body: 16 heads
    (16 warps a block) where H is a multiple of 16, n <= 48 and d <= 16
    (where their tiles fit), else 8; and the rows j split into about ``sms``
    / (b H / heads) chunks, so that the grid comes near one wave of the
    card's ``sms``."""
    hb = 16 if h % 16 == 0 and n <= 48 and d <= 16 else BODY_GROUP
    chunks = max(1, min(n, round(sms / (b * (h // hb)))))
    return hb, -(-n // chunks)


def agg_bwd_body_reference(a: torch.Tensor, v: torch.Tensor,
                           dva: torch.Tensor, k_tile: int = BODY_K_TILE
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward body's partition in plain PyTorch: for each group of
    ``BODY_GROUP`` heads and each tile of ``k_tile`` rows k (one block of the
    kernel), walk j in order, add ``dva_j V_j^T`` to the tile of dA in
    float32 and write the tile of ``dV_j = A^T dva_j``; the tile of dA is
    cast to a's dtype once, after the last j."""
    b, n, _, d, h = v.shape
    a32, v32, g32 = a.float(), v.float(), dva.float()
    da = torch.empty((b, n, n, h), dtype=a.dtype, device=a.device)
    dv = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    for h0 in range(0, h, BODY_GROUP):
        hs = slice(h0, min(h, h0 + BODY_GROUP))
        for k0 in range(0, n, k_tile):
            ks = slice(k0, min(n, k0 + k_tile))
            a_tile = a32[:, :, ks, hs]                        # (b, i, k, h)
            acc = torch.zeros_like(a_tile)
            for j in range(n):
                g_j = g32[:, j, :, :, hs]                     # (b, i, d, h)
                acc += torch.einsum("bidh,bkdh->bikh", g_j, v32[:, j, ks, :, hs])
                dv[:, j, ks, :, hs] = torch.einsum(
                    "bikh,bidh->bkdh", a_tile, g_j).to(v.dtype)
            da[:, :, ks, hs] = acc.to(a.dtype)
    return da, dv


def agg_bwd_route(dtype: torch.dtype, n: int, d: int, h: int,
                  v_strides: Tuple[int, int, int], aligned: bool) -> str:
    """Which route of ``triplet_aggregate_bwd.cu`` a call takes: ``"body"``
    (the bf16 tensor-core body) for bf16 with H a multiple of
    ``BODY_GROUP``, d a multiple of 8 up to ``BODY_MAX_D``, n <= 64 (n <=
    MAX_NODES at d <= 16, where the body's double-buffered tiles still fit
    shared memory), V's three outer strides (elements) multiples of 8 and
    every data pointer 16-byte ``aligned``, so that 8 heads of one (row, d)
    are one 16-byte piece; ``"panel"`` (the CUDA-core dA and panel dV)
    otherwise."""
    if (dtype == torch.bfloat16 and h % BODY_GROUP == 0 and d % 8 == 0
            and d <= BODY_MAX_D and (n <= 64 or (n <= MAX_NODES and d <= 16))
            and aligned and all(s % 8 == 0 for s in v_strides)):
        return "body"
    return "panel"


def agg_bwd_heads_per_block(b: int, n: int, d: int, h: int, sms: int) -> int:
    """Heads per block of the body: 16 (a block's rows are contiguous in
    memory, read by bulk copies; 16 warps) where H = 16, n <= 48, d <= 16
    and the ``b * ceil(n / 16)`` such blocks give at least half the card's
    ``sms`` one each; else 8 (twice the blocks, 16-byte pieces read by
    cp.async)."""
    if h == 16 and n <= 48 and d <= 16 and 2 * b * -(-n // BODY_K_TILE) >= sms:
        return 16
    return BODY_GROUP


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
    """Shared memory of the largest CUDA-core block that the forward and the
    backward's panel route launch: the panel loop (8 rows of weights in f32,
    padded to 12 floats per (k, h), and one (n, d*h) panel in the storage
    type) and the dA loop (8 rows of dva laid out the same way, and the V
    rows of 256 (k, h) columns, padded by h, in f32). The bf16 tensor-core
    panel loop runs only where its own tiles fit, and the CUDA-core loop
    otherwise. The backward's body fits at every shape it takes."""
    panel = 4 * 12 * n * h + itemsize * n * d * h
    v_rows = min(n, -(-256 // h) + 1)
    return max(panel, 4 * (12 * d * h + v_rows * (d * h + h)))


def _check_kernel_limits(v, route: str = "panel") -> None:
    """What the forward and the backward's ``route`` take; raises on
    anything else."""
    if v.device.type != "cuda":
        raise ValueError(f"the aggregate kernels run on cpu or cuda, not "
                         f"{v.device}")
    b, n, _, d, h = v.shape
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {v.dtype}")
    if n > MAX_NODES:
        raise ValueError(f"the kernel takes at most {MAX_NODES} nodes, got {n}")
    if v.stride(4) != 1 or v.stride(3) != h:
        raise ValueError(f"v's (d, h) axes must be contiguous, strides "
                         f"{v.stride()}")
    if route == "body":
        return
    need = shared_bytes(n, d, h, v.element_size())
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"N={n}, d={d}, H={h} needs {need} bytes of shared "
                         f"memory per block, over the {MAX_SHARED_BYTES} a "
                         f"block may use")
    if b * -(-n // J_CHUNK) > 65535:
        raise ValueError(f"the kernel takes at most 65535 (batch row, chunk "
                         f"of {J_CHUNK} j) pairs, got b={b}, N={n}")


_FWD = Entry("triplet_aggregate_fwd", "triplet_aggregate_fwd",
             *[PTR] * 3, *[INT] * 5, LONGS, STREAM)
_FWD_BODY = Entry("triplet_aggregate_fwd", "triplet_aggregate_fwd_body",
                  *[PTR] * 3, *[INT] * 6, *[LONGS] * 3, STREAM)
_BWD = Entry("triplet_aggregate_bwd", "triplet_aggregate_bwd",
             *[PTR] * 6, *[INT] * 6, LONGS, STREAM)
BWD_BODY = Entry("triplet_aggregate_bwd", "triplet_aggregate_bwd_body",
                 *[PTR] * 5, *[INT] * 5, LONGS, STREAM)


def _fwd_body(a, v, heads_per_block=None, j_chunk=None, out=None):
    """The body: one launch; a read through its strides; ``out`` (a new
    contiguous one where None) written through its strides, named
    ``RowStore`` in a trace where it is contiguous, else ``PairStore``."""
    b, n, _, d, h = v.shape
    if heads_per_block is None:
        heads_per_block, j_chunk = agg_fwd_blocks(b, n, d, h, sm_count(v.device))
    if out is None:
        out = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    launch(_FWD_BODY, v, a.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, d,
           h, heads_per_block, j_chunk, strides(a.stride()[:3]),
           strides(v.stride()[:3]), strides(out.stride()[:4]))
    return out


def _fwd_panel(a, v):
    """The panel loop: one block per (b, j); a contiguous."""
    b, n, _, d, h = v.shape
    out = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    launch(_FWD, v, a.data_ptr(), v.data_ptr(), out.data_ptr(),
           _DTYPE_CODES[v.dtype], b, n, d, h, strides(v.stride()[:3]))
    return out


def _check_out(out: torch.Tensor, v: torch.Tensor) -> None:
    """``out``'s contract (module docstring); raises on anything else."""
    if tuple(out.shape) != tuple(v.shape):
        raise ValueError(f"out must have shape {tuple(v.shape)}, got "
                         f"{tuple(out.shape)}")
    if out.dtype != v.dtype or out.device != v.device:
        raise TypeError(f"out is {out.dtype} on {out.device}, v is "
                        f"{v.dtype} on {v.device}")
    if out.stride(4) != 1 or any(s % BODY_GROUP for s in out.stride()[:4]):
        raise ValueError(f"out's strides must be multiples of {BODY_GROUP} "
                         f"elements with h contiguous, got {out.stride()}")
    if out.data_ptr() % 16:
        raise ValueError("out's data must be 16-byte aligned")


@counted("launches", "body_launches")
def triplet_aggregate_fwd(a: torch.Tensor, v: torch.Tensor, *,
                          out: Optional[torch.Tensor] = None,
                          _panel_route: bool = False) -> torch.Tensor:
    """The k-aggregation forward, with no gradient on the card (a caller
    that needs one takes :func:`triplet_aggregate_core`), through the route
    :func:`fwd_route` picks, into ``out`` where one is given; one call
    counts once in ``launches``, and once more in ``body_launches`` when it
    took the body. ``_panel_route`` sends a call through the panel loop
    whatever its shape (``chip_smoke.py`` times the two routes against each
    other). See the module docstring for the contract."""
    _check_shapes(a, v)
    if out is not None:
        _check_out(out, v)
    route = fwd_route(a, v)
    if route == "plain":
        va = triplet_aggregate_fwd_reference(a, v)
        return va if out is None else out.copy_(va)
    if records_grad((a, v)):
        raise RuntimeError("triplet_aggregate_fwd returns no gradient on the "
                           "card; call triplet_aggregate_core, which "
                           "differentiates through the backward kernel")
    b, n, _, d, h = v.shape
    if _copies_a(a):
        a = a.contiguous()
    if _panel_route:
        route = "panel"
    _check_kernel_limits(v, route)
    if route == "body":
        out = _fwd_body(a, v, out=out)
        count(triplet_aggregate_fwd, "body_launches")
    elif out is not None:
        raise ValueError(f"out is taken by the body route only; this call "
                         f"(dtype {v.dtype}, N={n}, d={d}, H={h}, v strides "
                         f"{v.stride()}) takes the panel route")
    else:
        out = _fwd_panel(a.contiguous(), v)
    count(triplet_aggregate_fwd)
    return out


def _bwd_body(a, v, dva, heads_per_block=None):
    """The body: one launch, no workspace. a and dva contiguous."""
    b, n, _, d, h = v.shape
    if heads_per_block is None:
        heads_per_block = agg_bwd_heads_per_block(b, n, d, h,
                                                  sm_count(v.device))
    da = torch.empty((b, n, n, h), dtype=a.dtype, device=v.device)
    dv = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    launch(BWD_BODY, v, a.data_ptr(), v.data_ptr(), dva.data_ptr(),
           da.data_ptr(), dv.data_ptr(), b, n, d, h, heads_per_block,
           strides(v.stride()[:3]))
    return da, dv


def _bwd_panel(a, v, dva):
    """Today's route: dA's partial sums over chunks of ``J_CHUNK`` rows j
    through a float32 workspace, their ordered reduction, and dV on the
    panel loop; three kernels. a and dva contiguous."""
    b, n, _, d, h = v.shape
    da = torch.empty((b, n, n, h), dtype=a.dtype, device=v.device)
    dv = torch.empty((b, n, n, d, h), dtype=v.dtype, device=v.device)
    workspace = torch.empty((-(-n // J_CHUNK), b, n, n, h),
                            dtype=torch.float32, device=v.device)
    launch(_BWD, v, a.data_ptr(), v.data_ptr(), dva.data_ptr(), da.data_ptr(),
           dv.data_ptr(), workspace.data_ptr(), _DTYPE_CODES[v.dtype], b, n,
           d, h, J_CHUNK, strides(v.stride()[:3]))
    return da, dv


@counted("launches", "body_launches")
def triplet_aggregate_bwd(a: torch.Tensor, v: torch.Tensor,
                          dva: torch.Tensor, *, _panel_route: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(da, dv)`` of the forward given the cotangent ``dva``,
    through the route :func:`agg_bwd_route` picks; one call counts once in
    ``launches``, and once more in ``body_launches`` when it took the body.
    ``_panel_route`` sends a call through today's route whatever its shape
    (``chip_smoke.py`` times the two routes against each other)."""
    _check_shapes(a, v, dva)
    if v.device.type == "cpu":
        return triplet_aggregate_bwd_reference(a, v, dva)
    a, dva = a.contiguous(), dva.contiguous()
    b, n, _, d, h = v.shape
    route = "panel" if _panel_route else agg_bwd_route(
        v.dtype, n, d, h, v.stride()[:3],
        all(t.data_ptr() % 16 == 0 for t in (a, v, dva)))
    _check_kernel_limits(v, route)
    if route == "body":
        da, dv = _bwd_body(a, v, dva)
        count(triplet_aggregate_bwd, "body_launches")
    else:
        da, dv = _bwd_panel(a, v, dva)
    count(triplet_aggregate_bwd)
    return da, dv


class TripletAggregateCore(torch.autograd.Function):
    """The k-aggregation with its gradient: forward
    :func:`triplet_aggregate_fwd`, backward :func:`triplet_aggregate_bwd`, as
    ``_agg_core`` with its ``defvjp``
    (``tgt_tpu/ops/pallas/triplet_dense.py:492-540``). Only ``(a, v)`` are
    kept for the backward; ``out`` is for calls that record no gradient."""

    @staticmethod
    def forward(ctx, a, v, out=None):
        ctx.save_for_backward(a, v)
        return triplet_aggregate_fwd(a, v, out=out)

    @staticmethod
    def backward(ctx, dva):
        a, v = ctx.saved_tensors
        return (*triplet_aggregate_bwd(a, v, dva), None)


def triplet_aggregate_core(a: torch.Tensor, v: torch.Tensor,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable k-aggregation (see the module docstring for the
    contract). A call given ``out`` writes into it and records no gradient:
    it raises where autograd would record one."""
    if out is not None and records_grad((a, v)):
        raise RuntimeError("triplet_aggregate_core writes into out only "
                           "where autograd records nothing")
    return TripletAggregateCore.apply(a, v, out)
