"""Dense triplet attention: the CUDA kernels' wrappers, their plain
versions, and the autograd function that joins forward and backward.

Counterpart of ``tgt_tpu/ops/pallas/triplet_dense.py``: its ``_fwd_kernel``
is ``tgt_torch/csrc/triplet_dense_fwd.cu`` and its ``_bwd_kernel`` is
``tgt_torch/csrc/triplet_dense_bwd.cu``, each at dropout rate 0 and at rate
> 0; the custom VJP ``_dense_core`` is :class:`TripletDenseCore`. Each
source note gives its kernel's bound on the H100 and its design. The TPU
machinery (lane packing, ``JBLK`` j-padding, ``_pick_jblk`` VMEM budgets,
the shard_map data mesh) has no counterpart: the f32 kernels read the
natural ``(..., d, h)`` layouts in place; in bf16 the forward and the
backward run the tensor-core bodies they share with the legacy pair
(``triplet_fwd_mma.cuh``, ``triplet_bwd_mma.cuh``). The bf16 forward reads
the natural layouts in place where :func:`reads_in_place` allows (8 heads
per block, transposed in shared memory); otherwise, and in the backward,
the bodies run on head-major copies that :func:`to_head_major` makes, as
``_pack`` relayouts around the TPU kernels.

Contract of :func:`triplet_dense` (and of :func:`triplet_dense_fwd`):
  q     (b, i, j, d, h), already scaled by d**-0.5
  k, v  (b, j, k, d, h)
  bias  (b, i, k, h) and gate (b, i, k, h) or None, in the compute dtype
  seed  (b, 1) int32, one dropout seed per batch row; read only at rate > 0
  rate  the dropout rate, in [0, 1)
  ->    va (b, j, i, d, h), float32 or bfloat16 like the inputs

At rate > 0 the gated weights (softmax, then gate) are multiplied by the
keep mask of :func:`hash_keep`, a stateless hash of the element's index
``(j*n + i)*(n*h) + k*h + h`` in the core's own (j, i, k, h) frame under its
batch row's seed, as ``_keep_tile`` draws it: the backward rebuilds the
forward's mask and no mask reaches device memory.

:func:`triplet_dense_bwd` takes the same inputs and the cotangent ``dva``
(b, j, i, d, h) and returns ``dq``, ``dk``, ``dv`` (contiguous, in the
inputs' shapes and dtype), and ``dbias``, ``dgate`` (b, i, k, h), summed
over j in f32 and cast to the inputs' dtype.

Past ``MAX_NODES`` (128) the bf16 bodies no longer hold a row's keys; an
ungated call at rate 0 in bf16 takes the key-tiled route
(``csrc/triplet_tiled_mma.cuh``: an online softmax over blocks of 64 keys
in the forward; in the backward a dQ kernel that also takes the row
statistics and dbias' partial sums, a dK/dV kernel and an ordered
reduction) up to ``TILED_MAX_NODES``, counted apart in
``tiled_launches``. Its weights are rounded against the running row max,
so it agrees with the plain version to bf16 rounding; it is bitwise
deterministic on repeat.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
and what the kernel cannot take raises. There is no fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tgt_torch.ops import remat
from tgt_torch.ops.kernels._build import (FLOAT, INT, LONGS, PTR, STREAM,
                                          UINT, Entry, count, counted, launch,
                                          records_grad, strides)
from tgt_torch.ops.kernels.triplet_bwd_panel import (j_chunks, pad_head_dim,
                                                     padded_head_dim, sm_count)
from tgt_torch.ops.kernels.triplet_fwd_panel import FWD_BLOCKS_PER_SM

KERNEL_SOURCE = "tgt_torch/csrc/triplet_dense_fwd.cu"
REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:222"
BWD_KERNEL_SOURCE = "tgt_torch/csrc/triplet_dense_bwd.cu"
BWD_REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:258"
DROPOUT_REPLACES = "tgt_tpu/ops/pallas/triplet_dense.py:141"

MAX_NODES = 128
TILED_MAX_NODES = 1024     # ttil::kMaxNodes, csrc/triplet_tiled_mma.cuh
HEAD_DIMS = (1, 2, 4, 8, 16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, split in 16-bit halves so no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def dropout_constants(rate: float) -> Tuple[int, float]:
    """(threshold, kept value) of the keep mask, as ``_hash_keepf`` computes
    them in Python doubles: a 31-bit hash below the threshold keeps its
    element, which is then scaled by float32(1 / (1 - rate))."""
    keep = 1.0 - rate
    return min(int(keep * 2.0 ** 31), 0x7FFFFFFF), 1.0 / keep


def hash_keep(lin: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Inverted-dropout keep mask from a stateless integer hash, bit for bit
    ``_hash_keepf`` (``tgt_tpu/ops/pallas/triplet_dense.py:141``): murmur3's
    32-bit finalizer over ``lin * 0x9E3779B9 + seed`` with wrapping 32-bit
    multiplies and logical shifts, done here in int64 masked to 32 bits.

    ``lin`` holds non-negative element indices (any integer dtype and
    shape), ``seed`` an int or an integer tensor that broadcasts against
    it. Returns float32 of {0, 1/(1-rate)}."""
    h = _mul32(lin.to(torch.int64) & _MASK32, 0x9E3779B9)
    seed = torch.as_tensor(seed, device=lin.device).to(torch.int64)
    h = (h + (seed & _MASK32)) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    thresh, scale = dropout_constants(rate)
    kept = torch.tensor(scale, dtype=torch.float32, device=lin.device)
    return torch.where((h & 0x7FFFFFFF) < thresh, kept, torch.zeros_like(kept))


def keep_tile(seed, j: int, n: int, kh: int, rate: float,
              device=None) -> torch.Tensor:
    """(n, kh) keep mask of row ``j``: element (i, k*H + h) hashes index
    ``(j*n + i)*kh + k*H + h`` under ``seed`` (``_keep_tile``,
    ``triplet_dense.py:167``)."""
    i = torch.arange(n, device=device)[:, None]
    c = torch.arange(kh, device=device)[None, :]
    return hash_keep((j * n + i) * kh + c, seed, rate)


def dropout_mask(seed: torch.Tensor, n: int, h: int,
                 rate: float) -> torch.Tensor:
    """(b, j, h, i, k) float32 keep mask of the whole core for the (b, 1)
    seeds: the kernel frame's index ``(j*n + i)*(n*h) + k*h + h``."""
    ar = torch.arange(n, device=seed.device)
    jj, hh = ar[:, None, None, None], torch.arange(h, device=seed.device)[
        None, :, None, None]
    ii, kk = ar[None, None, :, None], ar[None, None, None, :]
    lin = (jj * n + ii) * (n * h) + kk * h + hh
    return hash_keep(lin[None], seed.reshape(-1, 1, 1, 1, 1), rate)


def _logits(q, k, bias):
    """(b, j, h, i, k) f32 logits q.K + bias."""
    return (torch.einsum("bijdh,bjkdh->bjhik", q.float(), k.float())
            + bias.float().permute(0, 3, 1, 2)[:, None])


def _gate(gate):
    """(b, 1, h, i, k) f32 sigmoid of the gate."""
    return torch.sigmoid(gate.float().permute(0, 3, 1, 2))[:, None]


def dense_weights(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
                  gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, j, h, i, k) float32 weights: the softmax over k of q.K + bias,
    times sigmoid(gate) when gated."""
    a = torch.softmax(_logits(q, k, bias), dim=-1)
    return a if gate is None else a * _gate(gate)


def triplet_dense_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor,
                                gate: Optional[torch.Tensor] = None,
                                seed: Optional[torch.Tensor] = None,
                                rate: float = 0.0,
                                weights_name: Optional[str] = None
                                ) -> torch.Tensor:
    """Plain version: the einsum form of ``tgt_tpu/ops/triplet.py:353-364``
    without ``lin_O``, computed in float32 and returned in the input dtype,
    rounded where ``_fwd_kernel`` rounds (``triplet_dense.py:243-252``).
    The unnormalised weights ``e = exp(s - max_k s)`` times sigmoid(gate)
    and, at rate > 0, the :func:`dropout_mask` (softmax, gate, dropout, as
    ``:245-248`` orders them) are rounded to the input dtype before the
    product with V, as ``_dot`` casts its operands (``:179-182, 250``); the
    product sums in f32 and is then multiplied by 1 / max(sum_k e, 1e-30).
    The max is taken per (i, h), where the TPU kernel takes the cross-head
    row max (``:207-212``), so bf16 results agree with it to bf16 rounding,
    not bit for bit. In f32 the rounding is the identity: ``_plain_core``
    (``ops/triplet.py``) takes this function at rate 0, and the plain path
    still matches tgt_tpu's jnp path to 1e-5
    (``tests/test_torch_port_triplet.py``). It materialises the (b, j, h,
    i, k) logits. ``weights_name`` marks the weights for selective remat
    (the plain path's ``tri_a``, ``tgt_tpu/ops/triplet.py:363``)."""
    s = _logits(q, k, bias)
    e = torch.exp(s - s.amax(-1, keepdim=True).detach())
    a = e if gate is None else e * _gate(gate)
    if rate > 0.0:
        a = a * dropout_mask(seed, q.shape[1], q.shape[-1], rate)
    if weights_name is not None:
        a = remat.checkpoint_name(a, weights_name)
    dt = q.dtype
    va = torch.einsum("bjhik,bjkdh->bjidh", a.to(dt).float(), v.float())
    recip = 1.0 / e.sum(-1).clamp_min(1e-30)              # (b, j, h, i)
    return (va * recip.permute(0, 1, 3, 2)[:, :, :, None]).to(dt)


def triplet_dense_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor,
                                gate: Optional[torch.Tensor],
                                dva: torch.Tensor,
                                seed: Optional[torch.Tensor] = None,
                                rate: float = 0.0):
    """Plain backward: the formulas of ``_bwd_kernel``
    (``tgt_tpu/ops/pallas/triplet_dense.py:288-324``) with the per-(i, h)
    softmax max, in f32 math over materialised (b, j, h, i, k) tensors; at
    rate > 0 the keep mask multiplies both the dV operand ``a`` and ``dA``
    before dgate, dp and ds (``:299-305``). ``ds`` and ``a`` are rounded to
    the inputs' dtype before the dQ, dK and dV products, as ``_dot`` and
    ``_dot_t`` cast their operands (``:179-189, 316-321``; the identity in
    f32). Returns ``(dq, dk, dv, dbias, dgate)`` in the inputs' dtype;
    ``dgate`` is None when ungated."""
    pn = torch.softmax(_logits(q, k, bias), dim=-1)
    dva32 = dva.float()
    da = torch.einsum("bjidh,bjkdh->bjhik", dva32, v.float())
    keep = 1.0
    if rate > 0.0:
        keep = dropout_mask(seed, q.shape[1], q.shape[-1], rate)
        da = da * keep
    dgate = None
    if gate is not None:
        g = _gate(gate)
        a = pn * g * keep
        dgate = (da * pn * g * (1.0 - g)).sum(1).permute(0, 2, 3, 1)
        dp = da * g
    else:
        a = pn * keep
        dp = da
    ds = pn * (dp - (dp * pn).sum(-1, keepdim=True))
    dbias = ds.sum(1).permute(0, 2, 3, 1)
    dt = q.dtype
    dsr, ar = ds.to(dt).float(), a.to(dt).float()
    dq = torch.einsum("bjhik,bjkdh->bijdh", dsr, k.float())
    dk = torch.einsum("bjhik,bijdh->bjkdh", dsr, q.float())
    dv = torch.einsum("bjhik,bjidh->bjkdh", ar, dva32)
    return (dq.to(dt), dk.to(dt), dv.to(dt), dbias.to(dt),
            None if dgate is None else dgate.to(dt))


# The bf16 kernels run on head-major copies, as tgt_tpu's ``_pack``
# relayouts around its kernels (``triplet_dense.py:334-346, 406-408``): the
# permutations to (b, h, j, i|k, d) and (b, h, i, k). The forward's output
# va (b, j, i, d, h) comes back from KV_ORDER.
Q_ORDER = (0, 4, 2, 1, 3)      # q (b, i, j, d, h) -> (b, h, j, i, d)
KV_ORDER = (0, 4, 1, 2, 3)     # k, v, dva (b, j, k, d, h) -> (b, h, j, k, d)
PAIR_ORDER = (0, 3, 1, 2)      # bias, gate (b, i, k, h) -> (b, h, i, k)


def to_head_major(x: torch.Tensor, order, dp: int) -> torch.Tensor:
    """A contiguous head-major copy of ``x`` (``order`` one of the
    permutations above), its head width zero-padded to ``dp``."""
    return pad_head_dim(x.permute(*order), dp)


def from_head_major(x: torch.Tensor, order, d: int) -> torch.Tensor:
    """The inverse of :func:`to_head_major`: the first ``d`` columns of the
    head-major ``x``, back in the layout that ``order`` came from,
    contiguous."""
    inverse = [order.index(axis) for axis in range(len(order))]
    return x[..., :d].permute(*inverse).contiguous()


def _check_shapes(q, k, v, bias, gate, dva=None, seed=None,
                  rate=0.0) -> None:
    if q.dim() != 5:
        raise ValueError(f"q must be (b, i, j, d, h), got shape {tuple(q.shape)}")
    b, n, nj, d, h = q.shape
    if nj != n:
        raise ValueError(f"q must be square in (i, j), got {tuple(q.shape)}")
    for name, t, want in (("k", k, (b, n, n, d, h)), ("v", v, (b, n, n, d, h)),
                          ("bias", bias, (b, n, n, h)),
                          ("gate", gate, (b, n, n, h)),
                          ("dva", dva, (b, n, n, d, h))):
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"the dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0:
        if seed is None or tuple(seed.shape) != (b, 1):
            raise ValueError(f"rate > 0 needs a (b, 1) = ({b}, 1) seed, got "
                             f"{None if seed is None else tuple(seed.shape)}")
        if seed.dtype != torch.int32 or seed.device != q.device:
            raise TypeError(f"the seed must be int32 on {q.device}, got "
                            f"{seed.dtype} on {seed.device}")


def tiled(n: int) -> bool:
    """Whether a call of ``n`` nodes on the card takes the key-tiled route:
    past ``MAX_NODES``, which only that route takes."""
    return n > MAX_NODES


def _check_kernel_limits(q, k, v, bias, gate, dva=None, rate=0.0) -> None:
    """What both kernels take; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"the triplet kernels run on cpu or cuda, not "
                         f"{q.device}")
    b, n, _, d, h = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if n > MAX_NODES:
        if q.dtype != torch.bfloat16 or gate is not None or rate > 0.0:
            raise ValueError(
                f"past {MAX_NODES} nodes the kernel takes the ungated core "
                f"in bfloat16 at rate 0, got n = {n}, {q.dtype}, "
                f"{'gated' if gate is not None else 'ungated'}, rate {rate}")
        if n > TILED_MAX_NODES:
            raise ValueError(f"the kernel takes at most {TILED_MAX_NODES} "
                             f"nodes, got {n}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes a head width in {HEAD_DIMS}, "
                         f"got {d}")
    if b > 65535:
        raise ValueError(f"the kernel takes at most 65535 batch rows, got {b}")
    for name, t in (("q", q), ("k", k), ("v", v), ("dva", dva)):
        if t is not None and (t.stride(4) != 1 or t.stride(3) != h):
            raise ValueError(f"{name}'s (d, h) axes must be contiguous, "
                             f"strides {t.stride()}")
    for name, t in (("bias", bias), ("gate", gate)):
        if t is not None and t.stride(3) != 1:
            raise ValueError(f"{name}'s h axis must be contiguous, strides "
                             f"{t.stride()}")


def _dropout_args(seed, rate):
    """The kernels' dropout arguments: the seeds' pointer (None at rate 0,
    which selects the kernels without dropout), the threshold and the kept
    value. The kernels read the seed of row b at element b."""
    if rate == 0.0:
        return None, 0, 0.0
    if not seed.is_contiguous():
        raise ValueError(f"the seed must be contiguous, strides "
                         f"{seed.stride()}")
    thresh, scale = dropout_constants(rate)
    return seed.data_ptr(), thresh, scale


_FWD = Entry("triplet_dense_fwd", "triplet_dense_fwd",
             *[PTR] * 7, UINT, FLOAT, *[INT] * 5, LONGS, STREAM)
_FWD_MMA = Entry("triplet_dense_fwd", "triplet_dense_fwd_mma",
                 *[PTR] * 5, LONGS, LONGS, PTR, PTR, UINT, FLOAT, *[INT] * 6,
                 STREAM)
_FWD_INPLACE = Entry("triplet_dense_fwd", "triplet_dense_fwd_inplace",
                     *[PTR] * 7, UINT, FLOAT, *[INT] * 4, LONGS, INT, INT,
                     STREAM)
_FWD_TILED = Entry("triplet_dense_fwd", "triplet_dense_fwd_tiled",
                   *[PTR] * 5, *[INT] * 3, STREAM)
_BWD = Entry("triplet_dense_bwd", "triplet_dense_bwd",
             *[PTR] * 12, UINT, FLOAT, *[INT] * 5, LONGS, STREAM)
_BWD_MMA = Entry("triplet_dense_bwd", "triplet_dense_bwd_mma",
                 *[PTR] * 6, LONGS, LONGS, *[PTR] * 6, LONGS, PTR, UINT, FLOAT,
                 *[INT] * 6, STREAM)
_BWD_TILED = Entry("triplet_dense_bwd", "triplet_dense_bwd_tiled",
                   *[PTR] * 11, LONGS, *[INT] * 6, STREAM)
# rows i per block of the tiled dQ kernel at n nodes: a query, not a launch
_BWD_TILED_ROWS = Entry("triplet_dense_bwd", "triplet_dense_bwd_tiled_rows",
                        INT)


def _pair_strides(t: torch.Tensor):
    """The element strides of a (b, i, k, h) tensor's (b, h, i, k) axes."""
    return strides([t.stride(a) for a in PAIR_ORDER])


def _fwd_mma(q, k, v, bias, gate, seed, rate):
    """The bf16 forward: head-major copies of q, k and v in, the shared body
    (``triplet_fwd_mma.cuh``: one launch), the head-major output moved
    back; bias and gate read in place."""
    b, n, _, d, h = q.shape
    dp = padded_head_dim(d)
    q_t = to_head_major(q, Q_ORDER, dp)
    k_t, v_t = (to_head_major(x, KV_ORDER, dp) for x in (k, v))
    out_t = torch.empty_like(q_t)
    jc, chunks = j_chunks(b * h, n, sm_count(q.device), FWD_BLOCKS_PER_SM)
    seeds, thresh, scale = _dropout_args(seed, rate)
    launch(_FWD_MMA, q, q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
           bias.data_ptr(), None if gate is None else gate.data_ptr(),
           _pair_strides(bias), _pair_strides(bias if gate is None else gate),
           out_t.data_ptr(), seeds, thresh, scale, b, n, dp, h, jc, chunks)
    return from_head_major(out_t, KV_ORDER, d)


# what the in-place loader takes (``triplet_fwd_mma.cuh``,
# ``inplace_fwd_kernel``): its shared memory holds 8 heads up to n = 48 at a
# head width of 8 or 16, and it copies 16-byte pieces of 8 heads
INPLACE_GROUP = 8
INPLACE_MAX_NODES = 48


def reads_in_place(q, k, v, bias, gate) -> bool:
    """Whether the bf16 forward reads this call's layouts in place: n <=
    INPLACE_MAX_NODES, d of 8 or 16, H a multiple of 8, and every piece of
    8 heads 16-byte aligned (data pointers and outer strides). Any other
    shape goes through the head-major copies."""
    b, n, _, d, h = q.shape
    if n > INPLACE_MAX_NODES or d not in (8, 16) or h % INPLACE_GROUP:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st % INPLACE_GROUP == 0 for st in t.stride()[:-1])
               for t in (q, k, v, bias, gate) if t is not None)


def _fwd_inplace(q, k, v, bias, gate, seed, rate):
    """The bf16 forward on the natural layouts in place: one launch of the
    body's in-place loader, one block per (b, 8 heads, chunk of j)."""
    b, n, _, d, h = q.shape
    out = torch.empty((b, n, n, d, h), dtype=q.dtype, device=q.device)
    jc, chunks = j_chunks(b * h // INPLACE_GROUP, n, sm_count(q.device), 1)
    seeds, thresh, scale = _dropout_args(seed, rate)
    launch(_FWD_INPLACE, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           bias.data_ptr(), None if gate is None else gate.data_ptr(),
           out.data_ptr(), seeds, thresh, scale, b, n, d, h,
           _outer_strides(q, k, v, bias, bias if gate is None else gate), jc,
           chunks)
    return out


def _bwd_mma(q, k, v, bias, gate, dva, seed, rate):
    """The bf16 backward: head-major copies in, the shared body
    (``triplet_bwd_mma.cuh``: one panel launch and one ordered reduction),
    dq, dk, dv moved back; dbias and dgate written in place."""
    b, n, _, d, h = q.shape
    dp = padded_head_dim(d)
    q_t = to_head_major(q, Q_ORDER, dp)
    k_t, v_t, do_t = (to_head_major(x, KV_ORDER, dp) for x in (k, v, dva))
    dq_t, dk_t, dv_t = (torch.empty_like(q_t) for _ in range(3))
    jc, chunks = j_chunks(b * h, n, sm_count(q.device))
    partial = torch.empty((1 + (gate is not None), chunks, b, h, n, n),
                          dtype=torch.float32, device=q.device)
    dbias = torch.empty((b, n, n, h), dtype=q.dtype, device=q.device)
    dgate = None if gate is None else torch.empty_like(dbias)
    seeds, thresh, scale = _dropout_args(seed, rate)
    launch(_BWD_MMA, q, q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
           do_t.data_ptr(), bias.data_ptr(),
           None if gate is None else gate.data_ptr(), _pair_strides(bias),
           _pair_strides(bias if gate is None else gate), dq_t.data_ptr(),
           dk_t.data_ptr(), dv_t.data_ptr(), partial.data_ptr(),
           dbias.data_ptr(), None if dgate is None else dgate.data_ptr(),
           _pair_strides(dbias), seeds, thresh, scale, b, n, dp, h, jc, chunks)
    return (from_head_major(dq_t, Q_ORDER, d),
            from_head_major(dk_t, KV_ORDER, d),
            from_head_major(dv_t, KV_ORDER, d), dbias, dgate)


def _bias_head_major(bias: torch.Tensor) -> torch.Tensor:
    """The tiled route's bias: a contiguous (b h, i, k) copy, its key axis
    zero-padded to a multiple of 8."""
    b, n, _, h = bias.shape
    out = bias.new_zeros(b * h, n, -(-n // 8) * 8)
    out[:, :, :n] = bias.permute(0, 3, 1, 2).reshape(b * h, n, n)
    return out


def _fwd_tiled(q, k, v, bias):
    """The bf16 forward past ``MAX_NODES``: head-major copies in, one launch
    of the key-tiled body, the head-major output moved back."""
    b, n, _, d, h = q.shape
    dp = padded_head_dim(d)
    q_t = to_head_major(q, Q_ORDER, dp)
    k_t, v_t = (to_head_major(x, KV_ORDER, dp) for x in (k, v))
    bias_t = _bias_head_major(bias)
    out_t = torch.empty_like(q_t)
    launch(_FWD_TILED, q, q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
           bias_t.data_ptr(), out_t.data_ptr(), b * h, n, dp)
    return from_head_major(out_t, KV_ORDER, d)


def _bwd_tiled(q, k, v, bias, dva):
    """The bf16 backward past ``MAX_NODES``: head-major copies in, the
    key-tiled body's three launches (dQ with the row statistics and
    dbias' partial sums over chunks of rows j; dK and dV; the ordered sum
    of the chunks), dq, dk, dv moved back; dbias written in place."""
    b, n, _, d, h = q.shape
    dp = padded_head_dim(d)
    q_t = to_head_major(q, Q_ORDER, dp)
    k_t, v_t, do_t = (to_head_major(x, KV_ORDER, dp) for x in (k, v, dva))
    bias_t = _bias_head_major(bias)
    dq_t, dk_t, dv_t = (torch.empty_like(q_t) for _ in range(3))
    jc, chunks = j_chunks(b * h * -(-n // _BWD_TILED_ROWS(n)), n,
                          sm_count(q.device), 2)
    stats = torch.empty((b * h, n, n, 4), dtype=torch.float32,
                        device=q.device)
    partial = torch.empty((chunks, b * h, n, n), dtype=torch.float32,
                          device=q.device)
    dbias = torch.empty((b, n, n, h), dtype=q.dtype, device=q.device)
    launch(_BWD_TILED, q, q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
           do_t.data_ptr(), bias_t.data_ptr(), dq_t.data_ptr(),
           dk_t.data_ptr(), dv_t.data_ptr(), stats.data_ptr(),
           partial.data_ptr(), dbias.data_ptr(), _pair_strides(dbias), b, h,
           n, dp, jc, chunks)
    return (from_head_major(dq_t, Q_ORDER, d),
            from_head_major(dk_t, KV_ORDER, d),
            from_head_major(dv_t, KV_ORDER, d), dbias, None)


def _counter(n: int, rate: float) -> str:
    """The counter a call on the card counts under: ``tiled_launches`` past
    ``MAX_NODES``, else ``dropout_launches`` at rate > 0, else
    ``launches``."""
    if tiled(n):
        return "tiled_launches"
    return "dropout_launches" if rate > 0.0 else "launches"


def _outer_strides(*tensors):
    """The three outer element strides of each tensor, in order."""
    return strides([s for t in tensors for s in t.stride()[:3]])


# calls on the card, read by chip_smoke.py and h100bench: at rate 0, at > 0
# (n <= MAX_NODES), and the key-tiled route's past MAX_NODES
@counted("launches", "dropout_launches", "tiled_launches")
def triplet_dense_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor,
                      gate: Optional[torch.Tensor] = None,
                      seed: Optional[torch.Tensor] = None,
                      rate: float = 0.0) -> torch.Tensor:
    """Gated (or, with ``gate=None``, ungated) dense triplet attention
    forward, with dropout at ``rate`` > 0 under the (b, 1) ``seed``, and no
    gradient on the card: a caller that needs one takes
    :func:`triplet_dense`. See the module docstring for the contract. On
    the card, bf16 runs the tensor-core body shared with the legacy
    forward, in place or on head-major copies, f32 the CUDA-core kernel;
    either way one call counts once."""
    _check_shapes(q, k, v, bias, gate, seed=seed, rate=rate)
    if q.device.type == "cpu":
        return triplet_dense_fwd_reference(q, k, v, bias, gate, seed, rate)
    _check_kernel_limits(q, k, v, bias, gate, rate=rate)
    if records_grad((q, k, v, bias, gate)):
        raise RuntimeError("triplet_dense_fwd returns no gradient on the "
                           "card; call triplet_dense, which differentiates "
                           "through the backward kernel")
    b, n, _, d, h = q.shape
    if tiled(n):
        out = _fwd_tiled(q, k, v, bias)
    elif q.dtype == torch.bfloat16:
        if reads_in_place(q, k, v, bias, gate):
            out = _fwd_inplace(q, k, v, bias, gate, seed, rate)
        else:
            out = _fwd_mma(q, k, v, bias, gate, seed, rate)
    else:
        out = torch.empty((b, n, n, d, h), dtype=q.dtype, device=q.device)
        seeds, thresh, scale = _dropout_args(seed, rate)
        launch(_FWD, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               bias.data_ptr(), None if gate is None else gate.data_ptr(),
               out.data_ptr(), seeds, thresh, scale, _DTYPE_CODES[q.dtype], b,
               n, d, h,
               _outer_strides(q, k, v, bias, bias if gate is None else gate))
    count(triplet_dense_fwd, _counter(n, rate))
    return out


@counted("launches", "dropout_launches", "tiled_launches")
def triplet_dense_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, gate: Optional[torch.Tensor],
                      dva: torch.Tensor, seed: Optional[torch.Tensor] = None,
                      rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Gradients ``(dq, dk, dv, dbias, dgate)`` of the forward with respect
    to its inputs, given the cotangent ``dva`` and the forward's ``seed``
    and ``rate``; ``dgate`` is None when ungated. On the card, bf16 runs the
    tensor-core body shared with the legacy backward on head-major copies,
    f32 the CUDA-core kernels; either way one call counts once."""
    _check_shapes(q, k, v, bias, gate, dva, seed, rate)
    if q.device.type == "cpu":
        return triplet_dense_bwd_reference(q, k, v, bias, gate, dva, seed,
                                           rate)
    _check_kernel_limits(q, k, v, bias, gate, dva, rate)
    b, n, _, d, h = q.shape
    if tiled(n):
        grads = _bwd_tiled(q, k, v, bias, dva)
    elif q.dtype == torch.bfloat16:
        grads = _bwd_mma(q, k, v, bias, gate, dva, seed, rate)
    else:
        dq = torch.empty((b, n, n, d, h), dtype=q.dtype, device=q.device)
        dk, dv = torch.empty_like(dq), torch.empty_like(dq)
        dbias = torch.empty((b, n, n, h), dtype=q.dtype, device=q.device)
        dgate = None if gate is None else torch.empty_like(dbias)
        seeds, thresh, scale = _dropout_args(seed, rate)
        launch(_BWD, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               bias.data_ptr(), None if gate is None else gate.data_ptr(),
               dva.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               dbias.data_ptr(), None if dgate is None else dgate.data_ptr(),
               seeds, thresh, scale, _DTYPE_CODES[q.dtype], b, n, d, h,
               _outer_strides(q, k, v, bias, bias if gate is None else gate,
                              dva))
        grads = dq, dk, dv, dbias, dgate
    count(triplet_dense_bwd, _counter(n, rate))
    return grads


class TripletDenseCore(torch.autograd.Function):
    """The dense core with its gradient: forward :func:`triplet_dense_fwd`,
    backward :func:`triplet_dense_bwd`, as ``_dense_core`` with its
    ``defvjp`` (``tgt_tpu/ops/pallas/triplet_dense.py:363-445``). Only the
    inputs and the seed are kept for the backward, which recomputes the
    logits and the keep mask; ``seed`` and ``rate`` get no gradient. The
    output is the value the ``tri_va`` remat policy names
    (``tgt_tpu/ops/pallas/triplet_dense.py:768``): under that policy a
    replay takes the forward's output and launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gate, seed, rate):
        ctx.save_for_backward(q, k, v, bias, gate, seed)
        ctx.rate = rate
        return remat.saved_output("tri_va", lambda: triplet_dense_fwd(
            q, k, v, bias, gate, seed, rate))

    @staticmethod
    def backward(ctx, dva):
        q, k, v, bias, gate, seed = ctx.saved_tensors
        return (*triplet_dense_bwd(q, k, v, bias, gate, dva.contiguous(),
                                   seed, ctx.rate), None, None)


def triplet_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor,
                  gate: Optional[torch.Tensor] = None,
                  seed: Optional[torch.Tensor] = None,
                  rate: float = 0.0) -> torch.Tensor:
    """Differentiable dense triplet attention core (see the module
    docstring for the contract)."""
    return TripletDenseCore.apply(q, k, v, bias, gate, seed, rate)
