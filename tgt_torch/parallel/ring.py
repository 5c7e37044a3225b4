"""Edge-block (pair-axis) ring execution of the triplet interaction
(counterpart of tgt_tpu/parallel/ring.py).

The edge channel is sharded over the pair axis on its first node axis: the
rank at pair index ``p`` of ``P`` holds the i-rows ``[p N/P, (p+1) N/P)``
of ``e`` (``mesh.PairAxis``). For the in direction

  out[i, j] = sum_k softmax_k(Q[i, j] . K[j, k] + E[i, k]) sig(G[i, k]) V[j, k]

Q, the bias and gate rows and the output rows are i-local, while K and V
are needed for every j: their row blocks rotate around the ring
(``ring_pass``), and at step ``t`` this rank holds the block of rank
``(p - t) mod P``, whose output columns it computes. The out direction is
the same computation on pair-transposed K, V, bias and gate
(``_pair_transpose``, an all-to-all). tgt_tpu passes K/V ``P`` times and
discards the last pass; the port makes the ``P - 1`` passes it uses. The
aggregate variants ring only V: their N^2 weights are i-row-local.

The block math is einsums, as tgt_tpu leaves it to XLA: the pair path
launches none of the hand-written triplet kernels (tgt_tpu refuses its
Pallas kernels under a pair mesh; the Trainer raises where it does).

The collectives are ``torch.autograd.Function``s over the pair group:
``ring_pass`` (send to ``p + 1``, receive from ``p - 1``; its backward is
the reverse ring), ``_pair_transpose`` (an all-to-all; the global transpose
is its own inverse, so its backward is itself) and ``_gather_rows`` (an
all-gather; its backward sums the gradient that every pair rank holds for
each row block, which ``_reduce_rows`` does with one all-to-all and a sum
in rank order). They move bytes: every tensor goes as a flat uint8 view,
so any dtype travels bit for bit. The transport is chosen by the group's
backend, and named by ``transport``:

- ``nccl``: the collectives run on the device;
- ``gloo``: CPU tensors, as gloo runs them;
- ``gloo-host``: CUDA tensors over gloo, which moves CUDA tensors only for
  all-reduce and broadcast: each collective copies its input to pinned
  host memory, runs there and copies its output back (two ranks can then
  share one card). The copies happen in these functions and nowhere else.

Any other backend raises. ``PairAxis.stats`` counts each call and the
bytes it sends to other ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from tgt_torch.ops.common import dropout, layernorm, linear
from tgt_torch.parallel.mesh import PairAxis


def transport(axis: PairAxis, x: torch.Tensor) -> str:
    """How the pair collectives move ``x`` over ``axis``'s group."""
    backend = str(dist.get_backend(axis.group)).lower()
    if backend == "nccl":
        if not x.is_cuda:
            raise ValueError("the pair axis's NCCL group moves CUDA tensors "
                             f"only, not {x.device}")
        return "nccl"
    if backend == "gloo":
        return "gloo-host" if x.is_cuda else "gloo"
    raise ValueError(f"the pair axis has no transport for the {backend!r} "
                     f"backend (known: nccl, gloo)")


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _collective(axis: PairAxis, fn, out: torch.Tensor, inp: torch.Tensor,
                sent: int) -> None:
    """``fn(out, inp)`` on flat byte buffers over ``axis``'s group,
    staged through host memory for ``gloo-host``; counts ``sent`` bytes."""
    if transport(axis, inp) == "gloo-host":
        # pinned buffers, which PyTorch's host allocator caches
        pin = inp.is_cuda
        host_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=pin)
        host_in.copy_(inp)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=pin)
        fn(host, host_in)
        out.copy_(host)
    else:
        fn(out, inp)
    axis.stats["calls"] += 1
    axis.stats["bytes"] += sent


def _shift(axis: PairAxis, x: torch.Tensor, step: int) -> torch.Tensor:
    """Send ``x`` to pair index ``p + step`` and receive the tensor of
    ``p - step`` (mod P)."""
    if axis.group is None or axis.size == 1:
        return x
    to = axis.ranks[(axis.index + step) % axis.size]
    frm = axis.ranks[(axis.index - step) % axis.size]
    src = _bytes(x)
    out = torch.empty_like(src)

    def send_recv(o, i):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, i, to, axis.group),
            dist.P2POp(dist.irecv, o, frm, axis.group)])
        for req in reqs:
            req.wait()

    _collective(axis, send_recv, out, src, src.numel())
    return out.view(x.dtype).reshape(x.shape)


def _all_to_all(axis: PairAxis, x: torch.Tensor) -> torch.Tensor:
    """``x`` (P, ...): block s goes to pair index s; returns (P, ...) whose
    block r came from pair index r."""
    if axis.group is None:
        return x
    src = _bytes(x)
    out = torch.empty_like(src)
    _collective(axis, lambda o, i: dist.all_to_all_single(
        o, i, group=axis.group), out, src,
        src.numel() * (axis.size - 1) // axis.size)
    return out.view(x.dtype).reshape(x.shape)


_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _all_gather(axis: PairAxis, x: torch.Tensor) -> torch.Tensor:
    """(P, *x.shape): every pair rank's ``x`` in pair order."""
    if axis.group is None:
        return x[None]
    src = _bytes(x)
    out = torch.empty(axis.size * src.numel(), dtype=torch.uint8,
                      device=x.device)
    _collective(axis, lambda o, i: _gather_into(o, i, group=axis.group),
                out, src, src.numel() * (axis.size - 1))
    return out.view(x.dtype).reshape(axis.size, *x.shape)


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _shift(axis, x, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(ctx.axis, grad, -1), None


def ring_pass(x: torch.Tensor, axis: PairAxis) -> torch.Tensor:
    """Send to the next rank on the ring (wrapping); receive from the
    previous one."""
    return _RingPass.apply(x, axis)


def _transpose(axis: PairAxis, x: torch.Tensor) -> torch.Tensor:
    b, i_loc, n = x.shape[:3]
    p = axis.size
    if n % p:
        raise ValueError(f"pair-sharded node axis {n} must divide the ring "
                         f"size {p} (pad N to a multiple of the pair axis)")
    blk = n // p
    rest = x.shape[3:]
    # column block s of this rank's rows goes to pair index s
    xs = x.reshape(b, i_loc, p, blk, *rest).movedim(2, 0)
    xt = _all_to_all(axis, xs)                      # (p, b, i_loc, blk, ...)
    # block r holds rows i of rank r: the global i axis, then the swap
    xt = xt.movedim(0, 1).reshape(b, p * i_loc, blk, *rest)
    return xt.transpose(1, 2).contiguous()          # (b, blk, N, ...)


class _PairTranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _transpose(axis, x)

    @staticmethod
    def backward(ctx, grad):
        return _transpose(ctx.axis, grad), None


def _pair_transpose(x: torch.Tensor, axis: PairAxis) -> torch.Tensor:
    """Transpose the two node axes of an i-sharded (b, i_loc, N, ...)
    tensor, returning the result sharded the same way."""
    return _PairTranspose.apply(x, axis)


def _pair_transpose_bias(bias: torch.Tensor, axis: PairAxis) -> torch.Tensor:
    """Same pair-transpose for (b, i_loc, N, h) bias tensors."""
    return _pair_transpose(bias, axis)


def _reduce_rows(axis: PairAxis, grad: torch.Tensor) -> torch.Tensor:
    """(b, N, ...) held by every pair rank -> (b, i_loc, ...): the sum over
    the pair ranks of their gradients of this rank's rows, in pair order
    (a reduce-scatter as one all-to-all and a local sum)."""
    b, n = grad.shape[:2]
    blocks = grad.reshape(b, axis.size, n // axis.size,
                          *grad.shape[2:]).movedim(1, 0)
    got = _all_to_all(axis, blocks)                 # block r: rank r's
    total = got[0].float()
    for r in range(1, axis.size):
        total = total + got[r].float()
    return total.to(grad.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        g = _all_gather(axis, x)                    # (P, b, i_loc, ...)
        return g.movedim(0, 1).reshape(x.shape[0], -1, *x.shape[2:])

    @staticmethod
    def backward(ctx, grad):
        if ctx.axis.group is None:
            return grad, None
        return _reduce_rows(ctx.axis, grad.contiguous()), None


def _gather_rows(x_local: torch.Tensor, axis: PairAxis) -> torch.Tensor:
    """(b, i_loc, ...) row blocks -> full (b, N, ...), the same on every
    pair rank (tgt_tpu/parallel/pair_layer.py:97-101)."""
    return _GatherRows.apply(x_local, axis)


# ---------------------------------------------------------------------------
# triplet attention
# ---------------------------------------------------------------------------

def _block_source(my: int, t: int, p: int) -> int:
    """The pair index whose K/V block this rank holds at ring step ``t``:
    blocks travel to ``p + 1``, so it came from ``(my - t) mod p``."""
    return (my - t) % p


def _block_cols(src: int, j_blk: int) -> slice:
    return slice(src * j_blk, (src + 1) * j_blk)


def _place(out: Optional[torch.Tensor], blk: torch.Tensor, cols: slice,
           n: int) -> torch.Tensor:
    """Write the (b, i_loc, j_blk, d, h) block into columns ``cols`` of
    the (b, i_loc, n, d, h) output, made on the first block."""
    if out is None:
        out = blk.new_zeros(blk.shape[:2] + (n,) + blk.shape[3:])
    out[:, :, cols] = blk
    return out


def _block_attention(q_blk, k_blk, v_blk, bias, gate, scale,
                     dropout_rate=0.0, generator=None):
    """One (i_local, j_block) tile of per-j biased (optionally gated)
    attention.

    q_blk: (b, i_loc, j_blk, d, h), Q rows for local i, block j columns;
    k_blk/v_blk: (b, j_blk, N, d, h), K/V rows of the j block;
    bias/gate: (b, i_loc, N, h), the additive bias over k (mask folded in);
    gate None for the ungated variants. Returns (b, i_loc, j_blk, d, h).
    """
    s = torch.einsum("bijdh,bjkdh->bijhk", q_blk * scale, k_blk)
    s = s + bias.transpose(2, 3)[:, :, None]
    a = torch.softmax(s.float(), dim=-1)
    if gate is not None:
        a = a * torch.sigmoid(gate.transpose(2, 3).float())[:, :, None]
    if dropout_rate > 0.0:
        # a mask per tile: each (i, j, k) element is drawn on one rank only
        a = dropout(a, dropout_rate, False, generator)
    return torch.einsum("bijhk,bjkdh->bijdh", a.to(v_blk.dtype), v_blk)


def ring_triplet_direction(q_local, k_local, v_local, bias_local, gate_local,
                           scale: float, axis: PairAxis,
                           attention_dropout: float = 0.0,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """One triplet direction under i-block sharding with a j-block ring.

    q_local (b, i_loc, N, d, h): Q[i, j] for the local i rows, all j;
    k_local, v_local (b, j_loc, N, d, h): K[j, k], V[j, k] for the local j
    rows; bias_local, gate_local (b, i_loc, N, h): E[i, k] and G[i, k] plus
    the mask. Returns (b, i_loc, N, d, h), the output rows for local i."""
    p, my = axis.size, axis.index
    j_blk = k_local.shape[1]
    kv = torch.stack((k_local, v_local))
    out = None
    for t in range(p):
        cols = _block_cols(_block_source(my, t, p), j_blk)
        blk = _block_attention(q_local[:, :, cols], kv[0], kv[1], bias_local,
                               gate_local, scale, attention_dropout,
                               generator)
        out = _place(out, blk, cols, q_local.shape[2])
        if t < p - 1:
            kv = ring_pass(kv, axis)
    return out


def triplet_attention_ring(module, e_local: torch.Tensor,
                           mask_local: torch.Tensor, axis: PairAxis, *,
                           attention_dropout: float = 0.0,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """``TripletAttention`` (gated or ungated, read from ``module``'s own
    parameters) under pair-axis i-block sharding. e_local (b, i_loc, N, W);
    mask_local (b, i_loc, N, 1) additive. The gathered result is the
    unsharded layer's; the layer norm is row-local, so it commutes with
    the sharding. Dropout draws from ``generator``, which the caller folds
    with the pair index."""
    b, i_loc, n, w = e_local.shape
    h = module.num_heads
    d = w // h
    scale = d ** -0.5
    rate = 0.0 if deterministic else float(attention_dropout)
    e_ln = layernorm(module.tri_ln_e, e_local)
    m3 = mask_local[..., 0]

    def heads(x):
        return x.reshape(b, i_loc, n, d, h)

    def projections(which):
        q, k, v = (heads(t) for t in linear(
            getattr(module, f"lin_QKV_{which}"), e_ln).chunk(3, dim=-1))
        eg = linear(getattr(module, f"{module.bias_name}_{which}"), e_ln)
        e_b, g_b = eg.chunk(2, dim=-1) if module.gated else (eg, None)
        return q, k, v, e_b + m3[..., None], (
            None if g_b is None else g_b + m3[..., None])

    # in direction: q rows are i-local; k/v rows are j-local (the i axis of
    # e_local is the j-row owner axis of K/V)
    q, k, v, bias, gate = projections("in")
    va_in = ring_triplet_direction(q, k, v, bias, gate, scale, axis, rate,
                                   generator)
    # out direction: out[i, j] = sum_k softmax_k(Q[i,j].K[k,j] + E[k,i])
    # V[k,j], the in direction on pair-transposed K, V, bias and gate
    q2, k2, v2, bias2, gate2 = projections("out")
    va_out = ring_triplet_direction(
        q2, _pair_transpose(k2, axis), _pair_transpose(v2, axis),
        _pair_transpose_bias(bias2, axis),
        None if gate2 is None else _pair_transpose_bias(gate2, axis),
        scale, axis, rate, generator)
    va = torch.cat([va_in, va_out], dim=-1).reshape(b, i_loc, n, 2 * w)
    return linear(module.lin_O, va)


# ---------------------------------------------------------------------------
# triplet aggregation
# ---------------------------------------------------------------------------

def ring_aggregate_direction(a_local: torch.Tensor, v_local: torch.Tensor,
                             axis: PairAxis) -> torch.Tensor:
    """One triplet-aggregate direction under i-block sharding:
    out[i, j] = sum_k a[i, k, h] v[j, k, d, h]; the weights are N^2 and
    i-row-local, and only the V j-blocks ring around.

    a_local (b, i_loc, N, h); v_local (b, j_loc, N, d, h). Returns
    (b, i_loc, N, d, h)."""
    p, my = axis.size, axis.index
    j_blk = v_local.shape[1]
    out, v_blk = None, v_local
    for t in range(p):
        blk = torch.einsum("bikh,bjkdh->bijdh", a_local, v_blk)
        out = _place(out, blk, _block_cols(_block_source(my, t, p), j_blk),
                     a_local.shape[2])
        if t < p - 1:
            v_blk = ring_pass(v_blk, axis)
    return out


def triplet_aggregate_ring(module, e_local: torch.Tensor,
                           mask_local: torch.Tensor, axis: PairAxis, *,
                           attention_dropout: float = 0.0,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """``TripletAggregate`` (gated or ungated) under pair-axis i-block
    sharding, with the gated variant's unmasked out direction (reference
    lib/tgt/layers/triplet.py:63-64). Dropout applies to the N^2 weights,
    from ``generator``, which the caller folds with the pair index."""
    b, i_loc, n, w = e_local.shape
    h = module.num_heads
    d = w // h
    e_ln = layernorm(module.tri_ln_e, e_local)
    v_in, v_out = (v.reshape(b, i_loc, n, d, h) for v in
                   linear(module.lin_V, e_ln).chunk(2, dim=-1))
    if module.gated:
        e_in, g_in, e_out, g_out = linear(module.lin_EG, e_ln).chunk(4, -1)
    else:
        e_in, e_out = linear(module.lin_E, e_ln).chunk(2, dim=-1)

    def drop(a):
        return dropout(a, attention_dropout, deterministic, generator)

    # in direction: the weights (i, k) are row-local
    a_in = torch.softmax(e_in + mask_local, dim=2)
    if module.gated:
        a_in = a_in * torch.sigmoid(g_in + mask_local)
    va_in = ring_aggregate_direction(drop(a_in), v_in, axis)

    # out direction: pair-transposed weights and V, then the same ring
    e_out_t = _pair_transpose_bias(
        e_out if module.gated else e_out + mask_local, axis)
    a_out = torch.softmax(e_out_t, dim=2)
    if module.gated:
        # the reference's out direction: softmax and gate not masked
        a_out = a_out * torch.sigmoid(_pair_transpose_bias(g_out, axis))
    va_out = ring_aggregate_direction(drop(a_out),
                                      _pair_transpose(v_out, axis), axis)
    va = torch.cat([va_in, va_out], dim=-1).reshape(b, i_loc, n, 2 * w)
    return linear(module.lin_O, va)
