"""The least time of a triplet core call on the card: the larger of its
bytes (each input read once, each output written once) over the memory
rate and its operations over the peak rate. Shapes are the cores' own:
b rows, n nodes, d head width, h heads, ``itemsize`` bytes per element."""
from __future__ import annotations

from h100bench.yardstick import peaks


def seconds(nbytes: float, flops: float, itemsize: int) -> float:
    peak = peaks.BF16_FLOPS if itemsize == 2 else peaks.F32_FLOPS
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peak)


def dense_fwd(b, n, d, h, itemsize, gated=True):
    """q, k, v (b, n, n, d, h), bias and gate (b, n, n, h) in; va out;
    q.K and a.V: 4 d operations per (b, j, i, k, h)."""
    pair, vec = b * n * n * h, b * n * n * d * h
    nbytes = (3 * vec + (2 if gated else 1) * pair + vec) * itemsize
    return nbytes, 4.0 * b * n ** 3 * h * d


def dense_bwd(b, n, d, h, itemsize, gated=True):
    """q, k, v, bias, gate and dva in; dq, dk, dv, dbias, dgate out; five
    products: 10 d operations per (b, j, i, k, h)."""
    pair, vec = b * n * n * h, b * n * n * d * h
    g = 2 if gated else 1
    nbytes = ((3 * vec + g * pair + vec) + (3 * vec + g * pair)) * itemsize
    return nbytes, 10.0 * b * n ** 3 * h * d


def agg_fwd(b, n, d, h, itemsize):
    """a (b, n, n, h) and v (b, n, n, d, h) in, va out; 2 d per (b, j, i,
    k, h)."""
    nbytes = (b * n * n * h + 2 * b * n * n * d * h) * itemsize
    return nbytes, 2.0 * b * n ** 3 * d * h


def agg_bwd(b, n, d, h, itemsize):
    """a, v and dva in, da and dv out; 4 d per (b, j, i, k, h)."""
    nbytes = (2 * b * n * n * h + 3 * b * n * n * d * h) * itemsize
    return nbytes, 4.0 * b * n ** 3 * d * h


CORES = {"dense_fwd": dense_fwd, "dense_bwd": dense_bwd,
         "agg_fwd": agg_fwd, "agg_bwd": agg_bwd}


def call_seconds(core: str, b, n, d, h, itemsize) -> float:
    nbytes, flops = CORES[core](b, n, d, h, itemsize)
    return seconds(nbytes, flops, itemsize)
