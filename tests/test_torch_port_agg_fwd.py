"""The aggregate forward's two routes (``tgt_torch/csrc/triplet_aggregate_fwd.cu``)
on the CPU.

1. ``agg_fwd_body_reference``, the bf16 body's partition in plain PyTorch
   (blocks of 8 or 16 heads, chunks of rows j walked in order, every row i,
   f32 sums cast once), against tgt_tpu's ``_agg_core`` in interpret mode on
   the same numpy inputs: contiguous and pair-transposed V, n = 20 and 24
   (padded to the body's 32 rows), 8 and 16 heads per block, chunks of j
   that do and do not divide n. In f32 within 1e-5 of max|ref| (the same
   sums in another order). In bf16 on bf16-valued inputs: against
   ``_agg_core``'s f32 sums of them within 2^-8 of max|ref| (the body rounds
   its f32 sum once, at most half a bf16 step, 2^-8 of the value), and
   against ``_agg_core`` run in bf16 within 2^-7 of max|ref| (both round an
   f32 sum of the same products, summed in another order, once: at most one
   bf16 step apart).
2. The body's partition bitwise equal to ``triplet_aggregate_fwd_reference``
   on integer-valued inputs (every partial sum is exact, so any order gives
   the same bits), in f32 and in bf16.
3. ``agg_fwd_route`` and ``agg_fwd_blocks``: which calls take the body, and
   its partition near one wave of an H100's 132 SMs.
4. The wrapper on CPU tensors: the plain version, whatever the private
   ``_panel_route`` keyword says, and no launch counted.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tgt_torch.ops.kernels.triplet_aggregate import (
    agg_fwd_blocks, agg_fwd_body_reference, agg_fwd_route,
    triplet_aggregate_fwd, triplet_aggregate_fwd_reference)

from test_torch_port_aggregate import core_inputs, jax_agg

torch.set_num_threads(1)

F32_TOL = 1e-5          # of max|ref|: the same f32 sums in another order
ROUNDED_TOL = 2.0 ** -8  # of max|ref|: one rounding of an f32 sum to bf16
BF16_TOL = 2.0 ** -7     # of max|ref|: two such roundings, one step apart


def assert_scaled_close(got, want, tol, name=""):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _bf16_valued(x):
    return np.asarray(torch.from_numpy(np.asarray(x, np.float32))
                      .bfloat16().float())


# -- 1. the body's partition against _agg_core --------------------------------

# (n, heads per block, rows j per block, transposed V) at H = 16, d = 8:
# padded n, both head blocks, chunks that divide n and that do not
PARTITIONS = [(20, 8, 5, False), (20, 16, 6, True), (24, 8, 12, True),
              (24, 16, 7, False), (24, 8, 24, False), (20, 16, 1, False)]
PARTITION_IDS = [f"n{n}hb{hb}jc{jc}{'T' if t else ''}"
                 for n, hb, jc, t in PARTITIONS]


def _view(v, transposed):
    return v.transpose(1, 2) if transposed else v


class TestBodyAgainstAggCore:
    @pytest.mark.parametrize("case", PARTITIONS, ids=PARTITION_IDS)
    def test_f32(self, case):
        n, hb, jc, tr = case
        a, v, _ = core_inputs(2, n, 128, 16, seed=100 + n)
        want = np.array(jax_agg(jnp.asarray(a), jnp.asarray(v), tr))
        got = agg_fwd_body_reference(torch.from_numpy(a),
                                     _view(torch.from_numpy(v), tr), hb, jc)
        assert got.dtype == torch.float32
        assert_scaled_close(got, torch.from_numpy(want), F32_TOL)

    @pytest.mark.parametrize("case", PARTITIONS, ids=PARTITION_IDS)
    def test_bf16_against_f32_sums(self, case):
        n, hb, jc, tr = case
        a, v, _ = (_bf16_valued(x) for x in core_inputs(2, n, 128, 16, seed=110 + n))
        want = np.array(jax_agg(jnp.asarray(a), jnp.asarray(v), tr))
        got = agg_fwd_body_reference(torch.from_numpy(a).bfloat16(),
                                     _view(torch.from_numpy(v).bfloat16(), tr),
                                     hb, jc)
        assert got.dtype == torch.bfloat16
        assert_scaled_close(got, torch.from_numpy(want), ROUNDED_TOL)

    @pytest.mark.parametrize("case", PARTITIONS, ids=PARTITION_IDS)
    def test_bf16_against_bf16(self, case):
        n, hb, jc, tr = case
        a, v, _ = core_inputs(2, n, 128, 16, seed=120 + n)
        want = jax_agg(jnp.asarray(a, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), tr)
        got = agg_fwd_body_reference(torch.from_numpy(a).bfloat16(),
                                     _view(torch.from_numpy(v).bfloat16(), tr),
                                     hb, jc)
        assert_scaled_close(got, torch.from_numpy(np.array(want.astype(jnp.float32))),
                            BF16_TOL)


# -- 2. bitwise on exact sums ----------------------------------------------------

def integer_inputs(b, n, d, h, seed, transposed):
    rs = np.random.RandomState(seed)
    a = torch.from_numpy(rs.randint(-3, 4, size=(b, n, n, h)).astype(np.float32))
    v = torch.from_numpy(rs.randint(-3, 4, size=(b, n, n, d, h)).astype(np.float32))
    return a, _view(v, transposed)


# (n, d, h, heads per block, rows j per block, transposed V)
EXACT = [(16, 8, 8, 8, 4, False), (20, 16, 16, 16, 6, True),
         (13, 24, 16, 8, 5, False), (24, 32, 8, 8, 24, True),
         (9, 8, 12, 8, 2, False)]
EXACT_IDS = [f"n{n}d{d}h{h}hb{hb}jc{jc}{'T' if t else ''}"
             for n, d, h, hb, jc, t in EXACT]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EXACT, ids=EXACT_IDS)
def test_bitwise_on_exact_sums(case, dtype):
    n, d, h, hb, jc, tr = case
    a, v = (x.to(dtype) for x in integer_inputs(2, n, d, h, 130 + n, tr))
    got = agg_fwd_body_reference(a, v, hb, jc)
    assert got.dtype == dtype
    assert torch.equal(got, triplet_aggregate_fwd_reference(a, v))


# -- 3. the route and the partition ----------------------------------------------

CONTIGUOUS = lambda n, d, h: (n * n * d * h, n * d * h, d * h)   # noqa: E731
TRANSPOSED = lambda n, d, h: (n * n * d * h, d * h, n * d * h)   # noqa: E731

ROUTES = [
    # every TGT-Agx2 bucket, both V layouts: the body
    *[((torch.bfloat16, n, 16, 16, layout(n, 16, 16), True), "body")
      for n in (24, 32, 40, 48, 56) for layout in (CONTIGUOUS, TRANSPOSED)],
    # the F3 head widths at n = 48: d = 8, 24 and 32
    ((torch.bfloat16, 48, 8, 16, CONTIGUOUS(48, 8, 16), True), "body"),
    ((torch.bfloat16, 48, 24, 16, CONTIGUOUS(48, 24, 16), True), "body"),
    ((torch.bfloat16, 48, 32, 16, CONTIGUOUS(48, 32, 16), True), "body"),
    ((torch.bfloat16, 64, 16, 16, CONTIGUOUS(64, 16, 16), True), "body"),
    # n = 56 at d = 32: A's staging and the stages do not fit one block
    ((torch.bfloat16, 56, 32, 16, CONTIGUOUS(56, 32, 16), True), "panel"),
    # the F3 node counts: A's fragments would not fit the registers
    ((torch.bfloat16, 80, 16, 16, CONTIGUOUS(80, 16, 16), True), "panel"),
    ((torch.bfloat16, 128, 16, 16, CONTIGUOUS(128, 16, 16), True), "panel"),
    # f32 keeps the panel loop (TF32 keeps too few bits)
    ((torch.float32, 48, 16, 16, CONTIGUOUS(48, 16, 16), True), "panel"),
    # H not a multiple of 8, d not a multiple of 8 or above 32
    ((torch.bfloat16, 48, 16, 12, CONTIGUOUS(48, 16, 12), True), "panel"),
    ((torch.bfloat16, 48, 12, 16, CONTIGUOUS(48, 12, 16), True), "panel"),
    ((torch.bfloat16, 48, 64, 16, CONTIGUOUS(48, 64, 16), True), "panel"),
    # misaligned pointers or strides
    ((torch.bfloat16, 48, 16, 16, CONTIGUOUS(48, 16, 16), False), "panel"),
    ((torch.bfloat16, 48, 16, 16, (1 + 48 * 48 * 256, 48 * 256, 256), True),
     "panel"),
]


@pytest.mark.parametrize("args,want", ROUTES)
def test_route(args, want):
    assert agg_fwd_route(*args) == want


# (b, n, d, h) -> (heads per block, rows j per block) on 132 SMs: 16 heads
# up to n = 48 at d <= 16, 8 above; 128 blocks at the served batch and the
# training micro-batch
BLOCKS = [((16, 48, 16, 16), (16, 6)), ((32, 48, 16, 16), (16, 12)),
          ((16, 24, 16, 16), (16, 3)), ((16, 56, 16, 16), (8, 14)),
          ((32, 56, 16, 16), (8, 28)), ((32, 48, 32, 16), (8, 24)),
          ((16, 48, 16, 32), (16, 12)), ((16, 48, 16, 8), (8, 6)),
          ((1, 48, 16, 16), (16, 1)), ((256, 48, 16, 16), (16, 48))]


@pytest.mark.parametrize("shape,want", BLOCKS)
def test_blocks(shape, want):
    assert agg_fwd_blocks(*shape, 132) == want


@pytest.mark.parametrize("b,n", [(16, n) for n in (24, 32, 40, 48, 56)]
                         + [(32, n) for n in (24, 32, 40, 48, 56)])
def test_blocks_near_one_wave(b, n):
    hb, jc = agg_fwd_blocks(b, n, 16, 16, 132)
    blocks = b * (16 // hb) * -(-n // jc)
    assert 0.7 * 132 <= blocks <= 132


# -- 4. the wrapper on the CPU ------------------------------------------------------

@pytest.mark.parametrize("panel_route", [False, True])
def test_cpu_wrapper_is_the_plain_version(panel_route):
    a, v = (x.bfloat16() for x in integer_inputs(1, 16, 16, 16, 140, True))
    a = a / 7.0
    before = (triplet_aggregate_fwd.launches, triplet_aggregate_fwd.body_launches)
    got = triplet_aggregate_fwd(a, v, _panel_route=panel_route)
    assert torch.equal(got, triplet_aggregate_fwd_reference(a, v))
    assert (triplet_aggregate_fwd.launches,
            triplet_aggregate_fwd.body_launches) == before
