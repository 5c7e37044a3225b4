"""The aggregate backward's two routes (``tgt_torch/csrc/triplet_aggregate_bwd.cu``)
on the CPU.

1. The plain backward ``triplet_aggregate_bwd_reference`` in bf16 against
   ``jax.vjp`` of tgt_tpu's ``_agg_core`` in interpret mode, in bf16, on the
   same numpy inputs, contiguous and pair-transposed V, at b=2, N=8, W=128,
   H=16 (d=8), a geometry that passes the JAX kernel's lane rule.
2. ``agg_bwd_body_reference``, the bf16 body's partition in plain PyTorch
   (8-head groups, tiles of k rows, j in order, dA cast once per tile),
   against the plain backward: bitwise on integer-valued f32 inputs (every
   partial sum is exact, so any order gives the same bits), within f32
   rounding on random ones, and within one bf16 step in bf16, at tile sizes
   that do and do not divide n, H not a multiple of the group, and the
   pair-transposed V.
3. ``agg_bwd_route`` and ``agg_bwd_heads_per_block``: which calls take the
   body, and how many heads its blocks take.
4. The wrapper on CPU tensors: the plain version, whatever the private
   ``_panel_route`` keyword says, and no launch counted.
5. The body's anatomy tool (``tgt_torch/agg_bwd_anatomy.py``, run on the
   card) still finds the source text each of its variants edits.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_torch import agg_bwd_anatomy
from tgt_torch.ops.kernels.triplet_aggregate import (
    BODY_K_TILE, MAX_NODES, agg_bwd_body_reference, agg_bwd_heads_per_block,
    agg_bwd_route,
    triplet_aggregate_bwd, triplet_aggregate_bwd_reference)

from test_torch_port_aggregate import core_inputs, jax_agg

torch.set_num_threads(1)

# bf16 against bf16: both sides sum in f32 in another order and round the
# result to bf16 (one step is at most 2^-7 of the value); 2^-6 of max|ref|
# holds one such step. The card's kernel checks hold 1e-2 of max|ref|.
BF16_TOL = 2.0 ** -6
# the same sums in f32 in another order
F32_TOL = 1e-6


def _bf(x):
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


def assert_scaled_close(got, want, tol, name):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


# -- 1. the plain backward in bf16 against _agg_core ----------------------------

class TestPlainBackwardBf16:
    @pytest.mark.parametrize("transpose_v", [False, True],
                             ids=["contiguous", "transposed"])
    def test_matches_agg_core_vjp_in_bf16(self, transpose_v):
        a, v, dva = (np.asarray(_bf(x).float()) for x in core_inputs(2, 8, 128, 16, seed=80))
        _, vjp = jax.vjp(lambda a_, v_: jax_agg(a_, v_, transpose_v),
                         jnp.asarray(a, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
        want = vjp(jnp.asarray(dva, jnp.bfloat16))
        vt = _bf(v).transpose(1, 2) if transpose_v else _bf(v)
        got = triplet_aggregate_bwd_reference(_bf(a), vt, _bf(dva))
        # the reference's dv is the gradient of the view it was given
        got_dv = got[1].transpose(1, 2) if transpose_v else got[1]
        for name, g, w in (("da", got[0], want[0]), ("dv", got_dv, want[1])):
            assert g.dtype == torch.bfloat16, name
            assert_scaled_close(g, torch.tensor(np.asarray(w, np.float32)),
                                BF16_TOL, name)


# -- 2. the body's partition against the plain backward -------------------------

def body_inputs(b, n, d, h, seed, transposed=False, integer=False):
    rs = np.random.RandomState(seed)

    def draw(*shape):
        if integer:   # small integers: every product and partial sum is exact
            return rs.randint(-3, 4, size=shape).astype(np.float32)
        return rs.randn(*shape).astype(np.float32)

    a = torch.from_numpy(draw(b, n, n, h))
    v = torch.from_numpy(draw(b, n, n, d, h))
    dva = torch.from_numpy(draw(b, n, n, d, h))
    return a, (v.transpose(1, 2) if transposed else v), dva


# (n, d, h, k_tile, transposed V): the kernel's tile (BODY_K_TILE) and a
# smaller one, each dividing n and not, n below one tile, two head groups
# and H not a multiple of the group
PARTITIONS = [(16, 8, 8, 8, False), (16, 16, 16, BODY_K_TILE, False),
              (20, 8, 16, 8, False), (20, 16, 8, BODY_K_TILE, True),
              (12, 32, 8, BODY_K_TILE, False), (13, 24, 12, 8, True)]
PARTITION_IDS = [f"n{n}d{d}h{h}kt{kt}{'T' if t else ''}"
                 for n, d, h, kt, t in PARTITIONS]


class TestBodyPartition:
    @pytest.mark.parametrize("case", PARTITIONS, ids=PARTITION_IDS)
    def test_bitwise_on_exact_sums_f32(self, case):
        n, d, h, kt, tr = case
        a, v, dva = body_inputs(2, n, d, h, seed=90, transposed=tr, integer=True)
        for name, g, w in zip(("da", "dv"), agg_bwd_body_reference(a, v, dva, kt),
                              triplet_aggregate_bwd_reference(a, v, dva)):
            assert torch.equal(g, w), name

    @pytest.mark.parametrize("case", PARTITIONS, ids=PARTITION_IDS)
    def test_f32(self, case):
        n, d, h, kt, tr = case
        a, v, dva = body_inputs(2, n, d, h, seed=91, transposed=tr)
        for name, g, w in zip(("da", "dv"), agg_bwd_body_reference(a, v, dva, kt),
                              triplet_aggregate_bwd_reference(a, v, dva)):
            assert g.dtype == torch.float32
            assert_scaled_close(g, w, F32_TOL, name)

    @pytest.mark.parametrize("case", PARTITIONS, ids=PARTITION_IDS)
    def test_bf16(self, case):
        n, d, h, kt, tr = case
        a, v, dva = (x.bfloat16() for x in body_inputs(2, n, d, h, seed=92,
                                                       transposed=tr))
        for name, g, w in zip(("da", "dv"), agg_bwd_body_reference(a, v, dva, kt),
                              triplet_aggregate_bwd_reference(a, v, dva)):
            assert g.dtype == torch.bfloat16
            assert_scaled_close(g, w, BF16_TOL, name)


# -- 3. the route and the heads per block-----------------------------------------------

CONTIGUOUS = lambda n, d, h: (n * n * d * h, n * d * h, d * h)   # noqa: E731
TRANSPOSED = lambda n, d, h: (n * n * d * h, d * h, n * d * h)   # noqa: E731

ROUTES = [
    # every TGT-Agx2 bucket and the training micro-batch's shape: the body
    ((torch.bfloat16, 24, 16, 16, CONTIGUOUS(24, 16, 16), True), "body"),
    ((torch.bfloat16, 56, 16, 16, CONTIGUOUS(56, 16, 16), True), "body"),
    # the out direction's pair-transposed V, read in place
    ((torch.bfloat16, 48, 16, 16, TRANSPOSED(48, 16, 16), True), "body"),
    # the F3 shapes: n = 128, d = 8 and d = 32
    ((torch.bfloat16, MAX_NODES, 16, 16, CONTIGUOUS(128, 16, 16), True), "body"),
    ((torch.bfloat16, 48, 8, 16, CONTIGUOUS(48, 8, 16), True), "body"),
    ((torch.bfloat16, 48, 32, 16, CONTIGUOUS(48, 32, 16), True), "body"),
    # n = 80 at d = 32: the body's tiles do not fit
    ((torch.bfloat16, 80, 32, 16, CONTIGUOUS(80, 32, 16), True), "panel"),
    # f32 keeps today's route (TF32 keeps too few bits)
    ((torch.float32, 48, 16, 16, CONTIGUOUS(48, 16, 16), True), "panel"),
    # shapes the body does not take
    ((torch.bfloat16, 48, 16, 12, CONTIGUOUS(48, 16, 12), True), "panel"),
    ((torch.bfloat16, 48, 12, 16, CONTIGUOUS(48, 12, 16), True), "panel"),
    ((torch.bfloat16, 48, 64, 16, CONTIGUOUS(48, 64, 16), True), "panel"),
    ((torch.bfloat16, 48, 16, 16, CONTIGUOUS(48, 16, 16), False), "panel"),
    ((torch.bfloat16, 48, 16, 16, (1 + 48 * 48 * 256, 48 * 256, 256), True),
     "panel"),
]


@pytest.mark.parametrize("args,want", ROUTES)
def test_route(args, want):
    assert agg_bwd_route(*args) == want


# (b, n, d, h, heads per block) on an H100's 132 SMs: 16 where the blocks of
# 16 heads give at least half the SMs one each (the training micro-batch),
# 8 below that (b=16) and where 16 heads do not fit (n > 48, d > 16, H != 16)
HEADS = [(32, 48, 16, 16, 16), (64, 24, 16, 16, 16), (16, 48, 16, 16, 8),
         (32, 56, 16, 16, 8), (32, 48, 32, 16, 8), (32, 48, 16, 8, 8)]


@pytest.mark.parametrize("b,n,d,h,want", HEADS)
def test_heads_per_block(b, n, d, h, want):
    assert agg_bwd_heads_per_block(b, n, d, h, 132) == want


# -- 4. the wrapper on the CPU --------------------------------------------------

@pytest.mark.parametrize("panel_route", [False, True])
def test_cpu_wrapper_is_the_plain_version(panel_route):
    a, v, dva = (x.bfloat16() for x in body_inputs(1, 16, 16, 16, seed=93))
    before = (triplet_aggregate_bwd.launches, triplet_aggregate_bwd.body_launches)
    got = triplet_aggregate_bwd(a, v, dva, _panel_route=panel_route)
    for g, w in zip(got, triplet_aggregate_bwd_reference(a, v, dva)):
        assert torch.equal(g, w)
    assert (triplet_aggregate_bwd.launches,
            triplet_aggregate_bwd.body_launches) == before


# -- 5. the body's anatomy tool --------------------------------------------------

@pytest.mark.parametrize("variant", sorted(agg_bwd_anatomy.VARIANTS))
def test_anatomy_patches_apply(variant):
    """``python -m tgt_torch.agg_bwd_anatomy`` builds its variants by editing
    the body's source: each edit finds its text exactly once."""
    source = agg_bwd_anatomy.SOURCE.read_text()
    assert agg_bwd_anatomy.patched(source, agg_bwd_anatomy.VARIANTS[variant])
