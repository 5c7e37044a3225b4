"""The one-pass layer-norm kernel's plain version and its route
(``tgt_torch/ops/kernels/layernorm.py``, ``ops/common.layernorm``) on the
CPU: the plain version against tgt_tpu's ``layernorm`` in f32 and against
today's three-step composite in bf16, the route's predicate for every kind
of call, and the wrapper on CPU tensors. The kernel itself runs only on the
card (``python3 chip_smoke.py --layernorm``)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tgt_tpu.ops import common as jcommon
from tgt_torch.ops import common
from tgt_torch.ops.kernels import layernorm as lnk

torch.set_num_threads(1)


def _inputs(seed, rows, width):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, width) * 3 + rs.randn(rows, 1) * 5).astype(np.float32)
    scale = (1 + 0.5 * rs.randn(width)).astype(np.float32)
    bias = rs.randn(width).astype(np.float32)
    return x, scale, bias


def _module(scale, bias):
    ln = torch.nn.LayerNorm(len(scale))
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    return ln


def _bf16_steps(got, want):
    """|got - want| in units of one bf16 step (the spacing at the larger
    magnitude of the two)."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), exp - 8)
    return ((got - want).abs() / step).max().item()


@pytest.mark.parametrize("width", [256, 768, 40])
def test_reference_matches_tgt_tpu_in_f32(width):
    x, scale, bias = _inputs(width, 6, width)
    want = np.asarray(jcommon.layernorm({"scale": jnp.asarray(scale),
                                         "bias": jnp.asarray(bias)},
                                        jnp.asarray(x)), np.float32)
    got = lnk.layernorm_fwd_reference(torch.from_numpy(x),
                                      torch.from_numpy(scale),
                                      torch.from_numpy(bias), 1e-5).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("width", [256, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_reference_within_one_step_of_the_composite(width, dtype):
    x, scale, bias = _inputs(width + 1, 64, width)
    ln = _module(scale, bias).requires_grad_(False)
    xt = torch.from_numpy(x).to(dtype)
    got = lnk.layernorm_fwd_reference(xt, ln.weight, ln.bias, 1e-5)
    want = common.layernorm(ln, xt)              # the CPU's composite
    assert got.dtype == want.dtype == dtype
    if dtype == torch.bfloat16:
        assert _bf16_steps(got, want) <= 1.0
    else:
        torch.testing.assert_close(got, want, rtol=2 ** -10, atol=2 ** -14)


@pytest.mark.parametrize("dtype,width,taken", [
    (torch.bfloat16, 256, True), (torch.bfloat16, 512, True),
    (torch.bfloat16, 768, True), (torch.float16, 1024, True),
    (torch.bfloat16, 128, False), (torch.bfloat16, 300, False),
    (torch.bfloat16, 1280, False), (torch.float32, 256, False)])
def test_widths_and_dtypes_the_kernel_takes(dtype, width, taken):
    assert lnk.takes(dtype, width) is taken


@pytest.mark.parametrize("device,dtype,width,grad,route", [
    ("cuda", torch.bfloat16, 256, False, "kernel"),
    ("cuda", torch.bfloat16, 768, False, "kernel"),
    ("cuda", torch.float16, 256, False, "kernel"),
    ("cuda", torch.bfloat16, 256, True, "composite"),   # training, replay
    ("cuda", torch.float32, 256, False, "composite"),   # f32 configurations
    ("cuda", torch.bfloat16, 64, False, "composite"),   # a width it lacks
    ("cpu", torch.bfloat16, 256, False, "composite")])
def test_route(device, dtype, width, grad, route):
    assert common.layernorm_route(device, dtype, width, grad) == route


def test_records_grad_follows_autograd():
    ln = torch.nn.LayerNorm(8)
    x = torch.zeros(2, 8)
    assert common.records_grad(ln, x)                   # params need grad
    with torch.no_grad():
        assert not common.records_grad(ln, x)
    with torch.inference_mode():
        assert not common.records_grad(ln, x)
    ln.requires_grad_(False)
    assert not common.records_grad(ln, x)               # frozen, plain x
    assert common.records_grad(ln, x.requires_grad_())  # x needs grad


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x, scale, bias = _inputs(3, 10, 256)
    xt = torch.from_numpy(x).to(torch.bfloat16).view(2, 5, 256)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    before = lnk.layernorm_fwd.launches
    got = lnk.layernorm_fwd(xt, w, b, 1e-5)
    assert lnk.layernorm_fwd.launches == before
    assert torch.equal(got, lnk.layernorm_fwd_reference(xt, w, b, 1e-5))
    with pytest.raises(ValueError):
        lnk.layernorm_fwd(xt, w[:128], b, 1e-5)


def test_layernorm_keeps_the_composite_on_cpu_under_grad():
    x, scale, bias = _inputs(4, 3, 256)
    ln = _module(scale, bias)
    xt = torch.from_numpy(x).requires_grad_()
    y = common.layernorm(ln, xt)
    y.square().sum().backward()
    assert xt.grad is not None and ln.weight.grad is not None
    torch.testing.assert_close(y.detach(), lnk.layernorm_fwd_reference(
        xt.detach(), ln.weight.detach(), ln.bias.detach(), 1e-5),
        rtol=1e-5, atol=1e-5)
