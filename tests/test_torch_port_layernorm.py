"""The one-pass layer-norm kernel's plain version and its route
(``tgt_torch/ops/kernels/layernorm.py``, ``ops/common.layernorm``) on the
CPU: the plain version against tgt_tpu's ``layernorm`` in f32 and against
today's three-step composite in bf16, the route's predicate for every kind
of call, and the wrapper on CPU tensors. The kernel itself runs only on the
card (``python3 chip_smoke.py --layernorm``).

Also the launch seam every kernel wrapper calls (``ops/kernels/_build``),
with a Python callable in place of the ctypes symbol: the stream handle
appended last, the device guard only off the current device, a non-zero
return raised with the symbol's name, the declared counters, the names
``h100bench`` and ``chip_smoke.py`` read, and the grad observation
:func:`records_grad`."""
import contextlib
import ctypes
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tgt_tpu.ops import common as jcommon
from tgt_torch.ops import common
from tgt_torch.ops.kernels import _build
from tgt_torch.ops.kernels import layernorm as lnk
from tgt_torch.ops.kernels import triplet_aggregate as tak
from tgt_torch.ops.kernels import triplet_attention as tlk
from tgt_torch.ops.kernels import triplet_dense as tdk
from tgt_torch.ops.kernels._build import records_grad

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

    def call():
        return (x, ln.weight, ln.bias)

    assert records_grad(call())                         # params need grad
    with torch.no_grad():
        assert not records_grad(call())
    with torch.inference_mode():
        assert not records_grad(call())
    ln.requires_grad_(False)
    assert not records_grad(call())                     # frozen, plain x
    x.requires_grad_()
    assert records_grad(call())                         # x needs grad
    assert records_grad((None, x))                      # None is skipped
    assert not records_grad((None, ln.weight))

    def unread():
        raise AssertionError("read outside grad mode")
        yield

    with torch.no_grad():
        assert not records_grad(unread())


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


# -- the launch seam of ops/kernels/_build ---------------------------------------

STREAM_BASE = 0xC0FFEE


class FakeSymbol:
    """A Python callable in place of a ctypes symbol: records its calls and
    returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def fake_entry(rc=0, symbol="triplet_fake_body"):
    entry = _build.Entry("triplet_fake", symbol, _build.PTR, _build.INT,
                         _build.STREAM)
    entry.fn = FakeSymbol(rc)
    return entry


def on(device):
    """A stand-in for a tensor on CUDA device ``device``."""
    return types.SimpleNamespace(get_device=lambda: device)


@pytest.fixture
def card(monkeypatch):
    """Device 0 current, each device's current raw stream STREAM_BASE +
    its index; returns the devices whose guard was entered, in order."""
    guards = []

    @contextlib.contextmanager
    def device(d):
        guards.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda d: STREAM_BASE + d, raising=False)
    return guards


@pytest.mark.parametrize("device,guards", [(0, []), (1, [1])],
                         ids=["current", "other"])
def test_launch_appends_the_stream_last(card, device, guards):
    entry = fake_entry()
    assert _build.launch(entry, on(device), 7, 3) is None
    assert entry.fn.calls == [(7, 3, STREAM_BASE + device)]
    assert card == guards


@pytest.mark.parametrize("rc", [1, 700])
def test_launch_raises_on_a_cuda_error_naming_the_symbol(card, rc):
    entry = fake_entry(rc)
    with pytest.raises(RuntimeError,
                       match=f"triplet_fake_body .*CUDA error {rc}$"):
        _build.launch(entry, on(0), 7, 3)
    assert len(entry.fn.calls) == 1


def test_entry_loads_and_types_its_symbol_once(monkeypatch):
    symbol = FakeSymbol(rc=5)
    loads = []

    def load_library(name):
        loads.append(name)
        return types.SimpleNamespace(triplet_fake_body=symbol)

    monkeypatch.setattr(_build, "load_library", load_library)
    entry = _build.Entry("triplet_fake", "triplet_fake_body", _build.PTR,
                         _build.INT, _build.STREAM)
    assert entry(1, 2, 3) == 5 and entry(4, 5, 6) == 5
    assert loads == ["triplet_fake"]
    assert symbol.calls == [(1, 2, 3), (4, 5, 6)]
    assert symbol.argtypes == (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    assert symbol.restype is ctypes.c_int
    variant = types.SimpleNamespace(triplet_fake_body=FakeSymbol(rc=0))
    bound = entry.bind(variant)                 # a variant build's symbol
    assert bound.fn is variant.triplet_fake_body and bound(1, 2, 3) == 0
    assert entry.fn is symbol


@pytest.mark.parametrize("names", [("launches",),
                                   ("launches", "body_launches"),
                                   ("launches", "dropout_launches",
                                    "tiled_launches")])
def test_counted_counters_start_at_zero_and_count_one_per_call(names):
    @_build.counted(*names)
    def wrapper():
        pass

    assert {n: getattr(wrapper, n) for n in names} == dict.fromkeys(names, 0)
    for i, name in enumerate(names):
        for _ in range(i + 1):
            _build.count(wrapper, name)
    assert {n: getattr(wrapper, n) for n in names} == {
        n: i + 1 for i, n in enumerate(names)}
    _build.count(wrapper)
    assert wrapper.launches == 2


@pytest.mark.parametrize("wrapper,names", [
    (tdk.triplet_dense_fwd, ("launches", "dropout_launches",
                             "tiled_launches")),
    (tdk.triplet_dense_bwd, ("launches", "dropout_launches",
                             "tiled_launches")),
    (tak.triplet_aggregate_fwd, ("launches", "body_launches")),
    (tak.triplet_aggregate_bwd, ("launches", "body_launches")),
    (tlk.triplet_attention_fwd, ("launches",)),
    (tlk.triplet_attention_bwd, ("launches",)),
    (lnk.layernorm_fwd, ("launches",))],
    ids=lambda x: getattr(x, "__name__", None))
def test_wrappers_carry_the_counters_h100bench_reads(wrapper, names):
    for name in names:
        assert isinstance(getattr(wrapper, name), int)
