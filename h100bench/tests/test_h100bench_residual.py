"""The residual junction's reader (``residual_fused_share.serve``) on
synthetic trace records: the kernel names it counts, the parent's reading
(PyTorch's contiguous bf16 add alone: 0), and None where there is nothing
to read."""
from __future__ import annotations

import pytest

from h100bench import harness

FUSED = "void resf::residual_pieces<__nv_bfloat16, true>(...)"
FUSED_ADD = "void resf::residual_pieces<__nv_bfloat16, false>(...)"
ADD = ("void at::native::vectorized_elementwise_kernel<8, at::native::"
       "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(int, at::"
       "native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)")
OTHERS = {
    # the strided add, the f32 add and the broadcast multiply: not counted
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
    "impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16> >(...)>(...)": 0.5,
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(...)": 0.25,
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
    "impl_nocast<at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, "
    "c10::BFloat16, at::native::binary_internal::MulFunctor<float> > >"
    "(...)>(...)": 0.125,
    "void lnfwd::layernorm_rows<__nv_bfloat16, 1, 2>(...)": 0.0625,
}


def _reader():
    return harness.load_module(
        harness.HERE / "metrics" / "residual_fused_share.serve.py",
        "h100bench_metric_residual_fused_share_serve")


def record(kernels, driver="serve"):
    return {"mix": {"driver": driver}, "cfg": {},
            "trace": {"kernels": {**OTHERS, **kernels},
                      "items": [{"sizes": [20], "counters": {}}]}}


def test_change_reads_the_kernel_s_share_of_the_adds():
    rec = record({FUSED: 0.006, FUSED_ADD: 0.002, ADD: 0.0005})
    assert _reader().read(rec) == pytest.approx(100 * 0.008 / 0.0085)


def test_every_junction_through_the_kernel_reads_100():
    assert _reader().read(record({FUSED: 0.006})) == 100.0


def test_parent_reads_0():
    assert _reader().read(record({ADD: 0.1})) == 0.0


@pytest.mark.parametrize("rec", [
    {"mix": {"driver": "serve"}, "cfg": {}},                  # no trace
    {"mix": {"driver": "serve"}, "cfg": {}, "trace": None},
    record({FUSED: 0.006}, driver="train"),                  # another cell
    record({})],                                             # neither
    ids=["no_trace", "trace_none", "train", "neither"])
def test_none_where_nothing_to_read(rec):
    assert _reader().read(rec) is None
