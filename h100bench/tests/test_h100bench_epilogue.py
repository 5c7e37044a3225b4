"""The two readers of the aggregate layer's epilogue
(``triplet_aggregate_pair_share.serve``,
``strided_elementwise_ms_per_mol.serve``) on synthetic trace records: which
kernel names they count, the molecules they divide by, the parent's reading
(no pair-order store: 0), and None where there is nothing to read."""
from __future__ import annotations

import pytest

from h100bench import harness

ROW = "void tagf::agg_fwd_body_kernel<3, 16, 16, tagf::RowStore>(tagf::Args)"
PAIR = "void tagf::agg_fwd_body_kernel<3, 16, 16, tagf::PairStore>(tagf::Args)"
PARENT_BODY = "void tagf::agg_fwd_body_kernel<4, 16, 8>(tagf::Args)"
STRIDED = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_"
           "kernel_impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16> >"
           "(at::TensorIteratorBase&, ...)::{lambda(int)#1}>(int, ...)")
OTHERS = {
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunc"
    "tor_add<c10::BFloat16>, ...>(int, ...)": 0.5,
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
    "kernel_cuda(...)>(...)": 0.25,
    "void at::native::(anonymous namespace)::distribution_elementwise_grid_"
    "stride_kernel<float, 4, ...>(...)": 0.125,
    "void lnfwd::layernorm_rows<__nv_bfloat16, 1, 2>(...)": 0.0625,
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_bias_TNN": 0.03125,
}


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "h100bench_metric_" + name.replace(".", "_"))


def record(kernels, sizes=((20,), (33,), (56,)), driver="serve"):
    return {"mix": {"driver": driver}, "cfg": {},
            "trace": {"kernels": {**OTHERS, **kernels},
                      "items": [{"sizes": list(s), "counters": {}}
                                for s in sizes]}}


def test_pair_share_counts_the_pair_store_of_the_body():
    rec = record({ROW: 0.001, PAIR: 0.003, STRIDED: 0.3})
    assert _reader("triplet_aggregate_pair_share.serve").read(rec) == \
        pytest.approx(100 * 0.003 / 0.004)
    assert _reader("triplet_aggregate_pair_share.serve").read(
        record({PAIR: 0.004})) == 100.0


def test_strided_elementwise_over_the_molecules():
    rec = record({STRIDED: 0.3, STRIDED.replace("add", "mul"): 0.15,
                  PAIR: 0.004}, sizes=((20, 24), (33,), (56, 8, 9)))
    assert _reader("strided_elementwise_ms_per_mol.serve").read(rec) == \
        pytest.approx(1e3 * 0.45 / 6)
    # no generic elementwise kernel in a trace with molecules reads 0
    assert _reader("strided_elementwise_ms_per_mol.serve").read(
        record({PAIR: 0.004})) == 0.0


def test_parent_reads_no_pair_store():
    rec = record({PARENT_BODY: 0.004, STRIDED: 0.5})
    assert _reader("triplet_aggregate_pair_share.serve").read(rec) == 0.0
    assert _reader("strided_elementwise_ms_per_mol.serve").read(rec) == \
        pytest.approx(1e3 * 0.5 / 3)


@pytest.mark.parametrize("name", ["triplet_aggregate_pair_share.serve",
                                  "strided_elementwise_ms_per_mol.serve"])
@pytest.mark.parametrize("rec", [
    {"mix": {"driver": "serve"}, "cfg": {}},                  # no trace
    {"mix": {"driver": "serve"}, "cfg": {}, "trace": None},
    record({PAIR: 0.004, STRIDED: 0.3}, driver="train")],    # another cell
    ids=["no_trace", "trace_none", "train"])
def test_none_where_nothing_to_read(name, rec):
    assert _reader(name).read(rec) is None


def test_none_without_molecules_or_body_time():
    """The time per molecule needs molecules; the share needs body time
    (it divides no molecules, so a trace without them still reads)."""
    assert _reader("strided_elementwise_ms_per_mol.serve").read(
        record({PAIR: 0.004, STRIDED: 0.3}, sizes=())) is None
    assert _reader("triplet_aggregate_pair_share.serve").read(
        record({STRIDED: 0.3})) is None
    assert _reader("triplet_aggregate_pair_share.serve").read(
        record({PAIR: 0.004}, sizes=())) == 100.0
