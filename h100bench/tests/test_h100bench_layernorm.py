"""The two layer-norm readers (``layernorm_ms_per_mol.serve``,
``layernorm_fused_share.serve``) on synthetic trace records: which kernel
names they count, the molecules they divide by, the parent's reading
(PyTorch's layer norm alone), and None where there is nothing to read."""
from __future__ import annotations

import pytest

from h100bench import harness

FUSED = "void lnfwd::layernorm_rows<__nv_bfloat16, 1, 2>(...)"
TORCH_LN = ("void at::native::(anonymous namespace)::"
            "vectorized_layer_norm_kernel<float, float, false>(...)")
OTHERS = {
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
    "kernel_cuda(...)>(...)": 0.5,
    "void tagf::body_kernel<16>(...)": 0.25,
    "Memcpy HtoD (Pageable -> Device)": 0.125,
}


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "h100bench_metric_" + name.replace(".", "_"))


def record(kernels, sizes=((20,), (33,), (56,)), driver="serve"):
    return {"mix": {"driver": driver}, "cfg": {},
            "trace": {"kernels": {**OTHERS, **kernels},
                      "items": [{"sizes": list(s), "counters": {}}
                                for s in sizes]}}


def test_change_counts_both_routes_over_the_molecules():
    rec = record({FUSED: 0.006, TORCH_LN: 0.003})
    assert _reader("layernorm_ms_per_mol.serve").read(rec) == \
        pytest.approx(1e3 * 0.009 / 3)
    assert _reader("layernorm_fused_share.serve").read(rec) == \
        pytest.approx(100 * 0.006 / 0.009)


def test_every_molecule_of_an_item_counts():
    rec = record({FUSED: 0.012}, sizes=((20, 24), (33,), (56, 8, 9)))
    assert _reader("layernorm_ms_per_mol.serve").read(rec) == \
        pytest.approx(1e3 * 0.012 / 6)
    assert _reader("layernorm_fused_share.serve").read(rec) == 100.0


def test_parent_reads_torch_s_layer_norm_alone():
    rec = record({TORCH_LN: 0.03,
                  "void at::native::LayerNormForwardCUDAKernel<float>()": 0.01})
    assert _reader("layernorm_ms_per_mol.serve").read(rec) == \
        pytest.approx(1e3 * 0.04 / 3)
    assert _reader("layernorm_fused_share.serve").read(rec) == 0.0


@pytest.mark.parametrize("name", ["layernorm_ms_per_mol.serve",
                                  "layernorm_fused_share.serve"])
@pytest.mark.parametrize("rec", [
    {"mix": {"driver": "serve"}, "cfg": {}},                  # no trace
    {"mix": {"driver": "serve"}, "cfg": {}, "trace": None},
    record({FUSED: 0.006}, driver="train"),                  # another cell
    record({}),                                              # no layer norm
    record({FUSED: 0.006}, sizes=())],                       # no molecules
    ids=["no_trace", "trace_none", "train", "no_layer_norm", "no_items"])
def test_none_where_nothing_to_read(name, rec):
    assert _reader(name).read(rec) is None
