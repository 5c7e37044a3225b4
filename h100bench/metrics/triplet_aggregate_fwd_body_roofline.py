"""The triplet aggregation forward's body alone: the bound time of its calls
in the profiled span over the device time of its kernels (the tensor-core
body in namespace tagf, the panel loop in namespace agg;
csrc/triplet_aggregate_fwd.cu)."""
from h100bench.yardstick import readers

KERNELS = ("tagf::", "agg::agg_panel")
COUNTERS = ("triplet_aggregate_fwd.launches",)


def read(rec):
    return readers.roofline(rec, "agg_fwd", COUNTERS, kernels=KERNELS)
