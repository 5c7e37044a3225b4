"""The dense triplet attention backward's body alone: the bound time of its
calls in the profiled span over the device time of its tensor-core body
and ordered reduction (namespace tbwd, csrc/triplet_dense_bwd.cu); the
head-major copies around them are left out."""
from h100bench.yardstick import readers

KERNELS = ("tbwd::",)
COUNTERS = ("triplet_dense_bwd.launches",
            "triplet_dense_bwd.dropout_launches")


def read(rec):
    return readers.roofline(rec, "dense_bwd", COUNTERS, kernels=KERNELS)
