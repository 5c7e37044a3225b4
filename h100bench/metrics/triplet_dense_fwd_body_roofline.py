"""The dense triplet attention forward's body alone: the bound time of its
calls in the profiled span over the device time of its tensor-core bodies
(namespace tfwd, csrc/triplet_dense_fwd.cu); the head-major copies that a
call makes where it does not read in place are left out."""
from h100bench.yardstick import readers

KERNELS = ("tfwd::",)
COUNTERS = ("triplet_dense_fwd.launches",
            "triplet_dense_fwd.dropout_launches")


def read(rec):
    return readers.roofline(rec, "dense_fwd", COUNTERS, kernels=KERNELS)
