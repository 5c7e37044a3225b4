"""The dense triplet attention forward, whole calls: the bound time of its
calls in the profiled span over the device time of every operation that
its entry point (``TripletDenseCore.forward``) launched: the tensor-core
body (csrc/triplet_dense_fwd.cu) and, where it does not read in place, the
head-major copies around it."""
from h100bench.yardstick import readers

CALL = "TripletDenseCore.forward"
CALLS = ("tgt_torch.ops.kernels.triplet_dense:" + CALL,)
COUNTERS = ("triplet_dense_fwd.launches",
            "triplet_dense_fwd.dropout_launches")


def read(rec):
    return readers.roofline(rec, "dense_fwd", COUNTERS, call=CALL)
