"""The dense triplet attention backward, whole calls: the bound time of its
calls in the profiled span over the device time of every operation that
its entry point (``TripletDenseCore.backward``) launched: the head-major
copies in and out, the tensor-core body and its ordered reduction
(csrc/triplet_dense_bwd.cu), and the cotangent made contiguous."""
from h100bench.yardstick import readers

CALL = "TripletDenseCore.backward"
CALLS = ("tgt_torch.ops.kernels.triplet_dense:" + CALL,)
COUNTERS = ("triplet_dense_bwd.launches",
            "triplet_dense_bwd.dropout_launches")


def read(rec):
    return readers.roofline(rec, "dense_bwd", COUNTERS, call=CALL)
