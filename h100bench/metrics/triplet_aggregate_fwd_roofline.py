"""The triplet aggregation forward, whole calls: the bound time of its calls
in the profiled span over the device time of every operation that its
entry point (``TripletAggregateCore.forward``) launched: the tensor-core
body or the panel loop (csrc/triplet_aggregate_fwd.cu) and any copy of its
inputs."""
from h100bench.yardstick import readers

CALL = "TripletAggregateCore.forward"
CALLS = ("tgt_torch.ops.kernels.triplet_aggregate:" + CALL,)
COUNTERS = ("triplet_aggregate_fwd.launches",)


def read(rec):
    return readers.roofline(rec, "agg_fwd", COUNTERS, call=CALL)
