"""The aggregate forward body's pair-order store's share (the template tag
``PairStore`` in namespace ``tagf``, csrc/triplet_aggregate_fwd.cu) of the
body's device time in the profiled span: how often the served forward
writes both directions straight into lin_O's (b, i, j, d, 2, h) input
rather than a contiguous va of its own; 0 where the program has no such
store."""
from h100bench.yardstick import epilogue


def read(rec):
    got = epilogue.body_seconds(rec, "serve")
    if got is None:
        return None
    pair, body = got
    return 100.0 * pair / body
