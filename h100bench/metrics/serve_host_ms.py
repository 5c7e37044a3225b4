"""A served request's host time: the mean over the profiled span's
requests (the program's outermost ``serve.predict`` spans) of each one's
duration less its ``serve.copy_back``, the wait for the card. None where
the program keeps no spans."""
from h100bench.yardstick import spans


def read(rec):
    if rec["mix"]["driver"] != "serve":
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    return spans.serve_host_ms(tracing.recorded())
