"""A served request's wait for the card: the mean over the profiled span's
requests (the program's outermost ``serve.predict`` spans) of the
``serve.copy_back`` spans under each. None where the program keeps no
spans."""
from h100bench.yardstick import spans


def read(rec):
    if rec["mix"]["driver"] != "serve":
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    return spans.serve_wait_ms(tracing.recorded())
