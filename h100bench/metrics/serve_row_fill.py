"""The share of the rows that the served forwards run that hold a real
molecule: 100 x the sum of ``rows_real`` over that of ``rows_run``, each
times its MC draws, over the program's ``serve.forward`` spans in the
profiled span. None where the program keeps no spans."""
from h100bench.yardstick import spans


def read(rec):
    if rec["mix"]["driver"] != "serve":
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    return spans.serve_row_fill(tracing.recorded())
