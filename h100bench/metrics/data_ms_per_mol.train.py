"""The data layer's host ms per trained molecule: the program's
``data.transform`` and ``data.collate`` spans in the profiled span (the
loader thread's structural transforms and collations) over the molecules
transformed. None where the program keeps no spans."""
from h100bench.yardstick import spans


def read(rec):
    if rec["mix"]["driver"] != "train":
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    return spans.data_ms_per_molecule(tracing.recorded())
