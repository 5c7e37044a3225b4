"""The optimizer update's share of a training step's host time: 100 x the
program's ``train.update`` spans over its ``train.step`` spans in the
profiled span (Adam, the NaN guard's selects and copies, the state
rebuild). None where the program keeps no spans."""
from h100bench.yardstick import spans


def read(rec):
    if rec["mix"]["driver"] != "train":
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    return spans.train_update_share(tracing.recorded())
