"""The optimizer update's share of a Pairformer training step's host time:
100 x the program's ``train.update`` spans over its ``train.step`` spans in
the profiled span (the global-norm clip, Adam over 147 M parameters, the
NaN guard, the state rebuild). None where the program keeps no spans."""
from h100bench.yardstick import spans


def read(rec):
    if rec["mix"]["driver"] != "train_pairformer":
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    return spans.train_update_share(tracing.recorded())
