"""The host ms per traced crop inside the program's four Pairformer spans
(``pairformer.tri_mul``, ``.tri_att``, ``.transition``, ``.single``, each
forward and each remat replay) in the profiled span. None where the
program keeps no such spans."""
from h100bench.yardstick import pairformer


def read(rec):
    t = rec.get("trace")
    if rec["mix"]["driver"] != "train_pairformer" or not t or not t["items"]:
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    total = pairformer.host_ms(tracing.recorded())
    return None if total is None else total / len(t["items"])
