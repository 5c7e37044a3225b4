"""The host ms per traced crop inside the program's four MSA-track spans
(``evoformer.msa_row``, ``.msa_col``, ``.msa_transition``, ``.opm``, each
forward and each remat replay, both stacks) in the profiled span. None
where the program keeps no such spans."""
from h100bench.yardstick import evoformer


def read(rec):
    t = rec.get("trace")
    if rec["mix"]["driver"] != evoformer.DRIVER or not t or not t["items"]:
        return None
    try:
        from tgt_torch.utils import tracing
    except ImportError:
        return None
    total = evoformer.msa_host_ms(tracing.recorded())
    return None if total is None else total / len(t["items"])
