"""Distribution (counterpart of tgt_tpu/parallel): the data axis. Each rank
is one process with one device; ``initialize_distributed`` makes the
process group and ``gather_predictions`` joins the ranks' eval outputs. The
pair axis is not ported yet (ROADMAP.md, module item 5)."""
from tgt_torch.parallel.mesh import (DATA_AXIS, PAIR_AXIS, gather_predictions,
                                     initialize_distributed, rank_device)

__all__ = ["DATA_AXIS", "PAIR_AXIS", "gather_predictions",
           "initialize_distributed", "rank_device"]
