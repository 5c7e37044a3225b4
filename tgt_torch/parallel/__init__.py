"""Distribution (counterpart of tgt_tpu/parallel): each rank is one process
with one device on the row-major (data, pair) grid of ``mesh.py``.
``initialize_distributed`` makes the process group, ``pair_groups`` the
pair groups, ``gather_predictions`` joins the ranks' eval outputs;
``ring.py`` and ``pair_layer.py`` run the edge channel sharded over the
pair axis."""
from tgt_torch.parallel.mesh import (DATA_AXIS, PAIR_AXIS, PAIR_TENSOR_KEYS,
                                     PairAxis, current_pair_axis,
                                     gather_predictions,
                                     initialize_distributed, pair_groups,
                                     pair_scope, rank_device)

__all__ = ["DATA_AXIS", "PAIR_AXIS", "PAIR_TENSOR_KEYS", "PairAxis",
           "current_pair_axis", "gather_predictions",
           "initialize_distributed", "pair_groups", "pair_scope",
           "rank_device"]
