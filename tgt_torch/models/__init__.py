from tgt_torch.models.heads import (DistanceModel, GapModel, MultiModel,
                                     make_model)
from tgt_torch.models.model_config import TGTConfig

__all__ = ["DistanceModel", "GapModel", "MultiModel", "TGTConfig",
           "make_model"]
