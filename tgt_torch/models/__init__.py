from tgt_torch.models.heads import (DistanceModel, GapModel, MultiModel,
                                     make_model)
from tgt_torch.models.evoformer import EvoformerConfig, EvoformerModel
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.models.pairformer import PairformerConfig, PairformerModel

__all__ = ["DistanceModel", "EvoformerConfig", "EvoformerModel", "GapModel",
           "MultiModel", "PairformerConfig", "PairformerModel", "TGTConfig",
           "make_model"]
