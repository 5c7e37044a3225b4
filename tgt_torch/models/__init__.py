from tgt_torch.models.heads import DistanceModel, make_model
from tgt_torch.models.model_config import TGTConfig

__all__ = ["DistanceModel", "TGTConfig", "make_model"]
