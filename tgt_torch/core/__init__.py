from tgt_torch.core.device import resolve_device
from tgt_torch.core.graph import MASK_VALUE, Graph

__all__ = ["Graph", "MASK_VALUE", "resolve_device"]
