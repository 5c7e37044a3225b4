"""Scheme registry (reference: lib/training/execute.py:54-58 resolves
``scheme: pcqm.<name>`` strings to scheme classes)."""
from tgt_torch.schemes.base import TGTScheme, default_scheme_config
from tgt_torch.schemes.dist_pred import DistPredScheme
from tgt_torch.schemes.finetune import FinetuneScheme
from tgt_torch.schemes.gap_pred import GapPredScheme
from tgt_torch.schemes.pretrain import PretrainScheme
from tgt_torch.schemes.structure import DistogramScheme, EvoformerScheme

SCHEMES = {
    "pcqm.dist_pred": DistPredScheme,
    "pcqm.pretrain": PretrainScheme,
    "pcqm.finetune": FinetuneScheme,
    "pcqm.gap_pred": GapPredScheme,
    "structure.distogram": DistogramScheme,
    "structure.evoformer": EvoformerScheme,
}


def get_scheme(name: str):
    if name not in SCHEMES:
        raise ValueError(f"unknown scheme '{name}'; available: {list(SCHEMES)}")
    return SCHEMES[name]


__all__ = ["TGTScheme", "default_scheme_config", "DistPredScheme",
           "PretrainScheme", "FinetuneScheme", "GapPredScheme",
           "DistogramScheme", "EvoformerScheme", "SCHEMES",
           "get_scheme"]
