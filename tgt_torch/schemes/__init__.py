"""Scheme registry (reference: lib/training/execute.py:54-58 resolves
``scheme: pcqm.<name>`` strings to scheme classes)."""
from tgt_torch.schemes.base import TGTScheme, default_scheme_config
from tgt_torch.schemes.dist_pred import DistPredScheme

SCHEMES = {"pcqm.dist_pred": DistPredScheme}
_LATER = ("pcqm.pretrain", "pcqm.finetune", "pcqm.gap_pred")


def get_scheme(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"scheme '{name}' is not ported yet (ROADMAP.md item 1k)")
    if name not in SCHEMES:
        raise ValueError(f"unknown scheme '{name}'; available: {list(SCHEMES)}")
    return SCHEMES[name]


__all__ = ["TGTScheme", "default_scheme_config", "DistPredScheme", "SCHEMES",
           "get_scheme"]
