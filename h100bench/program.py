"""The system under test, built from the benchmark's inputs: the port's
scheme from a configuration file's ``config`` block, and its distance model
holding the weights the benchmark made."""
from __future__ import annotations

from typing import Dict

import torch


def scheme(cfg: dict, command: str, **overrides):
    from tgt_torch.schemes import get_scheme
    raw = dict(cfg)
    raw.update(overrides)
    return get_scheme(raw["scheme"])(raw, command=command)


def distance_model(model_cfg, weights: Dict[str, torch.Tensor], device):
    """The port's distance model, built without drawing weights of its own,
    holding ``weights``."""
    from tgt_torch.models.heads import DistanceModel
    with torch.device("meta"):
        model = DistanceModel(model_cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
