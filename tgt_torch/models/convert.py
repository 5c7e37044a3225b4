"""Weight bridge from tgt_tpu's params to the port's state_dict (the
counterpart of tgt_tpu/models/convert.py, which maps the other way).

The port's module names are the reference PyTorch state_dict names, so a
params tree of tgt_tpu maps onto them one for one:
- Linear    ``{'w', 'b'}``       -> ``.weight`` = w.T, ``.bias`` = b
- LayerNorm ``{'scale', 'bias'}`` -> ``.weight``, ``.bias``
- Embedding ``{'w'}``            -> ``.weight``
- ``encoder.layers`` (inner layers stacked on a leading axis) ->
  ``encoder.TGT_layers.{0..h-2}``; ``encoder.last`` -> ``TGT_layers.{h-1}``
- the Gaussian 3D embedding's names follow ``_M3D_GAUSSIAN_MAP``.

Input arrays are numpy; this module needs no JAX. ``load_jax_npz`` reads the
flat ``.npz`` that ``tgt_tpu.training.checkpoint.save_pytree`` writes (keys
``encoder/layers/update/lin_QKV/w``, ...) back into a nested dict.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tgt_torch.models.model_config import TGTConfig

# tgt_tpu m3d_embed key -> submodule path inside input_embed.m3d_embed
_M3D_GAUSSIAN_MAP = {
    "means": "gbf.means",
    "stds": "gbf.stds",
    "mul": "gbf.mul",
    "bias": "gbf.bias",
    "proj1": "gbf_proj.layer1",
    "proj2": "gbf_proj.layer2",
}


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))  # a copy: the source may be read-only


def _put_module(out: Dict[str, torch.Tensor], prefix: str,
                sub: Mapping[str, Any]) -> None:
    """Convert one params dict (a module) under the state_dict ``prefix``."""
    for name, s in sub.items():
        key = f"{prefix}.{name}" if prefix else name
        if not isinstance(s, Mapping):
            out[key] = _tensor(s)                  # raw buffer (angular_freqs)
            continue
        keys = set(s)
        if keys == {"w", "b"}:
            out[key + ".weight"] = _tensor(np.asarray(s["w"]).T)
            out[key + ".bias"] = _tensor(s["b"])
        elif keys == {"scale", "bias"}:
            out[key + ".weight"] = _tensor(s["scale"])
            out[key + ".bias"] = _tensor(s["bias"])
        elif keys == {"w"}:
            out[key + ".weight"] = _tensor(s["w"])
        else:
            _put_module(out, key, s)


def _index(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a params tree stacked on a leading layer axis."""
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def state_dict_from_jax_params(params: Mapping[str, Any],
                               cfg: TGTConfig) -> Dict[str, torch.Tensor]:
    """tgt_tpu params tree (numpy leaves) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for top, sub in params.items():
        if top == "input_embed":
            for name, s in sub.items():
                if name == "m3d_embed" and "angular_freqs" not in s:
                    _put_module(out, "input_embed.m3d_embed",
                                {_M3D_GAUSSIAN_MAP[k]: v for k, v in s.items()})
                else:
                    _put_module(out, "input_embed", {name: s})
        elif top == "encoder":
            if "indiv" in sub:
                raise NotImplementedError(
                    "per-layer IndivConfig is not ported yet (ROADMAP.md "
                    "item 1f)")
            h = cfg.model_height
            if "layers" in sub:
                for i in range(h - 1):
                    _put_module(out, f"encoder.TGT_layers.{i}",
                                _index(sub["layers"], i))
            _put_module(out, f"encoder.TGT_layers.{h - 1}", sub["last"])
        else:
            _put_module(out, "", {top: sub})
    return out


def load_jax_npz(path: str) -> Dict[str, Any]:
    """Read a ``save_pytree`` checkpoint (flat '/'-joined keys) into a
    nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as npz:
        for key in npz.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return tree
