"""Weight bridge between tgt_tpu's params and the port's state_dict, both
ways (the counterpart of tgt_tpu/models/convert.py).

The port's module names are the reference PyTorch state_dict names, so a
params tree of tgt_tpu maps onto them one for one:
- Linear    ``{'w', 'b'}``       -> ``.weight`` = w.T, ``.bias`` = b
- LayerNorm ``{'scale', 'bias'}`` -> ``.weight``, ``.bias``
- Embedding ``{'w'}``            -> ``.weight``
- ``encoder.layers`` (inner layers stacked on a leading axis) ->
  ``encoder.TGT_layers.{0..h-2}``; ``encoder.last`` -> ``TGT_layers.{h-1}``;
  under IndivConfig ``encoder.indiv`` (a tuple of one params dict per
  layer, which may differ in structure) -> ``TGT_layers.{i}``
- the Gaussian 3D embedding's names follow ``_M3D_GAUSSIAN_MAP``.

``jax_params_from_state_dict`` inverts the map (restacking the inner
layers under ``encoder/layers``, or the tuple ``encoder/indiv``; the task
model, or its kind, tells each module's kind), and ``opt_state_to_jax`` /
``opt_state_from_jax`` do the same for the optimizer state ``{mu, nu,
count}`` (tgt_tpu/training/harness.py:131-136), so that a checkpoint of
either package loads strictly in the other.

Arrays are numpy; this module needs no JAX. ``load_jax_npz`` reads the
flat ``.npz`` that ``save_pytree`` writes (keys
``encoder/layers/update/lin_QKV/w``, ...) back into a nested dict.

A released reference checkpoint (a ``model_state.pt`` state_dict) is
imported by ``import_reference_state_dict``, or from the shell (the
counterpart of ``python -m tgt_tpu.models.convert``, with the same
``.npz`` out):

    python -m tgt_torch.models.convert <model_state.pt> <out.npz> \
        --config <config.yaml> [--model distance|gap|multi]

Point ``pretrained_weights_file`` at the ``.npz``, or put it in a model
dir as ``checkpoint/model.npz``: either package reads it.

The structure models (the Pairformer and the Evoformer, whose configs are
not a ``TGTConfig``) have no tgt_tpu counterpart: their tree is flat, one
array per state_dict key, which ``save_pytree`` and ``load_jax_npz`` keep
as it is.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

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
    if not isinstance(cfg, TGTConfig):              # a structure model
        return {k: _tensor(v) for k, v in params.items()}
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
            h = cfg.model_height
            if "indiv" in sub:
                layers = sub["indiv"]
                if isinstance(layers, Mapping):      # read from an npz
                    layers = [layers[str(i)] for i in range(h)]
                for i, layer in enumerate(layers):
                    _put_module(out, f"encoder.TGT_layers.{i}", layer)
                continue
            if "layers" in sub:
                for i in range(h - 1):
                    _put_module(out, f"encoder.TGT_layers.{i}",
                                _index(sub["layers"], i))
            _put_module(out, f"encoder.TGT_layers.{h - 1}", sub["last"])
        else:
            _put_module(out, "", {top: sub})
    return out


def _stack(trees: List[Mapping[str, Any]]) -> Dict[str, Any]:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, Mapping)
            else np.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def _put_leaf(tree: Dict[str, Any], path: List[str], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _modules_of(model: Union[str, nn.Module],
                cfg: TGTConfig) -> Dict[str, nn.Module]:
    """Named modules of ``model``, or of the task model of that kind
    ('distance', 'gap', 'multi') built on the meta device."""
    if isinstance(model, nn.Module):
        return dict(model.named_modules())
    from tgt_torch.models.heads import MODELS
    return dict(MODELS[model](cfg, device="meta").named_modules())


def jax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                               cfg: TGTConfig,
                               model: Union[str, nn.Module] = "distance"
                               ) -> Dict[str, Any]:
    """The port's state_dict (or any dict keyed by its parameter names,
    such as Adam's moments) -> tgt_tpu's params tree of numpy arrays: the
    inverse of ``state_dict_from_jax_params``. The kind of each module
    (Linear, LayerNorm, Embedding) comes from ``model``: the task model
    itself, or its kind, built on the meta device. The kinds differ in
    the last layer (the distance model's QK-only edge update, the gap
    model's node-only layer)."""
    if not isinstance(cfg, TGTConfig):              # a structure model
        return {k: t.detach().cpu().numpy() for k, t in state_dict.items()}
    modules = _modules_of(model, cfg)
    m3d = {v: k for k, v in _M3D_GAUSSIAN_MAP.items()}
    h = cfg.model_height
    out: Dict[str, Any] = {}
    # stacked: the inner layers; IndivConfig: every layer, kept apart
    n_layers = h if cfg.has_indiv else h - 1
    layers: List[Dict[str, Any]] = [{} for _ in range(n_layers)]
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        name, attr = key.rsplit(".", 1)
        mod = modules.get(name)
        if isinstance(mod, nn.Linear):
            leaf = ["w", np.ascontiguousarray(a.T)] if attr == "weight" \
                else ["b", a]
        elif isinstance(mod, nn.LayerNorm):
            leaf = ["scale" if attr == "weight" else "bias", a]
        elif isinstance(mod, nn.Embedding):
            leaf = ["w", a]
        else:                                  # raw buffer (angular_freqs)
            name, leaf = key, [None, a]
        parts = name.split(".")
        tree = out
        if parts[:2] == ["encoder", "TGT_layers"]:
            i, parts = int(parts[2]), parts[3:]
            if i < n_layers:
                tree = layers[i]
            else:
                parts = ["encoder", "last"] + parts
        elif parts[:2] == ["input_embed", "m3d_embed"] and \
                ".".join(parts[2:]) in m3d:
            parts = parts[:2] + [m3d[".".join(parts[2:])]]
        path = parts + ([leaf[0]] if leaf[0] is not None else [])
        _put_leaf(tree, path, leaf[1])
    if cfg.has_indiv:
        out.setdefault("encoder", {})["indiv"] = tuple(layers)
    elif h > 1:
        out.setdefault("encoder", {})["layers"] = _stack(layers)
    return out


def opt_state_to_jax(opt_state: Mapping[str, Any], cfg: TGTConfig,
                     model: Union[str, nn.Module] = "distance"
                     ) -> Dict[str, Any]:
    """The port's optimizer state ``{mu, nu, count}`` (moments keyed by
    parameter name) of ``model`` (as in ``jax_params_from_state_dict``) ->
    tgt_tpu's tree of numpy arrays."""
    modules = _modules_of(model, cfg)
    out = {k: jax_params_from_state_dict(v, cfg, modules[""])
           for k, v in opt_state.items() if k != "count"}
    out["count"] = np.asarray(int(opt_state["count"]), np.int32)
    return out


def opt_state_from_jax(tree: Mapping[str, Any], cfg: TGTConfig,
                       names, device) -> Dict[str, Any]:
    """tgt_tpu's optimizer state tree -> the port's, with the moments of
    the parameters ``names`` on ``device``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "count":
            out[k] = torch.tensor(int(np.asarray(v)), dtype=torch.int32,
                                  device=device)
        else:
            sd = state_dict_from_jax_params(v, cfg)
            out[k] = {n: sd[n].to(device) for n in names}
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


def import_reference_state_dict(state: Mapping[str, Any], cfg: TGTConfig,
                                model: str = "distance") -> Dict[str, Any]:
    """A reference state_dict (tensors or arrays) of task model ``model``
    -> tgt_tpu's params tree of numpy arrays. The module names are the
    reference's, so the state loads strictly, names and shapes, into the
    port's model of that kind built on the meta device: a missing or an
    extra key raises. Values take the model's dtypes (float32)."""
    from tgt_torch.models.heads import MODELS

    module = MODELS[model](cfg, device="meta")
    own = module.state_dict()
    state = {k: torch.as_tensor(v) for k, v in state.items()}
    module.load_state_dict(state, strict=True, assign=True)
    return jax_params_from_state_dict(
        {k: v.detach().to(own[k].dtype) for k, v in state.items()}, cfg,
        module)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Convert a released reference checkpoint to the ``.npz`` that
    ``pretrained_weights_file`` and ``from_model_dir`` read."""
    from tgt_torch.core.config import load_yaml
    from tgt_torch.schemes import get_scheme
    from tgt_torch.training.checkpoint import flatten_tree, save_pytree

    ap = argparse.ArgumentParser(
        prog="python -m tgt_torch.models.convert",
        description="Convert a reference model_state.pt to a checkpoint "
                    ".npz of tgt_tpu and tgt_torch.")
    ap.add_argument("torch_checkpoint")
    ap.add_argument("out_npz")
    ap.add_argument("--config", required=True,
                    help="scheme config yaml (determines model shape)")
    ap.add_argument("--model", default=None,
                    choices=("distance", "gap", "multi"),
                    help="override model kind (distance|gap|multi)")
    args = ap.parse_args(argv)

    state = torch.load(args.torch_checkpoint, map_location="cpu",
                       weights_only=True)
    cfg_dict = load_yaml(args.config)
    scheme = get_scheme(cfg_dict["scheme"])(cfg_dict)
    params = import_reference_state_dict(state, scheme.model_cfg,
                                         args.model or scheme.MODEL)
    save_pytree(params, args.out_npz)
    n = sum(int(np.size(v)) for v in flatten_tree(params).values())
    print(f"converted {n/1e6:.1f}M params -> {args.out_npz}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
