"""Checkpoints in tgt_tpu's on-disk format (counterpart of
tgt_tpu/training/checkpoint.py): either package resumes the other's.

A checkpoint part is one ``.npz`` of a nested dict of arrays, its leaves
keyed by their '/'-joined paths (``encoder/layers/tria/lin_QKV_in/w``),
written to a temporary file and renamed into place. The trees are
tgt_tpu's params and optimizer state; ``tgt_torch.models.convert`` maps
them to and from the port's module. Layout (reference training.py:284-320):

  <model_path>/checkpoint/{model,optimizer}.npz + training_state.json
  <model_path>/all_checkpoints/epoch_{E}/model.npz   (optional backups)
  <model_path>/best/model.npz                        (best-metric snapshot)
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {'/'-joined path: leaf}, keys sorted at each level as
    ``jax.tree_util`` orders them."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in sorted(tree.items()):
        flat.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _atomic_write(path: str, write) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_pytree(tree: Any, path: str) -> None:
    """Atomically save a nested dict of arrays to ``path`` (.npz)."""
    flat = {k: np.asarray(v) for k, v in flatten_tree(tree).items()}
    _atomic_write(path, lambda f: np.savez(f, **flat))


def _unflatten_like(template: Any, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, Mapping):
        return {k: _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in template.items()}
    return leaves[prefix]


def load_pytree(template: Any, path: str, strict: bool = True
                ) -> Tuple[Any, List[str], List[str]]:
    """Load arrays saved by ``save_pytree`` into the structure of
    ``template``. With ``strict=False`` missing keys and keys of another
    shape keep the template's value and unexpected keys are ignored;
    returns (tree, missing, unexpected), the reference's non-strict
    ``load_state_dict`` (training.py:358-366)."""
    with np.load(path) as npz:
        saved = {k: npz[k] for k in npz.files}
    leaves: Dict[str, Any] = {}
    missing = []
    for key, tmpl_leaf in flatten_tree(template).items():
        if key in saved:
            arr = saved.pop(key)
            if tuple(arr.shape) != tuple(np.shape(tmpl_leaf)):
                if strict:
                    raise ValueError(
                        f"shape mismatch for {key}: saved {arr.shape} vs "
                        f"template {np.shape(tmpl_leaf)}")
                missing.append(key + " (shape mismatch, kept template)")
                leaves[key] = tmpl_leaf
            else:
                leaves[key] = arr
        else:
            if strict:
                raise KeyError(f"missing key in checkpoint: {key}")
            missing.append(key)
            leaves[key] = tmpl_leaf
    unexpected = list(saved.keys())
    if strict and unexpected:
        raise KeyError(f"unexpected keys in checkpoint: {unexpected[:5]}...")
    return _unflatten_like(template, leaves), missing, unexpected


class CheckpointManager:
    """The checkpoint, backup and best-model files of one model dir."""

    def __init__(self, model_path: str, save_backups: bool = False):
        self.model_path = model_path
        self.ckpt_dir = os.path.join(model_path, "checkpoint")
        self.backup_dir = os.path.join(model_path, "all_checkpoints")
        self.best_dir = os.path.join(model_path, "best")
        self.save_backups = save_backups

    def save(self, params: Any, opt_state: Any, counters: Dict[str, Any],
             epoch: Optional[int] = None) -> None:
        save_pytree(params, os.path.join(self.ckpt_dir, "model.npz"))
        save_pytree(opt_state, os.path.join(self.ckpt_dir, "optimizer.npz"))
        # the counters atomically too: a crash mid-write must not leave a
        # new model.npz beside a truncated training_state.json
        _atomic_write(os.path.join(self.ckpt_dir, "training_state.json"),
                      lambda f: f.write(json.dumps(counters).encode()))
        if self.save_backups and epoch is not None:
            save_pytree(params, os.path.join(self.backup_dir, f"epoch_{epoch}",
                                             "model.npz"))

    def save_best(self, params: Any) -> None:
        save_pytree(params, os.path.join(self.best_dir, "model.npz"))

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.ckpt_dir, "model.npz"))

    def load(self, params_template: Any, opt_template: Any
             ) -> Tuple[Any, Any, Dict[str, Any]]:
        params, _, _ = load_pytree(params_template,
                                   os.path.join(self.ckpt_dir, "model.npz"))
        opt_state, _, _ = load_pytree(
            opt_template, os.path.join(self.ckpt_dir, "optimizer.npz"))
        with open(os.path.join(self.ckpt_dir, "training_state.json")) as f:
            counters = json.load(f)
        return params, opt_state, counters

    def load_model_only(self, params_template: Any, which: str = "checkpoint"):
        path = {"checkpoint": self.ckpt_dir, "best": self.best_dir}[which]
        params, _, _ = load_pytree(params_template,
                                   os.path.join(path, "model.npz"))
        return params


def load_pretrained(params_template: Any, weights_file: str
                    ) -> Tuple[Any, List[str], List[str]]:
    """Non-strict pretrained load for stage transfer (head add/drop)."""
    return load_pytree(params_template, weights_file, strict=False)
