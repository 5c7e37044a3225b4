"""Batch inference / serving API (counterpart of tgt_tpu/serving.py).

Ported: ``DistancePredictor`` — interatomic distance-bin probabilities with
size-sorted bucketed batching and MC-dropout averaging, the first stage of
the published two-stage inference. Runs on the CUDA card unless the caller
passes ``device="cpu"``.

    pred = DistancePredictor.from_model_dir("models/.../dist_pred",
                                            mc_samples=10)
    probs = pred.predict(list_of_molecule_dicts)    # (M, Nmax, Nmax, bins)
    bins = pred.predict_bins(list_of_molecule_dicts)  # (M, S, Nmax, Nmax)

Molecule dict schema (dataset rows before the structural transform):
num_nodes, edges (m, 2), node_features (n, 9), edge_features (m, 3), plus
dist_input (n, n) | coords (n, 3) | rdkit_coords (n, 3).

tgt_tpu's TPU-only machinery is not ported: the persistent compile cache,
the dense kernels' data mesh, ``warmup`` with its relay probe (PyTorch runs
eagerly: nothing to precompile), and the vmap scheduling of MC draws (the
port runs the draws in a loop). ``GapPredictor`` and ``TwoStagePredictor``
come later (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from tgt_torch.core.config import load_yaml
from tgt_torch.core.device import resolve_device
from tgt_torch.data.collate import add_edge_mask, pad_batch_dim, padded_collate
from tgt_torch.data.structural import AddStructuralData
from tgt_torch.models.convert import load_jax_npz, state_dict_from_jax_params
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.schemes import get_scheme
from tgt_torch.schemes.commons import coords2dist

_FEED_KEYS = ("node_features", "distance_matrix", "feature_matrix",
              "node_mask", "edge_mask")


class _BasePredictor:
    MODEL = "gap"
    # Output axes that are per-node (and thus bucket-size-dependent),
    # declared per subclass.
    NODE_AXES: tuple = ()

    def __init__(self, model: nn.Module, model_cfg: TGTConfig,
                 mc_samples: int = 10, batch_size: int = 16,
                 buckets: Sequence[int] = (16, 32, 48, 64), seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = model_cfg
        self.mc_samples = mc_samples
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self._transform = AddStructuralData()
        # host generator of the per-draw seeds: one draw per device batch
        self._seeds = torch.Generator().manual_seed(seed)

    @classmethod
    def from_model_dir(cls, model_dir: str, mc_samples: int = 10,
                       batch_size: int = 16,
                       buckets: Sequence[int] = (16, 32, 48, 64),
                       which: str = "checkpoint", use_pallas=None,
                       device=None, **predictor_kwargs) -> "_BasePredictor":
        """Load config.yaml and the tgt_tpu checkpoint
        (``<which>/model.npz``, written by ``save_pytree``) from a model
        dir. ``use_pallas`` overrides the trained config's kernel choice."""
        cfg_dict = load_yaml(os.path.join(model_dir, "config.yaml"))
        scheme = get_scheme(cfg_dict["scheme"])(cfg_dict, command="evaluate")
        model_cfg = scheme.model_cfg
        if use_pallas is not None:
            model_cfg = model_cfg.replace(use_pallas=use_pallas)
        device = resolve_device(device)
        model = make_model(cls.MODEL, model_cfg, device=device)
        params = load_jax_npz(os.path.join(model_dir, which, "model.npz"))
        model.load_state_dict(state_dict_from_jax_params(params, model_cfg))
        pred = cls(model, model_cfg, mc_samples=mc_samples,
                   batch_size=batch_size, buckets=buckets, device=device,
                   **predictor_kwargs)
        pred.scheme_cfg = scheme.cfg
        return pred

    # -- batched dispatch --------------------------------------------------
    def _run(self, rows: List[Dict],
             forward: Callable[[Dict[str, torch.Tensor], List[int]],
                               torch.Tensor],
             node_axes: tuple) -> np.ndarray:
        """Size-sorted bucketed batching around ``forward(feed, seeds)``.
        Every device batch is queued before any result is copied back, so
        host collation of batch t+1 overlaps the card computing batch t.
        Outputs come back in input order."""
        if not rows:
            return np.zeros((0,), np.float32)
        sizes = np.asarray([r["num_nodes"] for r in rows])
        order = np.argsort(sizes, kind="stable")

        pending = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            chunk = [rows[i] for i in idx]
            batch = add_edge_mask(padded_collate(chunk, buckets=self.buckets))
            batch, _ = pad_batch_dim(batch, self.batch_size)
            seeds = torch.randint(0, 2**62, (self.mc_samples,),
                                  generator=self._seeds).tolist()
            with torch.inference_mode():
                out = forward(self._feed_of(batch), seeds)
            pending.append((idx, out[:len(chunk)]))

        outs = [(idx, out.cpu().numpy()) for idx, out in pending]
        # per-molecule node axes differ across buckets: zero-pad the
        # declared node axes to the largest before scattering back
        n_max = max((o.shape[a] for _, o in outs for a in node_axes
                     if o.ndim > a), default=0)
        result = None
        for idx, out in outs:
            out = self._pad_nodes(out, n_max, node_axes)
            if result is None:
                result = np.zeros((len(rows),) + out.shape[1:], out.dtype)
            result[idx] = out
        return result

    def _prepare_rows(self, molecules: List[Dict]) -> List[Dict]:
        rows = []
        for mol in molecules:
            row = dict(mol)
            if "distance_matrix" not in row:
                row = self._transform(row)
            row.setdefault("node_mask", np.ones(row["num_nodes"], np.uint8))
            rows.append(row)
        return rows

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _feed_of(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @staticmethod
    def _pad_nodes(out: np.ndarray, n_max: int,
                   node_axes: tuple) -> np.ndarray:
        """Zero-pad the declared per-node axes to n_max."""
        pad = [(0, 0)] * out.ndim
        grew = False
        for a in node_axes:
            if out.ndim > a and out.shape[a] < n_max:
                pad[a] = (0, n_max - out.shape[a])
                grew = True
        return np.pad(out, pad) if grew else out


class DistancePredictor(_BasePredictor):
    """Interatomic distance-bin probabilities from coordinates."""

    MODEL = "distance"
    NODE_AXES = (1, 2)  # output is (b, N, N, bins)

    def _feed_of(self, batch):
        feed = {k: self._tensor(batch[k]) for k in _FEED_KEYS}
        if "dist_input" in batch:
            feed["dist_input"] = self._tensor(batch["dist_input"]).float()
        elif "coords" in batch:
            feed["dist_input"] = coords2dist(self._tensor(batch["coords"]).float())
        elif "rdkit_coords" in batch:
            feed["dist_input"] = coords2dist(
                self._tensor(batch["rdkit_coords"]).float())
        elif self.cfg.embed_3d_type != "none":
            raise ValueError("model expects coords or dist_input")
        return feed

    def _symmetric_probs(self, feed, seed: int) -> torch.Tensor:
        logits = self.model(feed, deterministic=False, seed=seed)
        p = torch.softmax(logits.float(), dim=-1)
        return p + p.transpose(1, 2)

    def _mc_forward(self, feed, seeds: List[int]) -> torch.Tensor:
        """Mean over the draws of (softmax + its pair transpose) / 2."""
        total = sum(self._symmetric_probs(feed, s) for s in seeds)
        return total / len(seeds) / 2.0

    def _bins_forward(self, feed, seeds: List[int]) -> torch.Tensor:
        """Per-draw symmetrised argmax bins (b, S, N, N) int32 (reference
        dist_pred/scheme.py:181-205)."""
        return torch.stack([self._symmetric_probs(feed, s).argmax(dim=-1)
                            .to(torch.int32) for s in seeds], dim=1)

    def predict(self, molecules: List[Dict]) -> np.ndarray:
        """MC-averaged symmetric bin probabilities (M, Nmax, Nmax, bins)
        float32, input order preserved."""
        return self._run(self._prepare_rows(molecules), self._mc_forward,
                         self.NODE_AXES)

    def predict_bins(self, molecules: List[Dict]) -> np.ndarray:
        """Per-draw argmax bins samples (M, mc_samples, Nmax, Nmax) int32,
        input order preserved."""
        return self._run(self._prepare_rows(molecules), self._bins_forward,
                         (2, 3))
