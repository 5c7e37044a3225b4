"""Stage 1 — the distance predictor scheme (counterpart of
tgt_tpu/schemes/dist_pred.py): its configuration defaults and its training
loss. Evaluation, MC-averaged validation and bins prediction to parquet
come with ROADMAP.md item 1k; serving is
``tgt_torch.serving.DistancePredictor``.

Training (reference lib/training_schemes/pcqm/dist_pred/scheme.py): the
model reads RDKit (or DFT, or no) coordinates as distances, optionally with
smooth input noise, and the loss is the masked cross-entropy of its bin
logits against the binned DFT distances (optionally with target noise).
"""
from __future__ import annotations

from typing import Dict

import torch

from tgt_torch.core.config import Config, Lazy
from tgt_torch.schemes.base import TGTScheme, default_scheme_config
from tgt_torch.schemes.commons import (add_coords_noise, coords2dist,
                                       discrete_dist_loss)
from tgt_torch.training.harness import derive_seed


class DistPredScheme(TGTScheme):
    NAME = "dist_pred"
    MODEL = "distance"

    def default_config(self, command: str) -> Config:
        c = default_scheme_config()
        c["save_path_prefix"] = "models/pcqm/dist_pred"
        c["coords_noise"] = 0.0
        c["coords_noise_smooth"] = 0.0
        c["coords_input"] = "rdkit"      # 'rdkit' | 'dft' | 'none'
        c["coords_target"] = "dft"
        c["embed_3d_type"] = Lazy(
            lambda cc: "gaussian" if cc.coords_input != "none" else "none")
        c["num_dist_bins"] = 512
        c["range_dist_bins"] = 8.0
        c["coords_target_noise"] = 0.0
        c["save_pred_dir"] = Lazy(lambda cc: f"bins{cc.prediction_samples}")
        c["train_split"] = "train-3d" if command != "predict" else "train"
        c["val_split"] = "valid-3d" if command != "predict" else "valid"
        c["predict_on"] = (["train", "val"] if command == "predict"
                           else ["val"])
        return c

    def device_keys(self):
        keys = ["node_features", "distance_matrix", "feature_matrix",
                "node_mask"]
        if self.cfg.coords_input != "none":
            keys.append(f"{self.cfg.coords_input}_coords")
        keys.append(f"{self.cfg.coords_target}_coords")
        return keys

    # -- device-side input construction -------------------------------------
    def _model_inputs(self, batch: Dict[str, torch.Tensor],
                      edge_mask: torch.Tensor, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
        feed = {k: batch[k] for k in ("node_features", "distance_matrix",
                                      "feature_matrix", "node_mask")}
        feed["edge_mask"] = edge_mask
        if self.cfg.coords_input != "none":
            coords = batch[f"{self.cfg.coords_input}_coords"].float()
            if self.cfg.coords_noise > 0:
                coords = add_coords_noise(coords, edge_mask,
                                          self.cfg.coords_noise,
                                          self.cfg.coords_noise_smooth,
                                          generator)
            feed["dist_input"] = coords2dist(coords)
        return feed

    def _dist_target(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator) -> torch.Tensor:
        coords = batch[f"{self.cfg.coords_target}_coords"].float()
        if self.cfg.coords_target_noise > 0:
            coords = coords + torch.randn(
                coords.shape, generator=generator, device=coords.device,
                dtype=coords.dtype) * self.cfg.coords_target_noise
        return coords2dist(coords)

    # -- training --------------------------------------------------------------
    def loss_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        """Masked bin cross-entropy of one stochastic forward. ``seed``
        fixes the coordinate noise and every dropout mask of the model."""
        edge_mask = self.edge_mask_of(batch)
        gen = torch.Generator(device=edge_mask.device)
        gen.manual_seed(derive_seed(seed, 0))
        feed = self._model_inputs(batch, edge_mask, gen)
        dist_targ = self._dist_target(batch, gen)
        logits = model(feed, deterministic=False, seed=derive_seed(seed, 1))
        loss = discrete_dist_loss(logits, dist_targ, edge_mask,
                                  self.cfg.num_dist_bins,
                                  self.cfg.range_dist_bins)
        return loss, {}
