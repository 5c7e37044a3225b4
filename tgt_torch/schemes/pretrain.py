"""Stage 2 — gap pretraining on noisy DFT coordinates (counterpart of
tgt_tpu/schemes/pretrain.py).

As the reference (lib/training_schemes/pcqm/pretrain/scheme.py):
- model: the multi model (gap head and denoising distance head);
- input: DFT coordinates plus smooth noise (sigma ``coords_noise``, tau
  ``coords_noise_smooth``), at training and at evaluation time;
- loss: L1 of the gap plus ``dist_loss_weight`` x the bin cross-entropy of
  the denoised distances against the clean DFT ones;
- eval: both heads averaged over ``evaluation_samples`` draws (each with
  its own noise; dropout on when ``predict_in_train``), the distance
  probabilities symmetrised over the pair transpose; per-graph |gap error|
  and per-graph cross-entropy.

Each draw's noise comes from ``derive_seed(seed, 0)`` and its dropout from
``derive_seed(seed, 1)``, so a resumed run repeats an uninterrupted one.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from tgt_torch.core.config import Config
from tgt_torch.schemes.base import TGTScheme, default_scheme_config
from tgt_torch.schemes.commons import (add_coords_noise, coords2dist,
                                       discrete_dist_loss, masked_l1)
from tgt_torch.training.harness import derive_seed


class PretrainScheme(TGTScheme):
    NAME = "pretrain"
    MODEL = "multi"

    def default_config(self, command: str) -> Config:
        c = default_scheme_config()
        c["save_path_prefix"] = "models/pcqm/pretrain"
        c["coords_noise"] = 0.5
        c["coords_noise_smooth"] = 1.0
        c["num_dist_bins"] = 256
        c["range_dist_bins"] = 8.0
        c["dist_loss_weight"] = 0.1
        c["train_split"] = "train-3d"
        c["val_split"] = "valid-3d"
        return c

    def extra_columns(self, split: str) -> List:
        from tgt_torch.data.pcqm import Coords
        return [Coords("dft")]

    def device_keys(self, training: bool = True):
        return ("node_features", "distance_matrix", "feature_matrix",
                "node_mask", "target", "dft_coords")

    def _noisy_forward(self, model, batch: Dict[str, torch.Tensor],
                       edge_mask: torch.Tensor, seed: int,
                       deterministic: bool):
        """(gap, dist_logits) of one forward on noisy DFT distances."""
        feed = {k: batch[k] for k in ("node_features", "distance_matrix",
                                      "feature_matrix", "node_mask")}
        feed["edge_mask"] = edge_mask
        gen = torch.Generator(device=edge_mask.device)
        gen.manual_seed(derive_seed(seed, 0))
        coords = add_coords_noise(batch["dft_coords"].float(), edge_mask,
                                  self.cfg.coords_noise,
                                  self.cfg.coords_noise_smooth, gen)
        feed["dist_input"] = coords2dist(coords)
        return model(feed, deterministic=deterministic,
                     seed=derive_seed(seed, 1))

    def loss_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        edge_mask = self.edge_mask_of(batch)
        gap, dist_logits = self._noisy_forward(model, batch, edge_mask, seed,
                                               deterministic=False)
        prim = masked_l1(gap.float(), batch["target"].float(),
                         self.own_samples(batch), batch.get("sample_count"))
        dist_targ = coords2dist(batch["dft_coords"].float())
        dloss = discrete_dist_loss(dist_logits, self.pair_rows(dist_targ),
                                   self.pair_rows(edge_mask),
                                   self.cfg.num_dist_bins,
                                   self.cfg.range_dist_bins,
                                   count=batch.get("pair_count"))
        loss = prim + self.cfg.dist_loss_weight * dloss
        return loss, {"gap_loss": prim, "dist_loss": dloss}

    @torch.no_grad()
    def eval_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        edge_mask = self.edge_mask_of(batch)
        det = not self.cfg.predict_in_train

        def one(s):
            gap, dist_logits = self._noisy_forward(model, batch, edge_mask,
                                                   s, deterministic=det)
            return {"gap": gap, "probs": torch.softmax(
                self.full_rows(dist_logits).float(), dim=-1)}

        acc, valid = self.mc_sample(one, seed, self.nb_draw_samples)
        v = torch.clamp(valid, min=1).float()
        gap_loss = torch.abs(acc["gap"] / v - batch["target"].float())
        probs = acc["probs"] + acc["probs"].transpose(-2, -3)
        probs = probs / (2.0 * v)
        dist_loss = discrete_dist_loss(
            torch.log(probs + 1e-9), coords2dist(batch["dft_coords"].float()),
            edge_mask, self.cfg.num_dist_bins, self.cfg.range_dist_bins,
            reduce=False)
        return {"gap_loss": gap_loss, "dist_loss": dist_loss,
                "valid_samples": valid}

    def evaluate_predictions(self, preds: Dict[str, np.ndarray]
                             ) -> Dict[str, float]:
        gap = float(np.mean(preds["gap_loss"]))
        dist = float(np.mean(preds["dist_loss"]))
        return {"gap_loss": gap, "dist_loss": dist,
                "loss": gap + self.cfg.dist_loss_weight * dist}
