"""Stage 4 — the trimmed gap predictor: final evaluation and submission
(counterpart of tgt_tpu/schemes/gap_pred.py).

As the reference (lib/training_schemes/pcqm/gap_pred/scheme.py):
- model: the gap model (the distance head and the last layer's edge branch
  dropped); ``train`` only loads the finetuned weights non-strictly and
  saves the trimmed checkpoint (``trim_checkpoint``);
- eval: MC gap draws cycling over the stored bins samples, averaged;
  validation -> MAE; test -> the OGB test-dev submission file, or
  ``y_pred_test_dev.npy`` where ogb is not installed.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from tgt_torch.core.config import Config
from tgt_torch.schemes.finetune import FinetuneScheme


class GapPredScheme(FinetuneScheme):
    NAME = "gap_pred"
    MODEL = "gap"

    def default_config(self, command: str) -> Config:
        c = super().default_config(command)
        c["save_path_prefix"] = "models/pcqm/gap_pred"
        return c

    def extra_columns(self, split: str) -> List:
        from tgt_torch.data.pcqm import Bins
        return [Bins(self.cfg.bins_input_path, self.bins_num_samples)]

    def device_keys(self, training: bool = True):
        return ("node_features", "distance_matrix", "feature_matrix",
                "node_mask", "target", "dist_bins")

    def loss_fn(self, model, batch, seed):
        raise NotImplementedError(
            "gap_pred does not train; its train command only trims the "
            "finetuned checkpoint (reference gap_pred/scheme.py:144-154)")

    @torch.no_grad()
    def eval_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        acc, valid, gaps = self._bins_draws(model, batch, seed)
        return {"gap_pred": acc / torch.clamp(valid, min=1).float(),
                "gap_target": batch["target"].float(),
                "gap_samples": torch.stack(gaps, dim=1),
                "valid_samples": valid}

    def evaluate_predictions(self, preds: Dict[str, np.ndarray],
                             dataset_name: str = "validation",
                             predictions_path: str = None) -> Dict[str, float]:
        gap_pred = preds["gap_pred"]
        if dataset_name == "test":
            # the OGB test-dev submission (reference gap_pred/scheme.py:
            # 121-130); the raw .npy where ogb is not installed
            out_dir = predictions_path or "."
            os.makedirs(out_dir, exist_ok=True)
            try:
                from ogb.lsc.pcqm4mv2 import PCQM4Mv2Evaluator
            except ImportError:
                np.save(os.path.join(out_dir, "y_pred_test_dev.npy"),
                        gap_pred)
                return {"loss": float("nan")}
            PCQM4Mv2Evaluator().save_test_submission(
                input_dict={"y_pred": gap_pred}, dir_path=out_dir,
                mode="test-dev")
            return {"loss": float("nan")}
        return {"loss": float(np.mean(np.abs(gap_pred - preds["gap_target"])))}

    def trim_checkpoint(self, finetuned_weights_file: str, out_file: str,
                        device=None):
        """Load the multi model's weights non-strictly into the gap model
        (initialised from seed 0) and save the trimmed model; returns the
        (missing, unexpected) key lists."""
        from tgt_torch.models.convert import jax_params_from_state_dict
        from tgt_torch.training.checkpoint import load_pretrained, save_pytree
        model = self.init_model(0, device)
        template = jax_params_from_state_dict(model.state_dict(),
                                              self.model_cfg, model)
        params, missing, unexpected = load_pretrained(template,
                                                      finetuned_weights_file)
        save_pytree(params, out_file)
        return missing, unexpected
