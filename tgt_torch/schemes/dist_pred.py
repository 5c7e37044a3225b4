"""Stage 1 — the distance predictor scheme's configuration (the defaults
of tgt_tpu/schemes/dist_pred.py:34-53). Training, evaluation and bins
prediction to parquet come with the trainer slice (ROADMAP.md item 1k);
serving is ``tgt_torch.serving.DistancePredictor``."""
from __future__ import annotations

from tgt_torch.core.config import Config, Lazy
from tgt_torch.schemes.base import TGTScheme, default_scheme_config


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
