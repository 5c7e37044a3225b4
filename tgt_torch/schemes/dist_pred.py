"""Stage 1 — the distance predictor scheme (counterpart of
tgt_tpu/schemes/dist_pred.py); serving is
``tgt_torch.serving.DistancePredictor``.

As the reference (lib/training_schemes/pcqm/dist_pred/scheme.py):
- input: RDKit (or DFT, or no) coordinates as distances, optionally with
  smooth input noise; target: the binned DFT distances, optionally with
  target noise;
- loss: the masked cross-entropy of the bin logits;
- eval: the f32 softmax averaged over ``evaluation_samples`` draws (dropout
  on when ``predict_in_train``), symmetrised as p + p^T, non-finite draws
  skipped; per-graph cross-entropy of its log;
- predict: per-draw argmax bins -> packed uint8/16 upper triangles ->
  per-rank parquet shards + meta.json (the ``bins{S}`` directory).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from tgt_torch.core.config import Config, Lazy
from tgt_torch.data.bins import bins_dtype, pack_bins_multi
from tgt_torch.parallel.mesh import current_pair_axis, pair_scope
from tgt_torch.schemes.base import TGTScheme, default_scheme_config
from tgt_torch.schemes.commons import (add_coords_noise, coords2dist,
                                       discrete_dist_loss, stack_draws)
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

    def extra_columns(self, split: str) -> List:
        from tgt_torch.data.pcqm import Coords
        cols = []
        if self.cfg.coords_input == "rdkit" or self.cfg.coords_target == "rdkit":
            cols.append(Coords("rdkit"))
        if self.cfg.coords_input == "dft" or self.cfg.coords_target == "dft":
            cols.append(Coords("dft"))
        return cols

    def device_keys(self, training: bool = True):
        keys = ["node_features", "distance_matrix", "feature_matrix",
                "node_mask"]
        if self.cfg.coords_input != "none":
            keys.append(f"{self.cfg.coords_input}_coords")
        keys.append(f"{self.cfg.coords_target}_coords")
        return keys

    # -- device-side input construction -------------------------------------
    def _model_inputs(self, batch: Dict[str, torch.Tensor],
                      edge_mask: torch.Tensor, generator: torch.Generator,
                      training: bool = True) -> Dict[str, torch.Tensor]:
        feed = {k: batch[k] for k in ("node_features", "distance_matrix",
                                      "feature_matrix", "node_mask")}
        feed["edge_mask"] = edge_mask
        if self.cfg.coords_input != "none":
            coords = batch[f"{self.cfg.coords_input}_coords"].float()
            if training and self.cfg.coords_noise > 0:
                coords = add_coords_noise(coords, edge_mask,
                                          self.cfg.coords_noise,
                                          self.cfg.coords_noise_smooth,
                                          generator)
            feed["dist_input"] = coords2dist(coords)
        return feed

    def _dist_target(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator,
                     training: bool = True) -> torch.Tensor:
        coords = batch[f"{self.cfg.coords_target}_coords"].float()
        if training and self.cfg.coords_target_noise > 0:
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
        loss = discrete_dist_loss(logits, self.pair_rows(dist_targ),
                                  self.pair_rows(edge_mask),
                                  self.cfg.num_dist_bins,
                                  self.cfg.range_dist_bins,
                                  count=batch.get("pair_count"))
        return loss, {}

    # -- evaluation ------------------------------------------------------------
    def _probs(self, model, feed, seed: int) -> torch.Tensor:
        """The f32 bin probabilities of one draw; dropout on when
        ``predict_in_train`` (reference tgt_training.py:42)."""
        logits = model(feed, deterministic=not self.cfg.predict_in_train,
                       seed=seed)
        return torch.softmax(self.full_rows(logits).float(), dim=-1)

    @torch.no_grad()
    def eval_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        """Per-graph cross-entropy of the log of the draws' mean
        symmetrised probabilities, and the count of finite draws. Under
        ``mc_eval_mode: vmap`` the draws run as one draw-stacked forward
        (off the pair axis, whose forward takes one seed)."""
        edge_mask = self.edge_mask_of(batch)
        feed = self._model_inputs(batch, edge_mask, None, training=False)
        dist_targ = self._dist_target(batch, None, training=False)

        def stacked(seeds):
            p = self._probs(model, stack_draws(feed, len(seeds)), seeds)
            return {"p": p.view(len(seeds), -1, *p.shape[1:])}

        sums, valid = self.mc_sample(
            lambda s: {"p": self._probs(model, feed, s)}, seed,
            self.nb_draw_samples,
            stacked if current_pair_axis() is None else None)
        probs = sums["p"] + sums["p"].transpose(-2, -3)
        probs = probs / (2.0 * torch.clamp(valid, min=1).float())
        logits = torch.log(probs + 1e-9)
        xent = discrete_dist_loss(logits, dist_targ, edge_mask,
                                  self.cfg.num_dist_bins,
                                  self.cfg.range_dist_bins, reduce=False)
        return {"loss": xent, "valid_samples": valid}

    def evaluate_predictions(self, preds: Dict[str, np.ndarray]
                             ) -> Dict[str, float]:
        return {"loss": float(np.mean(preds["loss"]))}

    # -- bins prediction -------------------------------------------------------
    @torch.no_grad()
    def predict_bins_fn(self, model, batch: Dict[str, torch.Tensor],
                        seed: int) -> torch.Tensor:
        """``nb_draw_samples`` argmax-bin draws of the symmetrised
        probabilities, the k-th under ``derive_seed(seed, k)``:
        (b, S, N, N) int32."""
        edge_mask = self.edge_mask_of(batch)
        feed = self._model_inputs(batch, edge_mask, None, training=False)
        draws = []
        for k in range(self.nb_draw_samples):
            p = self._probs(model, feed, derive_seed(seed, k))
            draws.append(torch.argmax(p + p.transpose(-2, -3),
                                      dim=-1).to(torch.int32))
        return torch.stack(draws, dim=1)

    def predict_and_save(self, model, rank: int = 0, world_size: int = 1,
                         base_path: str = None, device=None,
                         write: bool = True, axis_of=None) -> None:
        """Bins draws for each ``predict_on`` split, written as per-rank
        parquet shards ``data/{split}_{rank:03d}.parquet`` (columns idx and
        bins: the draws' packed upper triangles over the molecule's own
        atoms, concatenated) + ``meta.json`` (reference
        dist_pred/scheme.py:256-306). On the pair axis ``rank`` and
        ``world_size`` are the data index and count, every rank of the pair
        group runs the draws on the axis ``axis_of(device batch)`` gives
        (``Trainer.batch_axis``), and only pair index 0 writes
        (``write``)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        base_path = base_path or os.path.join(self.cfg.save_path, "predictions")
        save_dir = os.path.join(base_path, self.cfg.save_pred_dir)
        data_dir = os.path.join(save_dir, "data")
        if write:
            os.makedirs(data_dir, exist_ok=True)
        if rank == 0 and write:
            with open(os.path.join(save_dir, "meta.json"), "w") as f:
                json.dump({"num_bins": self.cfg.num_dist_bins,
                           "range_bins": self.cfg.range_dist_bins,
                           "num_samples": self.nb_draw_samples}, f)
        device = device or next(model.parameters()).device
        dtype = bins_dtype(self.cfg.num_dist_bins)
        for split in self.cfg.predict_on:
            loader = self.test_loader(split, rank, world_size)
            all_idx, all_bins = [], []
            for i, batch in enumerate(loader):
                db = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      for k, v in self.device_batch(batch,
                                                    training=False).items()}
                with pair_scope(None if axis_of is None else axis_of(db)):
                    bins = self.predict_bins_fn(model, db, derive_seed(
                        1234 + rank, i)).cpu().numpy().astype(dtype)
                num_nodes = batch["node_mask"].sum(-1).astype(int)
                for bi, n in enumerate(num_nodes):
                    all_bins.append(
                        pack_bins_multi(bins[bi, :, :n, :n]).reshape(-1))
                # global row ids: a running position would collide across
                # rank shards and misjoin in the finetune stage
                all_idx.append(np.asarray(batch["idx"]))
            if not write:
                continue
            table = pa.Table.from_pydict({"idx": np.concatenate(all_idx),
                                          "bins": all_bins})
            out = os.path.join(data_dir, f"{split}_{rank:03d}.parquet")
            pq.write_table(table, out)
            print(f"rank {rank} saved {split} bins to {out}", flush=True)
