"""Scheme base: the layered defaults, the model config built from them,
and what the Trainer needs of a task (counterpart of
tgt_tpu/schemes/base.py).

A scheme resolves a user config (a published YAML) over the reference's
defaults and builds the ``TGTConfig``. The full key set of tgt_tpu is kept,
so every published config loads and a mistyped key still raises. Ported
for training: the learning-rate schedule, the synthetic dataset, the train
loader, the device batch (batch-axis padding and ``sample_mask``) and the
edge mask. The PCQM parquet data, validation and test loaders and MC
sampling come with ROADMAP.md items 1j and 1k.

A task's ``loss_fn(model, batch, seed) -> (loss, aux)`` takes the model
module (the parameters live in it) and a device batch of tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from tgt_torch.core.config import Config, Lazy
from tgt_torch.data.collate import pad_batch_dim, padded_collate
from tgt_torch.data.loader import DataLoader, DistributedTrainSampler
from tgt_torch.data.synthetic import SyntheticDataset
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.training import schedules
from tgt_torch.training.harness import resolve_grad_accum


def default_scheme_config() -> Config:
    """Shared config keys with the reference's defaults
    (training.py:196-241, tgt_training.py:12-49, training_mixins.py:276-290)."""
    return Config(
        scheme=None,
        model_name="tgt",
        model_prefix=None,
        save_path_prefix="models/pcqm",
        save_path=Lazy(lambda c: (
            f"{c.save_path_prefix}/{c.model_name}" if c.model_prefix is None
            else f"{c.save_path_prefix}/{c.model_prefix}/{c.model_name}")),
        distributed=False,
        dataloader_workers=1,
        evaluation_type="prediction",
        mixed_precision=False,
        jax_coordinator=None,
        jax_num_processes=None,
        jax_process_id=None,
        dataset_source="pcqm",
        dataset_path="data/PCQM",
        random_seed=0,
        num_epochs=1000,
        batch_size=32,
        validation_frequency=1,
        validation_condition=None,
        save_model_condition=None,
        # model (read by build_model_cfg)
        model_height=4,
        node_width=64,
        edge_width=8,
        num_heads=8,
        node_act_dropout=0.0,
        edge_act_dropout=0.0,
        source_dropout=0.0,
        drop_path=0.0,
        activation="gelu",
        scale_degree=True,
        node_ffn_multiplier=1.0,
        edge_ffn_multiplier=1.0,
        layer_multiplier=1,
        upto_hop=32,
        triplet_heads=0,
        triplet_type="aggregate",
        triplet_dropout=0.0,
        embed_3d_type="gaussian",
        num_3d_kernels=128,
        compute_dtype="float32",
        remat=False,
        remat_policy="none",
        compilation_cache_dir=None,
        use_scan=True,
        use_pallas=False,
        dense_min_nodes=48,
        dense_min_exact_nodes=32,
        mc_eval_mode="map",
        buckets=[16, 24, 32, 48, 64],
        use_mesh=True,
        num_pair_devices=1,
        rng_impl="rbg",
        optimizer="adam",
        sgd_momentum=0.0,
        max_lr=5e-4,
        min_lr=1e-6,
        lr_schedule="warmup_cosine",
        lr_warmup_steps=60_000,
        lr_total_steps=1_000_000,
        cosine_halfwave=False,
        clip_grad_value=None,
        clip_grad_norm=None,
        weight_decay=0.0,
        max_recovery_tries=10,
        grad_accum_steps=1,
        global_batch_size=None,
        infer_micro_weights=False,
        rlr_factor=None,
        rlr_patience=10,
        stopping_lr=0.0,
        precompile_buckets=False,
        size_bucketed_batching=False,
        debug_nans=False,
        # eval / predict
        evaluation_samples=10,
        prediction_samples=10,
        predict_in_train=True,
        predict_on=["val"],
        prediction_bmult=1,
        monitor="val_loss",
        save_all_checkpoints=False,
        pretrained_weights_file=None,
        trial_run=False,
        train_split="train",
        val_split="valid",
        test_split="test-dev",
        synth_train_samples=64,
        synth_val_samples=32,
        synth_max_nodes=16,
    )


class TGTScheme:
    """Base scheme: resolves the config and builds the model config."""

    NAME = "base"
    MODEL = "multi"

    def __init__(self, overrides: Optional[Dict[str, Any]] = None,
                 command: str = "train"):
        cfg = self.default_config(command)
        if overrides:
            overrides = dict(overrides)
            overrides.pop("scheme", None)  # consumed by the dispatcher
            cfg.override(overrides)
        self.cfg = cfg.resolve()
        if self.cfg.mixed_precision and self.cfg.compute_dtype == "float32":
            self.cfg.compute_dtype = "bfloat16"
        self.command = command
        self.model_cfg = self.build_model_cfg()
        self._datasets: Dict[str, Any] = {}

    def default_config(self, command: str) -> Config:
        return default_scheme_config()

    def build_model_cfg(self) -> TGTConfig:
        c = self.cfg

        def iv(v):
            # YAML lists become per-layer IndivConfig tuples
            return tuple(v) if isinstance(v, list) else v

        return TGTConfig(
            node_width=c.node_width, edge_width=c.edge_width,
            num_heads=iv(c.num_heads), model_height=c.model_height,
            layer_multiplier=c.layer_multiplier,
            triplet_heads=iv(c.triplet_heads),
            triplet_type=iv(c.triplet_type),
            triplet_dropout=iv(c.triplet_dropout),
            activation=iv(c.activation),
            scale_degree=iv(c.scale_degree),
            node_ffn_multiplier=iv(c.node_ffn_multiplier),
            edge_ffn_multiplier=iv(c.edge_ffn_multiplier),
            source_dropout=iv(c.source_dropout), drop_path=iv(c.drop_path),
            node_act_dropout=iv(c.node_act_dropout),
            edge_act_dropout=iv(c.edge_act_dropout),
            upto_hop=c.upto_hop, embed_3d_type=c.embed_3d_type,
            num_3d_kernels=c.num_3d_kernels,
            num_dist_bins=getattr(c, "num_dist_bins", 256),
            compute_dtype=c.compute_dtype, remat=c.remat,
            remat_policy=c.remat_policy or "none",
            use_scan=c.use_scan, use_pallas=c.use_pallas,
            dense_min_nodes=c.dense_min_nodes,
            dense_min_exact_nodes=c.dense_min_exact_nodes)

    # -- model --------------------------------------------------------------
    def init_model(self, seed: int, device=None):
        """The task model with weights drawn from ``seed``."""
        return make_model(self.MODEL, self.model_cfg, device=device, seed=seed)

    def make_lr_schedule(self):
        c = self.cfg
        kind = c.lr_schedule or "constant"
        if kind == "warmup_cosine":
            return schedules.warmup_cosine(c.max_lr, c.lr_warmup_steps,
                                           c.lr_total_steps, c.min_lr,
                                           c.cosine_halfwave)
        if kind == "warmup_linear":
            return schedules.warmup_linear(c.max_lr, c.lr_warmup_steps)
        return schedules.constant(c.max_lr)

    # -- datasets -------------------------------------------------------------
    def get_dataset(self, split: str):
        if split in self._datasets:
            return self._datasets[split]
        if self.cfg.dataset_source != "synthetic":
            raise NotImplementedError(
                f"dataset_source={self.cfg.dataset_source!r}: the PCQM "
                f"parquet data layer is not ported yet (ROADMAP.md item 1j); "
                f"use dataset_source: synthetic")
        n = (self.cfg.synth_train_samples if split == "train"
             else self.cfg.synth_val_samples)
        ds = SyntheticDataset(num_samples=n, max_nodes=self.cfg.synth_max_nodes,
                              seed={"train": 0, "val": 1, "test": 2}[split])
        self._datasets[split] = ds
        return ds

    def train_loader(self, epoch: int, rank: int, world_size: int):
        """Host batches of ``batch_size * accum`` molecules: the Trainer
        splits each back into ``batch_size`` micro-batches."""
        if self.cfg.size_bucketed_batching:
            raise NotImplementedError(
                "size_bucketed_batching: the size-bucketed train sampler is "
                "not ported yet (ROADMAP.md item 1j)")
        ds = self.get_dataset("train")
        bsz = self.cfg.batch_size * resolve_grad_accum(self.cfg, world_size)
        sampler = DistributedTrainSampler(len(ds), bsz, rank=rank,
                                          world_size=world_size,
                                          seed=self.cfg.random_seed or 0)
        sampler.set_epoch(epoch)
        return DataLoader(ds, sampler,
                          collate_fn=lambda rows: padded_collate(
                              rows, buckets=tuple(self.cfg.buckets)))

    # -- batch plumbing ---------------------------------------------------------
    DEVICE_KEYS = ("node_features", "distance_matrix", "feature_matrix",
                   "node_mask", "target")

    def device_keys(self):
        return self.DEVICE_KEYS

    def batch_num_samples(self, batch: Dict[str, np.ndarray]) -> int:
        return int(batch["node_mask"].shape[0])

    def device_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """The keys the task reads, with the batch axis zero-padded to at
        least ``batch_size`` and a (b,) ``sample_mask`` of the real rows."""
        sub = {k: batch[k] for k in self.device_keys() if k in batch}
        sub, sample_mask = pad_batch_dim(sub, max(self.cfg.batch_size,
                                                  len(batch["node_mask"])))
        sub["sample_mask"] = sample_mask
        return sub

    @staticmethod
    def edge_mask_of(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(b, N, N) pair mask, zero for every pair of a padded sample."""
        nm = batch["node_mask"].float() * batch["sample_mask"].float()[:, None]
        return nm[:, :, None] * nm[:, None, :]

    # -- task hooks -------------------------------------------------------------
    def loss_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        raise NotImplementedError
