"""Scheme base: the layered defaults, the model config built from them,
and what the Trainer needs of a task (counterpart of
tgt_tpu/schemes/base.py).

A scheme resolves a user config (a published YAML) over the reference's
defaults and builds the ``TGTConfig``. The full key set of tgt_tpu is kept,
so every published config loads and a mistyped key still raises. Also:
the learning-rate schedule, the datasets (synthetic, or the PCQM parquet
files with per-rank cache ranges), the train loader (random or
size-bucketed batches), the validation and test loaders, the device batch
(batch-axis padding and ``sample_mask``), the edge mask and MC sampling.

A task's ``loss_fn(model, batch, seed) -> (loss, aux)`` and
``eval_fn(model, batch, seed) -> dict`` take the model module (the
parameters live in it) and a device batch of tensors; every random draw
comes from ``seed``. The loss's masked means divide by the batch's
``pair_count`` and ``sample_count`` where the Trainer puts them there
(their sums over the ranks, ``loss_counts``), else by its own counts. ``precompile_buckets`` is accepted and has no effect:
the port runs eagerly, so there is no program to compile ahead.

On the pair axis (inside the Trainer's ``pair_scope``) the distance logits
hold this rank's i-rows: a loss takes the same rows of its targets and
pair mask (``pair_rows``), and a per-sample term, which every rank of the
pair group computes alike from the whole node state, counts on pair index
0 alone (``own_samples``). Evaluation reads the whole rows
(``full_rows``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tgt_torch.core.config import Config, Lazy
from tgt_torch.data.collate import pad_batch_dim, padded_collate
from tgt_torch.data.loader import (DataLoader, DistributedTestSampler,
                                   DistributedTrainSampler,
                                   SizeBucketedTrainSampler, slice_for_rank)
from tgt_torch.data.synthetic import SyntheticDataset
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.parallel.mesh import current_pair_axis
from tgt_torch.parallel.ring import _gather_rows
from tgt_torch.training import schedules
from tgt_torch.training.harness import derive_seed, resolve_grad_accum


class Subset:
    """First-k view of a dataset (trial-run capping)."""

    def __init__(self, dataset, k: int):
        self.dataset = dataset
        self.k = k

    def __len__(self):
        return self.k

    def __getitem__(self, i):
        return self.dataset[i]


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
        self.nb_draw_samples = (self.cfg.prediction_samples
                                if command == "predict"
                                else self.cfg.evaluation_samples)
        self.lr_scale = 1.0
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
    def dataset_split_name(self, split: str) -> str:
        return {"train": self.cfg.train_split, "val": self.cfg.val_split,
                "test": self.cfg.test_split}[split]

    def extra_columns(self, split: str) -> List:
        return []

    def get_dataset(self, split: str, rank: int = 0, world_size: int = 1):
        if split in self._datasets:
            return self._datasets[split]
        if self.cfg.dataset_source == "synthetic":
            n = (self.cfg.synth_train_samples if split == "train"
                 else self.cfg.synth_val_samples)
            ds = SyntheticDataset(num_samples=n,
                                  max_nodes=self.cfg.synth_max_nodes,
                                  seed={"train": 0, "val": 1, "test": 2}[split])
        else:
            from tgt_torch.data.pcqm import PCQM4Mv2Dataset
            from tgt_torch.data.structural import AddStructuralData
            # per-rank cache range: each process loads only its sampler's
            # contiguous slice (reference data.py:63-66); trial_run reads
            # rows 0..k, so it needs the whole split
            cache_range_fn = None
            if world_size > 1 and not self.cfg.trial_run:
                cache_range_fn = (lambda n, r=rank, w=world_size:
                                  slice_for_rank(n, r, w))
            ds = PCQM4Mv2Dataset(
                split=self.dataset_split_name(split),
                dataset_path=self.cfg.dataset_path,
                return_idx=True,
                cache_range_fn=cache_range_fn,
                transforms=[AddStructuralData()],
                additional_columns=self.extra_columns(split))
        if self.cfg.trial_run:
            # a trial run caps each dataset at 2 batches (reference
            # training.py:57-70,235-240)
            ds = Subset(ds, min(len(ds), self.cfg.batch_size * 2))
        self._datasets[split] = ds
        return ds

    def _collate(self, rows):
        return padded_collate(rows, buckets=tuple(self.cfg.buckets))

    def train_loader(self, epoch: int, rank: int, world_size: int):
        """Host batches of ``batch_size * accum`` molecules: the Trainer
        splits each back into ``batch_size`` micro-batches."""
        ds = self.get_dataset("train", rank, world_size)
        bsz = self.cfg.batch_size * resolve_grad_accum(self.cfg, world_size)
        sizes = getattr(ds, "sizes", None)
        if self.cfg.size_bucketed_batching and sizes is not None and \
                len(sizes) == len(ds):
            if world_size > 1:
                # each rank's bucket remainders give it its own number of
                # batches, and the Trainer's collectives would wait forever
                raise ValueError(
                    "size_bucketed_batching gives the ranks different "
                    f"numbers of batches; it needs a world size of 1 (got "
                    f"{world_size})")
            sampler = SizeBucketedTrainSampler(
                sizes, bsz, self.cfg.buckets, rank=rank,
                world_size=world_size, seed=self.cfg.random_seed or 0)
        else:
            sampler = DistributedTrainSampler(len(ds), bsz, rank=rank,
                                              world_size=world_size,
                                              seed=self.cfg.random_seed or 0)
        sampler.set_epoch(epoch)
        return DataLoader(ds, sampler, collate_fn=self._collate)

    def val_loader(self, rank: int, world_size: int):
        return self.test_loader("val", rank, world_size)

    def test_loader(self, split: str, rank: int, world_size: int):
        """Fixed batches of ``batch_size * prediction_bmult`` molecules of
        this rank's contiguous chunk of ``split``."""
        ds = self.get_dataset(split if split in ("train", "val", "test")
                              else "val", rank, world_size)
        bsz = round(self.cfg.batch_size * self.cfg.prediction_bmult)
        sampler = DistributedTestSampler(len(ds), bsz, rank=rank,
                                         world_size=world_size)
        return DataLoader(ds, sampler, collate_fn=self._collate)

    # -- batch plumbing ---------------------------------------------------------
    DEVICE_KEYS = ("node_features", "distance_matrix", "feature_matrix",
                   "node_mask", "target")

    def device_keys(self, training: bool = True):
        return self.DEVICE_KEYS

    def batch_num_samples(self, batch: Dict[str, np.ndarray]) -> int:
        return int(batch["node_mask"].shape[0])

    def device_batch(self, batch: Dict[str, np.ndarray],
                     training: bool = True) -> Dict[str, np.ndarray]:
        """The keys the task reads, with the batch axis zero-padded to at
        least ``batch_size`` (``batch_size * prediction_bmult`` outside
        training) and a (b,) ``sample_mask`` of the real rows."""
        sub = {k: batch[k] for k in self.device_keys(training) if k in batch}
        target_b = round(self.cfg.batch_size *
                         (1 if training else self.cfg.prediction_bmult))
        sub, sample_mask = pad_batch_dim(sub, max(target_b,
                                                  len(batch["node_mask"])))
        sub["sample_mask"] = sample_mask
        return sub

    @staticmethod
    def edge_mask_of(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(b, N, N) pair mask, zero for every pair of a padded sample."""
        nm = batch["node_mask"].float() * batch["sample_mask"].float()[:, None]
        return nm[:, :, None] * nm[:, None, :]

    @staticmethod
    def pair_rows(x: torch.Tensor) -> torch.Tensor:
        """This rank's i-rows of a (b, N, N, ...) pair tensor on the pair
        axis; ``x`` itself off it."""
        axis = current_pair_axis()
        return x if axis is None else x[:, axis.rows(x.shape[1])]

    @staticmethod
    def full_rows(x: torch.Tensor) -> torch.Tensor:
        """The whole rows of a pair-sharded output (the distance logits)
        on the pair axis; ``x`` itself off it."""
        axis = current_pair_axis()
        return x if axis is None else _gather_rows(x, axis)

    @staticmethod
    def own_samples(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The (b,) mask of the samples whose per-sample loss terms this
        rank counts: ``sample_mask``, and zeros on a pair rank other than
        index 0, whose terms pair index 0 counts already."""
        axis = current_pair_axis()
        mask = batch["sample_mask"]
        return mask if axis is None or axis.index == 0 else \
            torch.zeros_like(mask)

    def loss_counts(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The counts that ``loss_fn``'s masked means divide by: the valid
        pairs (``edge_mask_of``, this rank's rows on the pair axis) and the
        real samples (``own_samples``). Under a process group the Trainer
        sums them over the ranks and passes the sums in the batch under
        these keys, so that each rank's loss is its share of the global
        batch's."""
        return {"pair_count": self.pair_rows(self.edge_mask_of(batch)).sum(),
                "sample_count": self.own_samples(batch).float().sum()}

    # -- task hooks -------------------------------------------------------------
    def loss_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        raise NotImplementedError

    def eval_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        raise NotImplementedError

    def postprocess_eval(self, out: Dict[str, np.ndarray],
                         host_batch: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        """Strip padded samples from per-graph outputs (host side)."""
        n = len(host_batch["node_mask"])
        return {k: v[:n] if v.ndim >= 1 and v.shape[0] >= n else v
                for k, v in out.items()}

    def evaluate_predictions(self, preds: Dict[str, np.ndarray]
                             ) -> Dict[str, float]:
        raise NotImplementedError

    # -- MC sampling ------------------------------------------------------------
    def mc_sample(self, fn: Callable[[int], Dict[str, torch.Tensor]],
                  seed: int, num_samples: int,
                  stacked: Optional[Callable[[List[int]],
                                             Dict[str, torch.Tensor]]] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Sum ``fn(seed_k)`` in f32 over ``num_samples`` draws, the k-th
        under ``derive_seed(seed, k)``, skipping every draw with a
        non-finite value (reference dist_pred/scheme.py:139-167, its
        NaN-resample loop). Returns (sums, count of the valid draws).

        ``mc_eval_mode`` schedules the draws (tgt_tpu/schemes/base.py:
        421-455): ``map`` calls ``fn`` once per draw; ``vmap`` calls
        ``stacked(seeds)`` once, a draw-stacked forward of all the draws'
        seeds that returns each value with a leading draw axis, entry k
        ``fn(seed_k)``'s. Each draw is then finite or not on its own, and
        the sums run in the same order as the loop's. A caller without a
        draw-stacked form (``stacked`` None) runs the loop in either mode."""
        seeds = [derive_seed(seed, k) for k in range(num_samples)]
        if stacked is not None and self.cfg.mc_eval_mode == "vmap":
            outs = stacked(seeds)
            draws = ({n: v[k] for n, v in outs.items()}
                     for k in range(num_samples))
        else:
            draws = (fn(s) for s in seeds)
        acc: Optional[Dict[str, torch.Tensor]] = None
        valid = None
        for out in draws:
            finite = torch.stack([torch.isfinite(v).all()
                                  for v in out.values()]).all()
            if acc is None:
                acc = {n: torch.zeros_like(v, dtype=torch.float32)
                       for n, v in out.items()}
                valid = torch.zeros((), dtype=torch.int32,
                                    device=finite.device)
            # decided on the device: the host never waits on a draw
            acc = {n: torch.where(finite, a + out[n].float(), a)
                   for n, a in acc.items()}
            valid = valid + finite.to(torch.int32)
        return acc, valid
