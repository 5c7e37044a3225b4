"""CLI dispatcher: config parsing + command execution (counterpart of
tgt_tpu/cli/execute.py).

Grammar as the reference (lib/training/execute.py:33-52):

    python -m tgt_torch.cli.run_training [config.yaml | model_dir] \
        ['key: yamlvalue'] ... [--device cpu]

- a model dir stands for its saved ``config.yaml``;
- later inline YAML snippets override the file;
- ``scheme: pcqm.<name>`` selects the task scheme;
- ``--device`` names the device; without it the commands run on the card.

Commands (reference execute.py:25-29):
    train    -> Trainer.fit (resumes from the model dir's checkpoint);
                gap_pred only trims the finetuned checkpoint
    predict  -> the scheme's predictions under <save_path>/predictions:
                dist_pred's bins directory (one parquet shard per rank),
                else ``{split}_{rank:03d}.npz`` per split (and results.yaml
                for finetune and gap_pred)
    evaluate -> metrics of the predict_on splits -> predictions/results.yaml

Several processes, one device each (data parallelism): every process runs
the same command, and the rendezvous comes from the yaml keys
``jax_coordinator``, ``jax_num_processes`` and ``jax_process_id`` or from
torchrun (``python -m torch.distributed.run --nproc-per-node 2 -m
tgt_torch.cli.run_training <yaml> [--device cpu]``). Each rank evaluates
and predicts its shard of a split; metrics come from the gathered
predictions, and rank 0 alone writes the config, the trim and
results.yaml.

With ``num_pair_devices: P`` the world of ``D x P`` processes is the
Trainer's (data, pair) grid: the P ranks of a data index run every
forward together on their own i-rows, the shards of a split are the data
indices' (``{split}_{data index:03d}``), and pair index 0 of each writes
them.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist
import yaml

from tgt_torch.core.config import load_yaml, parse_cli_overrides, save_yaml
from tgt_torch.schemes import get_scheme

COMMANDS = ("train", "predict", "evaluate")
DEFAULT_CONFIG_FILE = "config.yaml"


def configs_from_args(args: List[str]) -> Dict[str, Any]:
    config: Dict[str, Any] = {}
    if args:
        args = list(args)
        if os.path.isdir(args[0]):
            config.update(load_yaml(os.path.join(args[0],
                                                 DEFAULT_CONFIG_FILE)))
            args = args[1:]
        elif os.path.exists(args[0]) or args[0] == "-":
            # regular files and pipes (/dev/stdin, heredocs)
            path = "/dev/stdin" if args[0] == "-" else args[0]
            config.update(load_yaml(path))
            args = args[1:]
        if args:
            config.update(parse_cli_overrides(args))
    if "scheme" not in config:
        raise ValueError('"scheme" is not in config!')
    return config


def execute(command: str, config: Dict[str, Any],
            rank: Optional[int] = None, world_size: Optional[int] = None,
            device=None) -> Optional[Dict]:
    """Run ``command`` as rank ``rank`` of ``world_size``. Without them the
    process group comes from the config's rendezvous keys or torchrun's
    environment (``initialize_distributed``), or the run is one process;
    a group made here is destroyed at the end."""
    if command not in COMMANDS:
        raise ValueError(f"unknown command {command}; one of {COMMANDS}")
    scheme = get_scheme(config["scheme"])(config, command=command)
    made = False
    if rank is None or world_size is None:
        from tgt_torch.parallel import initialize_distributed
        existed = dist.is_initialized()
        rank, world_size = initialize_distributed(
            coordinator=scheme.cfg.jax_coordinator,
            num_processes=world_size or scheme.cfg.jax_num_processes,
            process_id=scheme.cfg.jax_process_id, device=device)
        made = dist.is_initialized() and not existed
    try:
        if dist.is_initialized():
            from tgt_torch.parallel import rank_device
            device = rank_device(device)
        from tgt_torch.training import Trainer
        trainer = Trainer(scheme, rank=rank, world_size=world_size,
                          device=device)
        if command == "train":
            return execute_train(scheme, trainer, config)
        if command == "predict":
            return execute_predict(scheme, trainer)
        return execute_evaluate(scheme, trainer)
    finally:
        if made:
            dist.destroy_process_group()


def execute_train(scheme, trainer, config) -> Dict:
    if trainer.is_main:
        os.makedirs(trainer.model_path, exist_ok=True)
        # the user config, for model-dir reruns (reference
        # training.py:255-265)
        save_yaml(config, os.path.join(trainer.model_path,
                                       DEFAULT_CONFIG_FILE))
    if scheme.NAME == "gap_pred":
        # gap_pred's training only trims the finetuned checkpoint
        # (reference gap_pred/scheme.py:144-154)
        if trainer.is_main:
            out = os.path.join(trainer.ckpt.ckpt_dir, "model.npz")
            missing, unexpected = scheme.trim_checkpoint(
                scheme.cfg.pretrained_weights_file, out,
                device=trainer.device)
            print(f"trimmed checkpoint saved to {out}")
            print(f"missing: {missing[:6]}\nunexpected (dropped): "
                  f"{unexpected[:6]}")
        if trainer.group:
            dist.barrier()      # the trimmed checkpoint is written
        return {}
    return trainer.fit()


def execute_predict(scheme, trainer) -> Dict:
    model = _load_eval_model(scheme, trainer)
    pred_path = os.path.join(trainer.model_path, "predictions")
    writes = trainer.pair_index == 0
    if scheme.NAME == "dist_pred":
        scheme.predict_and_save(model, rank=trainer.data_index,
                                world_size=trainer.num_data,
                                base_path=pred_path, device=trainer.device,
                                write=writes, axis_of=trainer.batch_axis)
        return {}
    os.makedirs(pred_path, exist_ok=True)
    results = {}
    for split in scheme.cfg.predict_on:
        preds = trainer.eval_epoch(model, scheme.test_loader(
            split, trainer.data_index, trainer.num_data))
        if writes:
            out_file = os.path.join(pred_path,
                                    f"{split}_{trainer.data_index:03d}.npz")
            np.savez(out_file, **preds)
            print(f"saved {split} predictions to {out_file}")
        results[split] = preds
    if scheme.NAME in ("finetune", "gap_pred"):
        # the per-rank files above stay shards; the metrics cover the
        # whole split
        _write_results(scheme, trainer, _gathered(trainer, results))
    return results


def execute_evaluate(scheme, trainer) -> Dict:
    model = _load_eval_model(scheme, trainer)
    results = {split: trainer.eval_epoch(model, scheme.test_loader(
        split, trainer.data_index, trainer.num_data))
        for split in scheme.cfg.predict_on}
    return _write_results(scheme, trainer, _gathered(trainer, results))


def _gathered(trainer, preds_by_split) -> Dict:
    return {split: trainer.gather(preds)
            for split, preds in preds_by_split.items()}


def _write_results(scheme, trainer, preds_by_split) -> Dict:
    """The metrics of each split's predictions (gathered: every rank
    computes the same), and results.yaml, written by rank 0."""
    pred_path = os.path.join(trainer.model_path, "predictions")
    metrics_all = {}
    for split, preds in preds_by_split.items():
        if scheme.NAME == "gap_pred" and split == "test" and \
                not trainer.is_main:
            # the test-dev submission is rank 0's to write; its metric
            # is NaN on every rank
            metrics = {"loss": float("nan")}
        elif scheme.NAME == "gap_pred":
            metrics = scheme.evaluate_predictions(
                preds, dataset_name=split, predictions_path=pred_path)
        else:
            metrics = scheme.evaluate_predictions(preds)
        metrics_all[split] = {k: float(v) for k, v in metrics.items()}
        trainer.log(f"[{split}] " + ", ".join(
            f"{k}={v:.6f}" for k, v in metrics_all[split].items()))
    if not trainer.is_main:
        return metrics_all
    os.makedirs(pred_path, exist_ok=True)
    # the results.yaml artifact (reference testing.py:152-172)
    path = os.path.join(pred_path, "results.yaml")
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = yaml.safe_load(f) or {}
    existing.update(metrics_all)
    save_yaml(existing, path)
    return metrics_all


def _load_eval_model(scheme, trainer):
    """The model of the model dir's checkpoint, else of
    ``pretrained_weights_file``, else freshly initialised (with a
    warning)."""
    model = trainer.init_state(0)["model"]
    if trainer.ckpt.has_checkpoint():
        trainer.load_params_tree(model, trainer.ckpt.load_model_only(
            trainer.params_tree(model)))
        trainer.log(f"loaded model from {trainer.ckpt.ckpt_dir}")
    elif scheme.cfg.pretrained_weights_file:
        from tgt_torch.training.checkpoint import load_pretrained
        params, _, _ = load_pretrained(trainer.params_tree(model),
                                       scheme.cfg.pretrained_weights_file)
        trainer.load_params_tree(model, params)
    else:
        trainer.log("WARNING: no checkpoint found; evaluating random init")
    return model


def main(command: str, argv: Optional[List[str]] = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    execute(command, configs_from_args(args), device=device)
