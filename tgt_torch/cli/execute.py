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
                dist_pred's bins directory, else ``{split}_000.npz`` per
                split (and results.yaml for finetune and gap_pred)
    evaluate -> metrics of the predict_on splits -> predictions/results.yaml

One process on one device: a world size above 1 is ROADMAP.md item 1m.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
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


def execute(command: str, config: Dict[str, Any], world_size: int = 1,
            device=None) -> Optional[Dict]:
    if command not in COMMANDS:
        raise ValueError(f"unknown command {command}; one of {COMMANDS}")
    scheme = get_scheme(config["scheme"])(config, command=command)
    world_size = max(world_size, scheme.cfg.jax_num_processes or 1)
    if world_size > 1:
        raise NotImplementedError(
            f"world_size={world_size}: data parallelism is not ported yet "
            f"(ROADMAP.md item 1m); run one process")

    from tgt_torch.training import Trainer
    trainer = Trainer(scheme, device=device)
    if command == "train":
        return execute_train(scheme, trainer, config)
    if command == "predict":
        return execute_predict(scheme, trainer)
    return execute_evaluate(scheme, trainer)


def execute_train(scheme, trainer, config) -> Dict:
    os.makedirs(trainer.model_path, exist_ok=True)
    # the user config, for model-dir reruns (reference training.py:255-265)
    save_yaml(config, os.path.join(trainer.model_path, DEFAULT_CONFIG_FILE))
    if scheme.NAME == "gap_pred":
        # gap_pred's training only trims the finetuned checkpoint
        # (reference gap_pred/scheme.py:144-154)
        out = os.path.join(trainer.ckpt.ckpt_dir, "model.npz")
        missing, unexpected = scheme.trim_checkpoint(
            scheme.cfg.pretrained_weights_file, out, device=trainer.device)
        print(f"trimmed checkpoint saved to {out}")
        print(f"missing: {missing[:6]}\nunexpected (dropped): "
              f"{unexpected[:6]}")
        return {}
    return trainer.fit()


def execute_predict(scheme, trainer) -> Dict:
    model = _load_eval_model(scheme, trainer)
    pred_path = os.path.join(trainer.model_path, "predictions")
    if scheme.NAME == "dist_pred":
        scheme.predict_and_save(model, base_path=pred_path,
                                device=trainer.device)
        return {}
    os.makedirs(pred_path, exist_ok=True)
    results = {}
    for split in scheme.cfg.predict_on:
        preds = trainer.eval_epoch(model, scheme.test_loader(split, 0, 1))
        out_file = os.path.join(pred_path, f"{split}_000.npz")
        np.savez(out_file, **preds)
        print(f"saved {split} predictions to {out_file}")
        results[split] = preds
    if scheme.NAME in ("finetune", "gap_pred"):
        _write_results(scheme, trainer, results)
    return results


def execute_evaluate(scheme, trainer) -> Dict:
    model = _load_eval_model(scheme, trainer)
    results = {split: trainer.eval_epoch(model,
                                         scheme.test_loader(split, 0, 1))
               for split in scheme.cfg.predict_on}
    return _write_results(scheme, trainer, results)


def _write_results(scheme, trainer, preds_by_split) -> Dict:
    pred_path = os.path.join(trainer.model_path, "predictions")
    metrics_all = {}
    for split, preds in preds_by_split.items():
        if scheme.NAME == "gap_pred":
            metrics = scheme.evaluate_predictions(
                preds, dataset_name=split, predictions_path=pred_path)
        else:
            metrics = scheme.evaluate_predictions(preds)
        metrics_all[split] = {k: float(v) for k, v in metrics.items()}
        print(f"[{split}] " + ", ".join(f"{k}={v:.6f}"
                                        for k, v in metrics_all[split].items()))
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
        print(f"loaded model from {trainer.ckpt.ckpt_dir}")
    elif scheme.cfg.pretrained_weights_file:
        from tgt_torch.training.checkpoint import load_pretrained
        params, _, _ = load_pretrained(trainer.params_tree(model),
                                       scheme.cfg.pretrained_weights_file)
        trainer.load_params_tree(model, params)
    else:
        print("WARNING: no checkpoint found; evaluating random init",
              flush=True)
    return model


def main(command: str, argv: Optional[List[str]] = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    execute(command, configs_from_args(args), device=device)
