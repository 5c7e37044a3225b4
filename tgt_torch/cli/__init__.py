"""Command line (counterpart of tgt_tpu/cli): ``train``, ``evaluate`` and
``predict`` of a scheme from a YAML config or a model dir."""
from tgt_torch.cli.execute import configs_from_args, execute, main

__all__ = ["execute", "configs_from_args", "main"]
