"""Training (counterpart of tgt_tpu/training): the optimizer written out
over the parameter tensors, the learning-rate schedules and the plateau
controller, checkpoints in tgt_tpu's format, and the ``Trainer`` with
``fit``, on one device or one rank of many. The CLI is ``tgt_torch.cli``."""
from tgt_torch.training.harness import (StopTraining, Trainer,
                                        make_optimizer, resolve_grad_accum)

__all__ = ["Trainer", "StopTraining", "make_optimizer", "resolve_grad_accum"]
