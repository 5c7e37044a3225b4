"""Training (counterpart of tgt_tpu/training): the optimizer written out
over the parameter tensors, the learning-rate schedules and the one-device
``Trainer``. Checkpoints, validation, ``fit``, the plateau controller and
the CLI come with ROADMAP.md item 1k."""
from tgt_torch.training.harness import (Trainer, make_optimizer,
                                        resolve_grad_accum)

__all__ = ["Trainer", "make_optimizer", "resolve_grad_accum"]
