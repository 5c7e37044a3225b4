"""tgt_torch — the Triplet Graph Transformer in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

Port of ``tgt_tpu`` (JAX on TPU), which stays the reference. The module
layout mirrors ``tgt_tpu`` so each module's counterpart is easy to find.
This package imports ``torch``, ``numpy`` and ``yaml``; it never imports
``jax`` or ``tgt_tpu``.

Ported so far: serving of the distance predictor (``tgt_torch.serving.
DistancePredictor``), its training (``tgt_torch.training.Trainer`` on the
``pcqm.dist_pred`` scheme, with checkpoints in tgt_tpu's format), the
PCQM4Mv2 parquet data layer and the CLI (``python -m
tgt_torch.cli.run_training``, ``do_evaluations``, ``make_predictions``),
with all six triplet variants; the preparation of the real PCQM4Mv2
(``tgt_torch.data.prepare``), the native structural transform, the import
of released reference checkpoints (``python -m tgt_torch.models.convert``),
the profiling utilities (``tgt_torch.utils.profiling``) and data
parallelism (``tgt_torch.parallel``: one process per device, each step the
global batch's). With
``use_pallas: dense`` the triplet core runs hand-written CUDA kernels on the
card: ``csrc/triplet_dense_{fwd,bwd}.cu`` for the attention variants
(TGT-At, with triplet dropout drawn in the kernels),
``csrc/triplet_aggregate_{fwd,bwd}.cu`` for the aggregate variants
(TGT-Agx2); with ``use_pallas: true`` the attention variants run
``csrc/triplet_attention_{fwd,bwd}.cu``, tgt_tpu's legacy fused pair.
"""
