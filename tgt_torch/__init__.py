"""tgt_torch — the Triplet Graph Transformer in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

Port of ``tgt_tpu`` (JAX on TPU), which stays the reference. The module
layout mirrors ``tgt_tpu`` so each module's counterpart is easy to find.
This package imports ``torch``, ``numpy`` and ``yaml``; it never imports
``jax`` or ``tgt_tpu``.

Ported so far: serving of the distance predictor (``tgt_torch.serving.
DistancePredictor``) and its training (``tgt_torch.training.Trainer`` on
the ``pcqm.dist_pred`` scheme), with the gated/ungated triplet-attention
models, whose triplet core runs the CUDA kernels
``csrc/triplet_dense_fwd.cu`` and ``csrc/triplet_dense_bwd.cu`` on the card.
"""
