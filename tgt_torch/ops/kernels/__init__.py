"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

| TPU kernel (tgt_tpu)                                | here                      |
|-----------------------------------------------------|---------------------------|
| ops/pallas/triplet_dense.py:_fwd_kernel, rate 0, > 0 | triplet_dense.triplet_dense_fwd |
| ops/pallas/triplet_dense.py:_bwd_kernel, rate 0, > 0 | triplet_dense.triplet_dense_bwd |
| ops/pallas/triplet_dense.py:_agg_fwd_kernel         | triplet_aggregate.triplet_aggregate_fwd |
| ops/pallas/triplet_dense.py:_agg_bwd_kernel         | triplet_aggregate.triplet_aggregate_bwd |
| ops/pallas/triplet_attention.py:_fwd_kernel         | triplet_attention.triplet_attention_fwd |
| ops/pallas/triplet_attention.py:_bwd_kernel         | triplet_attention.triplet_attention_bwd |
| none: ops/common.py:layernorm, which XLA fuses      | layernorm.layernorm_fwd   |
| none: x + drop_path(update), which XLA fuses        | residual.residual_fwd     |

``triplet_dense.TripletDenseCore`` joins the first two as the custom VJP
``_dense_core`` does (its dropout hash ``_hash_keepf`` is
``triplet_dense.hash_keep`` and ``csrc/dropout_hash.cuh``),
``triplet_aggregate.TripletAggregateCore`` the next two as ``_agg_core``
does, and ``triplet_attention.TripletCore`` the legacy pair as
``_triplet_core`` does. Every Pallas kernel of tgt_tpu has its counterpart
here. In bf16 the two triplet-attention backwards run one body on the tensor
cores (``csrc/triplet_bwd_mma.cuh``, whose plain version and launch helpers
are ``triplet_bwd_panel``), and so do the two forwards
(``csrc/triplet_fwd_mma.cuh``); in f32 they keep their CUDA-core kernels.
The aggregate forward and backward each have two routes, chosen by shape
(``triplet_aggregate.agg_fwd_route``, ``agg_bwd_route``): in bf16 one
tensor-core pass (their partitions in plain PyTorch are
``triplet_aggregate.agg_fwd_body_reference`` and ``agg_bwd_body_reference``),
in f32 and at shapes outside the bodies the panel loop (forward) and three
CUDA-core kernels (backward). The layer norm replaces no Pallas kernel: it
is the one pass that XLA fuses tgt_tpu's widen-normalise-narrow chain into,
taken by ``ops/common.layernorm`` for the calls autograd does not record;
nor does the residual junction, the one pass of ``x + drop_path(update)``,
taken by ``ops/common.residual`` on the same condition.
"""
