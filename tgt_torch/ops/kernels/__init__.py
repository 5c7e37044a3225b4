"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

| TPU kernel (tgt_tpu)                               | here                      |
|----------------------------------------------------|---------------------------|
| ops/pallas/triplet_dense.py:_fwd_kernel, rate 0    | triplet_dense.triplet_dense_fwd |
| ops/pallas/triplet_dense.py:_bwd_kernel, rate 0    | triplet_dense.triplet_dense_bwd |
| ops/pallas/triplet_dense.py:_agg_fwd_kernel        | triplet_aggregate.triplet_aggregate_fwd |
| ops/pallas/triplet_dense.py:_agg_bwd_kernel        | triplet_aggregate.triplet_aggregate_bwd |

``triplet_dense.TripletDenseCore`` joins the first two as the custom VJP
``_dense_core`` does, ``triplet_aggregate.TripletAggregateCore`` the other
two as ``_agg_core`` does.

The other Pallas kernels (the dropout branch of the dense pair, the legacy
``triplet_attention.py`` pair) are queued in ROADMAP.md.
"""
