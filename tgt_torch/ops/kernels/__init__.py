"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

| TPU kernel (tgt_tpu)                               | here                      |
|----------------------------------------------------|---------------------------|
| ops/pallas/triplet_dense.py:_fwd_kernel, rate 0    | triplet_dense.triplet_dense_fwd |
| ops/pallas/triplet_dense.py:_bwd_kernel, rate 0    | triplet_dense.triplet_dense_bwd |

``triplet_dense.TripletDenseCore`` joins the two as the custom VJP
``_dense_core`` does.

The other Pallas kernels are queued in ROADMAP.md.
"""
