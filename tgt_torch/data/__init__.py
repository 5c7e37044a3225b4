"""Host-side data preparation (counterpart of tgt_tpu/data): structural
transform, bucketed collation, the synthetic dataset, the training sampler
and the threaded loader. The PCQM parquet dataset, the other samplers and
the native library binding come with ROADMAP.md item 1j."""
