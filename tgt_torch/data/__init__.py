"""Host-side data preparation (counterpart of tgt_tpu/data): structural
transform and bucketed collation. Datasets, samplers, loaders and the
native library binding come with ROADMAP.md item 1j."""
