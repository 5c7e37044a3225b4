"""Host-side data preparation (counterpart of tgt_tpu/data): structural
transform, bucketed collation, the synthetic dataset, the PCQM4Mv2 parquet
dataset and its writers, the samplers and the threaded loader. The
preparation of the real PCQM4Mv2 and the native library binding are
ROADMAP.md item 1j's rest."""
