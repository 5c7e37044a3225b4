"""Host-side data preparation (counterpart of tgt_tpu/data): structural
transform (through the native library of csrc/tgt_native.cpp,
``_native``), bucketed collation, the synthetic dataset, the PCQM4Mv2
parquet dataset, its writers and the preparation of the real PCQM4Mv2
(``prepare``), the samplers and the threaded loader."""
