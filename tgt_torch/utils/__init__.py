"""Utilities (counterpart of tgt_tpu/utils): tracing, step timing, the
operation count of a call and parameter counts, in ``profiling``."""
