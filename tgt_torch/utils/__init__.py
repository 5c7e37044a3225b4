"""Utilities (counterpart of tgt_tpu/utils): the span recorder of the
serving, trainer and data layers, in ``tracing``; tracing, step timing,
the operation count of a call and parameter counts, in ``profiling``."""
