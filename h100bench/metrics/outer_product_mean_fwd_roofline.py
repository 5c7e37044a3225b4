"""The Evoformer's outer product mean, forward, whole calls: the bound time
of its calls in the profiled span (the sum over the sequences and the
output projection, operations at the bf16 peak or bytes at the memory
rate, whichever is longer) over the device time of every operation that
``OuterProductMean.forward`` launched (``yardstick/evoformer.py``)."""
from h100bench.yardstick import evoformer

CALLS = ("tgt_torch.ops.msa:OuterProductMean.forward",)


def read(rec):
    return evoformer.opm_roofline(rec)
