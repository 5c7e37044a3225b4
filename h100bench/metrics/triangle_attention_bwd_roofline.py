"""The Pairformer's triangle attention on the dense core, backward, whole
calls: the bound time of the key-tiled route's calls in the profiled span
(ungated, b = 1, n = tokens, d = 32, h = 4) over the device time of every
operation that ``TripletDenseCore.backward`` launched
(``yardstick/pairformer.py``)."""
from h100bench.yardstick import pairformer

CALLS = (pairformer.MODULE + "TripletDenseCore.backward",)


def read(rec):
    return pairformer.roofline(rec, "dense_bwd")
