"""Model operations of the molecules served in the window (one forward per
MC draw, counted from their own atoms) over its seconds, as a share of the
H100's 989 TFLOP/s bf16 peak."""
from h100bench.yardstick import readers


def read(rec):
    return readers.mfu(rec, "serve")
