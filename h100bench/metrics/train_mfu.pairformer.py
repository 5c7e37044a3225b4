"""Model operations of the Pairformer crops trained in the window (three
forwards of what the loss reads, one of the single track, counted from
their tokens: ``yardstick/pairformer.py``) over its seconds, as a
share of the H100's 989 TFLOP/s bf16 peak."""
from h100bench.yardstick import pairformer, peaks


def read(rec):
    if rec["mix"]["driver"] != "train_pairformer":
        return None
    w = rec["window"]
    if not w["sizes"] or w["seconds"] <= 0:
        return None
    ops = pairformer.train_flops(rec["cfg"], w["sizes"])
    return 100.0 * ops / w["seconds"] / peaks.BF16_FLOPS
