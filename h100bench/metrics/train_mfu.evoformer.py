"""Model operations of the Evoformer crops trained in the window (three
forwards each, counted from their residues, cluster rows and extra rows:
``yardstick/evoformer.py``) over its seconds, as a share of the H100's 989
TFLOP/s bf16 peak."""
from h100bench.yardstick import evoformer, peaks


def read(rec):
    if rec["mix"]["driver"] != evoformer.DRIVER:
        return None
    w = rec["window"]
    if not w["crops"] or w["seconds"] <= 0:
        return None
    ops = evoformer.train_flops(rec["cfg"], w["crops"])
    return 100.0 * ops / w["seconds"] / peaks.BF16_FLOPS
