"""Kernel launches in the profiled span per crop it trained."""
from h100bench.yardstick import readers


def read(rec):
    return readers.launches_per_molecule(rec, "train_pairformer")
