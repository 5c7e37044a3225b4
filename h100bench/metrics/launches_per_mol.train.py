"""Kernel launches in the profiled span per molecule it completed."""
from h100bench.yardstick import readers


def read(rec):
    return readers.launches_per_molecule(rec, "train")
