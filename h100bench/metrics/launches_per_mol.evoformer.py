"""Kernel launches in the profiled span per crop it trained."""
from h100bench.yardstick import evoformer, readers


def read(rec):
    return readers.launches_per_molecule(rec, evoformer.DRIVER)
