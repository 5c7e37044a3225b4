"""The share of the profiled span in which no operation ran on the device."""
from h100bench.yardstick import evoformer, readers


def read(rec):
    return readers.device_idle(rec, evoformer.DRIVER)
