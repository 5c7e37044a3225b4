"""Device milliseconds per served molecule in the profiled span of
PyTorch's generic elementwise kernel (``elementwise_kernel<128, 4``), which
runs where an operand is broadcast, transposed or laid out unlike the
others (the aggregate layer's transposed output and the adds around it),
over the traced requests' molecules."""
from h100bench.yardstick import epilogue


def read(rec):
    got = epilogue.strided_seconds(rec, "serve")
    if got is None:
        return None
    seconds, molecules = got
    return 1e3 * seconds / molecules
