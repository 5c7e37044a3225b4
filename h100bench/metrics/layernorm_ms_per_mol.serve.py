"""Device milliseconds of layer norm per served molecule in the profiled
span: the kernels whose names hold the one-pass kernel's namespace
(``lnfwd::``, csrc/layernorm_fwd.cu) or PyTorch's ``layer_norm``, over the
traced requests' molecules. Where the program has no one-pass kernel it
reads PyTorch's layer-norm kernel alone, without the two dtype casts that
run around it (those are elementwise copies, not counted here)."""
from h100bench.yardstick import layernorm


def read(rec):
    got = layernorm.seconds(rec, "serve")
    if got is None:
        return None
    fused, torch_ln, molecules = got
    return 1e3 * (fused + torch_ln) / molecules
