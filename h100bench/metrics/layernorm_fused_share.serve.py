"""The one-pass layer-norm kernel's share (``lnfwd::``,
csrc/layernorm_fwd.cu) of the layer-norm device time of the profiled span
(that of ``layernorm_ms_per_mol.serve``): how often the served forward
takes the kernel rather than PyTorch's layer norm; 0 where the program has
no such kernel."""
from h100bench.yardstick import layernorm


def read(rec):
    got = layernorm.seconds(rec, "serve")
    if got is None:
        return None
    fused, torch_ln, _ = got
    return 100.0 * fused / (fused + torch_ln)
