"""Device time of layer norm in a profiled span: the trace's kernels whose
names hold the one-pass kernel's namespace (``lnfwd::``,
``tgt_torch/csrc/layernorm_fwd.cu``) or PyTorch's layer norm
(``layer_norm``, ``LayerNorm``), by route."""
from __future__ import annotations

from typing import Optional, Tuple

FUSED = ("lnfwd::",)
TORCH = ("layer_norm", "LayerNorm")


def seconds(rec, driver: str) -> Optional[Tuple[float, float, int]]:
    """(the one-pass kernel's device seconds, PyTorch's layer-norm
    kernels' device seconds, the traced items' molecules), or None without
    a trace of the driver's items or without layer-norm time in it."""
    t = rec.get("trace")
    if rec["mix"]["driver"] != driver or not t:
        return None
    fused = torch_ln = 0.0
    for name, s in t["kernels"].items():
        if any(k in name for k in FUSED):
            fused += s
        elif any(k in name for k in TORCH):
            torch_ln += s
    molecules = sum(len(i["sizes"]) for i in t["items"])
    if fused + torch_ln <= 0 or not molecules:
        return None
    return fused, torch_ln, molecules
