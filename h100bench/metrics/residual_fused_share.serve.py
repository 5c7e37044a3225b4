"""The one-pass residual junction's share (``resf::``,
tgt_torch/csrc/residual_fwd.cu) of the device time of the profiled span's
contiguous bf16 adds: the kernel's time over itself and PyTorch's
vectorized bf16 add (``vectorized_elementwise_kernel<...CUDAFunctor_add
<c10::BFloat16>``), which ends each junction of a program without the
kernel. How often the served forward takes the kernel; 0 where the program
has no such kernel, None without a served trace or without either."""
FUSED = "resf::"
ADD = ("vectorized_elementwise_kernel<", "CUDAFunctor_add<c10::BFloat16>")


def read(rec):
    t = rec.get("trace")
    if rec["mix"]["driver"] != "serve" or not t:
        return None
    fused = add = 0.0
    for name, s in t["kernels"].items():
        if FUSED in name:
            fused += s
        elif all(k in name for k in ADD):
            add += s
    if fused + add <= 0:
        return None
    return 100.0 * fused / (fused + add)
