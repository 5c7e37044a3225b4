// Forward dense triplet aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_dense.py:_agg_fwd_kernel
// (reached through _agg_core_fwd). The aggregate triplet variant computes
// its N^2 weights A (softmax over k, sigmoid gate, dropout) outside the
// kernel; the kernel does the O(N^3) k-sum: for every batch row b, pair
// column j, row i and column (d, h),
//
//   va[b,j,i,d,h] = sum_k A[b,i,k,h] V[b,j,k,d,h]
//
// in f32, whatever the storage type (f32 or bf16), stored in V's type.
//
// Bound on the H100: at b=16, N=48, edge width 256, H=16, d=16 in bf16 the
// function reads V (18.87 MB) and A (1.18 MB) and writes va (18.87 MB):
// 38.9 MB, 11.6 us at 3.35 TB/s. Its 2 N^3 d H flops per batch row, 0.91
// GFLOP, take 0.9 us at the bf16 tensor-core peak. So it is bound by device
// memory; at the training micro-batch (b=32) both double (23.2 us).
//
// Design (simple and right first; wgmma/TMA are later work): one block per
// (b, j), b*N blocks, runs the panel loop of triplet_aggregate_panel.cuh
// with the panel V[b, j] and the weights A[b] as they are: in bf16 on the
// tensor cores (mma.sync), otherwise (f32) on the CUDA cores. The block
// stages V[b, j] (N x d*H) once; V's outer strides are free, so the out
// direction's pair-transposed V is read in place. A[b] (N^2 H) is read
// once per j from L2. Every sum runs in a fixed order: two launches on the
// same inputs give bitwise equal outputs.
#include "triplet_aggregate_panel.cuh"

// dtype: 0 = float32, 1 = bfloat16. a: (b, i, k, h) contiguous; v: (b, j, k,
// d, h) with (d, h) contiguous and the element strides of its three outer
// axes in strides[0..2]; out: (b, j, i, d, h) contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int triplet_aggregate_fwd(const void* a, const void* v, void* out,
                                     int dtype, int batch, int n, int d, int h,
                                     const long long* strides, void* stream) {
  if (n < 1 || n > agg::kMaxN || d < 1 || h < 1 || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const agg::Strides3 sv{strides[0], strides[1], strides[2]};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return agg::launch_panel<float, false>(
        (const float*)a, (const float*)v, (float*)out, batch, n, d, h, sv, s);
  }
  if (dtype == 1) {
    return agg::launch_panel<__nv_bfloat16, false>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
        batch, n, d, h, sv, s);
  }
  return (int)cudaErrorInvalidValue;
}
