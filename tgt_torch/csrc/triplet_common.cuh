// Device helpers shared by the triplet attention kernels (the dense pair
// triplet_dense_{fwd,bwd}.cu and the legacy pair triplet_attention_{fwd,bwd}.cu):
// loads and stores of f32 or bf16 as f32, warp reductions, the sigmoid, and
// the opt-in to dynamic shared memory above 48 KB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

static constexpr unsigned kFullMask = 0xffffffffu;

static __device__ __forceinline__ float to_f32(float x) { return x; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to T and back: the identity for f32, bf16 rounding for bf16.
template <typename T>
static __device__ __forceinline__ float round_to(float x) {
  T r;
  store(&r, x);
  return to_f32(r);
}

static __device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

static __device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

static __device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
  return cudaSuccess;
}
