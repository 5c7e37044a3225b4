// Layer norm forward for Hopper (sm_90a): bf16 or fp16 in, the same type
// out, f32 arithmetic, in one pass over device memory.
//
// Replaces no TPU kernel. tgt_tpu's layernorm (tgt_tpu/ops/common.py:57)
// widens x to f32, normalises and rounds back; XLA fuses that chain into
// one pass on the TPU. PyTorch runs it as three launches (the widening
// copy, F.layer_norm in f32, the narrowing copy): 6 + 8 + 6 = 20 bytes of
// device memory per element, where the function needs 4 (read bf16 once,
// write bf16 once). This kernel is the one pass, for the calls that need no
// gradient (ops/common.py:layernorm routes them here).
//
// The mathematics is tgt_tpu's as written: widen x to f32; the mean, then
// mean((x - mean)^2) (two passes over the values in registers, not
// Welford); (x - mean) * rsqrt(var + eps) * scale + bias with the f32
// parameters; round once to x's type.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s): ~6 flops per
// element against 4 bytes, far below the card's ridge point (~295 flops a
// byte), so device memory bounds it. At a served TGT-Agx2 forward's edge
// rows, b = 160 draw-stacked rows, N = 56, width 256: 501,760 rows of 512
// bytes read and 512 written, 513.8 MB, 0.153 ms.
//
// Design:
// - One warp per row. Each lane holds width / 256 pieces of 8 neighbouring
//   elements, one 16-byte load (and later one 16-byte store) per piece:
//   lane l's piece v covers columns 256 v + 8 l .. + 7, so a warp's load is
//   512 contiguous bytes. Widths 256, 512, 768, 1024 (edge 256, node 768).
// - The f32 row never leaves registers: the lane widens its pieces, sums
//   them, and a butterfly of shuffles gives every lane the same row sum
//   (float addition commutes, so the lanes agree bit for bit); the centred
//   squares go through a second butterfly; the lane then writes its pieces,
//   normalised and rounded once. Nothing is staged in shared memory.
// - Scale and bias (f32) are read once per warp, into registers: the grid
//   is at most one wave of resident blocks (the occupancy calculator's
//   count times the SMs), and each warp strides over the rows.
// - At width 256 a warp loads two rows before it reduces either, so that
//   each lane keeps two 16-byte loads in flight; wider rows already give a
//   lane several.
// - Every sum has one order: two launches on the same inputs give bitwise
//   equal outputs. The kernel allocates nothing and launches on the
//   caller's stream.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lnfwd {

constexpr int kThreads = 256;        // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 8;            // elements of one 16-byte load
constexpr int kSpan = 32 * kPiece;   // 256: one piece of every lane
constexpr int kMaxPieces = 4;        // widths up to 1024

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 widen(type p) { return __bfloat1622float2(p); }
  static __device__ __forceinline__ type narrow(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ float2 widen(type p) { return __half22float2(p); }
  static __device__ __forceinline__ type narrow(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

template <typename T>
__device__ __forceinline__ void widen8(const uint4& raw, float* f) {
  const typename Pair<T>::type* p = reinterpret_cast<const typename Pair<T>::type*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = Pair<T>::widen(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 narrow8(const float* f) {
  uint4 raw;
  typename Pair<T>::type* p = reinterpret_cast<typename Pair<T>::type*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = Pair<T>::narrow(f[2 * i], f[2 * i + 1]);
  return raw;
}

// The sum over the warp, the same in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// V: pieces a lane holds of one row (width 256 V); R: rows a warp loads
// before it reduces the first.
template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads)
    layernorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y, long long rows, float eps) {
  constexpr int W = V * kSpan;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps * R;
  float sc[V][kPiece], bi[V][kPiece];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = v * kSpan + lane * kPiece;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 s = reinterpret_cast<const float4*>(scale + c)[h];
      const float4 b = reinterpret_cast<const float4*>(bias + c)[h];
      sc[v][4 * h] = s.x, sc[v][4 * h + 1] = s.y, sc[v][4 * h + 2] = s.z, sc[v][4 * h + 3] = s.w;
      bi[v][4 * h] = b.x, bi[v][4 * h + 1] = b.y, bi[v][4 * h + 2] = b.z, bi[v][4 * h + 3] = b.w;
    }
  }
  for (long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * R; r0 < rows;
       r0 += stride) {
    uint4 raw[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r0 + r < rows) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (r0 + r) * W) + lane;
#pragma unroll
        for (int v = 0; v < V; ++v) raw[r][v] = src[v * 32];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r0 + r >= rows) continue;  // the same in every lane
      float f[V][kPiece];
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        widen8<T>(raw[r][v], f[v]);
#pragma unroll
        for (int e = 0; e < kPiece; ++e) s += f[v][e];
      }
      const float mean = warp_sum(s) / (float)W;
      float q = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int e = 0; e < kPiece; ++e) {
          f[v][e] -= mean;
          q += f[v][e] * f[v][e];
        }
      }
      const float rstd = rsqrtf(warp_sum(q) / (float)W + eps);
      uint4* dst = reinterpret_cast<uint4*>(y + (r0 + r) * W) + lane;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float o[kPiece];
#pragma unroll
        for (int e = 0; e < kPiece; ++e) o[e] = f[v][e] * rstd * sc[v][e] + bi[v][e];
        dst[v * 32] = narrow8<T>(o);
      }
    }
  }
}

template <typename T, int V>
int launch(const void* x, const float* scale, const float* bias, void* y, long long rows,
           float eps, cudaStream_t stream) {
  constexpr int R = V == 1 ? 2 : 1;
  const auto kernel = layernorm_rows<T, V, R>;
  static int per_sm = 0;  // blocks of this instance resident on one SM
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kWarps * R;
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>((const T*)x, scale, bias, (T*)y, rows, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* x, const float* scale, const float* bias, void* y, long long rows,
                 int width, float eps, cudaStream_t stream) {
  switch (width / kSpan) {
    case 1: return launch<T, 1>(x, scale, bias, y, rows, eps, stream);
    case 2: return launch<T, 2>(x, scale, bias, y, rows, eps, stream);
    case 3: return launch<T, 3>(x, scale, bias, y, rows, eps, stream);
    default: return launch<T, 4>(x, scale, bias, y, rows, eps, stream);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace lnfwd

// x and y: (rows, width), contiguous, bf16 (dtype 1) or fp16 (dtype 2);
// scale and bias: (width,) f32, contiguous; every pointer 16-byte aligned;
// width a multiple of 256 up to 1024. Writes y in one launch on stream.
// Returns cudaGetLastError() after the launch (0 with no launch for 0
// rows), or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int layernorm_fwd(const void* x, const void* scale, const void* bias, void* y,
                             int dtype, long long rows, int width, float eps, void* stream) {
  using namespace lnfwd;
  if (rows < 0 || width < kSpan || width > kMaxPieces * kSpan || width % kSpan != 0 ||
      (dtype != 1 && dtype != 2) || !aligned16(x) || !aligned16(scale) || !aligned16(bias) ||
      !aligned16(y)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  if (dtype == 1) return launch_width<__nv_bfloat16>(x, sc, bi, y, rows, width, eps, s);
  return launch_width<__half>(x, sc, bi, y, rows, width, eps, s);
}
