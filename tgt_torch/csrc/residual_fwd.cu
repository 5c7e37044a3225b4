// A residual junction of the no-grad forward in one pass for Hopper
// (sm_90a): out = x + drop_path(y), bf16 or fp16 in and out, f32 in
// registers.
//
// Replaces no TPU kernel. tgt_tpu's TGT layer ends each sub-layer with
// x + drop_path(update) (tgt_tpu/ops/common.py drop_path), a chain XLA fuses
// into one pass on the TPU. PyTorch runs it as five launches on the edge
// tensor's bytes besides the (b, 1, 1, 1) draw: y / keep_prob (one pass,
// 2 bytes read and 2 written an element), * keep (a broadcast, the same
// again through the generic elementwise kernel), x + ... (4 read, 2
// written): 14 bytes of device memory an element where the junction needs
// 6 (read x, read y, write out).
//
// Arithmetic, bit for bit that of those launches on the card:
//   keep[s] = u[s] < kp                 (f32 compare; u the f32 draw, kp
//                                        the keep probability as f32)
//   t       = round(f32(y) * inv)       (PyTorch's tensor / Python scalar
//                                        on the card: a multiply by inv,
//                                        the reciprocal taken in double and
//                                        rounded to f32, which the caller
//                                        passes; 1.0f / kp differs from it
//                                        at some rates, 1 - 0.1 * 2 / 11
//                                        among them)
//   out     = round(f32(x) + f32(t) * keep)
// keep is 0 or 1, so f32(t) * keep is exact and a fused multiply-add gives
// the same sum; a multiply and not a select, so that x + (-0.0) keeps x's
// signed zero as the composite's add does. Without a draw (rate 0, or a
// deterministic call) out = round(f32(x) + f32(y)), PyTorch's add.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s): one add and at most
// two multiplies an element against 6 bytes, so device memory bounds it.
// At a served TGT-Agx2 forward's edge tensor, b = 160 draw-stacked rows,
// N = 56, width 256: 128.5 M elements, 771 MB, 0.230 ms.
//
// Design:
// - The sample s of the draw is grid axis y (a block loop over samples past
//   65,535), so a block reads u[s] once and computes keep once; nothing
//   divides on the device.
// - A thread moves 16-byte pieces of 8 elements; a block covers 1,024
//   consecutive pieces of one sample (grid axis x), each thread 4 of them
//   a warp's 512 bytes apart, and issues all 8 loads (x and y) before the
//   first add, so each thread keeps 128 bytes in flight.
// - Without a draw the whole tensor is one sample.
// - The kernel allocates nothing and launches on the caller's stream; the
//   wrapper allocates out (out of place: the caller may still hold x).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace resf {

constexpr int kThreads = 256;
constexpr int kPiece = 8;                     // elements of one 16-byte load
constexpr int kUnroll = 4;                    // pieces a thread moves
constexpr int kChunk = kThreads * kUnroll;    // pieces a block moves
constexpr int kMaxGridY = 65535;

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

// One piece of the junction: x + y, or with a draw x + round(y * inv) * keep.
template <typename T, bool kDraw>
__device__ __forceinline__ uint4 junction(const uint4& xr, const uint4& yr, float inv,
                                          float keep) {
  float xf[kPiece], yf[kPiece];
  widen8<T>(xr, xf);
  widen8<T>(yr, yf);
  if (kDraw) {
#pragma unroll
    for (int e = 0; e < kPiece; ++e) yf[e] *= inv;
    widen8<T>(narrow8<T>(yf), yf);  // the scaled update rounds to T first
#pragma unroll
    for (int e = 0; e < kPiece; ++e) xf[e] += yf[e] * keep;
  } else {
#pragma unroll
    for (int e = 0; e < kPiece; ++e) xf[e] += yf[e];
  }
  return narrow8<T>(xf);
}

// x, y, out: samples blocks of pieces 16-byte pieces each; u: samples f32
// draws (read only with kDraw).
template <typename T, bool kDraw>
__global__ void __launch_bounds__(kThreads)
    residual_pieces(const uint4* __restrict__ x, const uint4* __restrict__ y,
                    const float* __restrict__ u, float keep_prob, float inv,
                    uint4* __restrict__ out, int samples, long long pieces) {
  const long long p0 = (long long)blockIdx.x * kChunk + threadIdx.x;
  for (int s = blockIdx.y; s < samples; s += gridDim.y) {
    const float keep = kDraw ? (u[s] < keep_prob ? 1.f : 0.f) : 1.f;
    const long long base = (long long)s * pieces;
    uint4 xr[kUnroll], yr[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long p = p0 + k * kThreads;
      if (p < pieces) {
        xr[k] = x[base + p];
        yr[k] = y[base + p];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long p = p0 + k * kThreads;
      if (p < pieces) out[base + p] = junction<T, kDraw>(xr[k], yr[k], inv, keep);
    }
  }
}

template <typename T, bool kDraw>
int launch(const void* x, const void* y, const float* u, float keep_prob, float inv, void* out,
           int samples, long long pieces, cudaStream_t stream) {
  const long long chunks = (pieces + kChunk - 1) / kChunk;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)(samples < kMaxGridY ? samples : kMaxGridY));
  residual_pieces<T, kDraw><<<grid, kThreads, 0, stream>>>(
      (const uint4*)x, (const uint4*)y, u, keep_prob, inv, (uint4*)out, samples, pieces);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace resf

// x, y, out: samples x pieces 16-byte pieces (8 elements each), contiguous,
// bf16 (dtype 1) or fp16 (dtype 2), 16-byte aligned; u: null (no draw:
// out = x + y) or samples f32 draws, sample s the s-th block of pieces;
// keep_prob: 1 - the drop-path rate, as f32; inv: its reciprocal, taken in
// double and rounded to f32 (both read only with u). Writes out in one
// launch on stream. Returns cudaGetLastError() after the launch (0 with no
// launch for no pieces), or cudaErrorInvalidValue for what the kernel does
// not take.
extern "C" int residual_fwd(const void* x, const void* y, const void* u, void* out, int dtype,
                            int samples, long long pieces, float keep_prob, float inv,
                            void* stream) {
  using namespace resf;
  if (samples < 1 || pieces < 0 || (dtype != 1 && dtype != 2) || !aligned16(x) ||
      !aligned16(y) || !aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (pieces == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* draws = (const float*)u;
  if (dtype == 1) {
    return draws ? launch<__nv_bfloat16, true>(x, y, draws, keep_prob, inv, out, samples, pieces, s)
                 : launch<__nv_bfloat16, false>(x, y, draws, keep_prob, inv, out, 1,
                                                pieces * samples, s);
  }
  return draws ? launch<__half, true>(x, y, draws, keep_prob, inv, out, samples, pieces, s)
               : launch<__half, false>(x, y, draws, keep_prob, inv, out, 1, pieces * samples, s);
}
