// Forward of the legacy fused triplet attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_attention.py:_fwd_kernel
// (reached through _triplet_core_fwd_impl, use_pallas: true). On the
// head-major layout q_t, k_t, v_t (b, h, Nj, N, d) and bias, gate (b, h, N, N),
// for every (b, h), row j and row i it computes
//
//   s[k]   = scale * sum_d q_t[b,h,j,i,d] k_t[b,h,j,k,d] + bias[b,h,i,k]
//   a[k]   = softmax_k(s)[k] * sigmoid(gate[b,h,i,k]), rounded to v's dtype
//   out[b,h,j,i,:] = sum_k a[k] v_t[b,h,j,k,:]
//
// with the sums in f32: the scale is applied here, the max is taken per row
// (per (i, h)), the denominator is not clamped (the row max makes it at least
// 1), and the normalised weights times the gate are rounded to v's dtype
// before the product, as the TPU kernel does (triplet_attention.py:47-52).
// The caller stacks the in and out directions on the head axis, so one
// launch serves both.
//
// Bound on the H100: at b=16, N=48, edge width 256, 2 x 16 stacked heads,
// d=16, bf16 the function reads q, k, v (3 x 37.7 MB), bias and gate (2 x
// 2.36 MB) and writes out (37.7 MB): about 156 MB, 47 us at 3.35 TB/s; its
// 3.6 GFLOP take 3.7 us at the bf16 tensor-core peak. So it is bound by
// device memory.
//
// Two paths, by storage type:
//  - bf16, the serving and training path: triplet_attention_fwd_mma runs the
//    tensor-core body shared with the dense forward (triplet_fwd_mma.cuh,
//    legacy instantiation) on the head-major panels in place: one block per
//    (b, h, chunk of j) walks j in order, as the TPU kernel walks j inside one
//    (b, h) grid cell, with bias and sigmoid(gate) staged once per block.
//  - f32, the 1e-4 checks and the f32 gradients: the CUDA-core kernel below.
//    One block per (b, h, j) stages the contiguous K[b,h,j] and V[b,h,j]
//    panels (N x d) in shared memory as f32; each warp takes rows i in turn,
//    lanes over k for the softmax (a warp max, exp, a warp sum), then lanes
//    over (d, k-parity) for the sum of a*V.
#include "triplet_attention_row.cuh"
#include "triplet_fwd_mma.cuh"

namespace {

using legacy::kMaxN;
using legacy::kPerLane;

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
triplet_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ bias,
                             const T* __restrict__ gate, T* __restrict__ out,
                             float scale, int nj, int n, int d) {
  const int j = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp1 = d + 1;
  const long long panel = ((long long)bh * nj + j) * n * d;  // [b, h, j, 0, 0]
  const long long bias_off = (long long)bh * n * n;          // [b, h, 0, 0]

  extern __shared__ float smem[];
  float* ks = smem;                 // [n][d + 1], padded against bank conflicts
  float* vs = ks + n * dp1;         // [n][d + 1]
  float* qs = vs + n * dp1;         // [kWarps][d]
  float* as = qs + kWarps * d;      // [kWarps][n]
  legacy::stage(ks, k + panel, n, d, dp1);
  legacy::stage(vs, v + panel, n, d, dp1);
  __syncthreads();

  float* qw = qs + warp * d;
  float* aw = as + warp * n;
  const int groups = 32 / d;        // d is a power of two <= 32
  const int dd = lane & (d - 1);
  const int grp = lane / d;

  for (int i = warp; i < n; i += kWarps) {
    if (lane < d) qw[lane] = to_f32(q[panel + i * d + lane]);
    __syncwarp();
    float p[kPerLane], g[kPerLane];
    legacy::softmax_row<T>(qw, ks, dp1, bias + bias_off + (long long)i * n,
                           gate + bias_off + (long long)i * n, n, d, scale, lane,
                           p, g);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int kk = lane + 32 * t;
      if (kk < n) aw[kk] = round_to<T>(p[t] * g[t]);
    }
    __syncwarp();

    float acc = 0.f;
    for (int kk = grp; kk < n; kk += groups) acc = fmaf(aw[kk], vs[kk * dp1 + dd], acc);
    for (int off = d; off < 32; off <<= 1) acc += __shfl_down_sync(kFullMask, acc, off);
    if (lane < d) store(out + panel + i * d + lane, acc);
    __syncwarp();  // qw and aw are rewritten by the next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* gate, void* out, float scale, int bh, int nj, int n, int d,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * n * (d + 1) + kWarps * d + kWarps * n);
  triplet_attention_fwd_kernel<T><<<dim3(nj, bh), dim3(kWarps * 32), smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (const T*)gate, (T*)out,
      scale, nj, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 only (dtype 0; bf16 takes triplet_attention_fwd_mma). All tensors
// contiguous: q, k, v, out (batch, h, nj, n, d); bias, gate (batch, h, n, n).
// Returns cudaGetLastError() after the launch.
extern "C" int triplet_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* gate, void* out,
                                     float scale, int dtype, int batch, int h, int nj,
                                     int n, int d, void* stream) {
  if (dtype != 0 || n < 1 || n > kMaxN || d < 1 || d > 32 || (d & (d - 1)) != 0 ||
      h < 1 || batch < 1 || nj < 1 || (long long)batch * h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<float>(q, k, v, bias, gate, out, scale, batch * h, nj, n, d,
                       (cudaStream_t)stream);
}

// bf16. q, k, v, out: (batch, h, nj, n, dp) contiguous, dp 16 or 32; bias,
// gate: (batch, h, n, n) contiguous. Rows j go in chunks of jc. Returns the
// launch's CUDA error (0 when it went out).
extern "C" int triplet_attention_fwd_mma(const void* q, const void* k, const void* v,
                                         const void* bias, const void* gate, void* out,
                                         float scale, int batch, int h, int nj, int n,
                                         int dp, int jc, int chunks, void* stream) {
  using tfwd::bf16;
  const long long nn = (long long)n * n;
  tfwd::Args a{};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.bias = (const bf16*)bias;
  a.gate = (const bf16*)gate;
  a.out = (bf16*)out;
  const long long st[4] = {h * nn, nn, n, 1};
  for (int x = 0; x < 4; ++x) a.sb[x] = a.sg[x] = st[x];
  a.scale = scale;
  a.batch = batch;
  a.h = h;
  a.nj = nj;
  a.n = n;
  a.dp = dp;
  a.jc = jc;
  a.chunks = chunks;
  if (!tfwd::valid(a)) return (int)cudaErrorInvalidValue;
  return tfwd::launch<false, true, false>(a, (cudaStream_t)stream);
}
