// Backward of the legacy fused triplet attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_attention.py:_bwd_kernel
// (reached through _triplet_core_bwd). Given the forward's inputs on the
// head-major layout and the output cotangent do (b, h, Nj, N, d), for every
// (b, h), row j and row i it recomputes the forward's softmax p and gate g
// (triplet_attention_row.cuh), then
//
//   dA[k] = sum_d do[b,h,j,i,d] v_t[b,h,j,k,d],  dp = dA g
//   ds[k] = p[k] (dp[k] - sum_k' dp[k'] p[k'])
//
// and returns, with ds' = ds rounded to q's dtype as the TPU kernel rounds it,
//
//   dq[b,h,j,i,:] = scale sum_k ds' k_t[b,h,j,k,:]
//   dk[b,h,j,k,:] = scale sum_i ds' q_t[b,h,j,i,:]
//   dv[b,h,j,k,:] = sum_i p g do[b,h,j,i,:]  (f32 weights; bf16: see below)
//   dbias[b,h,i,k] = sum_j ds,  dgate[b,h,i,k] = sum_j dA p g (1 - g)
//
// summed in f32 whatever the storage type; dbias and dgate are summed in f32
// and cast once. Nothing N^3 is kept from the forward.
//
// Bound on the H100: at b=16, N=48, edge width 256, 2 x 16 stacked heads,
// d=16, bf16 it reads q, k, v, do (4 x 37.7 MB), bias and gate (2 x 2.36 MB)
// and writes dq, dk, dv (3 x 37.7 MB), dbias and dgate (2 x 2.36 MB): about
// 273 MB, 82 us at 3.35 TB/s. Its five products take 10 d FLOP per
// (b, h, j, i, k), 9 GFLOP, 9 us at the bf16 tensor-core peak. So it is
// bound by device memory.
//
// Two paths, by storage type:
//  - bf16, the training path: triplet_attention_bwd_mma runs the body shared
//    with the dense backward (triplet_bwd_mma.cuh) on the head-major panels
//    in place: one block per (b, h, chunk of j) walks j in order, as the TPU
//    kernel walks j inside one (b, h) grid cell; the five products on the
//    tensor cores, one recompute, dbias and dgate summed in registers and
//    reduced over the chunks in a fixed order. dv takes the weights p g at
//    f32 precision, as the TPU kernel does (:81-83): split into a bf16 high
//    and low part, two tensor-core products per tile (kSplitDv).
//  - f32, the 1e-4 checks and the f32 gradients: two kernels on the CUDA
//    cores, dv from f32 weights. Both take every sum in a fixed order (two
//    launches give bitwise equal outputs):
//     1. bwd_qkv: one block per (b, h, j). It stages K, V, Q and do of the
//        panel (N x d each, contiguous) in shared memory; each warp takes
//        rows i in turn, lanes over k, recomputes p and ds, writes the row of
//        dq, and leaves ds' and p g in shared memory (N x N each); then the
//        block sums dk and dv over i, threads over (k, d).
//     2. bwd_bias: one block per (b, h, tile of 16 rows i) that loops over j
//        in order, staging K and V of each j, and adds ds and dA p into
//        registers; dbias and dgate are written once at the end.
//    Shared memory of the first grows as N^2 and reaches 199 KB at N=128,
//    d=32.
#include "triplet_attention_row.cuh"
#include "triplet_bwd_mma.cuh"

namespace {

using legacy::kMaxN;
using legacy::kPerLane;

constexpr int kQkvWarps = 4;
constexpr int kBiasWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBiasTile = kBiasWarps * kRowsPerWarp;  // rows i per bias block

// One row of one panel, in one warp (lanes over k): the forward's p and g,
// and dA and ds from the row's cotangent dorow (d floats) and the staged V
// panel vs ([n][dp1]); zero for k >= n.
template <typename T>
__device__ __forceinline__ void row_grads(const float* qrow, const float* dorow,
                                          const float* ks, const float* vs, int dp1,
                                          const T* brow, const T* grow, int n, int d,
                                          float scale, int lane, float (&p)[kPerLane],
                                          float (&g)[kPerLane], float (&da)[kPerLane],
                                          float (&ds)[kPerLane]) {
  legacy::softmax_row<T>(qrow, ks, dp1, brow, grow, n, d, scale, lane, p, g);
  float rs = 0.f;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int kk = lane + 32 * t;
    da[t] = 0.f;
    if (kk < n) {
      const float* vr = vs + kk * dp1;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc = fmaf(dorow[e], vr[e], acc);
      da[t] = acc;
      rs = fmaf(acc * g[t], p[t], rs);
    }
  }
  rs = warp_sum(rs);
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) ds[t] = p[t] * (da[t] * g[t] - rs);
}

// q, k, v, dout, dq, dk, dv: (b, h, nj, n, d); bias, gate: (b, h, n, n); all
// contiguous.
template <typename T>
__global__ void __launch_bounds__(kQkvWarps * 32)
bwd_qkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ bias,
               const T* __restrict__ gate, const T* __restrict__ dout,
               T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
               float scale, int nj, int n, int d) {
  const int j = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp1 = d + 1;
  const long long panel = ((long long)bh * nj + j) * n * d;
  const long long bias_off = (long long)bh * n * n;

  extern __shared__ float smem[];
  float* ks = smem;                 // [n][d + 1]  k_t[b, h, j, k, :]
  float* vs = ks + n * dp1;         // [n][d + 1]  v_t[b, h, j, k, :]
  float* qs = vs + n * dp1;         // [n][d + 1]  q_t[b, h, j, i, :]
  float* os = qs + n * dp1;         // [n][d + 1]  do[b, h, j, i, :]
  float* dss = os + n * dp1;        // [n][n]      ds'[i][k]
  float* as = dss + n * n;          // [n][n]      p g [i][k]
  legacy::stage(ks, k + panel, n, d, dp1);
  legacy::stage(vs, v + panel, n, d, dp1);
  legacy::stage(qs, q + panel, n, d, dp1);
  legacy::stage(os, dout + panel, n, d, dp1);
  __syncthreads();

  const int groups = 32 / d;        // d is a power of two <= 32
  const int dd = lane & (d - 1);
  const int grp = lane / d;
  for (int i = warp; i < n; i += kQkvWarps) {
    float p[kPerLane], g[kPerLane], da[kPerLane], ds[kPerLane];
    row_grads<T>(qs + i * dp1, os + i * dp1, ks, vs, dp1,
                 bias + bias_off + (long long)i * n, gate + bias_off + (long long)i * n,
                 n, d, scale, lane, p, g, da, ds);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int kk = lane + 32 * t;
      if (kk < n) {
        dss[i * n + kk] = round_to<T>(ds[t]);
        as[i * n + kk] = p[t] * g[t];
      }
    }
    __syncwarp();
    float acc = 0.f;
    for (int kk = grp; kk < n; kk += groups) acc = fmaf(dss[i * n + kk], ks[kk * dp1 + dd], acc);
    for (int off = d; off < 32; off <<= 1) acc += __shfl_down_sync(kFullMask, acc, off);
    if (lane < d) store(dq + panel + i * d + lane, acc * scale);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int kk = idx / d, c = idx - kk * d;
    float acc_k = 0.f, acc_v = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_k = fmaf(dss[i * n + kk], qs[i * dp1 + c], acc_k);
      acc_v = fmaf(as[i * n + kk], os[i * dp1 + c], acc_v);
    }
    store(dk + panel + idx, acc_k * scale);
    store(dv + panel + idx, acc_v);
  }
}

// dbias, dgate: (b, h, n, n) contiguous outputs.
template <typename T>
__global__ void __launch_bounds__(kBiasWarps * 32)
bwd_bias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ bias,
                const T* __restrict__ gate, const T* __restrict__ dout,
                T* __restrict__ dbias, T* __restrict__ dgate, float scale, int nj,
                int n, int d) {
  const int i0 = blockIdx.x * kBiasTile, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp1 = d + 1;
  const long long bias_off = (long long)bh * n * n;

  extern __shared__ float smem[];
  float* ks = smem;                          // [n][d + 1]
  float* vs = ks + n * dp1;                  // [n][d + 1]
  float* qw = vs + n * dp1 + warp * 2 * d;   // [d] this warp's q row
  float* ow = qw + d;                        // [d] this warp's do row

  float acc_b[kRowsPerWarp][kPerLane], acc_g[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc_b[r][t] = acc_g[r][t] = 0.f;
  }

  for (int j = 0; j < nj; ++j) {
    const long long panel = ((long long)bh * nj + j) * n * d;
    __syncthreads();                         // the last row j is done with
    legacy::stage(ks, k + panel, n, d, dp1);
    legacy::stage(vs, v + panel, n, d, dp1);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + warp + kBiasWarps * r;
      if (i < n) {                           // warp-uniform
        if (lane < d) {
          qw[lane] = to_f32(q[panel + i * d + lane]);
          ow[lane] = to_f32(dout[panel + i * d + lane]);
        }
        __syncwarp();
        float p[kPerLane], g[kPerLane], da[kPerLane], ds[kPerLane];
        row_grads<T>(qw, ow, ks, vs, dp1, bias + bias_off + (long long)i * n,
                     gate + bias_off + (long long)i * n, n, d, scale, lane, p, g, da,
                     ds);
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          acc_b[r][t] += ds[t];
          acc_g[r][t] = fmaf(da[t], p[t], acc_g[r][t]);
        }
        __syncwarp();                        // qw and ow are rewritten next
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + warp + kBiasWarps * r;
    if (i >= n) continue;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int kk = lane + 32 * t;
      if (kk >= n) continue;
      const long long o = bias_off + (long long)i * n + kk;
      const float gv = sigmoid(to_f32(gate[o]));
      store(dbias + o, acc_b[r][t]);
      store(dgate + o, acc_g[r][t] * gv * (1.f - gv));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* gate, const void* dout, void* dq, void* dk, void* dv,
           void* dbias, void* dgate, float scale, int bh, int nj, int n, int d,
           cudaStream_t stream) {
  const size_t smem_qkv = sizeof(float) * (4 * n * (d + 1) + 2 * n * n);
  auto qkv = bwd_qkv_kernel<T>;
  cudaError_t e = allow_smem(qkv, smem_qkv);
  if (e != cudaSuccess) return (int)e;
  qkv<<<dim3(nj, bh), dim3(kQkvWarps * 32), smem_qkv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (const T*)gate,
      (const T*)dout, (T*)dq, (T*)dk, (T*)dv, scale, nj, n, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_bias = sizeof(float) * (2 * n * (d + 1) + kBiasWarps * 2 * d);
  const dim3 grid_bias((n + kBiasTile - 1) / kBiasTile, bh);
  bwd_bias_kernel<T><<<grid_bias, dim3(kBiasWarps * 32), smem_bias, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (const T*)gate,
      (const T*)dout, (T*)dbias, (T*)dgate, scale, nj, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 only (dtype 0; bf16 takes triplet_attention_bwd_mma). All tensors
// contiguous: q, k, v, dout, dq, dk, dv (batch, h, nj, n, d); bias, gate,
// dbias, dgate (batch, h, n, n). Launches both kernels on `stream`; returns
// the first CUDA error (0 when both launched).
extern "C" int triplet_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* gate,
                                     const void* dout, void* dq, void* dk, void* dv,
                                     void* dbias, void* dgate, float scale, int dtype,
                                     int batch, int h, int nj, int n, int d,
                                     void* stream) {
  if (dtype != 0 || n < 1 || n > kMaxN || d < 1 || d > 32 || (d & (d - 1)) != 0 ||
      h < 1 || batch < 1 || nj < 1 || (long long)batch * h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<float>(q, k, v, bias, gate, dout, dq, dk, dv, dbias, dgate, scale,
                       batch * h, nj, n, d, (cudaStream_t)stream);
}

// bf16. q, k, v, dout, dq, dk, dv: (batch, h, nj, n, dp) contiguous, dp 16
// or 32; bias, gate, dbias, dgate: (batch, h, n, n) contiguous. partial:
// 2 x chunks x batch x h x n x n floats of scratch; rows j go in chunks of
// jc. dv is taken from the weights' high and low bf16 parts (the TPU
// kernel's f32 weights). Returns the first CUDA error (0 when both launches
// went out).
extern "C" int triplet_attention_bwd_mma(const void* q, const void* k, const void* v,
                                         const void* bias, const void* gate,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* dbias, void* dgate, void* partial,
                                         float scale, int batch, int h, int nj, int n,
                                         int dp, int jc, int chunks, void* stream) {
  using tbwd::bf16;
  const long long nn = (long long)n * n;
  tbwd::Args a{};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.bias = (const bf16*)bias;
  a.gate = (const bf16*)gate;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.partial = (float*)partial;
  const long long st[4] = {h * nn, nn, n, 1};
  tbwd::Out o{(bf16*)dbias, (bf16*)dgate, {st[0], st[1], st[2], st[3]}};
  for (int x = 0; x < 4; ++x) a.sb[x] = a.sg[x] = st[x];
  a.scale = scale;
  a.batch = batch;
  a.h = h;
  a.nj = nj;
  a.n = n;
  a.dp = dp;
  a.jc = jc;
  a.chunks = chunks;
  if (!tbwd::valid(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return tbwd::launch<true, false, true>(a, o, s);
}
