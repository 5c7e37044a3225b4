// Backward of dense triplet attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_dense.py:_bwd_kernel
// (reached through _dense_core_bwd), at dropout rate 0 and at rate > 0. Given
// the forward's inputs, its seeds and the output cotangent dva, for every
// batch row b, pair column j, triplet head h and row i it recomputes
//
//   s[k]  = sum_d Q[b,i,j,d,h] K[b,j,k,d,h] + bias[b,i,k,h]     (Q pre-scaled)
//   pn[k] = softmax_k(s)[k]         (max per (i, h), denominator >= 1e-30)
//   g[k]  = sigmoid(gate[b,i,k,h])  (1 when ungated)
//   m[k]  = keep(seed[b], (j*n + i)*(n*H) + k*H + h)  (1 at rate 0), a = pn g m
//   dA[k] = m[k] sum_d dva[b,j,i,d,h] V[b,j,k,d,h],  dp = dA g
//   ds[k] = pn[k] (dp[k] - sum_k' dp[k'] pn[k'])
//
// The keep mask m is the forward's, rebuilt from the same stateless hash
// (dropout_hash.cuh) of the same index: it multiplies both the dV operand a
// and the dA chain, as the TPU kernel does. The rate > 0 branch is a
// template flag: the rate-0 instantiations carry none of it.
//
// and returns, with ds' and a' rounded to the storage type as the TPU
// kernel's _dot/_dot_t round their operands (the identity in f32),
//
//   dQ[b,i,j,:,h] = sum_k ds' K[b,j,k,:,h]     dbias[b,i,k,h] = sum_j ds
//   dK[b,j,k,:,h] = sum_i ds' Q[b,i,j,:,h]     dgate[b,i,k,h] = sum_j dA pn g(1-g)
//   dV[b,j,k,:,h] = sum_i a' dva[b,j,i,:,h]
//
// summed in f32 whatever the storage type (f32 or bf16). No (b, N, N, N, h) tensor
// reaches device memory and nothing N^3 is kept from the forward: the
// logits are recomputed.
//
// Bound on the H100: at b=16, N=48, edge width 256, H=16, d=16 in bf16 the
// function reads q, k, v, dva (4 x 18.9 MB), bias and gate (2 x 1.18 MB)
// and writes dq, dk, dv (3 x 18.9 MB), dbias and dgate (2 x 1.18 MB):
// about 138 MB, 41 us at 3.35 TB/s. Its five products take 10 d FLOP per
// (b, j, i, k, h), 4.5 GFLOP, 4.6 us at the bf16 tensor-core peak. So it is
// bound by device memory.
//
// Two paths, by storage type:
//  - bf16, the training path: triplet_dense_bwd_mma runs the body shared
//    with the legacy backward (triplet_bwd_mma.cuh: one block per (b, h,
//    chunk of j) walks j in order, the five products on the tensor cores,
//    one recompute, dbias and dgate summed in registers and reduced over the
//    chunks in a fixed order). It reads head-major copies (b, h, j, i|k, d)
//    that the wrapper makes of q, k, v and dva, as tgt_tpu's _pack relayouts
//    around its kernel, and writes head-major dq, dk, dv that the wrapper
//    moves back; the (b, i, k, h) bias, gate, dbias and dgate are read and
//    written in place. The keep mask is the forward's, rebuilt in the body.
//  - f32, the 1e-4 checks of the kernels and the f32 gradients: two kernels
//    on the CUDA cores that read the natural layouts in place (below). Both
//    take every sum in a fixed order (two launches on the same inputs give
//    bitwise equal outputs):
//     1. bwd_qkv: one block per (b, j, h), the forward's grid. It stages
//        K[b,j], V[b,j], the column Q[b,:,j] and dva[b,j] (N x d each) in
//        shared memory. Each warp takes rows i in turn, lanes over k,
//        recomputes pn and ds, writes the row of dQ, and leaves ds and a in
//        shared memory (N x N each); then the block sums dK and dV over i,
//        threads over (k, d).
//     2. bwd_bias: one block per (b, h, tile of 16 rows i) that loops over j
//        in order. Per j it stages K[b,j] and V[b,j]; each warp recomputes
//        its two rows and adds ds and dA pn into registers. dbias and dgate
//        are written once at the end.
//    Shared memory of the first grows as N^2 and reaches 199 KB at N=128,
//    d=32.
#include <stdint.h>

#include "dropout_hash.cuh"
#include "triplet_bwd_mma.cuh"
#include "triplet_common.cuh"
#include "triplet_tiled_mma.cuh"

namespace {

constexpr int kQkvWarps = 4;
constexpr int kBiasWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBiasTile = kBiasWarps * kRowsPerWarp;  // rows i per bias block
constexpr int kMaxN = 128;
constexpr int kPerLane = kMaxN / 32;
constexpr unsigned kFull = kFullMask;

struct Strides3 {
  long long b, x, y;  // element strides of the three outer axes
};

// The dropout arguments of one launch: (b) int32 seeds, the threshold and
// the kept value of dropout_hash.cuh. Unread by the rate-0 kernels.
struct Dropout {
  const int* seeds;
  uint32_t thresh;
  float scale;
};

// Stage the (n, d) panel at base (row stride `rs`, column stride h) into
// dst[n][d + 1] as f32.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, long long rs,
                                      int n, int d, int h) {
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    dst[r * (d + 1) + c] = to_f32(base[r * rs + c * h]);
  }
}

// One row i of one pair column j, in one warp: lanes take k = lane + 32 t.
// qrow and grow are the row's q and dva (d floats); ks and vs the staged
// K and V of column j ([n][d + 1]); brow and gtrow point at
// bias[b, i, 0, h] and gate[b, i, 0, h] with k stride bs and gs. With
// kDropout, element k's keep-mask index is lin0 + k*h under `seed`. On
// return, for k < n: pn = softmax weight, da = dA (masked), g =
// sigmoid(gate) (1 ungated), keep = the keep mask (1 at rate 0), ds = the
// logit gradient; zero for k >= n.
template <typename T, bool kGated, bool kDropout>
__device__ __forceinline__ void row_grads(
    const float* qrow, const float* grow, const float* ks, const float* vs,
    int n, int d, int h, const T* brow, long long bs, const T* gtrow,
    long long gs, const Dropout& drop, uint32_t seed, uint32_t lin0, int lane,
    float (&pn)[kPerLane], float (&da)[kPerLane], float (&g)[kPerLane],
    float (&keep)[kPerLane], float (&ds)[kPerLane]) {
  const int dp1 = d + 1;
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int kk = lane + 32 * t;
    pn[t] = -INFINITY;
    if (kk < n) {
      float acc = to_f32(brow[kk * bs]);
      const float* kr = ks + kk * dp1;
      for (int e = 0; e < d; ++e) acc = fmaf(qrow[e], kr[e], acc);
      pn[t] = acc;
      m = fmaxf(m, acc);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int kk = lane + 32 * t;
    pn[t] = kk < n ? expf(pn[t] - m) : 0.f;
    sum += pn[t];
  }
  sum = warp_sum(sum);
  const float recip = 1.f / fmaxf(sum, 1e-30f);
  float rs = 0.f;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int kk = lane + 32 * t;
    pn[t] *= recip;
    da[t] = 0.f;
    g[t] = 0.f;
    keep[t] = 1.f;
    if (kk < n) {
      const float* vr = vs + kk * dp1;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc = fmaf(grow[e], vr[e], acc);
      if (kDropout) {
        keep[t] = dropout_keep(lin0 + (uint32_t)(kk * h), seed, drop.thresh, drop.scale);
        acc *= keep[t];
      }
      da[t] = acc;
      g[t] = kGated ? sigmoid(to_f32(gtrow[kk * gs])) : 1.f;
      rs = fmaf(acc * g[t], pn[t], rs);
    }
  }
  rs = warp_sum(rs);
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) ds[t] = pn[t] * (da[t] * g[t] - rs);
}

// q: (b, i, j, d, h); k, v: (b, j, k, d, h); bias, gate: (b, i, k, h);
// dva: (b, j, i, d, h); the (d, h) axes of q/k/v/dva and the h axis of
// bias/gate are contiguous, the outer axes take any strides. dq (b, i, j,
// d, h) and dk, dv (b, j, k, d, h) are contiguous outputs.
// The second launch bound (a cap of 128 registers) keeps ptxas from capping
// these at 64 registers and spilling, as it did with the first alone.
template <typename T, bool kGated, bool kDropout>
__global__ void __launch_bounds__(kQkvWarps * 32, 4)
bwd_qkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ bias,
               const T* __restrict__ gate, const T* __restrict__ dva,
               T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
               Dropout drop, int n, int d, int h, Strides3 sq, Strides3 sk,
               Strides3 sv, Strides3 sb, Strides3 sg, Strides3 sd) {
  const int hh = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp1 = d + 1;
  const uint32_t seed = kDropout ? (uint32_t)drop.seeds[b] : 0u;

  extern __shared__ float smem[];
  float* ks = smem;                 // [n][d + 1]  K[b, j, k, :, h]
  float* vs = ks + n * dp1;         // [n][d + 1]  V[b, j, k, :, h]
  float* qs = vs + n * dp1;         // [n][d + 1]  Q[b, i, j, :, h]
  float* gs = qs + n * dp1;         // [n][d + 1]  dva[b, j, i, :, h]
  float* dss = gs + n * dp1;        // [n][n]      ds[i][k]
  float* as = dss + n * n;          // [n][n]      a[i][k]

  stage(ks, k + b * sk.b + j * sk.x + hh, sk.y, n, d, h);
  stage(vs, v + b * sv.b + j * sv.x + hh, sv.y, n, d, h);
  stage(qs, q + b * sq.b + j * sq.y + hh, sq.x, n, d, h);
  stage(gs, dva + b * sd.b + j * sd.x + hh, sd.y, n, d, h);
  __syncthreads();

  const int groups = 32 / d;        // d is a power of two <= 32
  const int dd = lane & (d - 1);
  const int grp = lane / d;
  for (int i = warp; i < n; i += kQkvWarps) {
    float pn[kPerLane], da[kPerLane], g[kPerLane], keep[kPerLane], ds[kPerLane];
    row_grads<T, kGated, kDropout>(
        qs + i * dp1, gs + i * dp1, ks, vs, n, d, h,
        bias + b * sb.b + i * sb.x + hh, sb.y, gate + b * sg.b + i * sg.x + hh,
        sg.y, drop, seed, (uint32_t)(j * n + i) * n * h + hh, lane, pn, da, g,
        keep, ds);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int kk = lane + 32 * t;
      if (kk < n) {
        dss[i * n + kk] = ds[t];
        as[i * n + kk] = kDropout ? pn[t] * g[t] * keep[t] : pn[t] * g[t];
      }
    }
    __syncwarp();
    float acc = 0.f;
    for (int kk = grp; kk < n; kk += groups) acc = fmaf(dss[i * n + kk], ks[kk * dp1 + dd], acc);
    for (int off = d; off < 32; off <<= 1) acc += __shfl_down_sync(kFull, acc, off);
    if (lane < d) store(dq + ((((long long)b * n + i) * n + j) * d + lane) * h + hh, acc);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int kk = idx / d, c = idx - kk * d;
    float acc_k = 0.f, acc_v = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_k = fmaf(dss[i * n + kk], qs[i * dp1 + c], acc_k);
      acc_v = fmaf(as[i * n + kk], gs[i * dp1 + c], acc_v);
    }
    const long long o = ((((long long)b * n + j) * n + kk) * d + c) * h + hh;
    store(dk + o, acc_k);
    store(dv + o, acc_v);
  }
}

// dbias, dgate: (b, i, k, h) contiguous outputs; dgate unused when ungated.
template <typename T, bool kGated, bool kDropout>
__global__ void __launch_bounds__(kBiasWarps * 32, 2)
bwd_bias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ bias,
                const T* __restrict__ gate, const T* __restrict__ dva,
                T* __restrict__ dbias, T* __restrict__ dgate, Dropout drop,
                int n, int d, int h, Strides3 sq, Strides3 sk, Strides3 sv,
                Strides3 sb, Strides3 sg, Strides3 sd) {
  const int hh = blockIdx.x, i0 = blockIdx.y * kBiasTile, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp1 = d + 1;
  const uint32_t seed = kDropout ? (uint32_t)drop.seeds[b] : 0u;

  extern __shared__ float smem[];
  float* ks = smem;                          // [n][d + 1]
  float* vs = ks + n * dp1;                  // [n][d + 1]
  float* qw = vs + n * dp1 + warp * 2 * d;   // [d] this warp's q row
  float* gw = qw + d;                        // [d] this warp's dva row

  float acc_b[kRowsPerWarp][kPerLane], acc_g[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc_b[r][t] = acc_g[r][t] = 0.f;
  }

  for (int j = 0; j < n; ++j) {
    __syncthreads();                         // the last column is done with
    stage(ks, k + b * sk.b + j * sk.x + hh, sk.y, n, d, h);
    stage(vs, v + b * sv.b + j * sv.x + hh, sv.y, n, d, h);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + warp + kBiasWarps * r;
      if (i < n) {                           // warp-uniform
        if (lane < d) {
          qw[lane] = to_f32(q[b * sq.b + i * sq.x + j * sq.y + lane * h + hh]);
          gw[lane] = to_f32(dva[b * sd.b + j * sd.x + i * sd.y + lane * h + hh]);
        }
        __syncwarp();
        float pn[kPerLane], da[kPerLane], g[kPerLane], keep[kPerLane], ds[kPerLane];
        row_grads<T, kGated, kDropout>(
            qw, gw, ks, vs, n, d, h, bias + b * sb.b + i * sb.x + hh, sb.y,
            gate + b * sg.b + i * sg.x + hh, sg.y, drop, seed,
            (uint32_t)(j * n + i) * n * h + hh, lane, pn, da, g, keep, ds);
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          acc_b[r][t] += ds[t];
          if (kGated) acc_g[r][t] = fmaf(da[t], pn[t], acc_g[r][t]);
        }
        __syncwarp();                        // qw and gw are rewritten next
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
      const long long o = (((long long)b * n + i) * n + kk) * h + hh;
      store(dbias + o, acc_b[r][t]);
      if (kGated) {
        const float gv = sigmoid(to_f32(gate[b * sg.b + i * sg.x + kk * sg.y + hh]));
        store(dgate + o, acc_g[r][t] * gv * (1.f - gv));
      }
    }
  }
}

template <typename T, bool kGated, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* gate, const void* dva, void* dq, void* dk, void* dv,
           void* dbias, void* dgate, const Dropout& drop, int batch, int n,
           int d, int h, const long long* st, cudaStream_t stream) {
  const Strides3 sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sb{st[9], st[10], st[11]},
      sg{st[12], st[13], st[14]}, sd{st[15], st[16], st[17]};
  const T* g = (const T*)(kGated ? gate : bias);  // never read when ungated

  const size_t smem_qkv = sizeof(float) * (4 * n * (d + 1) + 2 * n * n);
  auto qkv = bwd_qkv_kernel<T, kGated, kDropout>;
  cudaError_t e = allow_smem(qkv, smem_qkv);
  if (e != cudaSuccess) return (int)e;
  qkv<<<dim3(h, n, batch), dim3(kQkvWarps * 32), smem_qkv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, g, (const T*)dva,
      (T*)dq, (T*)dk, (T*)dv, drop, n, d, h, sq, sk, sv, sb, sg, sd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_bias = sizeof(float) * (2 * n * (d + 1) + kBiasWarps * 2 * d);
  const dim3 grid_bias(h, (n + kBiasTile - 1) / kBiasTile, batch);
  bwd_bias_kernel<T, kGated, kDropout>
      <<<grid_bias, dim3(kBiasWarps * 32), smem_bias, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)bias, g,
          (const T*)dva, (T*)dbias, (T*)dgate, drop, n, d, h, sq, sk, sv, sb,
          sg, sd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias,
             const void* gate, const void* dva, void* dq, void* dk, void* dv,
             void* dbias, void* dgate, const Dropout& drop, int batch, int n,
             int d, int h, const long long* st, cudaStream_t stream) {
  if (gate != nullptr && drop.seeds != nullptr) {
    return launch<T, true, true>(q, k, v, bias, gate, dva, dq, dk, dv, dbias,
                                 dgate, drop, batch, n, d, h, st, stream);
  }
  if (gate != nullptr) {
    return launch<T, true, false>(q, k, v, bias, gate, dva, dq, dk, dv, dbias,
                                  dgate, drop, batch, n, d, h, st, stream);
  }
  if (drop.seeds != nullptr) {
    return launch<T, false, true>(q, k, v, bias, gate, dva, dq, dk, dv, dbias,
                                  dgate, drop, batch, n, d, h, st, stream);
  }
  return launch<T, false, false>(q, k, v, bias, gate, dva, dq, dk, dv, dbias,
                                 dgate, drop, batch, n, d, h, st, stream);
}

}  // namespace

// f32 only (dtype 0; bf16 takes triplet_dense_bwd_mma). strides: 18
// element strides, the three outer axes of q, k, v, bias, gate and dva in
// that order. gate and dgate are null when ungated. seeds: null at rate 0,
// else the forward's (batch) int32 seeds on the device, with its threshold
// and kept value. Launches both kernels on `stream`; returns the first CUDA
// error (0 when both launched).
extern "C" int triplet_dense_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate,
                                 const void* dva, void* dq, void* dk, void* dv,
                                 void* dbias, void* dgate, const void* seeds,
                                 unsigned thresh, float keep_scale, int dtype,
                                 int batch, int n, int d, int h,
                                 const long long* strides, void* stream) {
  if (dtype != 0 || n < 1 || n > kMaxN || d < 1 || d > 32 || (d & (d - 1)) != 0 ||
      h < 1 || batch < 1 || batch > 65535 || ((gate == nullptr) != (dgate == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop{(const int*)seeds, thresh, keep_scale};
  return dispatch<float>(q, k, v, bias, gate, dva, dq, dk, dv, dbias, dgate, drop,
                         batch, n, d, h, strides, (cudaStream_t)stream);
}

// bf16. q_t, k_t, v_t, do_t: head-major (batch, h, n, n, dp) contiguous
// copies of q (its (b, h, j, i, d) view), k, v and dva (their (b, h, j, k, d)
// views), dp 16 or 32; dq_t, dk_t, dv_t the same. bias, gate (and dbias,
// dgate): (b, i, k, h) with the element strides of their (b, h, i, k) axes in
// sb and sg (and so); gate and dgate null when ungated. partial: 2 x chunks x
// batch x h x n x n floats of scratch; rows j go in chunks of jc. seeds as
// above. Returns the first CUDA error (0 when both launches went out).
extern "C" int triplet_dense_bwd_mma(
    const void* q_t, const void* k_t, const void* v_t, const void* do_t,
    const void* bias, const void* gate, const long long* sb, const long long* sg,
    void* dq_t, void* dk_t, void* dv_t, void* partial, void* dbias, void* dgate,
    const long long* so, const void* seeds, unsigned thresh, float keep_scale,
    int batch, int n, int dp, int h, int jc, int chunks, void* stream) {
  using tbwd::bf16;
  tbwd::Args a{};
  a.q = (const bf16*)q_t;
  a.k = (const bf16*)k_t;
  a.v = (const bf16*)v_t;
  a.dout = (const bf16*)do_t;
  a.bias = (const bf16*)bias;
  a.gate = (const bf16*)(gate != nullptr ? gate : bias);
  a.dq = (bf16*)dq_t;
  a.dk = (bf16*)dk_t;
  a.dv = (bf16*)dv_t;
  a.partial = (float*)partial;
  tbwd::Out o{(bf16*)dbias, (bf16*)dgate, {so[0], so[1], so[2], so[3]}};
  for (int x = 0; x < 4; ++x) {
    a.sb[x] = sb[x];
    a.sg[x] = gate != nullptr ? sg[x] : sb[x];
  }
  a.seeds = (const int*)seeds;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.scale = 1.f;                    // q comes pre-scaled
  a.batch = batch;
  a.h = h;
  a.nj = n;
  a.n = n;
  a.dp = dp;
  a.jc = jc;
  a.chunks = chunks;
  if (!tbwd::valid(a) || ((gate == nullptr) != (dgate == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (gate != nullptr && seeds != nullptr) return tbwd::launch<true, true>(a, o, s);
  if (gate != nullptr) return tbwd::launch<true, false>(a, o, s);
  if (seeds != nullptr) return tbwd::launch<false, true>(a, o, s);
  return tbwd::launch<false, false>(a, o, s);
}

// bf16 past 128 nodes, ungated, at rate 0 (the key-tiled route of
// triplet_tiled_mma.cuh: ttil::tiled_bwd_q_kernel, tiled_bwd_kv_kernel and
// tiled_reduce_kernel). q_t, k_t, v_t, do_t: head-major (bh, n, n, dp)
// contiguous, dp 16 or 32; bias_t: head-major (bh, n, n8), the key axis
// zero-padded to a multiple of 8; dq_t, dk_t, dv_t as q_t. stats: bh x n x n
// float4 and partial: chunks x bh x n x n floats of scratch; rows j go in
// chunks of jc. dbias: (b, i, k, h) at the element strides of its (b, h, i,
// k) axes in so. Returns the first CUDA error (0 when all three launches went
// out).
// Rows i per block of the tiled dQ kernel at n nodes, for the caller's
// partition of rows j into chunks.
extern "C" int triplet_dense_bwd_tiled_rows(int n) { return 16 * ttil::q_warps(n); }

extern "C" int triplet_dense_bwd_tiled(const void* q_t, const void* k_t, const void* v_t,
                                       const void* do_t, const void* bias_t, void* dq_t,
                                       void* dk_t, void* dv_t, void* stats, void* partial,
                                       void* dbias, const long long* so, int batch, int h,
                                       int n, int dp, int jc, int chunks, void* stream) {
  using tmma::bf16;
  ttil::Args a{};
  a.q = (const bf16*)q_t;
  a.k = (const bf16*)k_t;
  a.v = (const bf16*)v_t;
  a.dout = (const bf16*)do_t;
  a.bias = (const bf16*)bias_t;
  a.dq = (bf16*)dq_t;
  a.dk = (bf16*)dk_t;
  a.dv = (bf16*)dv_t;
  a.stats = (float4*)stats;
  a.partial = (float*)partial;
  a.bh = batch * h;
  a.n = n;
  a.dp = dp;
  a.jc = jc;
  a.chunks = chunks;
  if (!ttil::valid(a) || batch < 1 || h < 1) return (int)cudaErrorInvalidValue;
  return ttil::launch_bwd(a, (bf16*)dbias, so, batch, h, (cudaStream_t)stream);
}
