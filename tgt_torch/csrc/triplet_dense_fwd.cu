// Forward dense triplet attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_dense.py:_fwd_kernel
// (reached through _call_fwd, with _attn_tile), at dropout rate 0 and at
// rate > 0 (with _keep_tile and _hash_keepf). For every batch row b, pair
// column j and triplet head h it computes, for each row i,
//
//   s[k]       = sum_d Q[b,i,j,d,h] K[b,j,k,d,h] + bias[b,i,k,h]   (Q pre-scaled)
//   e[k]       = exp(s[k] - max_k s)                                (max per (i, h))
//   a[k]       = e[k] * sigmoid(gate[b,i,k,h])                      (gate optional)
//                * keep(seed[b], (j*n + i)*(n*H) + k*H + h)        (rate > 0)
//   va[b,j,i,:,h] = sum_k a[k] V[b,j,k,:,h] / max(sum_k e[k], 1e-30)
//
// keep is the stateless hash of dropout_hash.cuh: the dropout runs in the
// kernel, on the gated weights (softmax, gate, dropout, as the TPU kernel
// orders them), and the mask never reaches device memory. No (b, N, N, N, h)
// tensor reaches device memory either.
//
// Bound on the H100: at the flagship bucket (b=16, N=48, edge width 256,
// H=16, d=16, bf16) the function must move q, k, v and va (4 x 18.9 MB) plus
// bias and gate (2 x 1.18 MB), about 77.9 MB, which takes 23.2 us at
// 3.35 TB/s; its 1.81 GFLOP take 1.8 us at the bf16 tensor-core peak. So it is
// bound by device memory.
//
// Two paths, by storage type:
//  - bf16, the serving and training path: triplet_dense_fwd_mma runs the
//    tensor-core body shared with the legacy forward (triplet_fwd_mma.cuh,
//    kDense: one block per (b, h, chunk of j) walks j in order, S = Q K^T and
//    W V on mma.sync, the softmax in the accumulator fragments). Up to n = 48
//    with d of 8 or 16, triplet_dense_fwd_inplace reads the natural layouts
//    in place (tfwd::inplace_fwd_kernel: one block per (b, 8 heads, chunk of
//    j), 16-byte pieces of 8 heads transposed to per-head panels in shared
//    memory and back). Other shapes take triplet_dense_fwd_mma on head-major
//    copies (b, h, j, i|k, d) that the wrapper makes of q, k and v, as
//    tgt_tpu's _pack relayouts around its kernel, with a head-major output
//    that the wrapper moves back; bias and gate are read in place at their
//    (b, h, i, k) strides. Both routes compute the same sums in the same
//    order, so their outputs are bitwise equal. The rounding is
//    _fwd_kernel's: the unnormalised gated weights (times the keep mask) are
//    rounded to bf16 before the product, which sums in f32 and is then
//    multiplied by the reciprocal of the clamped denominator
//    (triplet_dense.py:243-252).
//  - f32, the 1e-4 checks and the f32 gradients: the CUDA-core kernel below,
//    which reads the natural layouts in place. One block per (b, j, h), so
//    b*N*H blocks (12,288 at the flagship bucket), stages K[b,j,:,:,h] and
//    V[b,j,:,:,h] (N x d each) in shared memory. Each warp takes rows i in
//    turn: lanes take k, then a warp max, exp, a warp sum, the gate, and the
//    k-sum of a*V with lanes split over (d, k-parity). Heads are the fastest
//    axis in memory, so a block reads its operands with stride H; the H
//    blocks of one (b, j) are adjacent in the grid and share those cache
//    lines through L2.
// Both take the softmax max per (i, h), so a head whose logits all sit far
// below the other heads' keeps its own distribution (the TPU kernel's
// cross-head row max flushes such a head to zero); the denominator is still
// clamped at 1e-30 as in the TPU kernel.
#include <stdint.h>

#include "dropout_hash.cuh"
#include "triplet_common.cuh"
#include "triplet_fwd_mma.cuh"
#include "triplet_tiled_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxN = 128;
constexpr int kPerLane = kMaxN / 32;
constexpr unsigned kFull = kFullMask;

struct Strides3 {
  long long b, x, y;  // element strides of the three outer axes
};

// q: (b, i, j, d, h); k, v: (b, j, k, d, h); bias, gate: (b, i, k, h);
// out: (b, j, i, d, h) contiguous. The (d, h) axes of q/k/v and the h axis
// of bias/gate are contiguous; the outer axes take any strides. seeds: (b)
// int32, read only when kDropout.
template <typename T, bool kGated, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
triplet_dense_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ bias,
                         const T* __restrict__ gate, T* __restrict__ out,
                         const int* __restrict__ seeds, uint32_t thresh,
                         float keep_scale, int n, int d, int h, Strides3 sq,
                         Strides3 sk, Strides3 sv, Strides3 sb, Strides3 sg) {
  const int hh = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t seed = kDropout ? (uint32_t)seeds[b] : 0u;

  extern __shared__ float smem[];
  float* ks = smem;                 // [n][d + 1], padded against bank conflicts
  float* vs = ks + n * (d + 1);     // [n][d]
  float* qs = vs + n * d;           // [kWarps][d]
  float* as = qs + kWarps * d;      // [kWarps][n]

  const T* kb = k + b * sk.b + j * sk.x + hh;
  const T* vb = v + b * sv.b + j * sv.x + hh;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int kk = idx / d, dd = idx - kk * d;
    ks[kk * (d + 1) + dd] = to_f32(kb[kk * sk.y + dd * h]);
    vs[idx] = to_f32(vb[kk * sv.y + dd * h]);
  }
  __syncthreads();

  float* qw = qs + warp * d;
  float* aw = as + warp * n;
  const int groups = 32 / d;        // d is a power of two <= 32
  const int dd = lane & (d - 1);
  const int grp = lane / d;

  for (int i = warp; i < n; i += kWarps) {
    const T* qrow = q + b * sq.b + i * sq.x + j * sq.y + hh;
    if (lane < d) qw[lane] = to_f32(qrow[lane * h]);
    __syncwarp();

    const T* brow = bias + b * sb.b + i * sb.x + hh;
    float s[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int kk = lane + 32 * t;
      s[t] = -INFINITY;
      if (kk < n) {
        float acc = to_f32(brow[kk * sb.y]);
        const float* kr = ks + kk * (d + 1);
        for (int e = 0; e < d; ++e) acc = fmaf(qw[e], kr[e], acc);
        s[t] = acc;
        m = fmaxf(m, acc);
      }
    }
    m = warp_max(m);

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int kk = lane + 32 * t;
      if (kk < n) {
        float p = expf(s[t] - m);
        sum += p;
        if (kGated) {
          const float g = to_f32(gate[b * sg.b + i * sg.x + kk * sg.y + hh]);
          p *= 1.f / (1.f + expf(-g));
        }
        if (kDropout) {
          const uint32_t lin = ((uint32_t)(j * n + i) * n + kk) * h + hh;
          p *= dropout_keep(lin, seed, thresh, keep_scale);
        }
        aw[kk] = p;
      }
    }
    sum = warp_sum(sum);
    const float recip = 1.f / fmaxf(sum, 1e-30f);
    __syncwarp();

    float acc = 0.f;
    for (int kk = grp; kk < n; kk += groups) acc = fmaf(aw[kk], vs[kk * d + dd], acc);
    for (int off = d; off < 32; off <<= 1) acc += __shfl_down_sync(kFull, acc, off);
    if (lane < d) {
      store(out + ((((long long)b * n + j) * n + i) * d + lane) * h + hh, acc * recip);
    }
    __syncwarp();  // qw and aw are rewritten by the next row
  }
}

template <typename T, bool kGated, bool kDropout>
void launch(const void* q, const void* k, const void* v, const void* bias,
            const void* gate, void* out, const int* seeds, uint32_t thresh,
            float keep_scale, int batch, int n, int d, int h,
            const long long* st, cudaStream_t stream) {
  const Strides3 sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sb{st[9], st[10], st[11]},
      sg{st[12], st[13], st[14]};
  const dim3 grid(h, n, batch);
  const dim3 block(kWarps * 32);
  const size_t smem = sizeof(float) * (n * (d + 1) + n * d + kWarps * d + kWarps * n);
  triplet_dense_fwd_kernel<T, kGated, kDropout><<<grid, block, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (const T*)gate,
      (T*)out, seeds, thresh, keep_scale, n, d, h, sq, sk, sv, sb, sg);
}

template <typename T>
void dispatch(const void* q, const void* k, const void* v, const void* bias,
              const void* gate, void* out, const int* seeds, uint32_t thresh,
              float keep_scale, int batch, int n, int d, int h,
              const long long* st, cudaStream_t stream) {
  if (gate != nullptr && seeds != nullptr) {
    launch<T, true, true>(q, k, v, bias, gate, out, seeds, thresh, keep_scale,
                          batch, n, d, h, st, stream);
  } else if (gate != nullptr) {
    launch<T, true, false>(q, k, v, bias, gate, out, seeds, thresh, keep_scale,
                           batch, n, d, h, st, stream);
  } else if (seeds != nullptr) {
    launch<T, false, true>(q, k, v, bias, gate, out, seeds, thresh, keep_scale,
                           batch, n, d, h, st, stream);
  } else {
    launch<T, false, false>(q, k, v, bias, gate, out, seeds, thresh, keep_scale,
                            batch, n, d, h, st, stream);
  }
}

}  // namespace

// f32 only (dtype 0; bf16 takes triplet_dense_fwd_mma). strides: 15 element
// strides, the three outer axes of q, k, v, bias and gate in that order. gate
// may be null (ungated). seeds: null at rate 0, else (batch) int32 on the
// device, with the threshold and the kept value of dropout_hash.cuh. Returns
// cudaGetLastError() after the launch.
extern "C" int triplet_dense_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate, void* out,
                                 const void* seeds, unsigned thresh,
                                 float keep_scale, int dtype, int batch, int n,
                                 int d, int h, const long long* strides,
                                 void* stream) {
  if (dtype != 0 || n < 1 || n > kMaxN || d < 1 || d > 32 || (d & (d - 1)) != 0 ||
      h < 1 || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  dispatch<float>(q, k, v, bias, gate, out, (const int*)seeds, thresh, keep_scale, batch,
                  n, d, h, strides, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// bf16. q_t, k_t, v_t: head-major (batch, h, n, n, dp) contiguous copies of q
// (its (b, h, j, i, d) view), k and v (their (b, h, j, k, d) views), dp 16 or
// 32; out_t the same, the (b, h, j, i, d) view of va. bias, gate: (b, i, k, h)
// with the element strides of their (b, h, i, k) axes in sb and sg; gate null
// when ungated. Rows j go in chunks of jc. seeds as above. Returns the
// launch's CUDA error (0 when it went out).
extern "C" int triplet_dense_fwd_mma(const void* q_t, const void* k_t, const void* v_t,
                                     const void* bias, const void* gate,
                                     const long long* sb, const long long* sg, void* out_t,
                                     const void* seeds, unsigned thresh, float keep_scale,
                                     int batch, int n, int dp, int h, int jc, int chunks,
                                     void* stream) {
  using tfwd::bf16;
  tfwd::Args a{};
  a.q = (const bf16*)q_t;
  a.k = (const bf16*)k_t;
  a.v = (const bf16*)v_t;
  a.bias = (const bf16*)bias;
  a.gate = (const bf16*)(gate != nullptr ? gate : bias);
  a.out = (bf16*)out_t;
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
  if (!tfwd::valid(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (gate != nullptr && seeds != nullptr) return tfwd::launch<true, true, true>(a, s);
  if (gate != nullptr) return tfwd::launch<true, true, false>(a, s);
  if (seeds != nullptr) return tfwd::launch<true, false, true>(a, s);
  return tfwd::launch<true, false, false>(a, s);
}

// bf16, read in place (tfwd::inplace_fwd_kernel). q (b, i, j, d, h), k and v
// (b, j, k, d, h), bias and gate (b, i, k, h) with the strides of the natural
// layouts: strides holds the three outer element strides of q, k, v, bias and
// gate; the (d, h) axes of q, k, v and the h axis of bias and gate are
// contiguous, every piece of 8 heads 16-byte aligned. out: (b, j, i, d, h)
// contiguous. Takes n <= 48, d of 8 or 16 and h a multiple of 8 (the wrapper
// sends other shapes through triplet_dense_fwd_mma). Rows j go in chunks of
// jc. Returns the launch's CUDA error (0 when it went out).
extern "C" int triplet_dense_fwd_inplace(const void* q, const void* k, const void* v,
                                         const void* bias, const void* gate, void* out,
                                         const void* seeds, unsigned thresh,
                                         float keep_scale, int batch, int n, int d, int h,
                                         const long long* strides, int jc, int chunks,
                                         void* stream) {
  using tfwd::bf16;
  tfwd::InPlaceArgs a{};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.bias = (const bf16*)bias;
  a.gate = (const bf16*)(gate != nullptr ? gate : bias);
  a.out = (bf16*)out;
  for (int x = 0; x < 3; ++x) {
    a.sq[x] = strides[x];
    a.sk[x] = strides[3 + x];
    a.sv[x] = strides[6 + x];
    a.sb[x] = strides[9 + x];
    a.sg[x] = strides[12 + x];
  }
  a.seeds = (const int*)seeds;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.batch = batch;
  a.h = h;
  a.n = n;
  a.d = d;
  a.jc = jc;
  a.chunks = chunks;
  if (!tfwd::valid_inplace(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (gate != nullptr && seeds != nullptr) return tfwd::launch_inplace<true, true>(a, s);
  if (gate != nullptr) return tfwd::launch_inplace<true, false>(a, s);
  if (seeds != nullptr) return tfwd::launch_inplace<false, true>(a, s);
  return tfwd::launch_inplace<false, false>(a, s);
}

// bf16 past 128 nodes, ungated, at rate 0 (ttil::tiled_fwd_kernel, the
// key-tiled route of triplet_tiled_mma.cuh). q_t, k_t, v_t: head-major (bh, n,
// n, dp) contiguous copies as for triplet_dense_fwd_mma, dp 16 or 32; bias_t:
// a head-major (bh, n, n8) copy of the bias, its key axis zero-padded to a
// multiple of 8; out_t as q_t. Takes n <= ttil::kMaxNodes. Returns the
// launch's CUDA error (0 when it went out).
extern "C" int triplet_dense_fwd_tiled(const void* q_t, const void* k_t, const void* v_t,
                                       const void* bias_t, void* out_t, int bh, int n, int dp,
                                       void* stream) {
  using tmma::bf16;
  ttil::Args a{};
  a.q = (const bf16*)q_t;
  a.k = (const bf16*)k_t;
  a.v = (const bf16*)v_t;
  a.bias = (const bf16*)bias_t;
  a.out = (bf16*)out_t;
  a.bh = bh;
  a.n = n;
  a.dp = dp;
  a.jc = n;
  a.chunks = 1;
  if (!ttil::valid(a)) return (int)cudaErrorInvalidValue;
  return ttil::launch_fwd(a, (cudaStream_t)stream);
}
