// Forward dense triplet attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_dense.py:_fwd_kernel
// (with _attn_tile), at dropout rate 0 and at rate > 0 (with _keep_tile and
// _hash_keepf). For every batch row b, pair column j and triplet head h it
// computes, for each row i,
//
//   s[k]       = sum_d Q[b,i,j,d,h] K[b,j,k,d,h] + bias[b,i,k,h]   (Q pre-scaled)
//   a[k]       = softmax_k(s)[k] * sigmoid(gate[b,i,k,h])          (gate optional)
//                * keep(seed[b], (j*n + i)*(n*H) + k*H + h)        (rate > 0)
//   va[b,j,i,:,h] = sum_k a[k] V[b,j,k,:,h]
//
// keep is the stateless hash of dropout_hash.cuh: the dropout runs in the
// kernel, on the gated weights (softmax, gate, dropout, as the TPU kernel
// orders them), and the mask never reaches device memory. The rate > 0
// branch is a template flag: the rate-0 instantiations carry none of it.
//
// in f32, whatever the storage type (f32 or bf16). No (b, N, N, N, h)
// tensor reaches device memory: the N x N logits of one (b, j, h) live in
// registers and shared memory only.
//
// Bound on the H100: at the flagship bucket (b=16, N=48, edge width 256,
// H=16, d=16, bf16) the function must move q, k, v and va (4 x 18.9 MB) plus
// bias and gate (2 x 1.18 MB), about 77.9 MB, which takes 23.2 us at
// 3.35 TB/s; its 1.81 GFLOP take 1.8 us at the bf16 tensor-core peak. So it is
// bound by device memory.
//
// Design (simple and right first; wgmma/TMA are later work): one block per
// (b, j, h), so b*N*H blocks (12,288 at the flagship bucket). The block
// stages K[b,j,:,:,h] and V[b,j,:,:,h] (N x d each) in shared memory as f32.
// Each warp takes rows i in turn: lanes take k, then a warp max, exp, a warp
// sum, the gate, and the k-sum of a*V with lanes split over (d, k-parity).
// The softmax max is taken per (i, h), so a head whose logits all sit far
// below the other heads' keeps its own distribution (the TPU kernel's
// cross-head row max flushes such a head to zero). The denominator is still
// clamped at 1e-30 as in the TPU kernel. Heads are the fastest axis in
// memory, so a block reads its operands with stride H; the H blocks of one
// (b, j) are adjacent in the grid and share those cache lines through L2.
#include <stdint.h>

#include "dropout_hash.cuh"
#include "triplet_common.cuh"

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

// dtype: 0 = float32, 1 = bfloat16. strides: 15 element strides, the three
// outer axes of q, k, v, bias and gate in that order. gate may be null
// (ungated). seeds: null at rate 0, else (batch) int32 on the device, with
// the threshold and the kept value of dropout_hash.cuh. Returns
// cudaGetLastError() after the launch.
extern "C" int triplet_dense_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate, void* out,
                                 const void* seeds, unsigned thresh,
                                 float keep_scale, int dtype, int batch, int n,
                                 int d, int h, const long long* strides,
                                 void* stream) {
  if (n < 1 || n > kMaxN || d < 1 || d > 32 || (d & (d - 1)) != 0 || h < 1 ||
      batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int* sd = (const int*)seeds;
  if (dtype == 0) {
    dispatch<float>(q, k, v, bias, gate, out, sd, thresh, keep_scale, batch, n,
                    d, h, strides, s);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(q, k, v, bias, gate, out, sd, thresh, keep_scale,
                            batch, n, d, h, strides, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
