// The shared body of the two triplet-attention forward kernels in bf16 for
// Hopper (sm_90a): triplet_dense_fwd.cu (the dense pair, rows 1 and 2 of the
// port's kernel table) and triplet_attention_fwd.cu (the legacy pair, row 6).
// It replaces, for bf16 inputs, the TPU kernels
// tgt_tpu/ops/pallas/triplet_dense.py:_fwd_kernel (with _attn_tile, and
// _keep_tile/_hash_keepf at rate > 0) and
// tgt_tpu/ops/pallas/triplet_attention.py:_fwd_kernel, which compute the same
// attention on one (b, h) panel set; this header computes it once, for both.
// The backward body (triplet_bwd_mma.cuh) shares its logits and softmax
// (triplet_mma.cuh), so it recomputes exactly these weights.
//
// Inputs, all bf16: q, k, v (b, h, nj, n, dp) contiguous, with the head width
// dp 16 or 32 (the wrappers pad a narrower head with zero columns); bias and
// gate (b, h, i, k) at any element strides. For each (b, h) and each row j,
// with Q = q[b,h,j] (rows i), K = k[b,h,j] and V = v[b,h,j] (rows k):
//
//   s  = scale Q K^T + bias     e = exp(s - max_k s), the max per row (i, h)
//   g  = sigmoid(gate)          (1 ungated)
//   m  = keep((j n + i)(n H) + k H + h, seed[b])   (1 at rate 0)
//
//   dense  (kDense):  out = (bf16(e g m) V) / max(sum_k e, 1e-30)
//   legacy (!kDense): out = bf16(e / sum_k e * g) V
//
// The products sum in f32 and the output is rounded to bf16 once. Each
// rounding point is its TPU kernel's: the dense kernel rounds the unnormalised
// gated weights (after the keep mask) in _dot and multiplies the product by
// the reciprocal of the clamped denominator afterwards
// (triplet_dense.py:243-252); the legacy kernel rounds the normalised weights
// times the gate to v's dtype, with no clamp (triplet_attention.py:47-52; its
// row max makes the sum at least 1). Both take the max per (i, h): the dense TPU
// kernel's cross-head row max, which flushes a head ~88 below the others to
// zero, is not copied. Rows i and keys k past n are zero padding, and keys past
// n are masked before the max; a fully masked row stays finite, and zero when
// its gate is.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s, 989 TFLOP/s bf16): at
// b=16, N=48, edge width 256, H=16, d=16 the dense function moves q, k, v and
// its output (4 x 18.9 MB) plus bias and gate (2 x 1.18 MB), 77.9 MB, 23 us;
// the legacy function with its 2 x 16 stacked heads 156 MB, 47 us. Their two
// products, 4 d flops per (b, h, j, i, k), take 2-4 us at the tensor-core
// peak. Both are bound by device memory; the softmax's exponentials (one per
// (b, h, j, i, k), 28 and 57 million) take about 8 and 16 us on the SMs'
// special-function units, so the sigmoid is taken once per (b, h, i, k).
//
// Design:
//  - One block per (b, h, chunk of rows j) walks its j in order, as both TPU
//    kernels walk j inside one grid cell: bias and sigmoid(gate) of (b, h) are
//    staged once per block (bf16 and f32), as the TPU kernels hoist them out
//    of their j loops (triplet_dense.py:232-235, triplet_attention.py:37-38).
//    Chunks of j give the card enough blocks when b h is small. One launch
//    per call; no sum crosses blocks, so two launches give bitwise equal
//    outputs.
//  - The block has one warp per 16-row tile of n (padded to 16 KT). Per j,
//    warp w takes rows i 16w..16w+15: S = Q K^T on the tensor cores
//    (mma.sync m16n8k16, bf16 in, f32 sums, fragments by ldmatrix), the max,
//    exponentials and row sums in the accumulator fragments (quad shuffles),
//    the gate and the keep mask; the weights go from the accumulators
//    straight into the A operand of W V as bf16 pairs (V's fragments by
//    ldmatrix.trans), as the backward's ds goes into dQ.
//  - Staging: cp.async (16 bytes) double-buffers the next j's three panels
//    (Q, K, V: 3 n dp bf16, 4.5 KB at N=48, d=16) while the current j
//    computes. Row strides padded by 8 elements keep ldmatrix and the
//    fragment loads free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "triplet_common.cuh"
#include "triplet_mma.cuh"

namespace tfwd {

using namespace tmma;

struct Args {
  const bf16 *q, *k, *v;   // (b, h, nj, n, dp), contiguous
  const bf16 *bias, *gate; // (b, h, i, k) at strides sb, sg; gate unread when ungated
  bf16* out;               // (b, h, nj, n, dp), contiguous
  long long sb[4], sg[4];
  const int* seeds;        // (b) at rate > 0
  uint32_t thresh;
  float keep_scale;
  float scale;
  int batch, h, nj, n, dp, jc, chunks;  // jc rows j per chunk
};

// The keep mask of one (b, h): element (j, i, k) hashes base + i nh + k h,
// with base = j n nh + hh and nh = n H (uint32 arithmetic wraps as the TPU
// kernel's int32 does).
struct Keep {
  uint32_t seed, thresh, nh, h;
  float scale;
};

// Shared memory of one block: two stages of the three panels, the bias tile
// (bf16) and, when gated, sigmoid(gate) (f32), each [16 KT][16 KT + 8].
__host__ __device__ constexpr size_t shared_bytes(int kt, int dp, bool gated) {
  return (size_t)2 * 3 * 16 * kt * panel_stride(dp) * sizeof(bf16) +
         (size_t)16 * kt * pair_stride(kt) * (sizeof(bf16) + (gated ? sizeof(float) : 0));
}

// One warp's rows m0..m0+15 of one panel triple: o = W V (o[t] holds columns
// 8 t..8 t + 7 of dp, as accumulator fragments) and the reciprocal of each
// row's denominator (clamped at 1e-30 when kDense). bias_s and gate_s are the
// (i, k) tiles of the warp's (b, h); base is the keep mask's index of (j, 0, 0).
template <int KT, bool kDense, bool kGated, bool kDropout>
__device__ __forceinline__ void attend(float (&o)[4][4], float (&recip)[2], const bf16* qs,
                                       const bf16* ks, const bf16* vs, int ps, int dp,
                                       const bf16* bias_s, const float* gate_s, int n,
                                       float scale, const Keep& keep, uint32_t base, int m0,
                                       int lane) {
  constexpr int NT = 2 * KT, NS = pair_stride(KT);
  const int gid = lane >> 2, tig = lane & 3;
  float sf[NT][4];
  qk_fragments<KT>(sf, qs, ks, ps, dp, m0, lane);
  softmax_fragments<NT>(sf, bias_s, NS, n, m0, gid, tig, scale, kDense ? 1e-30f : 0.f, recip);
#pragma unroll
  for (int t = 0; t < 4; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t af[4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 2 * kt + u, row = m0 + gid + 8 * hf, col = 8 * t + 2 * tig;
        float w0 = sf[t][2 * hf], w1 = sf[t][2 * hf + 1];
        if constexpr (!kDense) {
          w0 *= recip[hf];
          w1 *= recip[hf];
        }
        if constexpr (kGated) {
          const float2 g = *reinterpret_cast<const float2*>(gate_s + row * NS + col);
          w0 *= g.x;
          w1 *= g.y;
        }
        if constexpr (kDropout) {
          const uint32_t lin = base + (uint32_t)row * keep.nh + (uint32_t)col * keep.h;
          w0 *= dropout_keep(lin, keep.seed, keep.thresh, keep.scale);
          w1 *= dropout_keep(lin + keep.h, keep.seed, keep.thresh, keep.scale);
        }
        af[2 * u + hf] = pack(w0, w1);
      }
    }
#pragma unroll
    for (int et = 0; et < 2; ++et) {
      if (et * 16 < dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ps + et * 16 +
                          (lane >> 4) * 8);
        mma(o[2 * et], af, vb[0], vb[1]);
        mma(o[2 * et + 1], af, vb[2], vb[3]);
      }
    }
  }
}

template <int KT, bool kDense, bool kGated, bool kDropout>
__global__ void __launch_bounds__(KT * 32, KT <= 4 ? 4 : 1)
panel_fwd_kernel(const Args a) {
  constexpr int NP = 16 * KT, NS = pair_stride(KT);
  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int b = bh / a.h, hh = bh - b * a.h;
  const int n = a.n, dp = a.dp, ps = panel_stride(dp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * warp;
  const int j0 = chunk * a.jc, j1 = min(a.nj, j0 + a.jc);

  extern __shared__ uint4 smem[];
  bf16* panels = reinterpret_cast<bf16*>(smem);   // [2][3][NP][ps]: q, k, v
  bf16* bias_s = panels + 6 * NP * ps;            // [NP][NS]
  float* gate_s = reinterpret_cast<float*>(bias_s + NP * NS);  // [NP][NS] when gated

  const int chunks16 = (int)(shared_bytes(KT, dp, kGated) / 16);
  for (int x = threadIdx.x; x < chunks16; x += blockDim.x) smem[x] = make_uint4(0, 0, 0, 0);
  __syncthreads();                  // the padding stays zero from here on

  const long long panel = (long long)n * dp;
  const int lp = dp == 16 ? 1 : 2;  // log2 of the 16-byte pieces of a row
  const int per = n << lp;          // 16-byte pieces of one panel
  auto fetch = [&](int j, int stage) {
    const long long off = ((long long)bh * a.nj + j) * panel;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const bf16* src = (p == 0 ? a.q : p == 1 ? a.k : a.v) + off;
      bf16* dst = panels + (stage * 3 + p) * NP * ps;
      for (int x = threadIdx.x; x < per; x += blockDim.x) {
        const int row = x >> lp, c = (x & ((1 << lp) - 1)) * 8;
        cp_async16(dst + row * ps + c, src + row * dp + c);
      }
    }
    cp_commit();
  };
  fetch(j0, 0);

  const bf16* bb = a.bias + b * a.sb[0] + hh * a.sb[1];
  const bf16* gb = a.gate + b * a.sg[0] + hh * a.sg[1];
  for (int x = threadIdx.x; x < n * n; x += blockDim.x) {
    const int i = x / n, kk = x - i * n;
    bias_s[i * NS + kk] = bb[i * a.sb[2] + kk * a.sb[3]];
    if (kGated) gate_s[i * NS + kk] = fast_sigmoid(__bfloat162float(gb[i * a.sg[2] + kk * a.sg[3]]));
  }

  const Keep keep{kDropout ? (uint32_t)a.seeds[b] : 0u, a.thresh, (uint32_t)(n * a.h),
                  (uint32_t)a.h, a.keep_scale};
  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    __syncthreads();                // every reader of the other stage is done
    if (j + 1 < j1) {
      fetch(j + 1, stage ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                // this j's panels (and, first, bias and gate) are visible
    const bf16* qs = panels + (stage * 3 + 0) * NP * ps;
    float o[4][4], recip[2];
    attend<KT, kDense, kGated, kDropout>(o, recip, qs, qs + NP * ps, qs + 2 * NP * ps, ps, dp,
                                         bias_s, gate_s, n, a.scale, keep,
                                         (uint32_t)j * (uint32_t)n * keep.nh + (uint32_t)hh, m0,
                                         lane);
    const long long off = ((long long)bh * a.nj + j) * panel;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t * 8 < dp) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + gid + 8 * hf;
          const float r = kDense ? recip[hf] : 1.f;
          if (row < n) {
            *reinterpret_cast<uint32_t*>(a.out + off + row * dp + 8 * t + 2 * tig) =
                pack(o[t][2 * hf] * r, o[t][2 * hf + 1] * r);
          }
        }
      }
    }
  }
}

template <int KT, bool kDense, bool kGated, bool kDropout>
int launch_tiles(const Args& a, cudaStream_t stream) {
  const size_t smem = shared_bytes(KT, a.dp, kGated);
  auto kernel = panel_fwd_kernel<KT, kDense, kGated, kDropout>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.batch * a.h, a.chunks), KT * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The forward of one call: one launch. Returns its CUDA error (0 when it
// launched).
template <bool kDense, bool kGated, bool kDropout>
int launch(const Args& a, cudaStream_t stream) {
  const int kt = (a.n + 15) / 16;
  if (kt <= 2) return launch_tiles<2, kDense, kGated, kDropout>(a, stream);
  if (kt == 3) return launch_tiles<3, kDense, kGated, kDropout>(a, stream);
  if (kt == 4) return launch_tiles<4, kDense, kGated, kDropout>(a, stream);
  return launch_tiles<8, kDense, kGated, kDropout>(a, stream);
}

// -- the dense pair read in place ---------------------------------------------
//
// The dense layout (b, i|j, j|k, d, h) puts the heads on the fastest axis, so
// a head-major panel is a gather at a stride of H elements. This kernel reads
// the layout in place: one block per (b, group of kGroup = 8 heads, chunk of
// rows j). Per j, cp.async copies the 16-byte pieces (8 heads of one (row,
// d)) of the Q column and the K, V rows into a raw tile, in the layout they
// have in memory; ldmatrix.trans transposes each 8 x 8 block (8 d of one row
// by 8 heads) into the eight per-head panels, and attend() runs on them as on
// the head-major copies. The output goes back the same way: each warp leaves
// its rows in its head's Q panel, and ldmatrix.trans of 8 heads by 8 d gives
// each thread 2 heads of one (i, d), stored as 4 bytes in place. Bias and
// sigmoid(gate) of the 8 heads are staged once per block. The raw tile is
// refilled for j + 1 while j computes. Shared memory at n = 48, d = 16:
// 36 KB raw, 54 KB panels, 42 KB bias, 84 KB sigmoid(gate), so one block of
// 4 KT warps per SM, each warp taking its row tile of two heads in turn. It
// takes n <= 48, d of 8 or 16, H a multiple of 8, and 16-byte aligned pieces;
// the wrapper sends any other shape through the head-major copies.
constexpr int kGroup = 8;

struct InPlaceArgs {
  const bf16 *q, *k, *v;   // q (b, i, j, d, h), k and v (b, j, k, d, h)
  const bf16 *bias, *gate; // (b, i, k, h); gate unread when ungated
  bf16* out;               // (b, j, i, d, h), contiguous
  long long sq[3], sk[3], sv[3], sb[3], sg[3];  // element strides of the outer axes
  const int* seeds;
  uint32_t thresh;
  float keep_scale;
  int batch, h, n, d, jc, chunks;
};

// A head's panel stride: 16 KT rows of dp = 16, padded to 8 mod 64 elements,
// so that the transposes' 8 heads fall in distinct banks.
__host__ __device__ constexpr int head_stride(int kt) {
  return (16 * kt * panel_stride(16) + 63) / 64 * 64 + 8;
}

__host__ __device__ constexpr size_t inplace_shared_bytes(int kt, bool gated) {
  return (size_t)3 * 16 * kt * 16 * kGroup * sizeof(bf16) +           // raw tile
         (size_t)3 * kGroup * head_stride(kt) * sizeof(bf16) +         // panels
         (size_t)kGroup * 16 * kt * pair_stride(kt) * (sizeof(bf16) + (gated ? sizeof(float) : 0));
}

template <int KT, bool kGated, bool kDropout>
__global__ void __launch_bounds__(4 * KT * 32, 1)
inplace_fwd_kernel(const InPlaceArgs a) {
  constexpr int NP = 16 * KT, NS = pair_stride(KT), HS = head_stride(KT), PS = panel_stride(16);
  constexpr int kThreads = 4 * KT * 32;
  const int groups = a.h / kGroup;
  const int b = blockIdx.x / groups, g = blockIdx.x - b * groups, chunk = blockIdx.y;
  const int n = a.n, d = a.d;
  const int ld = d == 16 ? 4 : 3, lcb = ld - 3;   // log2 of d and of its 8-wide blocks
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * (warp % KT), hp = warp / KT;   // rows; heads 2 hp, 2 hp + 1
  const int j0 = chunk * a.jc, j1 = min(n, j0 + a.jc);

  extern __shared__ uint4 smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);           // [3][n][d][8]
  bf16* panels = raw + 3 * NP * 16 * kGroup;            // [3][8][HS]: q, k, v
  bf16* bias_s = panels + 3 * kGroup * HS;              // [8][NP][NS]
  float* gate_s = reinterpret_cast<float*>(bias_s + kGroup * NP * NS);  // [8][NP][NS]

  const int chunks16 = (int)(inplace_shared_bytes(KT, kGated) / 16);
  for (int x = threadIdx.x; x < chunks16; x += kThreads) smem[x] = make_uint4(0, 0, 0, 0);
  __syncthreads();                  // the padding stays zero from here on

  const int hg = g * kGroup;
  const int per = n << ld;          // 16-byte pieces of one tensor's rows
  auto fetch = [&](int j) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const bf16* src = p == 0   ? a.q + b * a.sq[0] + j * a.sq[2]
                        : p == 1 ? a.k + b * a.sk[0] + j * a.sk[1]
                                 : a.v + b * a.sv[0] + j * a.sv[1];
      const long long rs = p == 0 ? a.sq[1] : p == 1 ? a.sk[2] : a.sv[2];
      for (int x = threadIdx.x; x < per; x += kThreads) {
        cp_async16(raw + ((size_t)p * per + x) * kGroup,
                   src + (x >> ld) * rs + (x & (d - 1)) * a.h + hg);
      }
    }
    cp_commit();
  };
  fetch(j0);

  for (int x = threadIdx.x; x < n * n; x += kThreads) {
    const int i = x / n, kk = x - i * n;
    const uint4 bv = *reinterpret_cast<const uint4*>(a.bias + b * a.sb[0] + i * a.sb[1] +
                                                     kk * a.sb[2] + hg);
    const bf16* bh = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) bias_s[(u * NP + i) * NS + kk] = bh[u];
    if constexpr (kGated) {
      const uint4 gv = *reinterpret_cast<const uint4*>(a.gate + b * a.sg[0] + i * a.sg[1] +
                                                       kk * a.sg[2] + hg);
      const bf16* gh = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        gate_s[(u * NP + i) * NS + kk] = fast_sigmoid(__bfloat162float(gh[u]));
      }
    }
  }

  const Keep keep{kDropout ? (uint32_t)a.seeds[b] : 0u, a.thresh, (uint32_t)(n * a.h),
                  (uint32_t)a.h, a.keep_scale};
  const int blocks = n << lcb;     // 8 x 8 blocks to transpose per tensor
  const int mask = (1 << lcb) - 1;
  for (int j = j0; j < j1; ++j) {
    cp_wait<0>();
    __syncthreads();                // raw holds j; the last output has left the panels
    // raw -> panels: block (p, r, c0) is 8 rows (d c0..c0+7) of 8 heads; the
    // thread gets heads gid, d c0 + 2 tig + {0, 1} of row r
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const bf16* rp = raw + (size_t)p * per * kGroup;
      bf16* pp = panels + (p * kGroup + gid) * HS + 2 * tig;
      for (int q0 = warp * 4; q0 < blocks; q0 += 4 * KT * 4) {
        const int mine = min(q0 + (lane >> 3), blocks - 1);
        uint32_t t4[4];
        ldsm_x4_t(t4, rp + ((((mine >> lcb) << ld) + ((mine & mask) << 3) + (lane & 7)) << 3));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int blk = q0 + m;
          if (blk < blocks) {
            *reinterpret_cast<uint32_t*>(pp + (blk >> lcb) * PS + ((blk & mask) << 3)) = t4[m];
          }
        }
      }
    }
    __syncthreads();                // panels ready; raw is free
    if (j + 1 < j1) fetch(j + 1);

#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int hl = 2 * hp + u;
      bf16* qs = panels + hl * HS;
      float o[4][4], recip[2];
      attend<KT, true, kGated, kDropout>(o, recip, qs, panels + (kGroup + hl) * HS,
                                         panels + (2 * kGroup + hl) * HS, PS, 16,
                                         bias_s + hl * NP * NS, gate_s + hl * NP * NS, n, 1.f,
                                         keep, (uint32_t)j * (uint32_t)n * keep.nh + (uint32_t)(hg + hl),
                                         m0, lane);
      // this warp's rows of Q are read: the output takes their place
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + gid + 8 * hf;
          if (row < n) {
            *reinterpret_cast<uint32_t*>(qs + row * PS + 8 * t + 2 * tig) =
                pack(o[t][2 * hf] * recip[hf], o[t][2 * hf + 1] * recip[hf]);
          }
        }
      }
    }
    __syncthreads();                // every head's output is in its Q panel
    // panels -> out: block (i, c0) is 8 heads by d c0..c0+7 of row i; the
    // thread gets heads 2 tig + {0, 1} of d c0 + gid
    bf16* ob = a.out + (((long long)b * n + j) * n) * d * a.h + hg + 2 * tig;
    for (int q0 = warp * 4; q0 < blocks; q0 += 4 * KT * 4) {
      const int mine = min(q0 + (lane >> 3), blocks - 1);
      uint32_t t4[4];
      ldsm_x4_t(t4, panels + (lane & 7) * HS + (mine >> lcb) * PS + ((mine & mask) << 3));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int blk = q0 + m;
        if (blk < blocks) {
          // row i = blk >> lcb, column c = 8 (blk & mask) + gid: at (i d + c) H
          *reinterpret_cast<uint32_t*>(ob + ((long long)(((blk >> lcb) << ld) + ((blk & mask) << 3) + gid)) * a.h) = t4[m];
        }
      }
    }
  }
}

template <bool kGated, bool kDropout>
int launch_inplace(const InPlaceArgs& a, cudaStream_t stream) {
  const int kt = (a.n + 15) / 16;
  auto kernel = kt <= 2 ? inplace_fwd_kernel<2, kGated, kDropout>
                        : inplace_fwd_kernel<3, kGated, kDropout>;
  const int kt2 = kt <= 2 ? 2 : 3;
  const size_t smem = inplace_shared_bytes(kt2, kGated);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.batch * (a.h / kGroup), a.chunks), 4 * kt2 * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline bool valid_inplace(const InPlaceArgs& a) {
  return a.n >= 1 && a.n <= 48 && (a.d == 8 || a.d == 16) && a.h >= kGroup &&
         a.h % kGroup == 0 && a.batch >= 1 && a.jc >= 1 && a.chunks >= 1 &&
         (long long)(a.chunks - 1) * a.jc < a.n && (long long)a.chunks * a.jc >= a.n &&
         a.chunks <= 65535;
}

// What the body takes; the wrappers pad or raise on anything else.
inline bool valid(const Args& a) {
  const long long blocks = (long long)a.batch * a.h;
  return a.n >= 1 && a.n <= kMaxNodes && (a.dp == 16 || a.dp == 32) && a.h >= 1 &&
         a.batch >= 1 && a.nj >= 1 && a.jc >= 1 && a.chunks >= 1 &&
         (long long)(a.chunks - 1) * a.jc < a.nj && (long long)a.chunks * a.jc >= a.nj &&
         a.chunks <= 65535 && blocks <= 0x7fffffffLL;
}

}  // namespace tfwd
