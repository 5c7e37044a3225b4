// Tensor-core pieces shared by the two bf16 triplet-attention bodies for Hopper
// (sm_90a): the forward body triplet_fwd_mma.cuh and the backward body
// triplet_bwd_mma.cuh. Both take one (b, h) panel set at a time, with a head
// width dp of 16 or 32 and rows padded to 16 KT, and compute the logits and
// their softmax here, in the accumulator fragments of mma.sync m16n8k16 (bf16
// in, f32 sums): the backward recomputes exactly the forward's weights.
//
// Fragment layout of one warp's 16 rows m0..m0+15 against 16 KT keys: element
// q of tile t, sf[t][q], is row m0 + gid + 8 (q >> 1), key 8 t + 2 tig + (q & 1),
// with gid = lane / 4 and tig = lane % 4. Tiles 2 kt and 2 kt + 1 packed as bf16
// pairs are the A operand of a product over keys 16 kt..16 kt + 15.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_ptx.cuh"
#include "triplet_common.cuh"

namespace tmma {

constexpr int kMaxNodes = 128;

// sigmoid with the fast exponential and division: within a few ulp of f32,
// far inside the bf16 outputs' rounding
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// Row strides of the staged tiles, padded by 8 elements so that ldmatrix and
// the fragment loads are free of bank conflicts: a (row, dp) panel, and an
// (i, k) tile of 16 KT x 16 KT.
__host__ __device__ constexpr int panel_stride(int dp) { return dp + 8; }
__host__ __device__ constexpr int pair_stride(int kt) { return 16 * kt + 8; }

// S = Q K^T for one warp's rows m0..m0+15 against all 16 KT keys of the staged
// panels qs and ks ([16 KT][ps] bf16, head width dp of 16 or 32).
template <int KT>
__device__ __forceinline__ void qk_fragments(float (&sf)[2 * KT][4], const bf16* qs,
                                             const bf16* ks, int ps, int dp, int m0,
                                             int lane) {
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) sf[t][0] = sf[t][1] = sf[t][2] = sf[t][3] = 0.f;
#pragma unroll
  for (int et = 0; et < 2; ++et) {
    if (et * 16 < dp) {
      uint32_t qa[4];
      ldsm_x4(qa, qs + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ps + et * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * ps + et * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(sf[2 * kt], qa, kb[0], kb[1]);
        mma(sf[2 * kt + 1], qa, kb[2], kb[3]);
      }
    }
  }
}

// The backward's pair of the same: S = Q K^T and D = O V^T (dA = dO V^T) in
// one pass over the head width, which shares the loop and keeps the
// backward body's register use as it was with both products inline.
template <int KT>
__device__ __forceinline__ void qk_fragments2(float (&sf)[2 * KT][4], float (&df)[2 * KT][4],
                                              const bf16* qs, const bf16* ks, const bf16* os,
                                              const bf16* vs, int ps, int dp, int m0, int lane) {
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) sf[t][q] = df[t][q] = 0.f;
  }
#pragma unroll
  for (int et = 0; et < 2; ++et) {
    if (et * 16 < dp) {
      uint32_t qa[4], oa[4];
      const int ar = m0 + (lane & 7) + ((lane >> 3) & 1) * 8, ac = et * 16 + (lane >> 4) * 8;
      ldsm_x4(qa, qs + ar * ps + ac);
      ldsm_x4(oa, os + ar * ps + ac);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t kb[4], vb[4];
        const int br = kt * 16 + (lane & 7) + (lane >> 4) * 8;
        const int bc = et * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(kb, ks + br * ps + bc);
        ldsm_x4(vb, vs + br * ps + bc);
        mma(sf[2 * kt], qa, kb[0], kb[1]);
        mma(sf[2 * kt + 1], qa, kb[2], kb[3]);
        mma(df[2 * kt], oa, vb[0], vb[1]);
        mma(df[2 * kt + 1], oa, vb[2], vb[3]);
      }
    }
  }
}

// The softmax numerators in place: sf := exp(scale sf + bias - max), with the
// max taken per row over its n keys and keys past n set to zero; recip gets
// 1 / max(row sum, floor) of rows m0 + gid and m0 + gid + 8 (floor 1e-30 is
// the dense kernels' clamp; 0 leaves the legacy sum, at least 1, as it is).
// bias_s is the (i, k) bias tile ([16 KT][ns] bf16). Row max and sum are
// taken across the quad by shuffles.
template <int NT>
__device__ __forceinline__ void softmax_fragments(float (&sf)[NT][4], const bf16* bias_s,
                                                  int ns, int n, int m0, int gid, int tig,
                                                  float scale, float floor,
                                                  float (&recip)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + gid + 8 * hf, col = 8 * t + 2 * tig;
      const float2 bv = __bfloat1622float2(*reinterpret_cast<const bf162*>(bias_s + row * ns + col));
      const float x0 = col < n ? fmaf(sf[t][2 * hf], scale, bv.x) : -INFINITY;
      const float x1 = col + 1 < n ? fmaf(sf[t][2 * hf + 1], scale, bv.y) : -INFINITY;
      sf[t][2 * hf] = x0;
      sf[t][2 * hf + 1] = x1;
      mx[hf] = fmaxf(mx[hf], fmaxf(x0, x1));
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFullMask, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFullMask, mx[hf], 2));
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sf[t][q] = __expf(sf[t][q] - mx[q >> 1]);
      sum[q >> 1] += sf[t][q];
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] += __shfl_xor_sync(kFullMask, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(kFullMask, sum[hf], 2);
    recip[hf] = 1.f / fmaxf(sum[hf], floor);
  }
}

}  // namespace tmma
