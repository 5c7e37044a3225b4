// The per-row softmax of the legacy triplet attention kernels
// (triplet_attention_fwd.cu, triplet_attention_bwd.cu), shared by both so the
// backward recomputes exactly the forward's weights.
#pragma once

#include "triplet_common.cuh"

namespace legacy {

constexpr int kMaxN = 128;
constexpr int kPerLane = kMaxN / 32;

// One row i of one (b, h, j) panel, in one warp: lanes take k = lane + 32 t.
// qrow is the row's q (d floats), ks the staged K panel ([n][dp1] floats),
// brow and grow point at bias[b, h, i, 0] and gate[b, h, i, 0] (contiguous
// over k). On return, for k < n: p = softmax_k(q.k * scale + bias), the max
// taken over the row and no clamp on the denominator (it is at least 1), and
// g = sigmoid(gate); p = g = 0 for k >= n.
template <typename T>
__device__ __forceinline__ void softmax_row(const float* qrow, const float* ks, int dp1,
                                            const T* brow, const T* grow, int n, int d,
                                            float scale, int lane, float (&p)[kPerLane],
                                            float (&g)[kPerLane]) {
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int kk = lane + 32 * t;
    p[t] = -INFINITY;
    if (kk < n) {
      const float* kr = ks + kk * dp1;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc = fmaf(qrow[e], kr[e], acc);
      p[t] = acc * scale + to_f32(brow[kk]);
      m = fmaxf(m, p[t]);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int kk = lane + 32 * t;
    p[t] = kk < n ? expf(p[t] - m) : 0.f;
    sum += p[t];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int kk = lane + 32 * t;
    p[t] = p[t] / sum;
    g[t] = kk < n ? sigmoid(to_f32(grow[kk])) : 0.f;
  }
}

// Stage a contiguous (n, d) panel into dst[n][dp1] as f32.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int n, int d, int dp1) {
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    dst[r * dp1 + c] = to_f32(src[idx]);
  }
}

}  // namespace legacy
