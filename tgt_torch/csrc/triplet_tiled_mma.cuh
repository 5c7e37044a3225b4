// The key-tiled route of the bf16 dense triplet attention for Hopper (sm_90a):
// the forward and the backward past the 128 nodes that the bodies of
// triplet_fwd_mma.cuh and triplet_bwd_mma.cuh hold in registers and shared
// memory. It takes the ungated core at dropout rate 0 (the triangle attention
// of AlphaFold 3's Pairformer, at n = 384-768, d = 32, H = 4); the wrappers
// send every call with n <= 128 to those bodies as before, and raise on a gated
// or dropout call past 128 nodes.
//
// Inputs, all bf16: q, k, v (and the cotangent) as head-major panels (b h, nj,
// n, dp), contiguous, with the head width dp 16 or 32; the bias as a head-major
// copy (b h, n, n8) with its key axis zero-padded to n8 = 8 ceil(n / 8), so
// that every 16-byte piece of a row lies inside it. For each (b, h) and row j,
// with Q = q[bh, j] (rows i), K = k[bh, j] and V = v[bh, j] (rows k):
//
//   s = Q K^T + bias      p = softmax_k(s)      out = p V
//
// Forward (tiled_fwd_kernel): one block of W warps per (16 W rows i, row j,
// (b, h)). It walks the keys in blocks of 64 (K, V and the (i, k) bias tile
// double-buffered by cp.async) with an online softmax in the accumulator
// fragments: the running row max m, the unnormalised weights e = exp(s - m)
// rounded to bf16 into the A operand of e V, the product and the row sum
// rescaled by exp(m_old - m_new) when the max grows; at the end the output is
// multiplied by 1 / max(sum, 1e-30), as the dense body clamps it. The weights
// are rounded against the running max rather than the row's own, so the route
// agrees with the plain core to bf16 rounding, not bit for bit.
//
// Backward, three launches, no atomics:
//  - tiled_bwd_q_kernel, one block per (16 W rows i, chunk of rows j, (b, h)):
//    per j, a first pass over the key blocks takes the row statistics (max m,
//    1 / sum, and D = sum_k p dP with dP = dO V^T) online; a second pass
//    recomputes S and dP, forms p = exp(s - m) / sum and dS = p (dP - D),
//    accumulates dQ = dS K in registers and dS itself into an f32 tile of the
//    block's rows by all n keys in shared memory, which every j of the chunk
//    adds to. The statistics go to a workspace (b h, nj, n) of float4; the tile
//    goes to the chunk's slice of the partial sums after the last j.
//  - tiled_bwd_kv_kernel, one block of W warps per (16 W keys, row j, (b, h)):
//    it stages K and V once and walks the rows i in tiles of 64: S^T = K Q^T
//    and dP^T = V dO^T, p and dS from the saved statistics, then dV += p^T dO
//    and dK += dS^T Q in registers.
//  - tiled_reduce_kernel adds the chunks' partial sums of dbias in chunk order.
// Products sum in f32; dS and p are rounded to bf16 before their products, as
// the dense body rounds them. Every sum runs in a fixed order, so two calls
// give bitwise equal outputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "triplet_common.cuh"
#include "triplet_mma.cuh"

namespace ttil {

using namespace tmma;

constexpr int kMaxNodes = 1024;
constexpr int kBlockKeys = 64;               // keys (or rows i) per staged block
constexpr int kKT = kBlockKeys / 16;         // 16-wide tiles of a block
constexpr int kNT = 2 * kKT;                 // 8-wide fragment tiles of a block
constexpr int kBS = kBlockKeys + 8;          // row stride of a bias tile

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int blocks_of(int n) { return (n + kBlockKeys - 1) / kBlockKeys; }

// Rows [r0, r0 + rows) of an (n, dp) panel into a staged tile [rows][ps]; the
// rows past n are not written (they hold zeros or an earlier tile's rows,
// which every use masks).
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int rows, int n,
                                           int dp, int ps) {
  const int lp = dp == 16 ? 1 : 2;
  const int pieces = max(0, min(rows, n - r0)) << lp;
  for (int x = threadIdx.x; x < pieces; x += blockDim.x) {
    const int r = x >> lp, c = (x & ((1 << lp) - 1)) * 8;
    cp_async16(dst + r * ps + c, src + (long long)(r0 + r) * dp + c);
  }
}

// Rows [i0, i0 + rows) by keys [k0, k0 + cols) of an (n, n8) bias panel into a
// tile [rows][stride]; cols a multiple of 8.
__device__ __forceinline__ void stage_bias(bf16* dst, int stride, const bf16* src, int i0,
                                           int rows, int k0, int cols, int n) {
  const int n8 = round8(n);
  const int vr = max(0, min(rows, n - i0));
  const int per = max(0, min(cols, n8 - k0)) >> 3;
  for (int x = threadIdx.x; x < vr * per; x += blockDim.x) {
    const int r = x / per, c = (x - r * per) * 8;
    cp_async16(dst + r * stride + c, src + (long long)(i0 + r) * n8 + k0 + c);
  }
}

__device__ __forceinline__ void zero_shared(uint4* smem, size_t bytes) {
  for (size_t x = threadIdx.x; x < bytes / 16; x += blockDim.x) smem[x] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// s := s + bias for keys < n, -inf past n; returns the row-halves' maxima
// over the quad. bt is the block's (i, k) bias tile, rows m0.. local.
__device__ __forceinline__ void add_bias(float (&sf)[kNT][4], const bf16* bt, int k0, int n,
                                         int m0, int gid, int tig, float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + gid + 8 * hf, col = 8 * t + 2 * tig;
      const float2 bv = __bfloat1622float2(*reinterpret_cast<const bf162*>(bt + row * kBS + col));
      const float x0 = k0 + col < n ? sf[t][2 * hf] + bv.x : -INFINITY;
      const float x1 = k0 + col + 1 < n ? sf[t][2 * hf + 1] + bv.y : -INFINITY;
      sf[t][2 * hf] = x0;
      sf[t][2 * hf + 1] = x1;
      mx[hf] = fmaxf(mx[hf], fmaxf(x0, x1));
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// acc (16 rows x dp, fragments) += A (16 x 16, packed) B, B rows 16 kt..16 kt
// + 15 of the staged panel bs [rows][ps] (ldmatrix.trans).
__device__ __forceinline__ void product_tile(float (&acc)[4][4], const uint32_t (&af)[4],
                                             const bf16* bs, int ps, int dp, int kt, int lane) {
#pragma unroll
  for (int et = 0; et < 2; ++et) {
    if (et * 16 < dp) {
      uint32_t vb[4];
      ldsm_x4_t(vb, bs + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ps + et * 16 +
                        (lane >> 4) * 8);
      mma(acc[2 * et], af, vb[0], vb[1]);
      mma(acc[2 * et + 1], af, vb[2], vb[3]);
    }
  }
}

// Rows row0.. of the fragments acc (times the per-row-half factor r) into a
// head-major panel at dst (row stride dp), rows below n.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[4][4],
                                           const float (&r)[2], int row0, int n, int dp,
                                           int gid, int tig) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t * 8 < dp) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + gid + 8 * hf;
        if (row < n) {
          *reinterpret_cast<uint32_t*>(dst + (long long)row * dp + 8 * t + 2 * tig) =
              pack(acc[t][2 * hf] * r[hf], acc[t][2 * hf + 1] * r[hf]);
        }
      }
    }
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;  // (bh, n, n, dp); dout unread in the forward
  const bf16* bias;              // (bh, n, n8)
  bf16 *out, *dq, *dk, *dv;      // (bh, n, n, dp)
  float4* stats;                 // (bh, n, n): max, 1 / sum, D
  float* partial;                // (chunks, bh, n, n)
  int bh, n, dp, jc, chunks;
};

// -- forward -------------------------------------------------------------------

template <int W>
__host__ __device__ constexpr size_t fwd_shared_bytes(int dp) {
  return (size_t)(16 * W + 4 * kBlockKeys) * panel_stride(dp) * sizeof(bf16) +
         (size_t)2 * 16 * W * kBS * sizeof(bf16);
}

template <int W>
__global__ void __launch_bounds__(W * 32) tiled_fwd_kernel(const Args a) {
  const int i0 = blockIdx.x * 16 * W, j = blockIdx.y, bh = blockIdx.z;
  const int n = a.n, dp = a.dp, ps = panel_stride(dp), nkb = blocks_of(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * warp;

  extern __shared__ uint4 smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [16 W][ps]
  bf16* kv = qs + 16 * W * ps;                // [2 stages][K, V][64][ps]
  bf16* bs = kv + 4 * kBlockKeys * ps;        // [2 stages][16 W][kBS]
  zero_shared(smem, fwd_shared_bytes<W>(dp));
  __syncthreads();

  const long long panel = (long long)n * dp, row = ((long long)bh * n + j) * panel;
  const bf16* bias = a.bias + (long long)bh * n * round8(n);
  auto fetch = [&](int kb, int st) {
    bf16* kd = kv + 2 * st * kBlockKeys * ps;
    stage_rows(kd, a.k + row, kb * kBlockKeys, kBlockKeys, n, dp, ps);
    stage_rows(kd + kBlockKeys * ps, a.v + row, kb * kBlockKeys, kBlockKeys, n, dp, ps);
    stage_bias(bs + st * 16 * W * kBS, kBS, bias, i0, 16 * W, kb * kBlockKeys, kBlockKeys, n);
    cp_commit();
  };
  stage_rows(qs, a.q + row, i0, 16 * W, n, dp, ps);
  fetch(0, 0);                       // the Q tile goes with the first block

  float o[4][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 4; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    __syncthreads();                 // every reader of the other stage is done
    if (kb + 1 < nkb) {
      fetch(kb + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv + 2 * st * kBlockKeys * ps;
    float sf[kNT][4], mx[2];
    qk_fragments<kKT>(sf, qs, ks, ps, dp, m0, lane);
    add_bias(sf, bs + st * 16 * W * kBS, kb * kBlockKeys, n, m0, gid, tig, mx);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mn = fmaxf(m[hf], mx[hf]);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float alpha = __expf(m[hf] - ms);
      m[hf] = ms;
      l[hf] *= alpha;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        o[t][2 * hf] *= alpha;
        o[t][2 * hf + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
      uint32_t af[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = 2 * kt + u;
          const float e0 = __expf(sf[t][2 * hf] - m[hf]), e1 = __expf(sf[t][2 * hf + 1] - m[hf]);
          l[hf] += e0 + e1;
          af[2 * u + hf] = pack(e0, e1);
        }
      }
      product_tile(o, af, ks + kBlockKeys * ps, ps, dp, kt, lane);
    }
  }
  float r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) r[hf] = 1.f / fmaxf(quad_sum(l[hf]), 1e-30f);
  store_rows(a.out + row, o, r, i0 + m0, n, dp, gid, tig);
}

// -- backward: dQ, the row statistics and dbias' partial sums ---------------------

template <int W>
__host__ __device__ constexpr size_t bwd_q_shared_bytes(int dp, int n) {
  return (size_t)(2 * 16 * W + 4 * kBlockKeys) * panel_stride(dp) * sizeof(bf16) +
         (size_t)2 * 16 * W * kBS * sizeof(bf16) +
         (size_t)16 * W * (blocks_of(n) * kBlockKeys + 8) * sizeof(float);
}

template <int W>
__global__ void __launch_bounds__(W * 32) tiled_bwd_q_kernel(const Args a) {
  const int i0 = blockIdx.x * 16 * W, chunk = blockIdx.y, bh = blockIdx.z;
  const int n = a.n, dp = a.dp, ps = panel_stride(dp), nkb = blocks_of(n);
  const int as = nkb * kBlockKeys + 8;       // row stride of the dbias tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * warp;
  const int j0 = chunk * a.jc, j1 = min(n, j0 + a.jc);

  extern __shared__ uint4 smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [16 W][ps]
  bf16* dos = qs + 16 * W * ps;               // [16 W][ps]
  bf16* kv = dos + 16 * W * ps;               // [2 stages][K, V][64][ps]
  bf16* bs = kv + 4 * kBlockKeys * ps;        // [2 stages][16 W][kBS]
  float* acc = reinterpret_cast<float*>(bs + 2 * 16 * W * kBS);  // [16 W][as]
  zero_shared(smem, bwd_q_shared_bytes<W>(dp, n));
  __syncthreads();

  const long long panel = (long long)n * dp;
  const bf16* bias = a.bias + (long long)bh * n * round8(n);
  for (int j = j0; j < j1; ++j) {
    const long long row = ((long long)bh * n + j) * panel;
    // step s < nkb: the statistics pass over key block s; then the gradient
    // pass over key block s - nkb
    auto fetch = [&](int s, int st) {
      const int kb = s < nkb ? s : s - nkb;
      bf16* kd = kv + 2 * st * kBlockKeys * ps;
      stage_rows(kd, a.k + row, kb * kBlockKeys, kBlockKeys, n, dp, ps);
      stage_rows(kd + kBlockKeys * ps, a.v + row, kb * kBlockKeys, kBlockKeys, n, dp, ps);
      stage_bias(bs + st * 16 * W * kBS, kBS, bias, i0, 16 * W, kb * kBlockKeys, kBlockKeys, n);
      cp_commit();
    };
    __syncthreads();                 // the last j's readers are done
    stage_rows(qs, a.q + row, i0, 16 * W, n, dp, ps);
    stage_rows(dos, a.dout + row, i0, 16 * W, n, dp, ps);
    fetch(0, 0);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f}, rl[2], dsum[2];
    float dq[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;
    for (int s = 0; s < 2 * nkb; ++s) {
      const int st = s & 1, kb = s < nkb ? s : s - nkb;
      __syncthreads();
      if (s + 1 < 2 * nkb) {
        fetch(s + 1, st ^ 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const bf16* ks = kv + 2 * st * kBlockKeys * ps;
      float sf[kNT][4], df[kNT][4], mx[2];
      qk_fragments2<kKT>(sf, df, qs, ks, dos, ks + kBlockKeys * ps, ps, dp, m0, lane);
      add_bias(sf, bs + st * 16 * W * kBS, kb * kBlockKeys, n, m0, gid, tig, mx);
      if (s < nkb) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float mn = fmaxf(m[hf], mx[hf]);
          const float ms = mn == -INFINITY ? 0.f : mn;
          const float alpha = __expf(m[hf] - ms);
          m[hf] = ms;
          l[hf] *= alpha;
          dd[hf] *= alpha;
        }
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float e = __expf(sf[t][q] - m[q >> 1]);
            l[q >> 1] += e;
            dd[q >> 1] += e * df[t][q];
          }
        }
        if (s == nkb - 1) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            rl[hf] = 1.f / fmaxf(quad_sum(l[hf]), 1e-30f);
            dsum[hf] = quad_sum(dd[hf]) * rl[hf];
          }
        }
        continue;
      }
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        uint32_t af[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = 2 * kt + u, r = m0 + gid + 8 * hf, col = kb * kBlockKeys + 8 * t + 2 * tig;
            const float p0 = __expf(sf[t][2 * hf] - m[hf]) * rl[hf];
            const float p1 = __expf(sf[t][2 * hf + 1] - m[hf]) * rl[hf];
            const float ds0 = p0 * (df[t][2 * hf] - dsum[hf]);
            const float ds1 = p1 * (df[t][2 * hf + 1] - dsum[hf]);
            float2* cell = reinterpret_cast<float2*>(acc + r * as + col);
            float2 c = *cell;
            c.x += ds0;
            c.y += ds1;
            *cell = c;
            af[2 * u + hf] = pack(ds0, ds1);
          }
        }
        product_tile(dq, af, ks, ps, dp, kt, lane);
      }
    }
    const float one[2] = {1.f, 1.f};
    store_rows(a.dq + row, dq, one, i0 + m0, n, dp, gid, tig);
    if (tig == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + m0 + gid + 8 * hf;
        if (i < n) a.stats[((long long)bh * n + j) * n + i] = make_float4(m[hf], rl[hf], dsum[hf], 0.f);
      }
    }
  }
  __syncthreads();
  float* dst = a.partial + ((long long)chunk * a.bh + bh) * n * n;
  const int rows = max(0, min(16 * W, n - i0));
  for (int x = threadIdx.x; x < rows * n; x += blockDim.x) {
    const int r = x / n, kk = x - r * n;
    dst[(long long)(i0 + r) * n + kk] = acc[r * as + kk];
  }
}

// -- backward: dK and dV -----------------------------------------------------------

template <int W>
__host__ __device__ constexpr size_t bwd_kv_shared_bytes(int dp) {
  return (size_t)(2 * 16 * W + 4 * kBlockKeys) * panel_stride(dp) * sizeof(bf16) +
         (size_t)2 * kBlockKeys * (16 * W + 8) * sizeof(bf16) +
         (size_t)2 * kBlockKeys * sizeof(float4);
}

template <int W>
__global__ void __launch_bounds__(W * 32) tiled_bwd_kv_kernel(const Args a) {
  constexpr int KS = 16 * W + 8;             // row stride of the (i, k) bias tile
  const int k0 = blockIdx.x * 16 * W, j = blockIdx.y, bh = blockIdx.z;
  const int n = a.n, dp = a.dp, ps = panel_stride(dp), nit = blocks_of(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * warp;

  extern __shared__ uint4 smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [16 W][ps]
  bf16* vs = ks + 16 * W * ps;                // [16 W][ps]
  bf16* qd = vs + 16 * W * ps;                // [2 stages][Q, dO][64][ps]
  bf16* bs = qd + 4 * kBlockKeys * ps;        // [2 stages][64 rows i][KS]
  float4* sts = reinterpret_cast<float4*>(bs + 2 * kBlockKeys * KS);  // [2 stages][64]
  zero_shared(smem, bwd_kv_shared_bytes<W>(dp));
  __syncthreads();

  const long long panel = (long long)n * dp, row = ((long long)bh * n + j) * panel;
  const bf16* bias = a.bias + (long long)bh * n * round8(n);
  const float4* stats = a.stats + ((long long)bh * n + j) * n;
  auto fetch = [&](int it, int st) {
    bf16* qdst = qd + 2 * st * kBlockKeys * ps;
    stage_rows(qdst, a.q + row, it * kBlockKeys, kBlockKeys, n, dp, ps);
    stage_rows(qdst + kBlockKeys * ps, a.dout + row, it * kBlockKeys, kBlockKeys, n, dp, ps);
    stage_bias(bs + st * kBlockKeys * KS, KS, bias, it * kBlockKeys, kBlockKeys, k0, 16 * W, n);
    const int vr = max(0, min(kBlockKeys, n - it * kBlockKeys));
    for (int x = threadIdx.x; x < vr; x += blockDim.x) {
      cp_async16(sts + st * kBlockKeys + x, stats + it * kBlockKeys + x);
    }
    cp_commit();
  };
  stage_rows(ks, a.k + row, k0, 16 * W, n, dp, ps);
  stage_rows(vs, a.v + row, k0, 16 * W, n, dp, ps);
  fetch(0, 0);                       // K and V go with the first tile

  float dk[4][4], dv[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dk[t][q] = dv[t][q] = 0.f;
  }
  for (int it = 0; it < nit; ++it) {
    const int st = it & 1;
    __syncthreads();
    if (it + 1 < nit) {
      fetch(it + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* qs = qd + 2 * st * kBlockKeys * ps;
    const bf16* dos = qs + kBlockKeys * ps;
    const bf16* bt = bs + st * kBlockKeys * KS;
    const float4* sv = sts + st * kBlockKeys;
    // rows: the warp's 16 keys; columns: the tile's 64 rows i
    float sf[kNT][4], df[kNT][4];
    qk_fragments2<kKT>(sf, df, ks, qs, vs, dos, ps, dp, m0, lane);
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
      uint32_t pa[4], da[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = 2 * kt + u, key = m0 + gid + 8 * hf, c = 8 * t + 2 * tig;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 x = sv[c + e];
            const float b = __bfloat162float(bt[(c + e) * KS + key]);
            const bool valid = it * kBlockKeys + c + e < n;
            p[e] = valid ? __expf(sf[t][2 * hf + e] + b - x.x) * x.y : 0.f;
            ds[e] = p[e] * (df[t][2 * hf + e] - x.z);
          }
          pa[2 * u + hf] = pack(p[0], p[1]);
          da[2 * u + hf] = pack(ds[0], ds[1]);
        }
      }
      product_tile(dv, pa, dos, ps, dp, kt, lane);
      product_tile(dk, da, qs, ps, dp, kt, lane);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows(a.dk + row, dk, one, k0 + m0, n, dp, gid, tig);
  store_rows(a.dv + row, dv, one, k0 + m0, n, dp, gid, tig);
}

// dbias[b, i, k, h] = sum over the chunks, in order, of partial[c, bh, i, k].
__global__ void tiled_reduce_kernel(const float* partial, bf16* dbias, long long s0,
                                    long long s1, long long s2, long long s3, int batch, int h,
                                    int n, int chunks) {
  const long long nn = (long long)n * n, total = (long long)batch * h * nn;
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= total) return;
  const long long bh = x / nn, ik = x - bh * nn;
  const int b = (int)(bh / h), hh = (int)(bh - (long long)b * h);
  const int i = (int)(ik / n), kk = (int)(ik - (long long)i * n);
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += partial[(long long)c * total + x];
  dbias[b * s0 + hh * s1 + i * s2 + kk * s3] = __float2bfloat16(sum);
}

// -- launches ------------------------------------------------------------------------

constexpr int kFwdWarps = 4;
constexpr int kKvWarps = 4;

// warps per block of the dQ kernel: its dbias tile (16 W rows by n keys, f32)
// fits shared memory at W = 4 up to n = 384, at W = 2 up to kMaxNodes
inline int q_warps(int n) { return n <= 384 ? 4 : 2; }

inline bool valid(const Args& a) {
  return a.n > 0 && a.n <= kMaxNodes && (a.dp == 16 || a.dp == 32) && a.bh >= 1 &&
         a.bh <= 65535 && a.jc >= 1 && a.chunks >= 1 && (long long)(a.chunks - 1) * a.jc < a.n &&
         (long long)a.chunks * a.jc >= a.n;
}

inline int launch_fwd(const Args& a, cudaStream_t stream) {
  constexpr int W = kFwdWarps;
  const size_t smem = fwd_shared_bytes<W>(a.dp);
  const cudaError_t e = allow_smem(tiled_fwd_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + 16 * W - 1) / (16 * W), a.n, a.bh);
  tiled_fwd_kernel<W><<<grid, W * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int launch_bwd_q(const Args& a, cudaStream_t stream) {
  const size_t smem = bwd_q_shared_bytes<W>(a.dp, a.n);
  const cudaError_t e = allow_smem(tiled_bwd_q_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + 16 * W - 1) / (16 * W), a.chunks, a.bh);
  tiled_bwd_q_kernel<W><<<grid, W * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int launch_bwd(const Args& a, bf16* dbias, const long long* so, int batch, int h,
                      cudaStream_t stream) {
  int rc = q_warps(a.n) == 4 ? launch_bwd_q<4>(a, stream) : launch_bwd_q<2>(a, stream);
  if (rc != 0) return rc;
  constexpr int W = kKvWarps;
  const size_t smem = bwd_kv_shared_bytes<W>(a.dp);
  const cudaError_t e = allow_smem(tiled_bwd_kv_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + 16 * W - 1) / (16 * W), a.n, a.bh);
  tiled_bwd_kv_kernel<W><<<grid, W * 32, smem, stream>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long total = (long long)a.bh * a.n * a.n;
  tiled_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      a.partial, dbias, so[0], so[1], so[2], so[3], batch, h, a.n, a.chunks);
  return (int)cudaGetLastError();
}

}  // namespace ttil
