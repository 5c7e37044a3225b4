// The panel loop shared by the aggregate kernels (triplet_aggregate_fwd.cu
// for va, triplet_aggregate_bwd.cu for dV): one block per (b, j) computes
//
//   out[b, j, r, c] = sum_x Aop[r, x, h(c)] P[b, j, x, c]
//
// over the panel P[b, j] (n x d*h, columns c = d*h + hh, contiguous), with
// Aop[r, x] = A[b, r, x] (the forward: P = V) or A[b, x, r] (dV: P = dva).
// A is (b, i, k, h), contiguous. out is (b, j, r, d, h), contiguous.
//
// Two versions, chosen per call by launch_panel:
//  - agg_panel_mma_kernel (bf16, h a multiple of 8, d <= 32, 16-byte
//    aligned operands): for each head the block multiplies the n x n
//    weights by the n x d panel slice on the tensor cores (mma.sync
//    m16n8k16, bf16 in, f32 sums; sizes padded to 16 and 8 with zeros).
//    It stages the panel once, transposed to (h, d, x), and the weights of
//    8 heads at a time, transposed to (head, r, x), with 16-byte loads (8
//    heads of one (r, x) are 16 contiguous bytes); row strides padded by 8
//    elements put the 32-bit fragment loads of a warp in distinct banks. The
//    output rows are staged in shared memory and written with 16-byte
//    stores.
//  - agg_panel_kernel (any other case, f32 included, since the tensor cores'
//    f32 mode, TF32, keeps too few bits): CUDA-core FMAs. The block stages
//    the panel once; the rows r go in tiles of 8, staged as f32 laid out
//    (x, h, row) with the 8 rows of one (x, h) padded to 48 bytes, so that a
//    thread reads them as two 16-byte loads and a load phase hits distinct
//    banks. Each thread owns one column c and keeps 8 sums in registers.
// Both sum in a fixed order: two launches on the same inputs give bitwise
// equal outputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agg {

constexpr int kThreads = 256;
constexpr int kRows = 8;       // output rows per tile, summed in registers
constexpr int kBatch = 8;      // global loads a thread keeps in flight
constexpr int kRowStride = 12; // floats per (x, h) entry of a tile: 8 + 4 pad
constexpr int kMaxN = 128;
constexpr size_t kMaxShared = 232448;
static_assert(kRows == 8 && kRowStride % 4 == 0 && kRowStride >= kRows,
              "the loops read a tile entry as two float4");

constexpr int kMmaWarps = 8;
constexpr int kHeadGroup = 8;  // heads whose weights are staged at once
constexpr int kMaxDTiles = 4;  // n-tiles of 8 along d: d <= 32

struct Strides3 {
  long long b, x, y;  // element strides of the three outer axes
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The 8 rows of one tile entry, as two 16-byte shared-memory stores.
__device__ __forceinline__ void put8(float4* dst, const float* v) {
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void fma8(float* acc, float4 lo, float4 hi, float v) {
  acc[0] = fmaf(lo.x, v, acc[0]);
  acc[1] = fmaf(lo.y, v, acc[1]);
  acc[2] = fmaf(lo.z, v, acc[2]);
  acc[3] = fmaf(lo.w, v, acc[3]);
  acc[4] = fmaf(hi.x, v, acc[4]);
  acc[5] = fmaf(hi.y, v, acc[5]);
  acc[6] = fmaf(hi.z, v, acc[6]);
  acc[7] = fmaf(hi.w, v, acc[7]);
}

inline int set_shared(const void* kernel, size_t smem) {
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// -- CUDA-core version ---------------------------------------------------------

template <typename T, bool kTransA>
__global__ void __launch_bounds__(kThreads)
agg_panel_kernel(const T* __restrict__ a, const T* __restrict__ p,
                 T* __restrict__ out, int n, int dh, int h, Strides3 sp) {
  const int j = blockIdx.x, b = blockIdx.y;
  const int nh = n * h;
  extern __shared__ float4 smem4[];
  // the weight tile [n*h][kRowStride] f32, then the panel [n][dh]
  T* ps = reinterpret_cast<T*>(smem4 + nh * (kRowStride / 4));

  const T* pb = p + b * sp.b + j * sp.x;
  for (int c = threadIdx.x; c < dh; c += blockDim.x) {
    for (int x0 = 0; x0 < n; x0 += kBatch) {  // kBatch loads in flight
      T buf[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (x0 + u < n) buf[u] = pb[(x0 + u) * sp.y + c];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (x0 + u < n) ps[(x0 + u) * dh + c] = buf[u];
      }
    }
  }
  const T* ab = a + (long long)b * n * nh;
  T* ob = out + ((long long)b * n + j) * n * dh;

  for (int r0 = 0; r0 < n; r0 += kRows) {
    __syncthreads();  // the panel is staged; the previous tile is consumed
    for (int xh = threadIdx.x; xh < nh; xh += blockDim.x) {
      const T* src;
      long long stride;
      if (kTransA) {                    // Aop[r, x] = A[b, x, r0 + r]
        const int x = xh / h;
        src = ab + ((long long)x * n + r0) * h + (xh - x * h);
        stride = h;
      } else {                          // Aop[r, x] = A[b, r0 + r, x]
        src = ab + (long long)r0 * nh + xh;
        stride = nh;
      }
      float val[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        val[r] = r0 + r < n ? to_f32(src[r * stride]) : 0.f;
      }
      put8(smem4 + xh * (kRowStride / 4), val);
    }
    __syncthreads();

    for (int c = threadIdx.x; c < dh; c += blockDim.x) {
      const float4* ac = smem4 + (c % h) * (kRowStride / 4);
      const int step = h * (kRowStride / 4);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int x = 0; x < n; ++x) {
        fma8(acc, ac[x * step], ac[x * step + 1], to_f32(ps[x * dh + c]));
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r < n) store(ob + (long long)(r0 + r) * dh + c, acc[r]);
      }
    }
  }
}

// -- tensor-core version (bf16) -------------------------------------------------

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += A (16 x 16, row) B (16 x 8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct MmaShape {
  int kp;   // n rounded up to 16: the rows r and the summed axis x
  int dp;   // d rounded up to 8
  int ks;   // row stride of the staged tiles, kp + 8 elements
  int os;   // row stride of the staged output, d*h + 8 elements
};

__host__ __device__ inline MmaShape mma_shape(int n, int d, int h) {
  MmaShape s;
  s.kp = (n + 15) / 16 * 16;
  s.dp = (d + 7) / 8 * 8;
  s.ks = s.kp + 8;
  s.os = d * h + 8;
  return s;
}

// bf16 elements of the staged panel and weights (zeroed before staging)
__host__ __device__ inline size_t mma_tile_elems(int n, int d, int h) {
  const MmaShape s = mma_shape(n, d, h);
  return (size_t)h * s.dp * s.ks + (size_t)kHeadGroup * s.kp * s.ks;
}

inline size_t mma_shared_bytes(int n, int d, int h) {
  return 2 * (mma_tile_elems(n, d, h) + (size_t)n * mma_shape(n, d, h).os);
}

template <bool kTransA>
__global__ void __launch_bounds__(kMmaWarps * 32)
agg_panel_mma_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ p,
                     __nv_bfloat16* __restrict__ out, int n, int d, int h,
                     Strides3 sp) {
  using bf16 = __nv_bfloat16;
  const int j = blockIdx.x, b = blockIdx.y;
  const int dh = d * h, chunks = dh / 8;   // 16-byte chunks of a row
  const MmaShape s = mma_shape(n, d, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  extern __shared__ uint4 smem16[];
  bf16* pt = reinterpret_cast<bf16*>(smem16);         // [h][dp][ks]: P[x, dd*h + hh] at [hh][dd][x]
  bf16* at = pt + (size_t)h * s.dp * s.ks;            // [kHeadGroup][kp][ks]: Aop[r, x] of head g at [g][r][x]
  bf16* os = at + (size_t)kHeadGroup * s.kp * s.ks;   // [n][os]: the output rows

  const int zero_chunks = (int)(mma_tile_elems(n, d, h) / 8);
  for (int idx = threadIdx.x; idx < zero_chunks; idx += blockDim.x) {
    smem16[idx] = make_uint4(0, 0, 0, 0);   // the padding stays zero
  }
  __syncthreads();

  const bf16* pb = p + b * sp.b + j * sp.x;
  const int total = n * chunks;
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    uint4 raw[4];                           // 4 loads in flight
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int x = idx / chunks, c0 = (idx - x * chunks) * 8;
        raw[u] = *reinterpret_cast<const uint4*>(pb + x * sp.y + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int x = idx / chunks, c0 = (idx - x * chunks) * 8;
        const int dd = c0 / h, hh = c0 - dd * h;
        const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
        for (int e = 0; e < 8; ++e) pt[((size_t)(hh + e) * s.dp + dd) * s.ks + x] = v[e];
      }
    }
  }

  const int m_tiles = s.kp / 16, n_tiles = s.dp / 8;
  const int pairs = n * n;
  for (int h0 = 0; h0 < h; h0 += kHeadGroup) {
    __syncthreads();  // the panel is staged; the previous group is consumed
    const bf16* ab = a + (long long)b * n * n * h + h0;
    for (int base = threadIdx.x; base < pairs; base += 4 * blockDim.x) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < pairs) {
          const int r = idx / n, x = idx - r * n;
          const long long src = kTransA ? (long long)x * n + r : (long long)r * n + x;
          raw[u] = *reinterpret_cast<const uint4*>(ab + src * h);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < pairs) {
          const int r = idx / n, x = idx - r * n;
          const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
          for (int e = 0; e < 8; ++e) at[((size_t)e * s.kp + r) * s.ks + x] = v[e];
        }
      }
    }
    __syncthreads();

    for (int unit = warp; unit < kHeadGroup * m_tiles; unit += kMmaWarps) {
      const int g = unit / m_tiles, m0 = (unit - g * m_tiles) * 16;
      const bf16* ag = at + ((size_t)g * s.kp + m0 + gid) * s.ks + tig * 2;
      const bf16* pg = pt + ((size_t)(h0 + g) * s.dp + gid) * s.ks + tig * 2;
      float acc[kMaxDTiles][4];
#pragma unroll
      for (int t = 0; t < kMaxDTiles; ++t) {
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      }
      for (int k0 = 0; k0 < s.kp; k0 += 16) {
        const uint32_t a0 = lds32(ag + k0), a1 = lds32(ag + 8 * s.ks + k0);
        const uint32_t a2 = lds32(ag + k0 + 8), a3 = lds32(ag + 8 * s.ks + k0 + 8);
#pragma unroll
        for (int t = 0; t < kMaxDTiles; ++t) {
          if (t < n_tiles) {
            const bf16* br = pg + (size_t)t * 8 * s.ks + k0;
            mma16816(acc[t], a0, a1, a2, a3, lds32(br), lds32(br + 8));
          }
        }
      }
      // c0, c1: row gid, columns tig*2 + {0, 1}; c2, c3: row gid + 8
#pragma unroll
      for (int t = 0; t < kMaxDTiles; ++t) {
        if (t < n_tiles) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = m0 + gid + (q >> 1) * 8, dd = t * 8 + tig * 2 + (q & 1);
            if (row < n && dd < d) {
              os[(size_t)row * s.os + dd * h + h0 + g] = __float2bfloat16(acc[t][q]);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  bf16* ob = out + ((long long)b * n + j) * n * dh;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx / chunks, c0 = (idx - i * chunks) * 8;
    *reinterpret_cast<uint4*>(ob + (long long)i * dh + c0) =
        *reinterpret_cast<const uint4*>(os + (size_t)i * s.os + c0);
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename T>
inline bool mma_path(const T* a, const T* p, const T* out, int n, int d,
                     int h, Strides3 sp) {
  return false;
}

template <>
inline bool mma_path<__nv_bfloat16>(const __nv_bfloat16* a,
                                    const __nv_bfloat16* p,
                                    const __nv_bfloat16* out, int n, int d,
                                    int h, Strides3 sp) {
  return h % kHeadGroup == 0 && (d + 7) / 8 <= kMaxDTiles && aligned16(a) &&
         aligned16(p) && aligned16(out) && sp.b % 8 == 0 && sp.x % 8 == 0 &&
         sp.y % 8 == 0 && mma_shared_bytes(n, d, h) <= kMaxShared;
}

// Launches the panel loop on (n, batch) blocks; returns a CUDA error code.
template <typename T, bool kTransA>
int launch_panel(const T* a, const T* p, T* out, int batch, int n, int d,
                 int h, Strides3 sp, cudaStream_t stream) {
  if (mma_path<T>(a, p, out, n, d, h, sp)) {
    const __nv_bfloat16* a16 = reinterpret_cast<const __nv_bfloat16*>(a);
    const __nv_bfloat16* p16 = reinterpret_cast<const __nv_bfloat16*>(p);
    __nv_bfloat16* out16 = reinterpret_cast<__nv_bfloat16*>(out);
    const size_t smem = mma_shared_bytes(n, d, h);
    auto kernel = agg_panel_mma_kernel<kTransA>;
    const int err = set_shared((const void*)kernel, smem);
    if (err != 0) return err;
    kernel<<<dim3(n, batch), kMmaWarps * 32, smem, stream>>>(a16, p16, out16,
                                                             n, d, h, sp);
    return (int)cudaGetLastError();
  }
  const int dh = d * h;
  const size_t smem = sizeof(float) * kRowStride * n * h + sizeof(T) * n * dh;
  auto kernel = agg_panel_kernel<T, kTransA>;
  const int err = set_shared((const void*)kernel, smem);
  if (err != 0) return err;
  const int threads = dh < kThreads ? (dh + 31) / 32 * 32 : kThreads;
  kernel<<<dim3(n, batch), threads, smem, stream>>>(a, p, out, n, dh, h, sp);
  return (int)cudaGetLastError();
}

}  // namespace agg
