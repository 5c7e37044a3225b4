// The shared body of the two triplet-attention backward kernels in bf16 for
// Hopper (sm_90a): triplet_attention_bwd.cu (the legacy pair, whose inputs
// are head-major already) and triplet_dense_bwd.cu (the dense pair, whose
// wrapper copies its inputs to head-major first). Both TPU kernels
// (tgt_tpu/ops/pallas/triplet_attention.py:_bwd_kernel and
// triplet_dense.py:_bwd_kernel) compute the same math on one (b, h) panel
// set; this header computes it once, for both.
//
// Inputs, all bf16: q, k, v, dout (b, h, nj, n, dp) contiguous, with the head
// width dp 16 or 32 (the wrappers pad a narrower head with zero columns);
// bias and gate (b, h, i, k) at any element strides. For each (b, h) and each
// row j, with Q = q[b,h,j] (rows i), K = k[b,h,j], V = v[b,h,j] (rows k),
// dO = dout[b,h,j] (rows i):
//
//   s    = scale Q K^T + bias            pn = softmax_k(s), max per row,
//   g    = sigmoid(gate) (1 ungated)          denominator >= 1e-30
//   m    = keep((j n + i)(n H) + k H + h, seed[b])  (1 at rate 0)
//   dA   = m (dO V^T),   dp = dA g,   ds = pn (dp - sum_k dp pn)
//   a    = pn g m
//   dQ   = scale ds' K,  dK = scale ds'^T Q,  dV = a'^T dO
//   dbias[i,k] = sum_j ds,  dgate[i,k] = g (1 - g) sum_j dA pn
//
// where ds' is ds rounded to bf16, as both TPU kernels round ds before dQ and
// dK (triplet_dense.py:316-318 through _dot/_dot_t, triplet_attention.py:92).
// a' is a rounded to bf16 in the dense instantiation, as the dense TPU kernel
// rounds it before dV (:321). The legacy TPU kernel takes dV from f32 weights
// (triplet_attention.py:81-83): its instantiation (kSplitDv) splits a into
// hi = bf16(a) and lo = bf16(a - hi) and adds both products, two mma.sync per
// tile, so a' = hi + lo holds a to about 2^-16 of its value. S and its softmax
// are the forward body's (triplet_mma.cuh), so the weights recomputed here are
// the forward's. Rows i and keys k past n are zero padding; the denominator
// clamp is the identity for the legacy pair, whose row max makes the sum at
// least 1.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3): at b=16, N=48, edge width 256,
// H=16, d=16, the dense call moves about 138 MB (41 us at 3.35 TB/s), the
// legacy call with its 2 x 16 stacked heads about 273 MB (82 us); the five
// products, 10 d flops per (b, h, j, i, k), take 5-9 us at the bf16
// tensor-core peak. Both are bound by device memory.
//
// Design:
//  - One block per (b, h, chunk of rows j) walks its j in order, as both TPU
//    kernels walk j inside one grid cell: one launch and one recompute per
//    call. Chunks give the card enough blocks when b h is small; each chunk
//    writes its f32 dbias and dgate sums (b, chunks, h, n, n: N^2, not N^3),
//    and reduce_kernel adds them in chunk order, applies g (1 - g) and writes
//    dbias and dgate in the caller's layout. No float atomics: two launches
//    on the same inputs give bitwise equal outputs.
//  - The block has one warp per 16-row tile of n (padded to 16 KT). Per j,
//    warp w takes rows i 16w..16w+15: S = Q K^T and dO V^T on the tensor
//    cores (mma.sync m16n8k16, bf16 in, f32 sums, fragments by ldmatrix), the
//    softmax in the accumulator fragments (row max and sum across the quad by
//    shuffles), ds and a; ds stays in registers as the A operand of dQ, and
//    ds and a go to shared memory as bf16. Then warp w takes keys 16w..16w+15
//    for dK = ds^T Q and dV = a^T dO (ldmatrix.trans; with kSplitDv also the
//    low parts of a, from a fifth tile in shared memory). dbias and dgate sums
//    stay in registers for n <= 64 (KT <= 4); above, the block adds them into
//    its own slice of the f32 partial sums, read and written by the thread
//    that owns each element.
//  - Staging: cp.async (16 bytes) double-buffers the next j's four panels
//    (Q, K, V, dO: 4 n dp bf16, 6 KB at N=48, d=16) while the current j
//    computes. Bias and gate of (b, h) are staged once, as bf16. Row strides
//    padded by 8 elements keep ldmatrix and the fragment loads free of bank
//    conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "triplet_common.cuh"
#include "triplet_mma.cuh"

namespace tbwd {

using namespace tmma;

constexpr int kRegTiles = 4;   // up to n = 64 the dbias/dgate sums stay in registers

struct Args {
  const bf16 *q, *k, *v, *dout;   // (b, h, nj, n, dp), contiguous
  const bf16 *bias, *gate;        // (b, h, i, k) at strides sb, sg; gate unread when ungated
  bf16 *dq, *dk, *dv;             // (b, h, nj, n, dp), contiguous
  float* partial;                 // (2, chunks, b, h, n, n): dbias, then dgate sums per chunk
  long long sb[4], sg[4];
  const int* seeds;               // (b) at rate > 0
  uint32_t thresh;
  float keep_scale;
  float scale;
  int batch, h, nj, n, dp, jc, chunks;  // jc rows j per chunk
};

// dbias and dgate: (b, h, i, k) at element strides so, and the gate at sg.
struct Out {
  bf16 *dbias, *dgate;
  long long so[4];
};

// Shared memory of one block: two stages of the four panels, then ds, a,
// bias and gate ([16 KT][16 KT + 8] bf16 each).
// With the split of the weights (kSplitDv) a fifth tile holds their low parts.
__host__ __device__ constexpr size_t shared_bytes(int kt, int dp, bool split) {
  return 2 * ((size_t)8 * 16 * kt * panel_stride(dp) +
              (size_t)(split ? 5 : 4) * 16 * kt * pair_stride(kt));
}

// The second bound promises four resident blocks per SM up to n = 48 (KT 3),
// so that one wave holds the training shapes' blocks (BLOCKS_PER_SM in
// triplet_bwd_panel.py), and one above. Either way ptxas may use every
// register the bound allows: with the first bound alone it capped one
// instantiation at 128 registers and spilled.
template <int KT, bool kGated, bool kDropout, bool kSplitDv>
__global__ void __launch_bounds__(KT * 32, KT <= 3 ? 4 : 1)
panel_bwd_kernel(const Args a) {
  constexpr int NP = 16 * KT, NT = 2 * KT, NS = pair_stride(KT);
  constexpr bool kRegAcc = KT <= kRegTiles;
  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int b = bh / a.h, hh = bh - b * a.h;
  const int n = a.n, dp = a.dp, ps = panel_stride(dp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * warp;         // rows i in phase 1, keys k in phase 2
  const int j0 = chunk * a.jc, j1 = min(a.nj, j0 + a.jc);

  extern __shared__ uint4 smem[];
  bf16* panels = reinterpret_cast<bf16*>(smem);   // [2][4][NP][ps]: q, k, v, dout
  bf16* ds_s = panels + 8 * NP * ps;              // [NP][NS]
  bf16* a_s = ds_s + NP * NS;
  bf16* bias_s = a_s + NP * NS;
  bf16* gate_s = bias_s + NP * NS;
  bf16* alo_s = gate_s + NP * NS;                 // [NP][NS] with kSplitDv

  const int chunks16 = (int)(shared_bytes(KT, dp, kSplitDv) / 16);
  for (int x = threadIdx.x; x < chunks16; x += blockDim.x) smem[x] = make_uint4(0, 0, 0, 0);
  __syncthreads();                  // the padding stays zero from here on

  const long long panel = (long long)n * dp;
  const int per = n * (dp / 8);     // 16-byte pieces of one panel
  auto fetch = [&](int j, int stage) {
    const long long off = ((long long)bh * a.nj + j) * panel;
    for (int x = threadIdx.x; x < 4 * per; x += blockDim.x) {
      const int p = x / per, r = x - p * per;
      const int row = r / (dp / 8), c = (r - row * (dp / 8)) * 8;
      const bf16* src = p == 0 ? a.q : p == 1 ? a.k : p == 2 ? a.v : a.dout;
      cp_async16(panels + ((stage * 4 + p) * NP + row) * ps + c, src + off + row * dp + c);
    }
    cp_commit();
  };
  fetch(j0, 0);

  const bf16* bb = a.bias + b * a.sb[0] + hh * a.sb[1];
  const bf16* gb = a.gate + b * a.sg[0] + hh * a.sg[1];
  for (int x = threadIdx.x; x < n * n; x += blockDim.x) {
    const int i = x / n, kk = x - i * n;
    bias_s[i * NS + kk] = bb[i * a.sb[2] + kk * a.sb[3]];
    if (kGated) gate_s[i * NS + kk] = gb[i * a.sg[2] + kk * a.sg[3]];
  }

  const long long nn = (long long)n * n;
  float* pb = a.partial + (((long long)chunk * a.batch + b) * a.h + hh) * nn;
  float* pg = pb + (long long)a.chunks * a.batch * a.h * nn;
  float acc_b[kRegAcc ? NT : 1][4], acc_g[kRegAcc && kGated ? NT : 1][4];
#pragma unroll
  for (int t = 0; t < (kRegAcc ? NT : 1); ++t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_b[t][q] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < (kRegAcc && kGated ? NT : 1); ++t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_g[t][q] = 0.f;
  }
  const uint32_t seed = kDropout ? (uint32_t)a.seeds[b] : 0u;
  const float scale = a.scale;

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    __syncthreads();                // every reader of the other stage is done
    if (j + 1 < j1) {
      fetch(j + 1, stage ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                // this j's panels are visible to all
    const bf16* qs = panels + (stage * 4 + 0) * NP * ps;
    const bf16* ks = panels + (stage * 4 + 1) * NP * ps;
    const bf16* vs = panels + (stage * 4 + 2) * NP * ps;
    const bf16* os = panels + (stage * 4 + 3) * NP * ps;

    // the keep mask's index (j n + i)(n H) + k H + h from this j's base (so
    // written, ptxas keeps every dropout instantiation free of spills)
    const uint32_t nh = (uint32_t)(n * a.h);
    const uint32_t jbase = (uint32_t)j * (uint32_t)n * nh + (uint32_t)hh;
    // -- phase 1: rows i m0..m0+15 against every key --------------------------
    // S = Q K^T and dA = dO V^T, then the softmax numerators of S
    float sf[NT][4], da[NT][4], recip[2];
    qk_fragments2<KT>(sf, da, qs, ks, os, vs, ps, dp, m0, lane);
    softmax_fragments<NT>(sf, bias_s, NS, n, m0, gid, tig, scale, 1e-30f, recip);

    // pn, the gate, the keep mask and dA: a to shared memory, dA pn into the
    // dgate sums, sf := pn, da := dp = dA g, and the row sums of dp pn
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + gid + 8 * hf, col = 8 * t + 2 * tig;
        float g[2] = {1.f, 1.f};
        if (kGated) {
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const bf162*>(gate_s + row * NS + col));
          g[0] = fast_sigmoid(gv.x);
          g[1] = fast_sigmoid(gv.y);
        }
        float w[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = 2 * hf + u;
          const float pn = sf[t][q] * recip[hf];
          float keep = 1.f;
          if (kDropout) {
            keep = dropout_keep(
                jbase + (uint32_t)row * nh + (uint32_t)(col + u) * (uint32_t)a.h, seed,
                a.thresh, a.keep_scale);
          }
          const float dav = da[t][q] * keep;
          if constexpr (kGated) {
            const float dg = dav * pn;
            if constexpr (kRegAcc) {
              acc_g[t][q] += dg;
            } else if (row < n && col + u < n) {
              float* p = pg + row * n + col + u;
              *p = (j == j0 ? 0.f : *p) + dg;
            }
          }
          sf[t][q] = pn;
          da[t][q] = dav * g[u];
          rs[hf] = fmaf(da[t][q], pn, rs[hf]);
          w[u] = pn * g[u] * keep;
        }
        const uint32_t hi = pack(w[0], w[1]);
        *reinterpret_cast<uint32_t*>(a_s + row * NS + col) = hi;
        if constexpr (kSplitDv) {
          // the low parts, exact in f32: a = hi + lo to about 2^-16 of a
          const float2 hv = __bfloat1622float2(*reinterpret_cast<const bf162*>(&hi));
          *reinterpret_cast<uint32_t*>(alo_s + row * NS + col) = pack(w[0] - hv.x, w[1] - hv.y);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(kFullMask, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(kFullMask, rs[hf], 2);
    }
    // ds: into the dbias sums, to shared memory as bf16; sf := ds
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + gid + 8 * hf, col = 8 * t + 2 * tig;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = 2 * hf + u;
          const float ds = sf[t][q] * (da[t][q] - rs[hf]);
          sf[t][q] = ds;
          if constexpr (kRegAcc) {
            acc_b[t][q] += ds;
          } else if (row < n && col + u < n) {
            float* p = pb + row * n + col + u;
            *p = (j == j0 ? 0.f : *p) + ds;
          }
        }
        *reinterpret_cast<uint32_t*>(ds_s + row * NS + col) = pack(sf[t][2 * hf], sf[t][2 * hf + 1]);
      }
    }

    // dQ = scale ds' K, ds' straight from the accumulator fragments
    float dq[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t af[4] = {pack(sf[2 * kt][0], sf[2 * kt][1]), pack(sf[2 * kt][2], sf[2 * kt][3]),
                              pack(sf[2 * kt + 1][0], sf[2 * kt + 1][1]),
                              pack(sf[2 * kt + 1][2], sf[2 * kt + 1][3])};
#pragma unroll
      for (int et = 0; et < 2; ++et) {
        if (et * 16 < dp) {
          uint32_t kb[4];
          const int br = kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldsm_x4_t(kb, ks + br * ps + et * 16 + (lane >> 4) * 8);
          mma(dq[2 * et], af, kb[0], kb[1]);
          mma(dq[2 * et + 1], af, kb[2], kb[3]);
        }
      }
    }
    const long long off = ((long long)bh * a.nj + j) * panel;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t * 8 < dp) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + gid + 8 * hf;
          if (row < n) {
            *reinterpret_cast<uint32_t*>(a.dq + off + row * dp + 8 * t + 2 * tig) =
                pack(dq[t][2 * hf] * scale, dq[t][2 * hf + 1] * scale);
          }
        }
      }
    }
    __syncthreads();                // ds and a of every row are in shared memory

    // -- phase 2: keys k m0..m0+15 over every row i ----------------------------
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dk[t][q] = dv[t][q] = 0.f;
    }
#pragma unroll
    for (int it = 0; it < KT; ++it) {
      uint32_t dsf[4], af[4], alf[4];
      const int ar = it * 16 + (lane & 7) + (lane >> 4) * 8, ac = m0 + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(dsf, ds_s + ar * NS + ac);
      ldsm_x4_t(af, a_s + ar * NS + ac);
      if constexpr (kSplitDv) ldsm_x4_t(alf, alo_s + ar * NS + ac);
#pragma unroll
      for (int et = 0; et < 2; ++et) {
        if (et * 16 < dp) {
          uint32_t qb[4], ob[4];
          const int br = it * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int bc = et * 16 + (lane >> 4) * 8;
          ldsm_x4_t(qb, qs + br * ps + bc);
          ldsm_x4_t(ob, os + br * ps + bc);
          mma(dk[2 * et], dsf, qb[0], qb[1]);
          mma(dk[2 * et + 1], dsf, qb[2], qb[3]);
          mma(dv[2 * et], af, ob[0], ob[1]);
          mma(dv[2 * et + 1], af, ob[2], ob[3]);
          if constexpr (kSplitDv) {
            mma(dv[2 * et], alf, ob[0], ob[1]);
            mma(dv[2 * et + 1], alf, ob[2], ob[3]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t * 8 < dp) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + gid + 8 * hf;
          if (row < n) {
            const long long o = off + row * dp + 8 * t + 2 * tig;
            *reinterpret_cast<uint32_t*>(a.dk + o) = pack(dk[t][2 * hf] * scale, dk[t][2 * hf + 1] * scale);
            *reinterpret_cast<uint32_t*>(a.dv + o) = pack(dv[t][2 * hf], dv[t][2 * hf + 1]);
          }
        }
      }
    }
  }

  if constexpr (kRegAcc) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + gid + 8 * (q >> 1), col = 8 * t + 2 * tig + (q & 1);
        if (row < n && col < n) {
          pb[row * n + col] = acc_b[t][q];
          if constexpr (kGated) pg[row * n + col] = acc_g[t][q];
        }
      }
    }
  }
}

// dbias = the chunks' sums added in chunk order; dgate = g (1 - g) times the
// same of the dgate sums. One thread per (b, h, i, k).
template <bool kGated>
__global__ void reduce_kernel(const Args a, const Out o) {
  const long long nn = (long long)a.n * a.n;
  const long long count = (long long)a.batch * a.h * nn;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  const long long bh = idx / nn, r = idx - bh * nn;
  const long long b = bh / a.h, hh = bh - b * a.h;
  const long long i = r / a.n, kk = r - i * a.n;
  float sb = 0.f, sg = 0.f;
  for (int c = 0; c < a.chunks; ++c) {
    sb += a.partial[c * count + idx];
    if (kGated) sg += a.partial[(a.chunks + c) * count + idx];
  }
  const long long out = b * o.so[0] + hh * o.so[1] + i * o.so[2] + kk * o.so[3];
  o.dbias[out] = __float2bfloat16(sb);
  if (kGated) {
    const float g = sigmoid(__bfloat162float(
        a.gate[b * a.sg[0] + hh * a.sg[1] + i * a.sg[2] + kk * a.sg[3]]));
    o.dgate[out] = __float2bfloat16(sg * g * (1.f - g));
  }
}

template <int KT, bool kGated, bool kDropout, bool kSplitDv>
int launch_tiles(const Args& a, cudaStream_t stream) {
  const size_t smem = shared_bytes(KT, a.dp, kSplitDv);
  auto kernel = panel_bwd_kernel<KT, kGated, kDropout, kSplitDv>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.batch * a.h, a.chunks), KT * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The backward of one call: the panel kernel, then the reduction of its
// dbias and dgate sums. Returns the first CUDA error (0 when both launched).
template <bool kGated, bool kDropout, bool kSplitDv = false>
int launch(const Args& a, const Out& o, cudaStream_t stream) {
  const int kt = (a.n + 15) / 16;
  int e;
  if (kt <= 2) {
    e = launch_tiles<2, kGated, kDropout, kSplitDv>(a, stream);
  } else if (kt == 3) {
    e = launch_tiles<3, kGated, kDropout, kSplitDv>(a, stream);
  } else if (kt == 4) {
    e = launch_tiles<4, kGated, kDropout, kSplitDv>(a, stream);
  } else {
    e = launch_tiles<8, kGated, kDropout, kSplitDv>(a, stream);
  }
  if (e != 0) return e;
  const long long count = (long long)a.batch * a.h * a.n * a.n;
  reduce_kernel<kGated><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(a, o);
  return (int)cudaGetLastError();
}

// What the body takes; the wrappers pad or raise on anything else.
inline bool valid(const Args& a) {
  const long long blocks = (long long)a.batch * a.h;
  return a.n >= 1 && a.n <= kMaxNodes && (a.dp == 16 || a.dp == 32) && a.h >= 1 &&
         a.batch >= 1 && a.nj >= 1 && a.jc >= 1 && a.chunks >= 1 &&
         (long long)(a.chunks - 1) * a.jc < a.nj && (long long)a.chunks * a.jc >= a.nj &&
         a.chunks <= 65535 && blocks <= 0x7fffffffLL;
}

}  // namespace tbwd
