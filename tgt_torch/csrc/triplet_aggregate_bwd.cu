// Backward of dense triplet aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_dense.py:_agg_bwd_kernel
// (reached through _agg_core_bwd). Given the forward's inputs A (b, i, k, h)
// and V (b, j, k, d, h) and the output cotangent dva (b, j, i, d, h), it
// returns
//
//   dA[b,i,k,h]   = sum_j sum_d dva[b,j,i,d,h] V[b,j,k,d,h]   (cast to A's type)
//   dV[b,j,k,d,h] = sum_i A[b,i,k,h] dva[b,j,i,d,h]
//
// in f32, whatever the storage type (f32 or bf16), each sum in a fixed order:
// two launches on the same inputs give bitwise equal outputs. No float
// atomics, no fallback.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s, 989 TFLOP/s bf16): at
// b=16, N=48, edge width 256, H=16, d=16 in bf16 the function reads A (1.18
// MB), V and dva (2 x 18.87 MB) and writes dA (1.18 MB) and dV (18.87 MB):
// 59.0 MB, 17.6 us at 3.35 TB/s. Its two products, 4 N^3 d H flops per batch
// row (1.81 GFLOP), take 1.8 us at the bf16 tensor-core peak. So it is bound
// by device memory; at the training micro-batch (b=32) both double (35.2 us).
//
// Two routes; the wrapper (ops/kernels/triplet_aggregate.py, agg_bwd_route)
// picks one by shape before the launch.
//
// 1. The body (namespace tagb, triplet_aggregate_bwd_body): bf16, H a
//    multiple of 8, d a multiple of 8 up to 32, n <= 64 (n <= 128 at
//    d <= 16), 16-byte pieces of 8 heads: every TGT-Agx2 bucket. One
//    launch, no workspace:
//    - One block per (b, HB heads, tile of 16 rows k), one warp per head.
//      The block walks every j in order; each output element has exactly
//      one owning block and one order of its sum, so nothing is reduced
//      across blocks. HB is 16 (all of H = 16, n <= 48, d <= 16) where the
//      wrapper finds b ceil(n / 16) such blocks enough to fill half the
//      card (the training micro-batch), else 8 (twice the blocks).
//    - Loads. A stage holds dva[b, j] (all rows i) and V[b, j, k-tile], HB
//      heads, as they lie in memory, 3 stages deep where shared memory
//      allows (else 2). With HB = H = 16 dva_j is contiguous: one bulk copy
//      of the tensor memory accelerator (cp.async.bulk, completed on an
//      mbarrier) brings it; with HB = 8 cp.async brings its 16-byte pieces.
//      cp.async brings V's 16 rows (through its three outer strides, so the
//      out direction's pair-transposed view is read in place). On the
//      H100 the loads alone take 0.036 ms (b=16) and 0.050 (b=32) in blocks
//      of 16 heads, 0.058 and 0.104 in blocks of 8 (PERF.md section 6).
//    - Transposes. ldmatrix reads a block of 8 d by 8 heads and
//      stmatrix.trans writes it as rows of 8 d into 8 per-head panels
//      (row-swizzled, no padding); dV_j goes back the same way into pieces
//      of HB heads, stored 16 bytes a thread.
//    - Products on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums),
//      per warp: dA[:, k-tile] += dva_j V_j[k-tile]^T (M = i, N = k, K = d,
//      d padded to 16 with zeros), kept in registers across j; dV_j[k-tile]
//      = A^T[k-tile, :] dva_j (M = k, N = d, K = i). A's fragments are
//      loaded once per block into registers; one ldmatrix of a 16 x 16
//      block of dva_j is dA's A operand, and its movmatrix transpose dV's B
//      operand. dA leaves once, after the last j, cast to bf16.
//    - One barrier per j: the panels, dV_j's panels and pieces are double
//      buffered, so between two barriers a warp runs j's products, j + 1's
//      transposes, dV_{j-1}'s pieces and dV_{j-2}'s stores; even warps take
//      the products first, odd warps last, so that the tensor cores and
//      shared memory work at once.
//    - Cost: dva is read by each of the ceil(n / 16) blocks of one (b,
//      heads); they run side by side, so device memory reads it about once
//      and the rest comes from L2. Shared memory is the limit: per j and
//      block the copies, transposes, operand loads and dV's pieces move
//      about 1,600 wavefronts of 128 bytes (the 32-byte rows of 16 heads
//      cost the transposes a 2-way bank conflict), against ~2,600 cycles
//      measured per j on the H100 (clock64 per phase).
//    - Size at n = 48, d = 16, HB = 16: 512 threads, 128 registers, 0
//      spills; 3 stages of 32 KB and 108 KB of panels and pieces, one block
//      per SM, 96 blocks at b=32. HB = 8: 256 threads, 168-254 registers,
//      one block per SM; 96 blocks at b=16.
// 2. The panel route (triplet_aggregate_bwd): f32 (the tensor cores' TF32
//    keeps too few bits) and any bf16 shape outside the body. The TPU kernel
//    sums dA over j on a sequential ("arbitrary") grid axis; here each output
//    is written by one thread from sums in a fixed order, in three kernels:
//    - agg_da_kernel: one block per (b, tile of 8 rows i, chunk of 256
//      (k, h) columns, chunk of j_chunk rows j). It loops over its j in
//      order; per j it stages the rows of V[b,j] its columns need and the 8
//      rows of dva[b,j] in shared memory as f32 (dva laid out (d, h, row),
//      padded, as the forward lays out its weights), and each thread adds
//      sum_d dva V into 8 registers. It writes one f32 partial sum per chunk
//      of j to a workspace.
//    - agg_da_reduce_kernel: dA = the partial sums added in chunk order,
//      cast to A's type.
//    - dV: one block per (b, j), the forward's panel loop
//      (triplet_aggregate_panel.cuh: tensor cores in bf16, CUDA cores in
//      f32) with A transposed and dva as the panel.
#include "triplet_aggregate_panel.cuh"
#include "mma_ptx.cuh"

namespace {

using agg::kBatch;
using agg::kRowStride;
using agg::kRows;
using agg::kThreads;
using agg::Strides3;
using agg::fma8;
using agg::put8;
using agg::set_shared;
using agg::store;
using agg::to_f32;

// Rows k of V that one chunk of kThreads (k, h) columns spans, at most.
__host__ __device__ __forceinline__ int da_v_rows(int n, int h) {
  const int rows = (kThreads + h - 1) / h + 1;
  return rows < n ? rows : n;
}

// Partial dA over rows j in [j0, j0 + j_chunk) for rows i in [i0, i0 + 8)
// and the columns q = k*h + hh of one chunk. V's staged rows are padded by
// h floats, so the few rows k that the lanes of one warp read fall into
// different banks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
agg_da_kernel(const T* __restrict__ v, const T* __restrict__ dva,
              float* __restrict__ partial, int n, int d, int h, int j_chunk,
              int splits, Strides3 sv) {
  const int chunk = blockIdx.x, i0 = blockIdx.y * kRows;
  const int split = blockIdx.z % splits, b = blockIdx.z / splits;
  const int dh = d * h, vstride = dh + h;
  const int q0 = chunk * kThreads;
  const int k0 = q0 / h;
  const int k1 = min(n, (q0 + kThreads + h - 1) / h);   // rows [k0, k1)
  const int q = q0 + threadIdx.x;
  const bool active = q < n * h;
  const int k = q / h, hh = q - k * h;
  const int j0 = split * j_chunk, j1 = min(n, j0 + j_chunk);

  // the dva tile [dh][kRowStride], then V's rows [k1 - k0][dh + h], f32
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4 + dh * (kRowStride / 4));

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int j = j0; j < j1; ++j) {
    __syncthreads();  // the previous j's tiles are consumed
    const T* vb = v + b * sv.b + (j * sv.x + k0 * sv.y);
    const T* db = dva + (((long long)b * n + j) * n + i0) * dh;
    const int rows = k1 - k0;
    for (int c = threadIdx.x; c < dh; c += blockDim.x) {
      for (int x0 = 0; x0 < rows; x0 += kBatch) {  // kBatch loads in flight
        float buf[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (x0 + u < rows) buf[u] = to_f32(vb[(x0 + u) * sv.y + c]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (x0 + u < rows) vs[(x0 + u) * vstride + c] = buf[u];
        }
      }
      float val[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        val[r] = i0 + r < n ? to_f32(db[r * dh + c]) : 0.f;
      }
      put8(smem4 + c * (kRowStride / 4), val);
    }
    __syncthreads();
    if (active) {
      const float* vk = vs + (k - k0) * vstride + hh;
      const float4* dk = smem4 + hh * (kRowStride / 4);
      const int step = h * (kRowStride / 4);
      for (int e = 0; e < d; ++e) {
        fma8(acc, dk[e * step], dk[e * step + 1], vk[e * h]);
      }
    }
  }
  if (active) {
    const long long batch = gridDim.z / splits;     // partial: (split, b, i, k, h)
    float* pb = partial + ((split * batch + b) * n + i0) * n * h;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r < n) pb[((long long)r * n + k) * h + hh] = acc[r];
    }
  }
}

// dA = the partial sums of the j chunks, added in chunk order.
template <typename T>
__global__ void agg_da_reduce_kernel(const float* __restrict__ partial,
                                     T* __restrict__ da, long long count,
                                     int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  float sum = partial[idx];
  for (int s = 1; s < splits; ++s) sum += partial[s * count + idx];
  store(da + idx, sum);
}

template <typename T>
int launch(const void* a, const void* v, const void* dva, void* da, void* dv,
           float* workspace, int batch, int n, int d, int h, int j_chunk,
           const long long* st, cudaStream_t stream) {
  const int dh = d * h;
  const int splits = (n + j_chunk - 1) / j_chunk;
  const size_t da_smem =
      sizeof(float) * ((size_t)dh * kRowStride + (size_t)da_v_rows(n, h) * (dh + h));
  auto da_kernel = agg_da_kernel<T>;
  int err = set_shared((const void*)da_kernel, da_smem);
  if (err != 0) return err;

  const dim3 da_grid((n * h + kThreads - 1) / kThreads,
                     (n + kRows - 1) / kRows, batch * splits);
  da_kernel<<<da_grid, kThreads, da_smem, stream>>>(
      (const T*)v, (const T*)dva, workspace, n, d, h, j_chunk, splits,
      Strides3{st[0], st[1], st[2]});
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long count = (long long)batch * n * n * h;
  agg_da_reduce_kernel<T><<<(unsigned)((count + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(workspace, (T*)da, count,
                                                   splits);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  const long long nn = n;
  const Strides3 sdva{nn * nn * dh, nn * dh, dh};   // dva is contiguous
  return agg::launch_panel<T, true>((const T*)a, (const T*)dva, (T*)dv, batch,
                                    n, d, h, sdva, stream);
}

}  // namespace

// -- the bf16 tensor-core body -------------------------------------------------

namespace tagb {

using namespace tmma;

constexpr int kGroup = 8;                // heads per 16-byte piece
constexpr int kTile = 16;                // rows k per block

// The tiles of one block of HB heads (G = HB / 8 groups of 8) at n <= 16 NI
// and head width D, in shared memory:
//  - STAGES raw stages, each (16 NI + 16) rows of D pieces of HB heads (dva
//    rows i, then V rows k) as they lie in memory;
//  - two sets of per-head panels of dva (16 NI rows) and V (16 rows), rows
//    of D padded to DP = 16 or 32 by zero columns, swizzled (swz);
//  - two per-head panels of dV_j (16 rows, row stride DP + 8), and two
//    tiles of dV_j's pieces.
// STAGES is 3 where that fits, else 2.
template <int NI, int D, int HB>
struct Layout {
  static constexpr int G = HB / kGroup;
  static constexpr int THREADS = HB * 32;
  static constexpr int OCT = D / 8;                // 8-wide blocks of d
  static constexpr int DP = D <= 16 ? 16 : 32;
  static constexpr int NP = 16 * NI;
  static constexpr int PS = DP + 8;                   // dV_j's panels
  static constexpr int HSD = head_stride(NP, DP);
  static constexpr int HSV = head_stride(kTile, DP);
  static constexpr int HSO = head_stride(kTile, PS);
  static constexpr int RAW = (NP + kTile) * D * HB;   // one stage
  static constexpr int PANELS = HB * (HSD + HSV);     // one set of dva and V panels
  static constexpr int OPANEL = HB * HSO;             // dV_j's panels
  static constexpr int OUT = kTile * D * HB;          // dV_j's pieces
  static constexpr size_t bytes(int stages) {
    return sizeof(bf16) * ((size_t)stages * RAW + 2 * ((size_t)PANELS + OPANEL + OUT));
  }
  static constexpr int STAGES = bytes(3) <= agg::kMaxShared ? 3 : 2;
  static constexpr size_t SMEM = bytes(STAGES);
  static_assert(D % 8 == 0 && D <= 32, "d is 8, 16, 24 or 32");
  static_assert(HB == 8 || HB == 16, "a block takes 8 or 16 heads");
  static_assert(SMEM <= agg::kMaxShared, "the body's tiles must fit one block");
};

// The body takes n <= 64 at any d, and n <= 128 at d <= 16. Blocks of 16
// heads take H = 16, n <= 48 and d <= 16: a block's rows are then
// contiguous in memory, and its tiles fit shared memory and 128 registers a
// thread.
inline bool takes(int n, int d) { return n <= 64 || (n <= 128 && d <= 16); }
inline bool takes_16_heads(int n, int d, int h) { return h == 16 && n <= 48 && d <= 16; }

// -- bulk copies (the tensor memory accelerator) and their barriers --

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the barriers' initialisation, visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// shared memory that generic loads have read, handed to the copy engine
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the producer's arrival, with the bytes the phase's copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from device memory to shared memory, both 16-byte
// aligned, completed on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Args {
  const bf16 *a, *v, *dva;   // a (b, i, k, h), dva (b, j, i, d, h) contiguous
  bf16 *da, *dv;             // da (b, i, k, h), dv (b, j, k, d, h) contiguous
  long long sv[3];           // v's element strides of b, j, k; (d, h) contiguous
  int n, h;
};

// The inverse of to_panels (mma_ptx.cuh), for dV_j: one group's per-head
// panels [k][d] -> raw pieces [k][d][8 heads, at a stride of HB].
template <int PS, int OCT, int HB>
__device__ __forceinline__ void to_pieces(const bf16* panels, int hs, bf16* raw, int blocks,
                                          int u, int lane) {
  for (int q0 = u * 4; q0 < blocks; q0 += kGroup * 4) {
    const int mine = min(q0 + (lane >> 3), blocks - 1);
    const int r = mine / OCT, c = mine - r * OCT;
    uint32_t t4[4];
    ldsm_x4(t4, panels + (lane & 7) * hs + r * PS + c * 8);
    stsm_x4_t(t4, raw + (mine * 8 + (lane & 7)) * HB);
  }
}

// One group's per-head panels -> device memory as pieces of 8 heads, by the
// group's 8 warps: block (r, c) is 8 heads by columns 8 c..8 c + 7 of row r;
// ldmatrix.trans gives the thread heads 2 tig + {0, 1} of column 8 c + gid,
// stored as 4 bytes at dst + r row_stride + column h. Columns at or past
// `cols` are not stored.
template <int DP, int OCT>
__device__ __forceinline__ void from_panels(const bf16* panels, int hs, int rows, int cols,
                                            bf16* dst, long long row_stride, int h, int u,
                                            int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const int blocks = rows * OCT;
  for (int q0 = u * 4; q0 < blocks; q0 += kGroup * 4) {
    const int mine = min(q0 + (lane >> 3), blocks - 1);
    const int mr = mine / OCT, mc = mine - mr * OCT;
    uint32_t t4[4];
    ldsm_x4_t(t4, panels + (lane & 7) * hs + swz<DP>(mr, mc));
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int blk = q0 + m;
      const int r = blk / OCT, col = (blk - r * OCT) * 8 + gid;
      if (blk < blocks && col < cols) {
        *reinterpret_cast<uint32_t*>(dst + r * row_stride + (long long)col * h + 2 * tig) = t4[m];
      }
    }
  }
}

template <int NI, int D, int HB>
__global__ void __launch_bounds__(HB * 32, 1)
agg_bwd_body_kernel(const Args p) {
  using L = Layout<NI, D, HB>;
  constexpr int PS = L::PS, HSD = L::HSD, HSV = L::HSV, HSO = L::HSO, OCT = L::OCT, DP = L::DP,
                G = L::G, NP = L::NP, S = L::STAGES;
  const int n = p.n, h = p.h;
  const int ktiles = (n + kTile - 1) / kTile, blocks_h = h / HB;
  const int kb = blockIdx.x % ktiles, bh = blockIdx.x / ktiles;
  const int hb0 = (bh % blocks_h) * HB, b = bh / blocks_h;
  const int k0 = kb * kTile, krows = min(kTile, n - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = warp / kGroup, u = warp % kGroup;   // this warp's group, head in it
  const long long dh = (long long)D * h;

  extern __shared__ uint4 smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);   // [S][RAW]: dva pieces, then V's at NP D HB
  bf16* panels = raw + S * L::RAW;             // [2][HB][HSD + HSV]: dva_j[i][dd], then V_j[k][dd]
  bf16* o_p = panels + 2 * L::PANELS;          // [2][HB][HSO]: dV_j[k][dd]
  bf16* out = o_p + 2 * L::OPANEL;             // [2][kTile][D][HB]: dV_j's pieces
  auto dva_panels = [&](int j) { return panels + (j & 1) * L::PANELS; };
  auto v_panels = [&](int j) { return panels + (j & 1) * L::PANELS + HB * HSD; };

  {  // the panels' padding (rows past n or krows, columns past D) stays zero
    uint4* z = reinterpret_cast<uint4*>(panels);
    for (int x = threadIdx.x; x < L::PANELS / 4; x += L::THREADS) z[x] = make_uint4(0, 0, 0, 0);
  }

  // Stage j % S holds dva[b, j, :, :, heads] and V[b, j, k-tile, :, heads].
  // With 16 heads (all of H) dva_j is contiguous in memory: one bulk copy
  // brings it, completed on the stage's barrier; with 8 heads out of more,
  // cp.async brings its 16-byte pieces. cp.async brings V's tile, whose rows
  // (pair-transposed or not) lie apart. One commit group per j.
  __shared__ uint64_t bars[S];
  const bf16* dva_b = p.dva + (long long)b * n * n * dh + hb0;
  const bf16* v_b = p.v + b * p.sv[0] + k0 * p.sv[2] + hb0;
  const int dpieces = n * D * G, vpieces = krows * D * G;
  if constexpr (HB == 16) {
    if (threadIdx.x == 0) {
      for (int x = 0; x < S; ++x) mbar_init(bars + x, 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
  auto fetch = [&](int j) {
    if (j < n) {
      bf16* st = raw + (j % S) * L::RAW;
      const bf16* src = dva_b + (long long)j * n * dh;
      if constexpr (HB == 16) {
        if (threadIdx.x == 0) {
          fence_proxy_async();
          mbar_expect_tx(bars + j % S, dpieces * 16);
          bulk_copy(st, src, dpieces * 16, bars + j % S);
        }
      } else {
        for (int q = threadIdx.x; q < dpieces; q += L::THREADS) {
          cp_async16(st + q * kGroup, src + (long long)q * h);
        }
      }
      const bf16* vj = v_b + j * p.sv[1];
      bf16* vst = st + NP * D * HB;
      for (int q = threadIdx.x; q < vpieces; q += L::THREADS) {
        const int rd = q / G, gq = q - rd * G, k = rd / D, dd = rd - k * D;
        cp_async16(vst + q * kGroup, vj + k * p.sv[2] + dd * h + gq * kGroup);
      }
    }
    cp_commit();
  };
  // stage j's copies are in, for this thread, with `later` commit groups
  // after j's left pending; a barrier then shows them to all
  auto arrived = [&](int j, int later) {
    if constexpr (HB == 16) {
      if (j < n) mbar_wait(bars + j % S, (j / S) & 1);
    }
    if (later >= 2) cp_wait<2>();
    else if (later == 1) cp_wait<1>();
    else cp_wait<0>();
  };
  // stage j -> the panels of j, by each group's 8 warps
  auto transpose = [&](int j) {
    const bf16* st = raw + (j % S) * L::RAW + g * kGroup;
    to_panels<DP, OCT, HB>(st, dva_panels(j) + g * kGroup * HSD, HSD, n * OCT, u, lane);
    to_panels<DP, OCT, HB>(st + NP * D * HB, v_panels(j) + g * kGroup * HSV, HSV, krows * OCT,
                           u, lane);
  };
  bf16* dv_b = p.dv + ((long long)b * n * n + k0) * dh + hb0;
  // dV_j's pieces leave with 16-byte stores (with HB = H a tile's rows k are
  // contiguous)
  auto store_dv = [&](int j) {
    const bf16* src = out + (j & 1) * L::OUT;
    bf16* dst = dv_b + (long long)j * n * dh;
    for (int q = threadIdx.x; q < vpieces; q += L::THREADS) {
      const int rd = q / G, gq = q - rd * G;
      *reinterpret_cast<uint4*>(dst + (long long)rd * h + gq * kGroup) =
          *reinterpret_cast<const uint4*>(src + q * kGroup);
    }
  };
  auto pieces = [&](int j) {   // dV_j's panels -> its pieces
    to_pieces<PS, OCT, HB>(o_p + (j & 1) * L::OPANEL + g * kGroup * HSO, HSO,
                           out + (j & 1) * L::OUT + g * kGroup, krows * OCT, u, lane);
  };

#pragma unroll
  for (int x = 0; x < S; ++x) fetch(x);

  // A^T[k-tile, :] of this warp's head as the A operand of dV (M = k, K = i):
  // at[s] covers i 16 s..16 s + 15; rows k past the tile or n are zero
  uint32_t at[NI][4];
  {
    const bf16* ah = p.a + (long long)b * n * n * h + hb0 + warp;
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int s = 0; s < NI; ++s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kl = gid + (r & 1) * 8, i = 16 * s + 2 * tig + (r >> 1) * 8;
        const bool krow = kl < krows;
        const bf16 lo = krow && i < n ? ah[((long long)i * n + k0 + kl) * h] : zero;
        const bf16 hi = krow && i + 1 < n ? ah[((long long)(i + 1) * n + k0 + kl) * h] : zero;
        const bf162 pair = __halves2bfloat162(lo, hi);
        at[s][r] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
  }

  float acc[NI][2][4];
#pragma unroll
  for (int mt = 0; mt < NI; ++mt) {
#pragma unroll
    for (int t = 0; t < 2; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;
  }

  arrived(0, S - 1);
  __syncthreads();   // stage 0 is in; the panels' padding is zero
  transpose(0);
  arrived(1, S - 2);
  __syncthreads();   // the panels of j = 0 and stage 1 are in; stage 0 is free
  fetch(S);

  // Iteration j, between two barriers: the products of j, the transposes of
  // j + 1, dV_{j-1} to pieces, dV_{j-2} out, and the wait for stage j + 2;
  // then stage j + 1's refill with j + 1 + S.
  // The warps of odd index take the transposes and dV's pieces before the
  // products, the others after, so that shared memory and the tensor cores
  // work at once.
  const bool products_first = (warp & 1) == 0;
  for (int j = 0; j < n; ++j) {
    if (!products_first) {
      if (j + 1 < n) transpose(j + 1);
      if (j >= 1) pieces(j - 1);
      if (j >= 2) store_dv(j - 2);
    }
    const bf16* dp_w = dva_panels(j) + warp * HSD;
    const bf16* vp_w = v_panels(j) + warp * HSV;
    // dA[:, k-tile] += dva_j V_j^T (M = i, N = k, K = d) and
    // dV_j[k-tile] = A^T dva_j (M = k, N = d, K = i): one ldmatrix of each
    // 16 x 16 block of dva_j gives dA's A operand, and its movmatrix
    // transpose dV's B operand.
    float o[DP / 8][4];
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
    for (int e = 0; e < DP / 16; ++e) {
      uint32_t vb[4];
      ldsm_x4(vb, vp_w + swz<DP>((lane & 7) + (lane >> 4) * 8, 2 * e + ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < NI; ++mt) {
        uint32_t af[4], bt[4];
        ldsm_x4(af, dp_w + swz<DP>(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                   2 * e + (lane >> 4)));
        mma(acc[mt][0], af, vb[0], vb[1]);
        mma(acc[mt][1], af, vb[2], vb[3]);
#pragma unroll
        for (int m = 0; m < 4; ++m) bt[m] = movmatrix_t(af[m]);
        mma(o[2 * e], at[mt], bt[0], bt[1]);
        if (2 * e + 1 < OCT) mma(o[2 * e + 1], at[mt], bt[2], bt[3]);   // past d: padding
      }
    }
    bf16* op_w = o_p + (j & 1) * L::OPANEL + warp * HSO;
#pragma unroll
    for (int t = 0; t < OCT; ++t) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        *reinterpret_cast<uint32_t*>(op_w + (gid + 8 * hf) * PS + 8 * t + 2 * tig) =
            pack(o[t][2 * hf], o[t][2 * hf + 1]);
      }
    }
    if (products_first) {
      if (j + 1 < n) transpose(j + 1);
      if (j >= 1) pieces(j - 1);
      if (j >= 2) store_dv(j - 2);
    }
    arrived(j + 2, S - 2);
    __syncthreads();
    fetch(j + 1 + S);
  }
  if (n >= 2) store_dv(n - 2);
  pieces(n - 1);
  __syncthreads();   // dV_{n-1}'s pieces are in; every panel is consumed
  store_dv(n - 1);

  // dA[:, k-tile] leaves through the first set of dva panels
#pragma unroll
  for (int mt = 0; mt < NI; ++mt) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        *reinterpret_cast<uint32_t*>(panels + warp * HSD + swz<DP>(mt * 16 + gid + 8 * hf, t) +
                                     2 * tig) = pack(acc[mt][t][2 * hf], acc[mt][t][2 * hf + 1]);
      }
    }
  }
  __syncthreads();
  from_panels<DP, kTile / 8>(panels + g * kGroup * HSD, HSD, n, krows,
                             p.da + (long long)b * n * n * h + (long long)k0 * h + hb0 + g * kGroup,
                             (long long)n * h, h, u, lane);
}

template <int NI, int D, int HB>
int launch_tiles(const Args& a, int batch, cudaStream_t stream) {
  using L = Layout<NI, D, HB>;
  auto kernel = agg_bwd_body_kernel<NI, D, HB>;
  const int e = agg::set_shared((const void*)kernel, L::SMEM);
  if (e != 0) return e;
  const long long blocks = (long long)batch * (a.h / HB) * ((a.n + kTile - 1) / kTile);
  kernel<<<(unsigned)blocks, L::THREADS, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_width(const Args& a, int batch, int hb, cudaStream_t stream) {
  const int ni = (a.n + 15) / 16;
  if constexpr (D <= 16) {
    if (hb == 16) {
      if (ni <= 2) return launch_tiles<2, D, 16>(a, batch, stream);
      return launch_tiles<3, D, 16>(a, batch, stream);
    }
    if (ni > 4) return launch_tiles<8, D, 8>(a, batch, stream);
  }
  if (ni <= 2) return launch_tiles<2, D, 8>(a, batch, stream);
  if (ni == 3) return launch_tiles<3, D, 8>(a, batch, stream);
  return launch_tiles<4, D, 8>(a, batch, stream);
}

}  // namespace tagb

// The panel route. dtype: 0 = float32, 1 = bfloat16. a: (b, i, k, h)
// contiguous; v: (b, j, k, d, h) with (d, h) contiguous and the element
// strides of its three outer axes in strides[0..2]; dva: (b, j, i, d, h)
// contiguous. Writes da (b, i, k, h) and dv (b, j, k, d, h), both
// contiguous. workspace holds ceil(n / j_chunk) * b * n * n * h floats (the
// partial sums of dA). Returns cudaGetLastError() after the launches.
extern "C" int triplet_aggregate_bwd(const void* a, const void* v,
                                     const void* dva, void* da, void* dv,
                                     void* workspace, int dtype, int batch,
                                     int n, int d, int h, int j_chunk,
                                     const long long* strides, void* stream) {
  if (n < 1 || n > agg::kMaxN || d < 1 || h < 1 || batch < 1 || j_chunk < 1 ||
      (long long)batch * ((n + j_chunk - 1) / j_chunk) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  float* ws = (float*)workspace;
  if (dtype == 0) {
    return launch<float>(a, v, dva, da, dv, ws, batch, n, d, h, j_chunk,
                         strides, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(a, v, dva, da, dv, ws, batch, n, d, h,
                                 j_chunk, strides, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The body. a: (b, i, k, h) contiguous; v: (b, j, k, d, h) with (d, h)
// contiguous and the element strides of its three outer axes in
// strides[0..2]; dva: (b, j, i, d, h) contiguous; all bf16. Writes da (b, i,
// k, h) and dv (b, j, k, d, h), both contiguous, in one launch of blocks of
// heads_per_block heads (8, or 16 where H = 16, n <= 64 and d <= 16).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the body does not take.
extern "C" int triplet_aggregate_bwd_body(const void* a, const void* v, const void* dva,
                                          void* da, void* dv, int batch, int n, int d,
                                          int h, int heads_per_block, const long long* strides,
                                          void* stream) {
  const long long blocks = (long long)batch * (h / tagb::kGroup) *
                           ((n + tagb::kTile - 1) / tagb::kTile);   // at most
  const int hb = heads_per_block;
  if (n < 1 || !tagb::takes(n, d) || d < 8 || d > 32 || d % 8 != 0 || h < tagb::kGroup ||
      h % tagb::kGroup != 0 || batch < 1 || blocks > 0x7fffffffLL ||
      (hb != 8 && !(hb == 16 && tagb::takes_16_heads(n, d, h))) || !agg::aligned16(a) ||
      !agg::aligned16(v) || !agg::aligned16(dva) || !agg::aligned16(da) ||
      !agg::aligned16(dv) || strides[0] % 8 != 0 || strides[1] % 8 != 0 ||
      strides[2] % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const tagb::Args args{(const tmma::bf16*)a, (const tmma::bf16*)v, (const tmma::bf16*)dva,
                        (tmma::bf16*)da, (tmma::bf16*)dv, {strides[0], strides[1], strides[2]},
                        n, h};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 8: return tagb::launch_width<8>(args, batch, hb, s);
    case 16: return tagb::launch_width<16>(args, batch, hb, s);
    case 24: return tagb::launch_width<24>(args, batch, hb, s);
    default: return tagb::launch_width<32>(args, batch, hb, s);
  }
}
