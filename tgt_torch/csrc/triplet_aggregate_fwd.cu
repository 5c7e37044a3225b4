// Forward dense triplet aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel tgt_tpu/ops/pallas/triplet_dense.py:_agg_fwd_kernel
// (reached through _agg_core_fwd). The aggregate triplet variant computes
// its N^2 weights A (softmax over k, sigmoid gate, dropout) outside the
// kernel; the kernel does the O(N^3) k-sum: for every batch row b, pair
// column j, row i and column (d, h),
//
//   va[b,j,i,d,h] = sum_k A[b,i,k,h] V[b,j,k,d,h]
//
// in f32, whatever the storage type (f32 or bf16), rounded once to V's type
// (as _dot(...).astype). Each output has one owning block and one order of
// its sum, with no atomics: two launches on the same inputs give bitwise
// equal outputs.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s, 989 TFLOP/s bf16): at
// b=16, N=48, edge width 256, H=16, d=16 in bf16 the function reads V (18.87
// MB) and A (1.18 MB) and writes va (18.87 MB): 38.9 MB, 11.6 us at 3.35
// TB/s. Its 2 N^3 d H flops per batch row, 0.91 GFLOP, take 0.9 us at the
// bf16 tensor-core peak. So it is bound by device memory; at the training
// micro-batch (b=32) both double (23.2 us).
//
// Two routes; the wrapper (ops/kernels/triplet_aggregate.py, agg_fwd_route)
// picks one by shape before the launch.
//
// 1. The body (namespace tagf, triplet_aggregate_fwd_body): bf16, H a
//    multiple of 8, d a multiple of 8 up to 32, n <= 48 (n <= 64 at
//    d <= 16), 16-byte pieces of 8 heads: every TGT-Agx2 bucket. One
//    launch:
//    - One block per (b, HB heads, chunk of rows j), one warp per head,
//      covering every row i. The wrapper (agg_fwd_blocks) takes HB = 16
//      where it fits (n <= 48, d <= 16), else 8, and chunks that bring the
//      grid near one wave of the card's SMs: at N=48, 6 rows j at b=16 and
//      12 at b=32, 128 blocks each.
//    - A once per block: cp.async brings A[b, :, :, heads] (n^2 HB, 73.7 KB
//      at HB = 16, n = 48) through A's strides as 16-byte pieces of 8 heads;
//      ldmatrix/stmatrix.trans turn them into per-head [i][k] panels, and
//      each warp loads its head's fragments (M = i, K = k) into registers,
//      where they stay for every j (36 registers at n = 48). The panel
//      route reads all of A from L2 once per j.
//    - V_j streamed 3 stages deep: cp.async brings its 16-byte pieces of 8
//      heads through V's three outer strides, so the out direction's
//      pair-transposed view is read in place. Bulk copies of the tensor
//      memory accelerator (as the backward body reads dva) were no faster
//      where V_j's rows are contiguous and slower, one copy per row, on the
//      transposed view (PERF.md section 6).
//    - Transposes: blocks of 8 d by 8 heads go through ldmatrix and
//      stmatrix.trans into per-head [k][d] panels (swizzled, no padding),
//      whose rows k >= n stay zero (0 * NaN is NaN: shared memory is not
//      zeroed between stages, so the padding rows are zeroed once and never
//      written). ldmatrix.trans gives the B operand of mma.sync m16n8k16
//      (M = i, N = d, K = k): at n = 48, d = 16, 18 mma per warp per j, one
//      m-tile at a time.
//    - Output: the f32 sums, packed to bf16, go to per-head [i][d] panels
//      (swizzled); ldmatrix and stmatrix.trans make them (i, d, 8 heads)
//      pieces, which leave 16 bytes a thread through the element strides
//      of the output's (b, j, i, d) axes: the contiguous va, or, in the
//      aggregate layer's no-grad forward, each direction's half of one
//      (b, i, j, 2, d, h) buffer, which one lin_O GEMM reads
//      (ops/triplet.py). Any destination whose strides are multiples of 8
//      elements keeps the 16-byte pieces whole. A template tag names the
//      store in a trace and changes nothing else: RowStore for the
//      contiguous va, PairStore for any other destination.
//    - One barrier per j: panels and pieces are double buffered, so between
//      two barriers a warp runs j's products, j + 1's transposes, va_{j-1}'s
//      pieces and va_{j-2}'s stores; even warps take the products first,
//      odd warps last, so that the tensor cores and shared memory work at
//      once.
//    - Registers: the loops over a runtime count of pieces (copies, zeroing,
//      pieces, stores) stay rolled (#pragma unroll 1): unrolled, their
//      addresses cost the 16-head blocks a spill at their 128 registers.
//    - Limits: A's fragments take n^2 / 64 registers a thread (64 at n = 64),
//      so n <= 64; shared memory holds A's staging (or, in the loop, the
//      panels and pieces) beside the stages, so d > 16 takes n <= 48 and
//      blocks of 16 heads take n <= 48, d <= 16.
// 2. The panel route (triplet_aggregate_fwd): f32 (the tensor cores' TF32
//    keeps too few bits) and any bf16 shape outside the body. One block per
//    (b, j) runs the panel loop of triplet_aggregate_panel.cuh with the panel
//    V[b, j] and the weights A[b] as they are: in bf16 on the tensor cores
//    (mma.sync), otherwise (f32) on the CUDA cores. The block stages V[b, j]
//    (N x d*H) once; V's outer strides are free, so the out direction's
//    pair-transposed V is read in place. A[b] (N^2 H, contiguous) is read
//    once per j from L2.
#include "triplet_aggregate_panel.cuh"
#include "mma_ptx.cuh"

// -- the bf16 tensor-core body -------------------------------------------------

namespace tagf {

using namespace tmma;

constexpr int kGroup = kPieceHeads;   // heads per 16-byte piece

// The tiles of one block of HB heads (G = HB / 8 groups of 8) at n <= NP =
// 16 NI and head width D, in shared memory:
//  - STAGES = 3 raw stages of V_j, n rows k of D pieces of HB heads as they
//    lie in memory;
//  - one work region, used first for A: its pieces [i][NP][HB] (columns k
//    >= n zero) and its per-head panels [i][k] (NP x NP, swz<NP>); then by
//    the loop: two sets of per-head panels of V_j [k][DP] (swz<DP>, rows k >=
//    n zero), two sets of per-head panels of va_j [i][DP] (swz<DP>) and two
//    tiles of va_j's pieces [i][D][HB].
template <int NI, int D, int HB>
struct Layout {
  static constexpr int G = HB / kGroup;
  static constexpr int THREADS = HB * 32;
  static constexpr int OCT = D / 8;                      // 8-wide blocks of d
  static constexpr int DP = D == 8 ? 8 : (D <= 16 ? 16 : 32);
  static constexpr int NP = 16 * NI;
  static constexpr int UNITS = NI * OCT;                 // B operands per j: (k-step, 8 d)
  static constexpr int HSA = head_stride(NP, NP);
  static constexpr int HSP = head_stride(NP, DP);        // V_j's and va_j's panels
  static constexpr int RAW = NP * D * HB;                // one stage
  static constexpr int A_PIECES = NP * NP * HB;
  static constexpr int A_REGION = A_PIECES + HB * HSA;
  static constexpr int PANELS = HB * HSP;                // one set of per-head panels
  static constexpr int OUT = NP * D * HB;                // va_j's pieces
  static constexpr int LOOP = 2 * (2 * PANELS + OUT);
  static constexpr int WORK = A_REGION > LOOP ? A_REGION : LOOP;
  static constexpr int STAGES = 3;
  static constexpr size_t SMEM = sizeof(bf16) * ((size_t)STAGES * RAW + WORK);
  static_assert(D % 8 == 0 && D <= 32, "d is 8, 16, 24 or 32");
  static_assert(HB == 8 || HB == 16, "a block takes 8 or 16 heads");
  static_assert(NI >= 2 && NI <= 4, "n is padded to 32, 48 or 64");
  static_assert(SMEM <= agg::kMaxShared, "the body's tiles must fit one block");
};

// The body takes n <= 64 at d <= 16 and n <= 48 at d <= 32. Blocks of 16
// heads take H a multiple of 16, n <= 48 and d <= 16 (128 registers a
// thread).
inline bool takes(int n, int d) { return n <= 48 || (n <= 64 && d <= 16); }
inline bool takes_16_heads(int n, int d, int h) { return h % 16 == 0 && n <= 48 && d <= 16; }

struct Args {
  const bf16 *a, *v;        // a (b, i, k, h) with h contiguous; v (b, j, k, d, h) with (d, h)
  bf16* out;                // out (b, j, i, d, h), h contiguous
  long long sa[3], sv[3];   // element strides of a's (b, i, k) and v's (b, j, k)
  long long so[4];          // element strides of out's (b, j, i, d)
  int n, h, j_chunk;
};

// Names of the store, for a trace: out contiguous (RowStore) or not
// (PairStore); the kernel is the same
struct RowStore {};
struct PairStore {};

template <int NI, int D, int HB, class Store>
__global__ void __launch_bounds__(HB * 32, 1)
agg_fwd_body_kernel(const Args p) {
  using L = Layout<NI, D, HB>;
  constexpr int OCT = L::OCT, DP = L::DP, NP = L::NP, G = L::G, S = L::STAGES, HSA = L::HSA,
                HSP = L::HSP, UNITS = L::UNITS;
  const int n = p.n, h = p.h;
  const int chunks = (n + p.j_chunk - 1) / p.j_chunk, groups = h / HB;
  const int jb = blockIdx.x % chunks, bh = blockIdx.x / chunks;
  const int hb0 = (bh % groups) * HB, b = bh / groups;
  const int j0 = jb * p.j_chunk, nj = min(p.j_chunk, n - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = warp / kGroup, u = warp % kGroup;   // this warp's group, head in it

  extern __shared__ uint4 smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);   // [S][RAW]: V_j's pieces
  bf16* work = raw + S * L::RAW;
  bf16* a_raw = work;                          // first A's pieces [i][NP][HB],
  bf16* a_pan = work + L::A_PIECES;            // and its panels [HB][HSA]
  bf16* v_pan = work;                          // then [2][HB][HSP]: V_j[k][dd]
  bf16* o_pan = work + 2 * L::PANELS;          // [2][HB][HSP]: va_j[i][dd]
  bf16* out = work + 4 * L::PANELS;            // [2][OUT]: va_j's pieces

  // A[b, :, :, heads] as pieces through A's strides; its columns k in [n, NP)
  // are zero, so the k-steps past n add nothing
  {
    const bf16* a_b = p.a + b * p.sa[0] + hb0;
#pragma unroll 1
    for (int q = threadIdx.x; q < n * n * G; q += L::THREADS) {
      const int ik = q / G, gq = q - ik * G, i = ik / n, k = ik - i * n;
      cp_async16(a_raw + (i * NP + k) * HB + gq * kGroup,
                 a_b + i * p.sa[1] + k * p.sa[2] + gq * kGroup);
    }
    cp_commit();
    const int pad = NP - n;
#pragma unroll 1
    for (int q = threadIdx.x; q < n * pad * G; q += L::THREADS) {
      const int ik = q / G, gq = q - ik * G, i = ik / pad, k = n + ik - i * pad;
      *reinterpret_cast<uint4*>(a_raw + (i * NP + k) * HB + gq * kGroup) = make_uint4(0, 0, 0, 0);
    }
  }

  // stage jj % S holds V[b, j0 + jj, :, :, heads] as 16-byte pieces; one
  // commit group per jj
  const bf16* v_b = p.v + b * p.sv[0] + hb0;
  auto fetch = [&](int jj) {
    if (jj < nj) {
      bf16* st = raw + (jj % S) * L::RAW;
      const bf16* vj = v_b + (j0 + jj) * p.sv[1];
#pragma unroll 1
      for (int q = threadIdx.x; q < n * D * G; q += L::THREADS) {
        const int rd = q / G, gq = q - rd * G, k = rd / D, dd = rd - k * D;
        cp_async16(st + q * kGroup, vj + k * p.sv[2] + dd * h + gq * kGroup);
      }
    }
    cp_commit();
  };
  // stage jj -> the panels of jj, by each group's 8 warps
  auto transpose = [&](int jj) {
    to_panels<DP, OCT, HB>(raw + (jj % S) * L::RAW + g * kGroup,
                           v_pan + (jj & 1) * L::PANELS + g * kGroup * HSP, HSP, n * OCT, u, lane);
  };

#pragma unroll
  for (int x = 0; x < S; ++x) fetch(x);

  // A's pieces -> per-head panels -> this warp's fragments: af[mt][e] is the
  // A operand of rows i 16 mt.. and columns k 16 e..
  uint32_t af[NI][NI][4];
  cp_wait<S>();
  __syncthreads();   // A's pieces and their zero columns are in
  to_panels<NP, NP / 8, HB>(a_raw + g * kGroup, a_pan + g * kGroup * HSA, HSA, n * (NP / 8), u,
                            lane);
  __syncthreads();
  {
    const bf16* ap = a_pan + warp * HSA;
#pragma unroll
    for (int mt = 0; mt < NI; ++mt) {
#pragma unroll
      for (int e = 0; e < NI; ++e) {
        ldsm_x4(af[mt][e], ap + swz<NP>(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                        2 * e + (lane >> 4)));
      }
    }
  }
  __syncthreads();   // A's region is free: the loop's panels take it
  {  // the rows k >= n of both sets of V_j's panels stay zero
    const int per = (NP - n) * DP / 8;
#pragma unroll 1
    for (int q = threadIdx.x; q < 2 * HB * per; q += L::THREADS) {
      const int panel = q / per;
      *reinterpret_cast<uint4*>(v_pan + panel * HSP + n * DP + (q - panel * per) * 8) =
          make_uint4(0, 0, 0, 0);
    }
  }

  // va_j = A V_j for this warp's head, one m-tile of 16 rows i at a time;
  // the B operands of all k-steps and d blocks are loaded first
  auto products = [&](int jj) {
    const bf16* vp = v_pan + (jj & 1) * L::PANELS + warp * HSP;
    uint32_t bq[(UNITS + 1) / 2][4];
#pragma unroll
    for (int x = 0; x < (UNITS + 1) / 2; ++x) {
      const int q = min(2 * x + (lane >> 4), UNITS - 1);   // a repeated unit loads twice
      const int e = q / OCT, t = q - e * OCT;
      ldsm_x4_t(bq[x], vp + swz<DP>(16 * e + ((lane >> 3) & 1) * 8 + (lane & 7), t));
    }
    bf16* op = o_pan + (jj & 1) * L::PANELS + warp * HSP;
#pragma unroll
    for (int mt = 0; mt < NI; ++mt) {
      float acc[OCT][4];
#pragma unroll
      for (int t = 0; t < OCT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
      for (int e = 0; e < NI; ++e) {
#pragma unroll
        for (int t = 0; t < OCT; ++t) {
          const int q = e * OCT + t;
          mma(acc[t], af[mt][e], bq[q >> 1][(q & 1) * 2], bq[q >> 1][(q & 1) * 2 + 1]);
        }
      }
#pragma unroll
      for (int t = 0; t < OCT; ++t) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          *reinterpret_cast<uint32_t*>(op + swz<DP>(16 * mt + gid + 8 * hf, t) + 2 * tig) =
              pack(acc[t][2 * hf], acc[t][2 * hf + 1]);
        }
      }
    }
  };
  // va_j's panels -> its pieces [i][d][HB], by each group's 8 warps: ldmatrix
  // reads 8 heads' rows of 8 d, stmatrix.trans writes 8 d's rows of 8 heads
  auto pieces = [&](int jj) {
    const bf16* op = o_pan + (jj & 1) * L::PANELS + g * kGroup * HSP;
    bf16* dst = out + (jj & 1) * L::OUT + g * kGroup;
    const int blocks = n * OCT;
#pragma unroll 1
    for (int q0 = u * 4; q0 < blocks; q0 += kGroup * 4) {
      const int mine = min(q0 + (lane >> 3), blocks - 1);   // a repeated block stores twice
      const int r = mine / OCT, c = mine - r * OCT;
      uint32_t t4[4];
      ldsm_x4(t4, op + (lane & 7) * HSP + swz<DP>(r, c));
      stsm_x4_t(t4, dst + (mine * 8 + (lane & 7)) * HB);
    }
  };
  // va_j's pieces leave with 16-byte stores: its (i, d) pieces lie p.so[2]
  // and p.so[3] apart, in runs of HB heads
  auto store = [&](int jj) {
    const bf16* src = out + (jj & 1) * L::OUT;
    bf16* dst = p.out + b * p.so[0] + (j0 + jj) * p.so[1] + hb0;
#pragma unroll 1
    for (int q = threadIdx.x; q < n * D * G; q += L::THREADS) {
      const int rd = q / G, gq = q - rd * G, i = rd / D, dd = rd - i * D;
      *reinterpret_cast<uint4*>(dst + i * p.so[2] + dd * p.so[3] + gq * kGroup) =
          *reinterpret_cast<const uint4*>(src + q * kGroup);
    }
  };

  // stage jj's copies are in, for this thread, when the S - 1 or S - 2 commit
  // groups after it may still be pending; a barrier then shows them to all
  cp_wait<S - 1>();
  __syncthreads();   // stage 0 is in; the panels' zero rows are written
  transpose(0);
  cp_wait<S - 2>();
  __syncthreads();   // the panels of j0 and stage 1 are in; stage 0 is free
  fetch(S);

  // Iteration jj, between two barriers: the products of jj, the transposes
  // of jj + 1, va_{jj-1} to pieces, va_{jj-2} out, and the wait for stage
  // jj + 2; then stage jj + 1's refill with jj + 1 + S. The warps of odd
  // index take the transposes and pieces before the products, the others
  // after, so that shared memory and the tensor cores work at once.
  const bool products_first = (warp & 1) == 0;
  for (int jj = 0; jj < nj; ++jj) {
    if (!products_first) {
      if (jj + 1 < nj) transpose(jj + 1);
      if (jj >= 1) pieces(jj - 1);
      if (jj >= 2) store(jj - 2);
    }
    products(jj);
    if (products_first) {
      if (jj + 1 < nj) transpose(jj + 1);
      if (jj >= 1) pieces(jj - 1);
      if (jj >= 2) store(jj - 2);
    }
    cp_wait<S - 2>();   // stage jj + 2
    __syncthreads();
    fetch(jj + 1 + S);
  }
  if (nj >= 2) store(nj - 2);
  pieces(nj - 1);
  __syncthreads();   // va's last pieces are in
  store(nj - 1);
}

template <int NI, int D, int HB, class Store>
int launch_tiles(const Args& a, int batch, cudaStream_t stream) {
  using L = Layout<NI, D, HB>;
  auto kernel = agg_fwd_body_kernel<NI, D, HB, Store>;
  const int e = agg::set_shared((const void*)kernel, L::SMEM);
  if (e != 0) return e;
  const long long blocks =
      (long long)batch * (a.h / HB) * ((a.n + a.j_chunk - 1) / a.j_chunk);
  kernel<<<(unsigned)blocks, L::THREADS, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// n <= 32 runs at NI = 2 (its A fragments and panels padded to 32 rows)
template <int D, class Store>
int launch_width(const Args& a, int batch, int hb, cudaStream_t stream) {
  const int ni = (a.n + 15) / 16;
  if constexpr (D <= 16) {
    if (hb == 16) {
      if (ni <= 2) return launch_tiles<2, D, 16, Store>(a, batch, stream);
      return launch_tiles<3, D, 16, Store>(a, batch, stream);
    }
    if (ni == 4) return launch_tiles<4, D, 8, Store>(a, batch, stream);
  }
  if (ni <= 2) return launch_tiles<2, D, 8, Store>(a, batch, stream);
  return launch_tiles<3, D, 8, Store>(a, batch, stream);
}

template <class Store>
int launch_store(const Args& a, int d, int batch, int hb, cudaStream_t stream) {
  switch (d) {
    case 8: return launch_width<8, Store>(a, batch, hb, stream);
    case 16: return launch_width<16, Store>(a, batch, hb, stream);
    case 24: return launch_width<24, Store>(a, batch, hb, stream);
    default: return launch_width<32, Store>(a, batch, hb, stream);
  }
}

}  // namespace tagf

// The panel route. dtype: 0 = float32, 1 = bfloat16. a: (b, i, k, h)
// contiguous; v: (b, j, k, d, h) with (d, h) contiguous and the element
// strides of its three outer axes in strides[0..2]; out: (b, j, i, d, h)
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int triplet_aggregate_fwd(const void* a, const void* v, void* out,
                                     int dtype, int batch, int n, int d, int h,
                                     const long long* strides, void* stream) {
  if (n < 1 || n > agg::kMaxN || d < 1 || h < 1 || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const agg::Strides3 sv{strides[0], strides[1], strides[2]};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return agg::launch_panel<float, false>(
        (const float*)a, (const float*)v, (float*)out, batch, n, d, h, sv, s);
  }
  if (dtype == 1) {
    return agg::launch_panel<__nv_bfloat16, false>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
        batch, n, d, h, sv, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The body. a: (b, i, k, h) with h contiguous and the element strides of its
// three outer axes in a_strides[0..2]; v: (b, j, k, d, h) with (d, h)
// contiguous and its outer strides in v_strides[0..2]; all bf16. Writes out
// (b, j, i, d, h), h contiguous and the element strides of its (b, j, i, d)
// axes in out_strides[0..3], in one launch of blocks of heads_per_block
// heads (8, or 16 where H is a multiple of 16, n <= 48 and d <= 16) and
// j_chunk rows j. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the body does not take.
extern "C" int triplet_aggregate_fwd_body(const void* a, const void* v, void* out, int batch,
                                          int n, int d, int h, int heads_per_block, int j_chunk,
                                          const long long* a_strides, const long long* v_strides,
                                          const long long* out_strides, void* stream) {
  const int hb = heads_per_block;
  bool strides_ok = true;
  for (int x = 0; x < 3; ++x) strides_ok &= a_strides[x] % 8 == 0 && v_strides[x] % 8 == 0;
  for (int x = 0; x < 4; ++x) strides_ok &= out_strides[x] % 8 == 0;
  if (n < 1 || !tagf::takes(n, d) || d < 8 || d > 32 || d % 8 != 0 || h < tagf::kGroup ||
      h % tagf::kGroup != 0 || batch < 1 || j_chunk < 1 ||
      (hb != 8 && !(hb == 16 && tagf::takes_16_heads(n, d, h))) || !strides_ok ||
      !agg::aligned16(a) || !agg::aligned16(v) || !agg::aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)batch * (h / hb) * ((n + j_chunk - 1) / j_chunk) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const tagf::Args args{(const tmma::bf16*)a, (const tmma::bf16*)v, (tmma::bf16*)out,
                        {a_strides[0], a_strides[1], a_strides[2]},
                        {v_strides[0], v_strides[1], v_strides[2]},
                        {out_strides[0], out_strides[1], out_strides[2], out_strides[3]},
                        n, h, j_chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  const long long dh = (long long)d * h;
  const bool rows = out_strides[3] == h && out_strides[2] == dh && out_strides[1] == n * dh &&
                    out_strides[0] == n * n * dh;
  return rows ? tagf::launch_store<tagf::RowStore>(args, d, batch, hb, s)
              : tagf::launch_store<tagf::PairStore>(args, d, batch, hb, s);
}
