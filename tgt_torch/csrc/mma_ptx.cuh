// The PTX pieces of the package's bf16 tensor-core bodies for Hopper
// (sm_90a): ldmatrix (plain and transposed), stmatrix (transposed), movmatrix,
// mma.sync m16n8k16 (bf16 in, f32 sums), bf16 pair packing and cp.async; and
// what the two aggregate bodies share: the transposes of 16-byte pieces of 8
// heads into per-head panels. The triplet-attention bodies take them through
// triplet_mma.cuh; the aggregate bodies (triplet_aggregate_fwd.cu, namespace
// tagf, and triplet_aggregate_bwd.cu, namespace tagb) include this header
// alone, as they have their own f32 and bf16 load and store helpers
// (triplet_aggregate_panel.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmma {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The inverse of ldsm_x4 with the transpose: lanes 8 m..8 m + 7 give the
// row addresses of matrix m, which receives the transpose of the fragment
// r[m] (Hopper's stmatrix).
__device__ __forceinline__ void stsm_x4_t(const uint32_t (&r)[4], bf16* p) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The transpose of one 8 x 8 fragment, across the warp's registers.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// c += A (16 x 16, row) B (16 x 8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// -- per-head panels of 16-byte pieces of 8 heads --

constexpr int kPieceHeads = 8;   // bf16 heads in one 16-byte piece

// A head's panel of `rows` rows at row stride ps, padded to 8 mod 64
// elements, so that the transposes' 8 heads fall in distinct banks.
__host__ __device__ constexpr int head_stride(int rows, int ps) {
  return (rows * ps + 63) / 64 * 64 + 8;
}

// Offset of the 16-byte chunk c of row r in a head's panel of DP (8, 16, 32,
// 48 or 64) columns: the chunks are XOR-swizzled by row, so that the 8
// consecutive rows one ldmatrix or stmatrix phase touches fall in distinct
// banks with no padding.
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(DP == 8 || DP == 16 || DP == 32 || DP == 48 || DP == 64, "panel width");
  constexpr int shift = DP == 32 ? 1 : (DP == 64 ? 0 : 2);
  constexpr int mask = DP == 8 ? 0 : (DP == 32 ? 3 : (DP == 64 ? 7 : 1));
  return r * DP + ((c ^ ((r >> shift) & mask)) << 3);
}

// One group's raw pieces [rows][OCT blocks of 8 columns][8 heads, at a stride
// of HB] -> its per-head panels [row][column], by the group's 8 warps (u =
// warp in the group), 4 blocks of 8 columns by 8 heads at a time: ldmatrix
// reads a block's 8 columns as rows of 8 heads, stmatrix.trans writes its 8
// heads as rows of 8 columns, each into its head's panel (swz<DP>).
template <int DP, int OCT, int HB>
__device__ __forceinline__ void to_panels(const bf16* raw, bf16* panels, int hs, int blocks,
                                          int u, int lane) {
  for (int q0 = u * 4; q0 < blocks; q0 += kPieceHeads * 4) {
    const int mine = min(q0 + (lane >> 3), blocks - 1);   // a repeated block stores twice
    const int r = mine / OCT, c = mine - r * OCT;
    uint32_t t4[4];
    ldsm_x4(t4, raw + (mine * 8 + (lane & 7)) * HB);
    stsm_x4_t(t4, panels + (lane & 7) * hs + swz<DP>(r, c));
  }
}

}  // namespace tmma
