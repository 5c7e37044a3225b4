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
// in f32, whatever the storage type (f32 or bf16).
//
// Bound on the H100: at b=16, N=48, edge width 256, H=16, d=16 in bf16 the
// function reads A (1.18 MB), V and dva (2 x 18.87 MB) and writes dA
// (1.18 MB) and dV (18.87 MB): 59.0 MB, 17.6 us at 3.35 TB/s. Its two
// products, 4 N^3 d H flops per batch row (1.81 GFLOP), take 1.8 us at the
// bf16 tensor-core peak. So it is bound by device memory; at the training
// micro-batch (b=32) both double (35.2 us).
//
// Design (simple and right first; wgmma/TMA are later work). The TPU kernel
// sums dA over j on a sequential ("arbitrary") grid axis; Hopper's blocks run
// in no order, and float atomics would make the sum depend on that order. So
// each output is written by one thread from sums in a fixed order (two
// launches on the same inputs give bitwise equal outputs), in three kernels:
//  1. agg_da_kernel: one block per (b, tile of 8 rows i, chunk of 256
//     (k, h) columns, chunk of j_chunk rows j). It loops over its j in
//     order; per j it stages the rows of V[b,j] its columns need and the 8
//     rows of dva[b,j] in shared memory as f32 (dva laid out (d, h, row),
//     padded, as the forward lays out its weights), and each thread adds
//     sum_d dva V into 8 registers. It writes one f32 partial sum per chunk
//     of j to a workspace. Splitting j gives N/j_chunk times more blocks
//     than one loop over all j, so the card has enough warps to hide the
//     loads of each step.
//  2. agg_da_reduce_kernel: dA = the partial sums added in chunk order,
//     cast to A's type.
//  3. dV: one block per (b, j), the forward's panel loop
//     (triplet_aggregate_panel.cuh: tensor cores in bf16, CUDA cores in
//     f32) with A transposed and dva as the panel.
#include "triplet_aggregate_panel.cuh"

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

// dtype: 0 = float32, 1 = bfloat16. a: (b, i, k, h) contiguous; v: (b, j, k,
// d, h) with (d, h) contiguous and the element strides of its three outer
// axes in strides[0..2]; dva: (b, j, i, d, h) contiguous. Writes da (b, i, k,
// h) and dv (b, j, k, d, h), both contiguous. workspace holds
// ceil(n / j_chunk) * b * n * n * h floats (the partial sums of dA).
// Returns cudaGetLastError() after the launches.
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
