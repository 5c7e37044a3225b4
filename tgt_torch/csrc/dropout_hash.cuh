// The stateless triplet-dropout hash, the device counterpart of
// tgt_tpu/ops/pallas/triplet_dense.py:_hash_keepf (and of hash_keep in
// tgt_torch/ops/kernels/triplet_dense.py, which the CPU tests hold bit for bit
// against it).
//
// murmur3's 32-bit finalizer over lin * 0x9E3779B9 + seed, with wrapping
// 32-bit multiplies and logical shifts: uint32_t arithmetic gives the bits of
// the TPU kernel's wrapping int32 multiplies and shift_right_logical. The
// low 31 bits below `thresh` keep the element, which is then scaled by
// `scale`; the wrapper computes both from the rate in double precision, as the
// TPU kernel does (thresh = min(int((1 - rate) * 2^31), 2^31 - 1), scale =
// float32(1 / (1 - rate))).
//
// `lin` is the element's index (j*n + i)*(n*H) + k*H + h in the core's own
// (j, i, k, h) frame, `seed` its batch row's seed. A pure function of the two,
// so the backward rebuilds the forward's mask and no mask reaches memory.
#pragma once

#include <stdint.h>

static __device__ __forceinline__ float dropout_keep(uint32_t lin, uint32_t seed,
                                                     uint32_t thresh, float scale) {
  uint32_t x = lin * 0x9E3779B9u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & 0x7FFFFFFFu) < thresh ? scale : 0.f;
}
