// The port's dropout bits: a counter-based hash shared by every kernel that
// draws a dropout mask (fused_step.cu, dropout_mask.cu), so that all of them
// draw from one definition.
//
// It replaces the TPU's hardware PRNG behind attackfl_tpu/ops/fused_step.py:
// _mask.  Each mask element gets its 32 random bits from murmur3's fmix32
// chained over (seed, step, client) -> the client's key, then the tensor id,
// then the element index; _mask's rule is kept: keep if bits >=
// min(int(rate * 2^32), 2^32 - 1), scale kept elements by 1 / (1 - rate).
// The plain PyTorch version (ops/fused_step.py: fmix32, client_keys,
// dropout_mask) repeats every step exactly in int64 arithmetic.
//
// The multiplies must wrap at 32 bits, which uint32_t arithmetic does.

#pragma once

#include <stdint.h>

constexpr uint32_t GOLDEN = 0x9E3779B9u;

// Tensor ids of the fused kernel's masks (per branch b: + 4 * b).  The
// torch-autograd local update (training/local.py) draws its masks with ids
// from 16 up, so the two paths never share a mask.
constexpr uint32_t T_MW = 0, T_M1 = 1, T_MF = 2, T_M2 = 3, T_M4 = 8;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the key of one client at one step: ops/fused_step.py:client_keys
__host__ __device__ __forceinline__ uint32_t client_key(uint32_t seed, uint32_t step,
                                                        uint32_t client) {
  return fmix32(fmix32(fmix32(seed ^ GOLDEN) ^ step) ^ client);
}

// mask value of element `elem` of the tensor keyed `kt` (= fmix32(key ^ id))
__host__ __device__ __forceinline__ float mask_at(uint32_t kt, uint32_t elem, uint32_t thr,
                                                  float scale) {
  if (thr == 0u) return scale;   // rate 0: keep everything, scale 1
  return fmix32(kt ^ elem) >= thr ? scale : 0.0f;
}
