// Dropout masks for the torch-autograd local update: one launch fills one
// mask tensor of one minibatch step for every client.
//
// Replaces: scripts/tpu_validate_pallas.py:125 (the pallas_call in
// check_mask_statistics), whose body fills a mask with
// attackfl_tpu/ops/fused_step.py:_mask from the TPU's hardware PRNG.  Here
// the bits come from the hash of dropout_hash.cuh, with _mask's threshold
// and scale:
//
//   out[c, r, w] = mask_at(fmix32(keys[c] ^ tensor_id), r * width + w, thr, scale)
//
// which is exactly the plain version ops/fused_step.py:dropout_mask.
//
// What bounds it: it reads only the C keys and writes C * rows * width
// floats, a few integer operations per element, so bytes written bound it.
// The design does the least per byte: one kernel body for every shape, four
// consecutive elements per thread stored as one 16-byte float4 (a partial
// quad at the very end is stored element by element), grid-stride,
// neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // 16 blocks on each of the H100's SMs

// elements 4q .. 4q+3 of the flat [C * per_client] output; a quad may
// straddle two clients when per_client % 4 != 0, so the client and its key
// advance inside the quad
__global__ void __launch_bounds__(THREADS)
fill_mask(const int64_t* __restrict__ keys, float* __restrict__ out, int64_t n,
          uint32_t per_client, uint32_t tensor_id, uint32_t thr, float scale) {
  const int64_t n4 = (n + 3) / 4;
  for (int64_t q = blockIdx.x * (int64_t)THREADS + threadIdx.x; q < n4;
       q += (int64_t)gridDim.x * THREADS) {
    const int64_t i = 4 * q;
    int64_t c = i / per_client;
    uint32_t e = (uint32_t)(i - c * per_client);
    uint32_t kt = fmix32((uint32_t)keys[c] ^ tensor_id);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j, ++e) {
      if (e == per_client) {
        ++c;
        e = 0;
        if (i + j < n) kt = fmix32((uint32_t)keys[c] ^ tensor_id);
      }
      v[j] = mask_at(kt, e, thr, scale);
    }
    if (i + 4 <= n) {
      reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll   // constant indices keep v in registers
      for (int j = 0; j < 4; ++j)
        if (i + j < n) out[i + j] = v[j];
    }
  }
}

int blocks_for(int64_t items) {
  const int64_t b = (items + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// Fill out[C, rows, width] (contiguous float32, 16-byte aligned) from
// keys[C] (int64, each in [0, 2^32)).  Launches on `stream`; returns
// cudaGetLastError() of the launch.
int dropout_mask_fill(const int64_t* keys, float* out, int C, int rows, int width,
                      uint32_t tensor_id, uint32_t thr, float scale, void* stream) {
  const uint32_t per_client = (uint32_t)rows * (uint32_t)width;
  const int64_t n = (int64_t)C * per_client;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_mask<<<blocks_for((n + 3) / 4), THREADS, 0, s>>>(keys, out, n, per_client, tensor_id,
                                                      thr, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
