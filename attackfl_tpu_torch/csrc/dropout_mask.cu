// Dropout masks for the torch-autograd local update: one launch fills every
// mask tensor of one minibatch step for every client.
//
// Replaces: scripts/tpu_validate_pallas.py:125 (the pallas_call in
// check_mask_statistics), whose body fills a mask with
// attackfl_tpu/ops/fused_step.py:_mask from the TPU's hardware PRNG.  Here
// the bits come from the hash of dropout_hash.cuh, with _mask's threshold
// and scale.  Element (c, r, w) of tensor t is
//
//   mask_at(fmix32(keys[c] ^ tensor_id_t), r * width_t + w, thr_t, scale_t)
//
// which is exactly the plain version ops/fused_step.py:dropout_masks.  The
// tensors lie in one arena of floats, tensor t from quad first_quad_t on
// (ops/fused_step.py:mask_layout): every tensor starts 16-byte aligned, so
// no quad straddles two tensors.
//
// What bounds it: it reads only the C keys and writes the arena, a few
// integer operations per element, so bytes written bound it (a config-4
// step's nine tensors are 17.41 MB: 5.2 us at 3.35 TB/s).  Nine small
// launches per step (0.2-3.3 MB each) were mostly launch latency and a
// partly filled card; one launch for the step fills the card once.  The
// grid is split by tensor in proportion to its quads, each block owning
// QUADS_PER_THREAD * THREADS consecutive quads of one tensor, so a block
// finds its tensor once and no thread searches per quad.  Each thread
// hashes and stores QUADS_PER_THREAD quads, neighbouring threads on
// neighbouring 16-byte addresses, so every SM keeps many stores in flight;
// a partial quad at a tensor's end is stored element by element.  The
// arena (17.41 MB at C=100) fits the 50 MB L2, where the forward that reads
// it next finds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QUADS_PER_THREAD = 4;
constexpr uint32_t QUADS_PER_BLOCK = THREADS * QUADS_PER_THREAD;
constexpr int MAX_TENSORS = 16;

}  // namespace

// One mask tensor of the arena, as the wrapper passes it (ctypes mirrors
// this layout: ops/build.py:MaskSpec).
struct MaskSpec {
  int64_t first_quad;   // offset of the tensor in the arena, in quads
  uint32_t per_client;  // rows * width
  uint32_t tensor_id;
  uint32_t thr;
  float scale;
};

namespace {

// The kernel's one struct argument: the tensors and the first block of the
// grid that fills each (first_block[count] is the grid size).
struct MaskDescriptor {
  MaskSpec spec[MAX_TENSORS];
  uint32_t first_block[MAX_TENSORS + 1];
  int count;
};

// quad q of a tensor holds its elements 4q .. 4q+3 of the flat
// [C * per_client]; a quad may straddle two clients when per_client % 4 != 0,
// so the client and its key advance inside the quad
__device__ __forceinline__ void fill_quad(const int64_t* __restrict__ keys, float* __restrict__ out,
                                          uint32_t q, uint32_t n, const MaskSpec& s) {
  const uint32_t i = 4 * q;
  uint32_t c = i / s.per_client;
  uint32_t e = i - c * s.per_client;
  uint32_t kt = fmix32((uint32_t)keys[c] ^ s.tensor_id);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j, ++e) {
    if (e == s.per_client) {
      ++c;
      e = 0;
      if (i + j < n) kt = fmix32((uint32_t)keys[c] ^ s.tensor_id);
    }
    v[j] = mask_at(kt, e, s.thr, s.scale);
  }
  if (i + 4 <= n) {
    reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll   // constant indices keep v in registers
    for (int j = 0; j < 4; ++j)
      if (i + j < n) out[i + j] = v[j];
  }
}

__global__ void __launch_bounds__(THREADS, 8)   // 8 blocks, 2048 threads on each SM
fill_masks(const int64_t* __restrict__ keys, float* __restrict__ arena, uint32_t C,
           const MaskDescriptor d) {
  // the tensor of this block: the last whose first block is not after it
  int t = 0;
  while (t + 1 < d.count && d.first_block[t + 1] <= blockIdx.x) ++t;
  const MaskSpec s = d.spec[t];
  const uint32_t n = C * s.per_client;
  const uint32_t n4 = (n + 3) / 4;
  float* out = arena + 4 * s.first_quad;
  const uint32_t q0 = (blockIdx.x - d.first_block[t]) * QUADS_PER_BLOCK + threadIdx.x;
#pragma unroll
  for (int j = 0; j < QUADS_PER_THREAD; ++j) {
    const uint32_t q = q0 + j * THREADS;
    if (q < n4) fill_quad(keys, out, q, n, s);
  }
}

}  // namespace

extern "C" {

// Fill the masks of `count` tensors (at most 16), tensor t holding
// C * specs[t].per_client floats, into `arena` (float32, 16-byte aligned,
// laid out as specs[t].first_quad says) from keys[C] (int64, each in
// [0, 2^32)); each tensor holds fewer than 2^31 elements.  One launch on
// `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a count out of range.
int dropout_masks_fill(const int64_t* keys, float* arena, int C, const MaskSpec* specs,
                       int count, void* stream) {
  if (count < 1 || count > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  MaskDescriptor d = {};
  d.count = count;
  uint32_t blocks = 0;
  for (int t = 0; t < count; ++t) {
    d.spec[t] = specs[t];
    d.first_block[t] = blocks;
    const uint64_t n4 = ((uint64_t)C * specs[t].per_client + 3) / 4;
    blocks += (uint32_t)((n4 + QUADS_PER_BLOCK - 1) / QUADS_PER_BLOCK);
  }
  d.first_block[count] = blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_masks<<<blocks, THREADS, 0, s>>>(keys, arena, (uint32_t)C, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
