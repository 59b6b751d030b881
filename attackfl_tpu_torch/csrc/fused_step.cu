// Fused local training for the ICU TransformerModel: one launch runs one
// epoch of Adam steps for every client.
//
// Replaces: attackfl_tpu/ops/fused_step.py:_train_step_kernel (the Pallas
// TPU kernel; pallas_call at :524).  Per minibatch it computes the forward
// of both branches (input projection + GELU, seq-1 attention value/out,
// residual + LayerNorm, FFN 64->6(pad 8)->64, residual + LayerNorm, branch
// LayerNorm) and the head (128->64 GELU + dropout -> 32 GELU -> 1 sigmoid),
// the masked clipped BCE, the hand-derived backward, the global-norm clip
// over all parameter groups and bias-corrected Adam at step t_offset+j+1.
// The plain PyTorch version of the same body is run_epoch_reference in
// ops/fused_step.py; the two are held against each other on the card.
//
// Design against the TPU version:
// * One thread block per client.  The TPU's sequential minibatch grid axis
//   becomes a loop inside the block, and the global-norm clip is a
//   block-level reduction: no block ever needs another block.
// * A client's p, m and v (3 x 34,432 floats = 403.5 KiB) do not fit the
//   227 KiB of shared memory a block may use, so they stay in global
//   memory and are updated in place (the TPU kernel aliases them in->out
//   the same way); at 100 clients they are ~40 MB, inside the 50 MB L2.
//   Gradients and the forward stash live in per-client global scratch that
//   the wrapper allocates.
// * Every matrix product stages its operands in dynamic shared memory with
//   cp.async (the weight whole, the activations in chunks of MC rows, rows
//   padded by PAD floats) and computes its outputs as per-thread register
//   tiles: gemm for A @ W and A @ W^T, gemm_tn for the weight gradients
//   A^T @ dZ, which also folds in the bias gradient (the column sums of dZ).
//   The products' epilogues (bias, GELU, dropout mask, residual) are applied
//   per output as it leaves the registers.  Column sums over the batch
//   (LayerNorm dg/db, the output layer) run on all threads and meet in
//   shared memory.  The minibatch is read from global memory (it is staged
//   with the other operands by the products that take it).
// * fp32 on the CUDA cores, no TF32 and no tensor cores: the port's parity
//   tolerances are fp32 tolerances.
// * Dropout bits come from a counter-based hash (murmur3 fmix32 over seed,
//   step, client, tensor id and element index; dropout_hash.cuh) instead of
//   the TPU's hardware PRNG, with _mask's threshold and scale.
//
// What bounds it: 22.4 MFLOP of live fp32 multiply-adds per client-step
// at B=128 (ops/fused_step.py:epoch_work) against ~0.8 MB of
// parameter-state traffic, so operations, not bytes, bound the function.
// A register tile of TM x TN outputs costs TM + TN 16-byte shared loads per
// 4 k against 4 TM TN fmaf (12 loads to 128 fmaf at 8 x 4), so the products
// issue far fewer loads than fmaf.  What still holds it back: chip_smoke.py's
// split of a step by batch size puts about 40% of a step in work that does
// not grow with the rows (the clip and Adam over p, m, v and the gradients
// in L2, one 4-byte access per thread at a time; weight staging; barriers)
// and under a fifth in the forward and input-gradient tile loops; the rest
// grows with the rows (the weight-gradient loops, LayerNorms, masks, loss,
// staging, epilogues), and the split cannot part those.  One block of 8
// warps per client, so at 100 clients 32 of the 132 SMs idle and each SM
// has little to hide latency with; and every product's output goes out to
// the global scratch and is staged back in by the next one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int D = 64;
constexpr int FF = 8;
constexpr int NV = 26;
constexpr int NIN = 32;
constexpr int NCOL = 32;
constexpr int H2 = 32;        // fc2 width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// dynamic shared memory: the staged operands of one product.  The largest
// product is the head's first layer, w_h1 [128, 64] plus a 128-row chunk of cc [., 128], each row
// padded by PAD floats against bank conflicts
constexpr int PAD = 4;
constexpr int MC = 128;   // rows of a staged chunk
constexpr int SMEM_FLOATS = 2 * D * (D + PAD) + MC * (2 * D + PAD);

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);     // 1 - B1, rounded once
constexpr float OMB2 = (float)(1.0 - 0.999);   // 1 - B2, rounded once
constexpr float ADAM_EPS = 1e-8f;
constexpr float LN_EPS = 1e-6f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float P_LO = 1e-7f;
constexpr float P_HI = (float)(1.0 - 1e-7);

// vecs slots; per branch b the slot is 11 * b + S_*
constexpr int S_BD = 0, S_BV = 1, S_BO = 2, S_B1F = 3, S_B2F = 4, S_G1 = 5,
              S_BE1 = 6, S_G2 = 7, S_BE2 = 8, S_G3 = 9, S_BE3 = 10;
constexpr int S_BF1 = 22, S_BF2 = 23, S_WOUT = 24, S_BOUT = 25;
constexpr int COL_LABEL = 23, COL_MASK = 24;
// input-feature rows of each branch in the 32-column batch: vitals 0-6, labs 7-22
constexpr int IN_LO0 = 0, IN_HI0 = 7, IN_LO1 = 7, IN_HI1 = 23;

// packed groups, in GROUP_ORDER: w_in w_sq w_ff1 w_ff2 w_h1 w_h2 vecs
constexpr int N_G = 7;
constexpr int SZ_WIN = 2 * NIN * D, SZ_WSQ = 4 * D * D, SZ_WFF1 = 2 * D * FF,
              SZ_WFF2 = 2 * FF * D, SZ_WH1 = 2 * D * D, SZ_WH2 = D * H2,
              SZ_VECS = NV * D;
constexpr int OFF_WIN = 0;
constexpr int OFF_WSQ = OFF_WIN + SZ_WIN;
constexpr int OFF_WFF1 = OFF_WSQ + SZ_WSQ;
constexpr int OFF_WFF2 = OFF_WFF1 + SZ_WFF1;
constexpr int OFF_WH1 = OFF_WFF2 + SZ_WFF2;
constexpr int OFF_WH2 = OFF_WH1 + SZ_WH1;
constexpr int OFF_VECS = OFF_WH2 + SZ_WH2;
constexpr int P_TOTAL = OFF_VECS + SZ_VECS;   // 34,432 floats per client
static_assert(P_TOTAL == 34432, "packed layout drifted from the JAX package");

struct Groups {
  float* p[N_G];
  float* m[N_G];
  float* v[N_G];
};

struct Drop {
  uint32_t thr_attn, thr_block, thr_head;
  float scale_attn, scale_block, scale_head;
};

// Per-client scratch, in floats.  Branch arrays first, then the head, the
// backward temporaries and the gradients (in packed-group layout).
struct Scratch {
  float *z1[2], *x1[2], *vd[2], *xh1[2], *x2[2], *xh2[2], *xh3[2];
  float *z2[2], *hd[2], *rs1[2], *rs2[2], *rs3[2];
  float *cc, *z4, *x4d, *z5, *x5, *prob, *dz6;
  float *dz5, *dz4, *dcc, *t1, *t2, *t3, *dz2;
  float* grad;
};

__host__ __device__ inline size_t branch_floats(int B) {
  return (size_t)7 * B * D + (size_t)2 * B * FF + (size_t)3 * B;
}

__host__ __device__ inline size_t scratch_floats(int B) {
  size_t head = (size_t)B * 2 * D + 2 * (size_t)B * D + 2 * (size_t)B * H2 + 2 * (size_t)B;
  size_t temps = (size_t)B * H2 + (size_t)B * D + (size_t)B * 2 * D + 3 * (size_t)B * D
                 + (size_t)B * FF;
  size_t total = 2 * branch_floats(B) + head + temps + P_TOTAL;
  return (total + 31) & ~(size_t)31;   // keep every client's base 128-byte aligned
}

__device__ inline Scratch carve(float* s, int B) {
  Scratch S;
  for (int b = 0; b < 2; ++b) {
    float* q = s + b * branch_floats(B);
    S.z1[b] = q;  q += B * D;
    S.x1[b] = q;  q += B * D;
    S.vd[b] = q;  q += B * D;
    S.xh1[b] = q; q += B * D;
    S.x2[b] = q;  q += B * D;
    S.xh2[b] = q; q += B * D;
    S.xh3[b] = q; q += B * D;
    S.z2[b] = q;  q += B * FF;
    S.hd[b] = q;  q += B * FF;
    S.rs1[b] = q; q += B;
    S.rs2[b] = q; q += B;
    S.rs3[b] = q;
  }
  float* q = s + 2 * branch_floats(B);
  S.cc = q;   q += B * 2 * D;
  S.z4 = q;   q += B * D;
  S.x4d = q;  q += B * D;
  S.z5 = q;   q += B * H2;
  S.x5 = q;   q += B * H2;
  S.prob = q; q += B;
  S.dz6 = q;  q += B;
  S.dz5 = q;  q += B * H2;
  S.dz4 = q;  q += B * D;
  S.dcc = q;  q += B * 2 * D;
  S.t1 = q;   q += B * D;
  S.t2 = q;   q += B * D;
  S.t3 = q;   q += B * D;
  S.dz2 = q;  q += B * FF;
  S.grad = q;
  return S;
}

__device__ __forceinline__ float gelu(float x) {
  float t = tanhf(GELU_C * (x + 0.044715f * x * x * x));
  return 0.5f * x * (1.0f + t);
}

__device__ __forceinline__ float gelu_grad(float x) {
  float t = tanhf(GELU_C * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * GELU_C * (1.0f + 0.134145f * x * x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum of `v` over the block; every thread gets the result
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                    // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Asynchronous copies from global to shared memory (cp.async) of 16 or 4
// bytes: a thread issues all of its copies before any has landed.
// stage_wait() waits for every copy the thread issued, then for the block.
__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// s[r*lds + c] = g[r*ld + c] for r < rows, c < COLS (COLS % 4 == 0, lds % 4
// == 0, s 16-byte aligned), visible after stage_wait(): 16-byte copies where
// g and ld allow them, else 4-byte ones
template <int COLS>
__device__ __forceinline__ void stage(float* s, int lds, const float* g, int ld, int rows) {
  constexpr int C4 = COLS / 4;
  if (((reinterpret_cast<uintptr_t>(g) & 15) | (ld & 3)) == 0) {
    for (int i = threadIdx.x; i < rows * C4; i += THREADS) {
      const int r = i / C4, q = i - r * C4;
      copy16(s + r * lds + 4 * q, g + (size_t)r * ld + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
      const int r = i / COLS, q = i - r * COLS;
      copy4(s + r * lds + q, g + (size_t)r * ld + q);
    }
  }
}

// s[k*lds + n] = W[n*ldw + k] for n < N, k < K, visible after stage_wait():
// W [N, K] staged transposed; consecutive threads write consecutive n, so
// the stores share no bank
template <int N, int K>
__device__ __forceinline__ void stage_t(float* s, int lds, const float* W, int ldw) {
  for (int i = threadIdx.x; i < N * K; i += THREADS) {
    const int n = i % N, k = i / N;
    copy4(s + k * lds + n, W + n * ldw + k);
  }
}

// out(m, n) = epi(m, n, sum_k A[m*lda + k] * W(k, n)) for m < M, n < N, with
// W(k, n) = W[k*ldw + n] (NN: A @ W) or W[n*ldw + k] (NT: A @ W^T).
// W is staged in shared memory whole, as [K, N], and A in chunks of MCH rows;
// each thread holds a TM x TN register tile of the chunk's output and reads,
// per 4 k, TM float4 of A and TN float4 of W from shared memory.  Each output
// is one chain of fmaf over k = 0 .. K-1, the plain loop's order.
constexpr bool NN = false, NT = true;

template <int N, int K, int TM, int TN, bool WT, class Epi>
__device__ __forceinline__ void gemm(int M, const float* A, int lda, const float* W, int ldw,
                                     float* sm, Epi epi) {
  constexpr int CG = N / TN, RG = THREADS / CG, MCH = RG * TM;
  constexpr int LDW = N + PAD, LDA = K + PAD;
  static_assert(N % TN == 0 && TN % 4 == 0 && K % 4 == 0 && THREADS % CG == 0, "tile");
  static_assert(K * LDW + MCH * LDA <= SMEM_FLOATS, "shared-memory budget");
  float* sW = sm;
  float* sA = sm + K * LDW;
  if constexpr (WT)
    stage_t<N, K>(sW, LDW, W, ldw);
  else
    stage<N>(sW, LDW, W, ldw, K);
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  for (int m0 = 0; m0 < M; m0 += MCH) {
    stage<K>(sA, LDA, A + (size_t)m0 * lda, lda, min(MCH, M - m0));
    stage_wait();
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(sA + (rg * TM + i) * LDA + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 t = ld4(sW + (k + kk) * LDW + cg * TN + 4 * q);
          w[4 * q] = t.x; w[4 * q + 1] = t.y; w[4 * q + 2] = t.z; w[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(lane4(a[i], kk), w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + rg * TM + i;
      if (m < M)
#pragma unroll
        for (int j = 0; j < TN; ++j) epi(m, cg * TN + j, acc[i][j]);
    }
    __syncthreads();   // sA (and, after the last chunk, sW) may be restaged
  }
}

// Weight and bias gradients of one layer (A^T @ dZ and the column sums of dZ):
//   out[k*N + n] = sum_m A[m*lda + k] * Dz[m*ldd + n] for klo <= k < khi, and
//                  exactly zero for the other k;
//   bias[n]      = sum_m Dz[m*ldd + n] for n < N, zero for N <= n < D.
// Chunks of MC rows of A and Dz are staged in shared memory.  Each thread
// holds a TK x TN register tile of out and walks every R-th row of the chunk,
// R = THREADS / (tiles of out), reading TK/4 + TN/4 float4 per row; for the
// bias it sums one column over every (THREADS/N)-th row.  The R partial
// tiles and the bias's row slices are added up in shared memory at the end.
template <int K, int N, int TK, int TN>
__device__ __forceinline__ void gemm_tn(int M, const float* A, int lda, const float* Dz, int ldd,
                                        float* out, float* bias, float* sm, int klo = 0,
                                        int khi = K) {
  constexpr int CG = N / TN, G = (K / TK) * CG, R = THREADS / G, S = THREADS / N;
  constexpr int LDA = K + PAD, LDD = N + PAD;
  static_assert(K % TK == 0 && N % TN == 0 && TK % 4 == 0 && TN % 4 == 0, "tile");
  static_assert(THREADS % G == 0 && THREADS % N == 0 && N <= D, "tile");
  static_assert(MC * (LDA + LDD) <= SMEM_FLOATS && R * K * N + THREADS <= SMEM_FLOATS,
                "shared-memory budget");
  float* sA = sm;
  float* sD = sm + MC * LDA;
  const int tid = threadIdx.x, g = tid % G, r = tid / G, cg = g % CG, kg = g / CG;
  float acc[TK][TN];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float bsum = 0.0f;
  for (int m0 = 0; m0 < M; m0 += MC) {
    const int rows = min(MC, M - m0);
    stage<K>(sA, LDA, A + (size_t)m0 * lda, lda, rows);
    stage<N>(sD, LDD, Dz + (size_t)m0 * ldd, ldd, rows);
    stage_wait();
    for (int m = r; m < rows; m += R) {
      float a[TK], d[TN];
#pragma unroll
      for (int q = 0; q < TK / 4; ++q) {
        const float4 t = ld4(sA + m * LDA + kg * TK + 4 * q);
        a[4 * q] = t.x; a[4 * q + 1] = t.y; a[4 * q + 2] = t.z; a[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 t = ld4(sD + m * LDD + cg * TN + 4 * q);
        d[4 * q] = t.x; d[4 * q + 1] = t.y; d[4 * q + 2] = t.z; d[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
    }
    for (int m = tid / N; m < rows; m += S) bsum += sD[m * LDD + tid % N];
    __syncthreads();
  }
  float* red = sm;   // [R][K][N] partial tiles, then [S][N] bias slices
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) red[(r * K + kg * TK + i) * N + cg * TN + j] = acc[i][j];
  red[R * K * N + tid] = bsum;
  __syncthreads();
  for (int idx = tid; idx < K * N; idx += THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) s += red[q * K * N + idx];
    const int k = idx / N;
    out[idx] = (k >= klo && k < khi) ? s : 0.0f;
  }
  for (int n = tid; n < D; n += THREADS) {
    float s = 0.0f;
    if (n < N)
#pragma unroll
      for (int q = 0; q < S; ++q) s += red[R * K * N + q * N + n];
    bias[n] = s;
  }
  __syncthreads();
}

// LayerNorm forward over rows of width D, one warp per row:
// xhat = (r - mu) * rstd, y = xhat * g + be
__device__ void ln_fwd(int B, const float* r, int ldr, const float* g, const float* be,
                       float* xhat, float* rstd, float* y, int ldy) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < B; m += WARPS) {
    const float a = r[(size_t)m * ldr + lane], b = r[(size_t)m * ldr + lane + 32];
    const float mu = warp_sum(a + b) * (1.0f / D);
    const float da = a - mu, db = b - mu;
    const float var = warp_sum(da * da + db * db) * (1.0f / D);
    const float rs = rsqrtf(var + LN_EPS);
    const float ha = da * rs, hb = db * rs;
    xhat[m * D + lane] = ha;
    xhat[m * D + lane + 32] = hb;
    y[(size_t)m * ldy + lane] = ha * g[lane] + be[lane];
    y[(size_t)m * ldy + lane + 32] = hb * g[lane + 32] + be[lane + 32];
    if (lane == 0) rstd[m] = rs;
  }
}

// out0[n] = sum_m s0 and out1[n] = sum_m s1 for n < D, where f(m, n, s0, s1)
// adds row m's terms of column n: THREADS / D row groups of D columns, then
// a reduction of the groups' partial sums in shared memory (red, 2 THREADS)
template <class F>
__device__ __forceinline__ void col_sums(int M, F f, float* out0, float* out1, float* red) {
  constexpr int Q = THREADS / D;
  const int n = threadIdx.x % D;
  float s0 = 0.0f, s1 = 0.0f;
  for (int m = threadIdx.x / D; m < M; m += Q) f(m, n, s0, s1);
  red[threadIdx.x] = s0;
  red[THREADS + threadIdx.x] = s1;
  __syncthreads();
  if (threadIdx.x < D) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      a += red[q * D + n];
      b += red[THREADS + q * D + n];
    }
    out0[n] = a;
    out1[n] = b;
  }
  __syncthreads();
}

// LayerNorm backward: dx rows (one warp per row), then dg = sum dy*xhat and
// db = sum dy over rows into the vecs-gradient rows.
__device__ void ln_bwd(int B, const float* dy, int lddy, const float* xhat, const float* rstd,
                       const float* g, float* dx, float* dg, float* db, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < B; m += WARPS) {
    const float ya = dy[(size_t)m * lddy + lane], yb = dy[(size_t)m * lddy + lane + 32];
    const float ha = xhat[m * D + lane], hb = xhat[m * D + lane + 32];
    const float ga = ya * g[lane], gb = yb * g[lane + 32];
    const float mean1 = warp_sum(ga + gb) * (1.0f / D);
    const float mean2 = warp_sum(ga * ha + gb * hb) * (1.0f / D);
    const float rs = rstd[m];
    dx[m * D + lane] = (ga - mean1 - ha * mean2) * rs;
    dx[m * D + lane + 32] = (gb - mean1 - hb * mean2) * rs;
  }
  col_sums(B, [&](int m, int n, float& sg, float& sb) {
    const float y = dy[(size_t)m * lddy + n];
    sg = fmaf(y, xhat[m * D + n], sg);
    sb += y;
  }, dg, db, red);
}

__global__ void __launch_bounds__(THREADS)
train_epoch_kernel(Groups grp, const float* __restrict__ batches, float* __restrict__ loss_out,
                   float* __restrict__ scratch, int nb, int B,
                   const long long* __restrict__ seed_ptr, int seed_offset, int t_offset,
                   int client_base, float lr, float clip, Drop drop) {
  __shared__ float red[WARPS];
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int sizes[N_G] = {SZ_WIN, SZ_WSQ, SZ_WFF1, SZ_WFF2, SZ_WH1, SZ_WH2, SZ_VECS};
  const int offs[N_G] = {OFF_WIN, OFF_WSQ, OFF_WFF1, OFF_WFF2, OFF_WH1, OFF_WH2, OFF_VECS};

  const float* w_in = grp.p[0] + (size_t)c * SZ_WIN;
  const float* w_sq = grp.p[1] + (size_t)c * SZ_WSQ;
  const float* w_ff1 = grp.p[2] + (size_t)c * SZ_WFF1;
  const float* w_ff2 = grp.p[3] + (size_t)c * SZ_WFF2;
  const float* w_h1 = grp.p[4] + (size_t)c * SZ_WH1;
  const float* w_h2 = grp.p[5] + (size_t)c * SZ_WH2;
  const float* vecs = grp.p[6] + (size_t)c * SZ_VECS;

  Scratch S = carve(scratch + (size_t)c * scratch_floats(B), B);
  float* gw_in = S.grad + OFF_WIN;
  float* gw_sq = S.grad + OFF_WSQ;
  float* gw_ff1 = S.grad + OFF_WFF1;
  float* gw_ff2 = S.grad + OFF_WFF2;
  float* gw_h1 = S.grad + OFF_WH1;
  float* gw_h2 = S.grad + OFF_WH2;
  float* gvecs = S.grad + OFF_VECS;

  // the epoch's dropout seed, read from device memory: the low 32 bits of
  // seed + seed_offset, as the wrapper's int64 hash takes them
  const uint32_t seed = (uint32_t)(unsigned long long)(*seed_ptr + seed_offset);
  float loss_acc = 0.0f;

  for (int j = 0; j < nb; ++j) {
    const float* data = batches + ((size_t)c * nb + j) * B * NCOL;
    const uint32_t step = (uint32_t)(t_offset + j);
    // the dropout key of the GLOBAL client: a shard's client c is client
    // client_base + c of the unsharded launch, and draws its masks
    const uint32_t kc = client_key(seed, step, (uint32_t)(client_base + c));

    // ---------------- forward ----------------
    for (int b = 0; b < 2; ++b) {
      const int base = 11 * b;
      const uint32_t k_mw = fmix32(kc ^ (T_MW + 4 * b)), k_m1 = fmix32(kc ^ (T_M1 + 4 * b));
      const uint32_t k_mf = fmix32(kc ^ (T_MF + 4 * b)), k_m2 = fmix32(kc ^ (T_M2 + 4 * b));
      float* z1 = S.z1[b];
      float* x1 = S.x1[b];
      float* vd = S.vd[b];
      // z1 = data @ w_in[b] + bd ; x1 = gelu(z1)
      {
        const float* bias = vecs + (base + S_BD) * D;
        gemm<D, NCOL, 8, 4, NN>(
            B, data, NCOL, w_in + b * NIN * D, D, sm, [&](int m, int n, float acc) {
              const float z = acc + bias[n];
              z1[m * D + n] = z;
              x1[m * D + n] = gelu(z);
            });
      }
      __syncthreads();
      // vd = (x1 @ w_v + bv) * mw
      {
        const float* bias = vecs + (base + S_BV) * D;
        gemm<D, D, 8, 4, NN>(B, x1, D, w_sq + (2 * b) * D * D, D, sm, [&](int m, int n, float acc) {
          vd[m * D + n] = (acc + bias[n]) *
                          mask_at(k_mw, m * D + n, drop.thr_attn, drop.scale_attn);
        });
      }
      __syncthreads();
      // r1 = x1 + (vd @ w_o + bo) * m1   -> t1
      {
        const float* bias = vecs + (base + S_BO) * D;
        gemm<D, D, 8, 4, NN>(
            B, vd, D, w_sq + (2 * b + 1) * D * D, D, sm, [&](int m, int n, float acc) {
              S.t1[m * D + n] = x1[m * D + n] + (acc + bias[n]) *
                                mask_at(k_m1, m * D + n, drop.thr_block, drop.scale_block);
            });
      }
      __syncthreads();
      ln_fwd(B, S.t1, D, vecs + (base + S_G1) * D, vecs + (base + S_BE1) * D, S.xh1[b],
             S.rs1[b], S.x2[b], D);
      __syncthreads();
      // z2 = x2 @ w_ff1[b] + b1f ; hd = gelu(z2) * mf
      {
        const float* bias = vecs + (base + S_B1F) * D;
        float* z2 = S.z2[b];
        float* hd = S.hd[b];
        gemm<FF, D, 1, 4, NN>(
            B, S.x2[b], D, w_ff1 + b * D * FF, FF, sm, [&](int m, int n, float acc) {
              const float z = acc + bias[n];
              z2[m * FF + n] = z;
              hd[m * FF + n] =
                  gelu(z) * mask_at(k_mf, m * FF + n, drop.thr_block, drop.scale_block);
            });
      }
      __syncthreads();
      // r2 = x2 + (hd @ w_ff2[b] + b2f) * m2   -> t1
      {
        const float* bias = vecs + (base + S_B2F) * D;
        const float* x2 = S.x2[b];
        gemm<D, FF, 8, 4, NN>(
            B, S.hd[b], FF, w_ff2 + b * FF * D, D, sm, [&](int m, int n, float acc) {
              S.t1[m * D + n] = x2[m * D + n] + (acc + bias[n]) *
                                mask_at(k_m2, m * D + n, drop.thr_block, drop.scale_block);
            });
      }
      __syncthreads();
      ln_fwd(B, S.t1, D, vecs + (base + S_G2) * D, vecs + (base + S_BE2) * D, S.xh2[b],
             S.rs2[b], S.t2, D);
      __syncthreads();
      // branch LayerNorm straight into its half of the concatenated head input
      ln_fwd(B, S.t2, D, vecs + (base + S_G3) * D, vecs + (base + S_BE3) * D, S.xh3[b],
             S.rs3[b], S.cc + b * D, 2 * D);
      __syncthreads();
    }

    const uint32_t k_m4 = fmix32(kc ^ T_M4);
    // z4 = cc @ w_h1 + bf1 ; x4d = gelu(z4) * m4
    {
      const float* bias = vecs + S_BF1 * D;
      gemm<D, 2 * D, 8, 4, NN>(B, S.cc, 2 * D, w_h1, D, sm, [&](int m, int n, float acc) {
        const float z = acc + bias[n];
        S.z4[m * D + n] = z;
        S.x4d[m * D + n] = gelu(z) * mask_at(k_m4, m * D + n, drop.thr_head, drop.scale_head);
      });
    }
    __syncthreads();
    // z5 = x4d @ w_h2 + bf2 ; x5 = gelu(z5)
    {
      const float* bias = vecs + S_BF2 * D;
      gemm<H2, D, 4, 4, NN>(B, S.x4d, D, w_h2, H2, sm, [&](int m, int n, float acc) {
        const float z = acc + bias[n];
        S.z5[m * H2 + n] = z;
        S.x5[m * H2 + n] = gelu(z);
      });
    }
    __syncthreads();

    // prob, masked BCE (one thread per row), then the block sums
    const float* wo = vecs + S_WOUT * D;
    float lsum = 0.0f, msum_part = 0.0f;
    for (int m = tid; m < B; m += THREADS) {
      float z6 = 0.0f;
      for (int k = 0; k < H2; ++k) z6 = fmaf(S.x5[m * H2 + k], wo[k], z6);
      z6 += vecs[S_BOUT * D];
      const float prob = 1.0f / (1.0f + expf(-z6));
      S.prob[m] = prob;
      const float pc = fminf(fmaxf(prob, P_LO), P_HI);
      const float y = data[m * NCOL + COL_LABEL], msk = data[m * NCOL + COL_MASK];
      const float per = -(y * logf(pc) + (1.0f - y) * logf(1.0f - pc));
      lsum += per * msk;
      msum_part += msk;
    }
    const float lsum_all = block_sum(lsum, red);
    const float msum = fmaxf(block_sum(msum_part, red), 1.0f);
    loss_acc += lsum_all / msum;

    // ---------------- backward ----------------
    for (int m = tid; m < B; m += THREADS) {
      const float prob = S.prob[m];
      const float pc = fminf(fmaxf(prob, P_LO), P_HI);
      const float y = data[m * NCOL + COL_LABEL], msk = data[m * NCOL + COL_MASK];
      const float within = (prob > P_LO && prob < P_HI) ? 1.0f : 0.0f;
      const float dpc = msk * (pc - y) / (pc * (1.0f - pc)) / msum;
      S.dz6[m] = dpc * within * prob * (1.0f - prob);
    }
    __syncthreads();
    // g_wout, g_bout (vecs rows, zero-padded) and dz5 = dz6 * wo * gelu'(z5)
    col_sums(B, [&](int m, int n, float& sw, float& sb) {
      if (n < H2) sw = fmaf(S.x5[m * H2 + n], S.dz6[m], sw);
      if (n == 0) sb += S.dz6[m];
    }, gvecs + S_WOUT * D, gvecs + S_BOUT * D, sm);
    for (int idx = tid; idx < B * H2; idx += THREADS) {
      const int m = idx / H2, n = idx - m * H2;
      S.dz5[idx] = S.dz6[m] * wo[n] * gelu_grad(S.z5[idx]);
    }
    __syncthreads();
    gemm_tn<D, H2, 4, 4>(B, S.x4d, D, S.dz5, H2, gw_h2, gvecs + S_BF2 * D, sm);
    // dz4 = (dz5 @ w_h2^T) * m4 * gelu'(z4)
    gemm<D, H2, 8, 4, NT>(B, S.dz5, H2, w_h2, H2, sm, [&](int m, int k, float acc) {
      S.dz4[m * D + k] = acc * mask_at(k_m4, m * D + k, drop.thr_head, drop.scale_head) *
                         gelu_grad(S.z4[m * D + k]);
    });
    __syncthreads();
    gemm_tn<2 * D, D, 8, 4>(B, S.cc, 2 * D, S.dz4, D, gw_h1, gvecs + S_BF1 * D, sm);
    // dcc = dz4 @ w_h1^T
    gemm<2 * D, D, 8, 8, NT>(B, S.dz4, D, w_h1, D, sm,
                             [&](int m, int k, float acc) { S.dcc[m * 2 * D + k] = acc; });
    __syncthreads();

    for (int b = 0; b < 2; ++b) {
      const int base = 11 * b;
      const uint32_t k_mw = fmix32(kc ^ (T_MW + 4 * b)), k_m1 = fmix32(kc ^ (T_M1 + 4 * b));
      const uint32_t k_mf = fmix32(kc ^ (T_MF + 4 * b)), k_m2 = fmix32(kc ^ (T_M2 + 4 * b));
      // branch LayerNorm, then the FFN LayerNorm:  dx3 -> t1, dr2 -> t2
      ln_bwd(B, S.dcc + b * D, 2 * D, S.xh3[b], S.rs3[b], vecs + (base + S_G3) * D, S.t1,
             gvecs + (base + S_G3) * D, gvecs + (base + S_BE3) * D, sm);
      __syncthreads();
      ln_bwd(B, S.t1, D, S.xh2[b], S.rs2[b], vecs + (base + S_G2) * D, S.t2,
             gvecs + (base + S_G2) * D, gvecs + (base + S_BE2) * D, sm);
      __syncthreads();
      // dyf = dr2 * m2 -> t3
      for (int idx = tid; idx < B * D; idx += THREADS)
        S.t3[idx] = S.t2[idx] * mask_at(k_m2, idx, drop.thr_block, drop.scale_block);
      __syncthreads();
      gemm_tn<FF, D, 4, 4>(B, S.hd[b], FF, S.t3, D, gw_ff2 + b * FF * D,
                           gvecs + (base + S_B2F) * D, sm);
      // dz2 = (dyf @ w_ff2[b]^T) * mf * gelu'(z2)
      {
        const float* z2 = S.z2[b];
        gemm<FF, D, 1, 4, NT>(B, S.t3, D, w_ff2 + b * FF * D, D, sm, [&](int m, int k, float acc) {
          S.dz2[m * FF + k] = acc * mask_at(k_mf, m * FF + k, drop.thr_block, drop.scale_block) *
                              gelu_grad(z2[m * FF + k]);
        });
      }
      __syncthreads();
      gemm_tn<D, FF, 4, 4>(B, S.x2[b], D, S.dz2, FF, gw_ff1 + b * D * FF,
                           gvecs + (base + S_B1F) * D, sm);
      // dx2 = dr2 + dz2 @ w_ff1[b]^T -> t1
      gemm<D, FF, 8, 4, NT>(B, S.dz2, FF, w_ff1 + b * D * FF, FF, sm, [&](int m, int k, float acc) {
        S.t1[m * D + k] = S.t2[m * D + k] + acc;
      });
      __syncthreads();
      // attention LayerNorm: dr1 -> t2
      ln_bwd(B, S.t1, D, S.xh1[b], S.rs1[b], vecs + (base + S_G1) * D, S.t2,
             gvecs + (base + S_G1) * D, gvecs + (base + S_BE1) * D, sm);
      __syncthreads();
      // da = dr1 * m1 -> t3
      for (int idx = tid; idx < B * D; idx += THREADS)
        S.t3[idx] = S.t2[idx] * mask_at(k_m1, idx, drop.thr_block, drop.scale_block);
      __syncthreads();
      gemm_tn<D, D, 4, 4>(B, S.vd[b], D, S.t3, D, gw_sq + (2 * b + 1) * D * D,
                          gvecs + (base + S_BO) * D, sm);
      // dv = (da @ w_o^T) * mw -> t1
      gemm<D, D, 8, 4, NT>(
          B, S.t3, D, w_sq + (2 * b + 1) * D * D, D, sm, [&](int m, int k, float acc) {
            S.t1[m * D + k] = acc * mask_at(k_mw, m * D + k, drop.thr_attn, drop.scale_attn);
          });
      __syncthreads();
      gemm_tn<D, D, 4, 4>(B, S.x1[b], D, S.t1, D, gw_sq + (2 * b) * D * D,
                          gvecs + (base + S_BV) * D, sm);
      // dz1 = (dr1 + dv @ w_v^T) * gelu'(z1) -> t3
      {
        const float* z1 = S.z1[b];
        gemm<D, D, 8, 4, NT>(
            B, S.t1, D, w_sq + (2 * b) * D * D, D, sm, [&](int m, int k, float acc) {
              S.t3[m * D + k] = (S.t2[m * D + k] + acc) * gelu_grad(z1[m * D + k]);
            });
      }
      __syncthreads();
      // input projection: only the branch's own rows train; the rest of the
      // padded [32, D] matrix (other branch, label, mask) gets exactly zero
      gemm_tn<NIN, D, 4, 4>(B, data, NCOL, S.t3, D, gw_in + b * NIN * D,
                            gvecs + (base + S_BD) * D, sm, b == 0 ? IN_LO0 : IN_LO1,
                            b == 0 ? IN_HI0 : IN_HI1);
    }

    // ---------------- clip + Adam ----------------
    float part = 0.0f;
    for (int i = tid; i < P_TOTAL; i += THREADS) part = fmaf(S.grad[i], S.grad[i], part);
    const float gn2 = block_sum(part, red);
    float scale = 1.0f;
    if (clip > 0.0f) scale = fminf(1.0f, clip / fmaxf(sqrtf(gn2), 1e-12f));
    const int t = t_offset + j + 1;
    const float bc1 = (float)(1.0 - pow(0.9, (double)t));
    const float bc2 = (float)(1.0 - pow(0.999, (double)t));
    for (int g = 0; g < N_G; ++g) {
      float* P = grp.p[g] + (size_t)c * sizes[g];
      float* Mo = grp.m[g] + (size_t)c * sizes[g];
      float* V = grp.v[g] + (size_t)c * sizes[g];
      const float* G = S.grad + offs[g];
      for (int i = tid; i < sizes[g]; i += THREADS) {
        const float gi = G[i] * scale;
        const float m_new = B1 * Mo[i] + OMB1 * gi;
        const float v_new = B2 * V[i] + OMB2 * (gi * gi);
        Mo[i] = m_new;
        V[i] = v_new;
        P[i] = P[i] - lr * (m_new / bc1) / (sqrtf(v_new / bc2) + ADAM_EPS);
      }
    }
    // the next step's forward reads the updated parameters
    __syncthreads();
  }
  if (tid == 0) loss_out[c] = loss_acc;
}

}  // namespace

extern "C" {

// floats of per-client scratch the wrapper must allocate at batch size B
int fused_step_scratch_floats(int B) { return (int)scratch_floats(B); }

// One epoch for C clients.  ptrs: 21 device pointers, the packed groups of
// p, then m, then v, each in GROUP_ORDER, each [C, ...] contiguous float32.
// batches [C, nb, B, 32], loss [C], scratch C * fused_step_scratch_floats(B).
// seed: one int64 in device memory; the epoch's dropout seed is its value
// plus seed_offset, so a seed drawn on the device never visits the host.
// client_base: the global index of the first client (a mesh shard's block
// starts there; 0 for an unsharded launch), which keys the dropout hash.
// Launches on `stream`; returns cudaGetLastError() of the launch.
int fused_step_run_epoch(void* const* ptrs, const float* batches, float* loss, float* scratch,
                         int C, int nb, int B, const long long* seed, int seed_offset,
                         int t_offset, int client_base, float lr, float clip,
                         uint32_t thr_attn, float scale_attn, uint32_t thr_block,
                         float scale_block, uint32_t thr_head, float scale_head, void* stream) {
  Groups grp;
  for (int g = 0; g < N_G; ++g) {
    grp.p[g] = static_cast<float*>(ptrs[g]);
    grp.m[g] = static_cast<float*>(ptrs[N_G + g]);
    grp.v[g] = static_cast<float*>(ptrs[2 * N_G + g]);
  }
  Drop drop{thr_attn, thr_block, thr_head, scale_attn, scale_block, scale_head};
  constexpr int smem = SMEM_FLOATS * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      train_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  train_epoch_kernel<<<C, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      grp, batches, loss, scratch, nb, B, seed, seed_offset, t_offset, client_base, lr, clip,
      drop);
  return (int)cudaGetLastError();
}

}  // extern "C"
