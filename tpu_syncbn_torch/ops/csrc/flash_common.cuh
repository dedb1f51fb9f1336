// Shared code of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkdv.cu, flash_bwd_dq.cu): tile sizes, the 16-byte tile loader,
// output stores, launch parameters, and the warp-level matrix product of
// the float32 kernels: the 16x8x16 product of mma.sync.m16n8k16 in f32 on
// the CUDA cores, each thread computing exactly the accumulator elements
// mma.sync would hand it. Accumulator layout of a 16x8 tile c[4] in a warp
// (lane = 4*g + t): c[0], c[1] hold row g, columns 2t and 2t+1; c[2], c[3]
// hold row g+8, the same columns. The bf16 kernels are the Hopper designs
// of hopper.cuh, whose wgmma accumulators hand each thread the same rows
// and columns, so they share store_rows.
//
// Operands of the float32 kernels live in shared memory. Rows are padded
// by 16 bytes, so the fragment loads of a warp fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

// rows of the block's own tile and of the streamed tile; each of the block's
// WARPS warps owns 16 rows of its own tile
constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int WARPS = BLOCK_M / 16;
constexpr int THREADS = WARPS * 32;

// finite stand-in for -inf in masked logits, as the JAX package's NEG_BIG
// (-0.7 * float32 max): a fully masked tile keeps the running max finite
constexpr float NEG_BIG = -0.7f * 3.402823466e38f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared-memory row padding: 16 bytes
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };

// Copy rows [row0, row0 + ROWS) of one (batch, head) slab into shared memory
// s[ROWS][LD], 16 bytes a thread: rows >= L and columns >= d are zero-filled,
// so ragged ends need no padding in device memory. g points at (row 0,
// column 0) of the slab; rstride is the distance between rows in elements.
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile(T* s, const T* g, int64_t rstride,
                                          int row0, int L, int d) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = DP / EPC;        // chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * EPC;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L && c < d)
      val = *reinterpret_cast<const uint4*>(g + (int64_t)row * rstride + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// Copy n f32 row values (logsumexp or delta) starting at row0; rows >= L
// read as 0 (their entries are masked wherever they are used).
__device__ __forceinline__ void load_rows(float* s, const float* g, int row0,
                                          int L, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS)
    s[i] = row0 + i < L ? g[row0 + i] : 0.f;
}

// Two adjacent values of one row, stored in T.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// c (16x8) += a (16x16) * B (16x8). A is row-major in shared memory; B is
// read from x either transposed (NN = false: B(k, n) = x[n * ld + k], a
// K or Q tile read as K^T) or as is (NN = true: B(k, n) = x[k * ld + n]).
template <typename T> struct Mma;

template <> struct Mma<float> {
  struct A { float lo[16], hi[16]; };  // rows g and g + 8, all 16 columns

  __device__ __forceinline__ static void load_a(A& a, const float* p, int ld) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      a.lo[k] = p[g * ld + k];
      a.hi[k] = p[(g + 8) * ld + k];
    }
  }

  template <bool NN>
  __device__ __forceinline__ static void mma(float c[4], const A& a,
                                             const float* x, int ld) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float b0 = NN ? x[k * ld + 2 * t] : x[(2 * t) * ld + k];
      const float b1 = NN ? x[k * ld + 2 * t + 1] : x[(2 * t + 1) * ld + k];
      c[0] = fmaf(a.lo[k], b0, c[0]);
      c[1] = fmaf(a.lo[k], b1, c[1]);
      c[2] = fmaf(a.hi[k], b0, c[2]);
      c[3] = fmaf(a.hi[k], b1, c[3]);
    }
  }
};

// One warp: C[16 x 8NT] += A[16 x 16KT] * B[16KT x 8NT] (see Mma for the
// two ways B is read from x). The f32 path keeps its k loop rolled: fully
// unrolled it multiplies the build time for no gain on the CUDA cores.
template <typename T, int KT, int NT, bool NN>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* a_ptr,
                                          int lda, const T* x, int ldx) {
#pragma unroll(sizeof(T) == 2 ? KT : 1)
  for (int kk = 0; kk < KT; ++kk) {
    typename Mma<T>::A a;
    Mma<T>::load_a(a, a_ptr + kk * 16, lda);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* xb = NN ? x + (kk * 16) * ldx + nt * 8 : x + (nt * 8) * ldx + kk * 16;
      Mma<T>::template mma<NN>(c[nt], a, xb, ldx);
    }
  }
}

// Store a warp's 16 x 8NT accumulator tile into shared memory s (row-major,
// ld elements a row), rounded to T: the A operand of the next product.
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* s, int ld, const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    store2(s + g * ld + nt * 8 + 2 * t, c[nt][0], c[nt][1]);
    store2(s + (g + 8) * ld + nt * 8 + 2 * t, c[nt][2], c[nt][3]);
  }
}

// Write rows r0 and r0 + 8 of a warp's 16 x DP accumulator tile, times mul0
// and mul1, to an output slab o (row stride rs), skipping rows >= L and
// columns >= d.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* o, int64_t rs, int r0, int L,
                                           int d, const float (&c)[NT][4],
                                           float mul0, float mul1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col >= d) continue;
    if (r0 < L) store2(o + (int64_t)r0 * rs + col, c[nt][0] * mul0, c[nt][1] * mul0);
    if (r0 + 8 < L)
      store2(o + (int64_t)(r0 + 8) * rs + col, c[nt][2] * mul1, c[nt][3] * mul1);
  }
}

// Let `kernel` use `bytes` of dynamic shared memory (above 48 KB a launch
// without this is refused), once per device: the attribute is per device,
// and calling it once keeps it out of the launches a CUDA graph captures.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes,
                                      bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Head dims the kernels are built for: d is zero-padded up to one of these.
inline int padded_head_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0;
}

// Strides, in elements, of one (B, L, H, D) operand: batch, row, head.
struct Strides {
  int64_t b, r, h;
};

inline Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Arguments of the two backward kernels (each fills the gradients it makes).
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sg;  // sg: the gradients' (shared) strides
  int H, L, d;
  float scale;
};

inline BwdParams bwd_params(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const long long* strides,
                            int H, int L, int d, float scale) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = p.dk = p.dv = nullptr;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sdo = strides_at(strides, 3);
  p.sg = strides_at(strides, 4);
  p.H = H;
  p.L = L;
  p.d = d;
  p.scale = scale;
  return p;
}

}  // namespace flash

// Instantiate LAUNCH<T, DP, CAUSAL>(args...) for the padded head dim dp
// (16, 32, 64, 128) and the run-time causal flag.
#define FLASH_DISPATCH_DP(LAUNCH, T, causal, dp, ...)                          \
  do {                                                                         \
    switch (dp) {                                                              \
      case 16: FLASH_DISPATCH_C(LAUNCH, T, 16, causal, __VA_ARGS__);           \
      case 32: FLASH_DISPATCH_C(LAUNCH, T, 32, causal, __VA_ARGS__);           \
      case 64: FLASH_DISPATCH_C(LAUNCH, T, 64, causal, __VA_ARGS__);           \
      default: FLASH_DISPATCH_C(LAUNCH, T, 128, causal, __VA_ARGS__);          \
    }                                                                          \
  } while (0)

#define FLASH_DISPATCH_C(LAUNCH, T, DP, causal, ...)                           \
  return (int)((causal) ? LAUNCH<T, DP, true>(__VA_ARGS__)                     \
                        : LAUNCH<T, DP, false>(__VA_ARGS__))
