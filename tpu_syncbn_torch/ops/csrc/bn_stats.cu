// bn_stats: per-channel (sum x, sum x^2) of a dense channel-last (M, C)
// view, and the count n, in one launch.
//
// Replaces tpu_syncbn/ops/pallas_bn.py:99 (_stats_kernel; its pallas_call
// is in _stats_2d at :134). A Pallas grid runs in order, so the TPU kernel
// carries one accumulator across row blocks; Hopper runs blocks in no order.
//
// Bound on an H100 SXM (3.35 TB/s): one read of x, M*C*itemsize bytes,
// against 3 f32 operations per element: bound by bytes. At the stem's
// (802816, 64) bf16 view: 103 MB -> 31 us; at (3136, 512): 3.2 MB -> 1 us.
//
// Design.
// * Grid (n_c column blocks, n_m row blocks), at most one block per SM,
//   from cuda_bn.stats_plan: a pure function of (M, C, itemsize, SM count),
//   so a card repeats its result bit for bit. A column block is a strip of
//   gc 16-byte channel groups (a 128-byte strip of each row at ResNet
//   widths), a row block a contiguous range of rows.
// * 512 threads a block: thread t owns channel group t % gc and row lane
//   t / gc, and walks the block's rows lane, lane + 512/gc, ... with
//   16-byte ld.global.nc loads, 8 in flight, keeping f32 (sum, sum of
//   squares) of its 16 bytes in registers. (A 4-stage ring of row tiles
//   in shared memory, filled by TMA from one producer thread, was timed
//   against these loads on an H100 and lost or tied at every ResNet-50
//   shape; chip_smoke.py's timings.)
// * Block reduction: shuffles across the row lanes of a warp, then shared
//   memory across warps, in a fixed order; the f32 partial goes to
//   ws[row block][2][column].
// * The finish, in the same launch: a per-column-block arrival counter,
//   bumped by one acquire-release atomic a block. The last block of a
//   column to arrive sums that column's partials in a fixed order
//   (contiguous slices of row blocks, each in order, then the slices in
//   order), whichever block it is, and writes (sum x, sum x^2, n) into
//   out[2C + 1]; then it resets its counter to 0, so a call can be
//   captured in a CUDA graph and replayed.
// * Edges: an address or a row (C * itemsize) off 16-byte boundaries takes
//   a scalar path with the same grid (element loads, channels past C
//   masked); rows past M are never read; M = 0 writes zeros and n = 0.
//
// What this does about the Triton version's two losses: its second kernel
// (the sum of partials, with its own Python launch) is gone, and a small
// layer (M = 3136 or 12544) pays one launch, a pass of a few loads a
// thread and a finish that reads at most ~17 K partial floats from L2,
// split over the block's 512 threads (one block of 512 a SM, not two of
// 256: half the partials, twice the threads to sum them).

#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bn_stats_k {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // 16-byte loads in flight a thread

struct Plan {
  int64_t m, rows;  // rows: rows per row block
  int c, gc, n_c, n_m;
};

using dtype_cvt::to_f;

template <typename T, int VEC>
__device__ __forceinline__ void add16(const uint4& u, float (&s)[VEC], float (&q)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float v = to_f<T>(e[i]);
    s[i] += v;
    q[i] = fmaf(v, v, q[i]);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// One block an SM: said to ptxas, which otherwise trims registers for an
// occupancy the grid never asks for, and serializes the 8 loads a thread
// keeps in flight (measured on an H100 with chip_smoke.py).
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 1)
stats_kernel(const T* __restrict__ x, const Plan p, float* __restrict__ ws,
             int* __restrict__ counters, float* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) float red[THREADS * 2 * VEC];
  __shared__ int is_last;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gc = p.gc, lanes = THREADS / gc, cols = gc * VEC;
  const int cg = t & (gc - 1), rl = t / gc;
  const int ch = (blockIdx.x * gc + cg) * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * p.rows;
  const int64_t r1 = p.m < r0 + p.rows ? p.m : r0 + p.rows;

  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;

  if constexpr (VECTOR) {
    if (ch < p.c) {
      const T* base = x + ch;
      for (int64_t r = r0 + rl; r < r1; r += (int64_t)lanes * UNROLL) {
        uint4 u[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const int64_t rr = r + (int64_t)j * lanes;
          u[j] = rr < r1 ? __ldg(reinterpret_cast<const uint4*>(base + rr * p.c))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) add16<T, VEC>(u[j], s, q);
      }
    }
  } else {
    for (int64_t r = r0 + rl; r < r1; r += lanes) {
      const T* row = x + r * p.c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (ch + i < p.c) {
          const float v = to_f<T>(row[ch + i]);
          s[i] += v;
          q[i] = fmaf(v, v, q[i]);
        }
      }
    }
  }

  // block reduction: row lanes of a warp by shuffles, then warps (or, at
  // gc > 32, row lanes) through shared memory, in a fixed order
  const int groups_in_red = gc <= 32 ? WARPS : lanes;
  if (gc < 32) {
    for (int off = 16; off >= gc; off >>= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
        q[i] += __shfl_xor_sync(0xffffffffu, q[i], off);
      }
    }
  }
  if (gc > 32 || lane < gc) {
    const int rg = gc <= 32 ? warp : rl;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[(rg * 2 + 0) * cols + cg * VEC + i] = s[i];
      red[(rg * 2 + 1) * cols + cg * VEC + i] = q[i];
    }
  }
  __syncthreads();
  const int64_t cpad = (int64_t)p.n_c * cols;  // columns of ws
  float* wrow = ws + (int64_t)blockIdx.y * 2 * cpad + (int64_t)blockIdx.x * cols;
  for (int v = t; v < 2 * cols; v += THREADS) {
    const int k = v / cols, j = v - k * cols;
    float acc = 0.f;
    for (int rg = 0; rg < groups_in_red; ++rg) acc += red[(rg * 2 + k) * cols + j];
    wrow[k * cpad + j] = acc;
  }

  // The last block of this column to arrive finishes it. One thread's
  // acquire-release add publishes the block's partial (the barrier orders
  // the other threads' stores before it, as in a grid-wide sync) and, in
  // the last block, acquires every other block's.
  __syncthreads();
  if (t == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counters + blockIdx.x)
                 : "memory");
    is_last = prev == p.n_m - 1;
  }
  __syncthreads();
  if (!is_last) return;

  const int c4 = cols / 4, v4 = 2 * c4;  // float4 columns: c4 of sums, c4 of squares
  const int64_t row4 = cpad / 4;         // float4s per (row block, k)
  const float4* w4 = reinterpret_cast<const float4*>(ws) + (int64_t)blockIdx.x * c4;
  const int slices = v4 >= THREADS ? 1 : THREADS / v4;
  const int per = (p.n_m + slices - 1) / slices;
  float4* fin = reinterpret_cast<float4*>(red);
  auto write = [&](int v, const float4& a) {
    const int k = v / c4;
    const int c0 = blockIdx.x * cols + (v - k * c4) * 4;
    const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + i < p.c) out[k * p.c + c0 + i] = e[i];
  };
  for (int v0 = 0; v0 < v4; v0 += slices == 1 ? THREADS : v4) {
    const int v = v0 + (slices == 1 ? t : t % v4);
    const int sl = slices == 1 ? 0 : t / v4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v < v4 && sl < slices) {
      const int k = v / c4;
      const float4* col = w4 + k * row4 + (v - k * c4);
      const int p1 = min(p.n_m, (sl + 1) * per);
      int pp = sl * per;
      for (; pp + UNROLL <= p1; pp += UNROLL) {
        float4 u[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) u[j] = __ldcg(col + (int64_t)(pp + j) * 2 * row4);
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) add4(acc, u[j]);
      }
      for (; pp < p1; ++pp) add4(acc, __ldcg(col + (int64_t)pp * 2 * row4));
    }
    if (slices == 1) {
      if (v < v4) write(v, acc);
    } else {
      if (sl < slices) fin[sl * v4 + v] = acc;
      __syncthreads();
      if (t < v4) {
        float4 a = fin[t];
        for (int i = 1; i < slices; ++i) add4(a, fin[i * v4 + t]);
        write(t, a);
      }
    }
  }
  if (t == 0) {
    counters[blockIdx.x] = 0;
    if (blockIdx.x == 0) out[2 * p.c] = (float)p.m;
  }
}

template <typename T>
cudaError_t launch_stats(const void* x, float* ws, int* counters, float* out, int m,
                         int c, int gc, int n_c, int n_m, int rows, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // a plan that does not cover (m, c) is refused
  if (m < 0 || c < 1 || gc < 1 || gc > 256 || (gc & (gc - 1)) || n_c < 1 || n_m < 1 ||
      n_m > 65535 || rows < 1 || (int64_t)n_c * gc * VEC < c || (int64_t)n_m * rows < m)
    return cudaErrorInvalidValue;
  const Plan p{m, rows, c, gc, n_c, n_m};
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(n_c, n_m);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && c % VEC == 0)
    stats_kernel<T, true><<<grid, THREADS, 0, stream>>>(xt, p, ws, counters, out);
  else
    stats_kernel<T, false><<<grid, THREADS, 0, stream>>>(xt, p, ws, counters, out);
  return cudaGetLastError();
}

}  // namespace bn_stats_k

// dtype: 0 float32, 1 bfloat16, 2 float16. The launcher takes the 16-byte
// path where x and C allow it, else the scalar path. ws: (n_m, 2,
// n_c * gc * 16 / itemsize) f32 scratch; counters: >= n_c int32 zeros, left
// at zero; out: 2C + 1 f32.
extern "C" int bn_stats(int dtype, const void* x, float* ws, int* counters, float* out,
                        int m, int c, int gc, int n_c, int n_m, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)bn_stats_k::launch_stats<float>(x, ws, counters, out, m, c, gc, n_c,
                                                  n_m, rows, s);
    case 1:
      return (int)bn_stats_k::launch_stats<__nv_bfloat16>(x, ws, counters, out, m, c, gc,
                                                          n_c, n_m, rows, s);
    case 2:
      return (int)bn_stats_k::launch_stats<__half>(x, ws, counters, out, m, c, gc, n_c,
                                                   n_m, rows, s);
  }
  return (int)cudaErrorInvalidValue;
}
