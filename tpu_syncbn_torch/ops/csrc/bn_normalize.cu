// bn_normalize: y = x * scale + shift per channel over a dense channel-last
// (M, C) view, in x's dtype; (scale, shift) are the f32 per-channel fold of
// (mean, var, weight, bias, eps) that PyTorch computes beforehand
// (batch_norm.fold_scale_shift).
//
// Replaces tpu_syncbn/ops/pallas_bn.py:157 (_normalize_kernel; its
// pallas_call is in _normalize_2d at :187).
//
// Bound on an H100 SXM (3.35 TB/s): one read of x and one write of y,
// 2*M*C*itemsize bytes, against one FMA per element: bound by bytes. At the
// stem's (802816, 64) bf16 view: 206 MB -> 61 us; at (3136, 512): 6.4 MB ->
// 1.9 us.
//
// Design: one tile per block, one pass, no loop (cuda_bn.normalize_plan).
// A block of 128 threads spans `gcols` 16-byte channel groups (the row's
// groups rounded up to a power of two, at most the block) and
// `lanes = threads / gcols` rows, and each thread loads 4 rows, `lanes`
// apart, before it stores any: 8 KB of loads in flight a block. A thread
// keeps one channel group, so it loads its scale and shift once into
// registers; each element is one f32 FMA, rounded once to the output type.
// An address or a row (C * itemsize) off 16-byte boundaries takes a scalar
// path with the same tiles (element loads and stores, channels past C
// masked).
//
// What this does about the Triton version's losses: its tiling (4096
// elements a program, 4 warps) was already near the bound at the large
// layers, and a persistent grid-stride design lost to it by 5 % a ResNet-50
// step on an H100 (tools/bn_forward_times.py), so the tiles are the same;
// the launch is one ctypes call in place of Triton's Python launcher. The
// small layers' cost is the PyTorch fold before the kernel, not the kernel.

#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bn_normalize_k {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;  // rows a thread, loaded before any is stored

using dtype_cvt::from_f;
using dtype_cvt::to_f;

template <typename T, int VEC>
__device__ __forceinline__ uint4 fma16(const uint4& u, const float (&sc)[VEC],
                                       const float (&sh)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&u);
  uint4 o;
  T* f = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = from_f<T>(fmaf(to_f<T>(e[i]), sc[i], sh[i]));
  return o;
}

// block (bx, by): channel groups [by*gcols, +gcols), rows
// [bx*lanes*UNROLL, +lanes*UNROLL); thread t: group by*gcols + t % gcols,
// rows bx*lanes*UNROLL + t / gcols + j*lanes for j < UNROLL
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
normalize_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 int64_t m, int c, int gcols) {
  constexpr int VEC = 16 / sizeof(T);
  const int groups = (c + VEC - 1) / VEC;
  const int lanes = THREADS / gcols;
  const int g = blockIdx.y * gcols + threadIdx.x % gcols;
  if (g >= groups) return;
  const int64_t r0 = (int64_t)blockIdx.x * lanes * UNROLL + threadIdx.x / gcols;
  const int ch = g * VEC;
  float sc[VEC], sh[VEC];
  const uintptr_t vecs = reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(shift);
  if (VECTOR && vecs % 16 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + ch + i));
      const float4 b = __ldg(reinterpret_cast<const float4*>(shift + ch + i));
      sc[i] = a.x, sc[i + 1] = a.y, sc[i + 2] = a.z, sc[i + 3] = a.w;
      sh[i] = b.x, sh[i + 1] = b.y, sh[i + 2] = b.z, sh[i + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sc[i] = ch + i < c ? scale[ch + i] : 0.f;
      sh[i] = ch + i < c ? shift[ch + i] : 0.f;
    }
  }
  if constexpr (VECTOR) {
    const uint4* xv = reinterpret_cast<const uint4*>(x) + g;
    uint4* yv = reinterpret_cast<uint4*>(y) + g;
    uint4 u[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int64_t r = r0 + j * lanes;
      u[j] = r < m ? __ldg(xv + r * groups) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int64_t r = r0 + j * lanes;
      if (r < m) yv[r * groups] = fma16<T, VEC>(u[j], sc, sh);
    }
  } else {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int64_t r = r0 + j * lanes;
      if (r >= m) break;
      const T* xr = x + r * c;
      T* yr = y + r * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (ch + i < c) yr[ch + i] = from_f<T>(fmaf(to_f<T>(xr[ch + i]), sc[i], sh[i]));
    }
  }
}

template <typename T>
cudaError_t launch_normalize(const void* x, void* y, const float* scale,
                             const float* shift, int m, int c, int gcols, int n_rb,
                             int n_cb, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int groups = (c + VEC - 1) / VEC;
  if (m < 0 || c < 1 || gcols < 1 || THREADS % gcols != 0 || n_rb < 1 || n_cb < 1 ||
      n_cb > 65535)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  // a grid that leaves rows or channel groups out is refused
  const int64_t rows = (int64_t)n_rb * (THREADS / gcols) * UNROLL;
  if (rows < m || (int64_t)n_cb * gcols < groups) return cudaErrorInvalidValue;
  const bool vector = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0 && c % VEC == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 grid(n_rb, n_cb);
  if (vector)
    normalize_kernel<T, true><<<grid, THREADS, 0, stream>>>(xt, yt, scale, shift, m, c,
                                                             gcols);
  else
    normalize_kernel<T, false><<<grid, THREADS, 0, stream>>>(xt, yt, scale, shift, m, c,
                                                              gcols);
  return cudaGetLastError();
}

}  // namespace bn_normalize_k

// dtype: 0 float32, 1 bfloat16, 2 float16; scale and shift: C f32 each; y:
// M x C in x's dtype; the grid (n_rb x n_cb blocks, each spanning `gcols`
// channel groups) from cuda_bn.normalize_plan. The launcher
// takes the 16-byte path where x, y and C allow it, else the scalar path.
extern "C" int bn_normalize(int dtype, const void* x, void* y, const float* scale,
                            const float* shift, int m, int c, int gcols, int n_rb,
                            int n_cb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)bn_normalize_k::launch_normalize<float>(x, y, scale, shift, m, c, gcols,
                                                          n_rb, n_cb, s);
    case 1:
      return (int)bn_normalize_k::launch_normalize<__nv_bfloat16>(x, y, scale, shift, m,
                                                                  c, gcols, n_rb, n_cb, s);
    case 2:
      return (int)bn_normalize_k::launch_normalize<__half>(x, y, scale, shift, m, c, gcols,
                                                           n_rb, n_cb, s);
  }
  return (int)cudaErrorInvalidValue;
}
