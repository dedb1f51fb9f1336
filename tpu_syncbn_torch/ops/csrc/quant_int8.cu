// quant_int8: the int8 wire of the compressed all-reduce. Three launches
// over a flat f32 payload p = g (+ e) cut into chunks of cs elements (the
// last chunk padded with zeros, which enter its range as in the JAX
// package):
//
//   quant_minmax  per chunk (-min p, max p) -> ranges (2 * n_chunks) f32;
//                 the caller takes the world's max of it (one small
//                 all-reduce), so every replica quantizes on one grid;
//   quant_encode  from the world's ranges: zp = (max + min) / 2,
//                 scale = (max - min) / 2 * f32(1 / qmax) (1 for a constant
//                 chunk; the reciprocal is how XLA's CPU backend divides by
//                 the constant qmax, so the grid is the JAX package's),
//                 q = clip(rint((p - zp) / scale), +-qmax) as int8 over every
//                 element of every chunk (pad too: the wire carries whole
//                 chunks); with error feedback also e' = p - (scale q + zp)
//                 for the elements below n;
//   quant_decode  scale * float(sum q) + world * zp (then * f32(1 / world)
//                 for the mean, how XLA divides by the constant) back into
//                 an f32 payload of n elements.
//
// Replaces no pallas_call: in the JAX package this is XLA-fused code in
// tpu_syncbn/parallel/collectives.py (_int8_qparams :681, the dequantize
// of compressed_psum :773-781, ef_compressed_pmean :866-880 and
// compressed_reduce_scatter :942-960). The port writes it by hand because
// its plain PyTorch version is 15-20 ATen passes over the payload.
//
// Bound on an H100 SXM (3.35 TB/s): a few f32 operations an element, far
// below the card's operations per byte, so bytes bound each launch. For
// ResNet-50's 25,557,032 gradients with error feedback: minmax reads g and
// e (204.5 MB, 61 us); encode reads them again and writes q and e' (127.8
// MB, 99 us all told); decode reads 26.4 MB of q and writes 102.2 MB (38 us).
//
// Design. Two launch shapes, picked by the chunk size cs:
//
//   cs <= WARP_CHUNK_MAX (the all-reduce's 256-element chunks): one warp a
//     chunk, 8 warps a block. A full chunk whose rows are 16-byte aligned
//     (every chunk of the fused payload at cs = 256) is read as float4s, 8
//     elements a lane at cs = 256; any other chunk (ragged tail, odd cs)
//     element by element with the same arithmetic. Ranges reduce by warp
//     shuffles.
//   cs > WARP_CHUNK_MAX (the reduce-scatter's one chunk a shard: ResNet-50's
//     25,557,032 gradients are one chunk at world 1 and four of 6,389,258 at
//     world 4, which one warp each would read alone): a chunk is cut into
//     tiles of TILE elements, one block a tile. Encode and decode are
//     elementwise once the chunk's range is known, so each block reads its
//     chunk's range and codes its tile; minmax writes each tile's (min, max)
//     into the caller's scratch and a second small launch finishes each
//     chunk's range over its tiles. A tile starting on 16 bytes is read as
//     float4s, any other element by element (coalesced either way).
//
// min and max are exact in any order; they propagate NaN as the plain
// amin/amax do.
// Every operation is an IEEE-rounded intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn, __frcp_rn, rintf), so nvcc contracts nothing into an FMA and
// each result is bit-identical to the plain version's, which rounds after
// every op.
// Runs on the caller's stream, allocates nothing (the tiled minmax's
// scratch comes from the caller), holds no state between launches, so it
// can be captured in a CUDA graph.

#include "common.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace quant_int8_k {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // chunks a block (the warp shape)
constexpr unsigned FULL = 0xffffffffu;
// the tiled shape: chunks above WARP_CHUNK_MAX elements, TILE a block (16 a
// thread); ops/quant_int8.py sizes minmax's scratch with the same numbers
constexpr int WARP_CHUNK_MAX = 4096;
constexpr int TILE = 4096;
constexpr int PER_THREAD = TILE / THREADS;

__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

struct Src {
  const float* g;
  const float* e;  // residual, or null
  int64_t n;
};

__device__ __forceinline__ float load_p(const Src& s, int64_t i) {
  if (i >= s.n) return 0.f;  // the last chunk's zero padding
  float v = s.g[i];
  if (s.e) v = __fadd_rn(v, s.e[i]);
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// a whole chunk of this payload lies below n and starts on 16 bytes
__device__ __forceinline__ bool vector_chunk(const Src& s, int64_t base, int cs) {
  return cs % 4 == 0 && base + cs <= s.n && aligned16(s.g + base) &&
         (s.e == nullptr || aligned16(s.e + base));
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
  return a;
}

__global__ void __launch_bounds__(THREADS)
minmax_kernel(Src s, int cs, int64_t n_chunks, float* __restrict__ ranges) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (c >= n_chunks) return;
  const int64_t base = c * cs;
  float lo = INFINITY, hi = -INFINITY;
  if (vector_chunk(s, base, cs)) {
    const float4* g4 = reinterpret_cast<const float4*>(s.g + base);
    const float4* e4 = s.e ? reinterpret_cast<const float4*>(s.e + base) : nullptr;
    for (int j = lane; j < cs / 4; j += 32) {
      float4 v = __ldg(g4 + j);
      if (e4) v = add4(v, __ldg(e4 + j));
      lo = nan_min(nan_min(lo, v.x), nan_min(v.y, nan_min(v.z, v.w)));
      hi = nan_max(nan_max(hi, v.x), nan_max(v.y, nan_max(v.z, v.w)));
    }
  } else {
    for (int j = lane; j < cs; j += 32) {
      const float v = load_p(s, base + j);
      lo = nan_min(lo, v);
      hi = nan_max(hi, v);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0) {
    ranges[c] = -lo;
    ranges[n_chunks + c] = hi;
  }
}

struct Grid {
  float scale, zp, fq;
};

// one element: its int8 code and, with error feedback, its new residual
__device__ __forceinline__ int8_t code(const Grid& gr, float p) {
  float r = rintf(__fdiv_rn(__fsub_rn(p, gr.zp), gr.scale));
  r = fminf(fmaxf(r, -gr.fq), gr.fq);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ float resid(const Grid& gr, float p, int8_t q) {
  return __fsub_rn(p, __fadd_rn(__fmul_rn(gr.scale, static_cast<float>(q)), gr.zp));
}

// e may alias e_out: each element is read and then written by one thread
__global__ void __launch_bounds__(THREADS)
encode_kernel(Src s, int cs, int64_t n_chunks, const float* __restrict__ ranges, int qmax,
              int8_t* __restrict__ q, float* __restrict__ scale_out,
              float* __restrict__ zp_out, float* e_out) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (c >= n_chunks) return;
  const int64_t base = c * cs;
  const float gmin = -ranges[c];
  const float gmax = ranges[n_chunks + c];
  Grid gr;
  gr.zp = __fmul_rn(__fadd_rn(gmax, gmin), 0.5f);
  const float half = __fmul_rn(__fsub_rn(gmax, gmin), 0.5f);
  gr.fq = static_cast<float>(qmax);
  gr.scale = half > 0.f ? __fmul_rn(half, __frcp_rn(gr.fq)) : 1.f;
  if (lane == 0) {
    scale_out[c] = gr.scale;
    zp_out[c] = gr.zp;
  }
  if (vector_chunk(s, base, cs) && aligned16(q + base) &&
      (e_out == nullptr || aligned16(e_out + base))) {
    const float4* g4 = reinterpret_cast<const float4*>(s.g + base);
    const float4* e4 = s.e ? reinterpret_cast<const float4*>(s.e + base) : nullptr;
    char4* q4 = reinterpret_cast<char4*>(q + base);
    float4* o4 = e_out ? reinterpret_cast<float4*>(e_out + base) : nullptr;
    for (int j = lane; j < cs / 4; j += 32) {
      float4 p = g4[j];
      if (e4) p = add4(p, e4[j]);
      char4 k;
      k.x = code(gr, p.x);
      k.y = code(gr, p.y);
      k.z = code(gr, p.z);
      k.w = code(gr, p.w);
      q4[j] = k;
      if (o4) o4[j] = make_float4(resid(gr, p.x, k.x), resid(gr, p.y, k.y),
                                  resid(gr, p.z, k.z), resid(gr, p.w, k.w));
    }
  } else {
    for (int j = lane; j < cs; j += 32) {
      const int64_t i = base + j;
      const float p = load_p(s, i);
      const int8_t k = code(gr, p);
      q[i] = k;
      if (e_out && i < s.n) e_out[i] = resid(gr, p, k);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
decode_kernel(const int8_t* __restrict__ sumq, const float* __restrict__ scale,
              const float* __restrict__ zp, int64_t n, int cs, int64_t n_chunks, int world,
              int mean, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (c >= n_chunks) return;
  const int64_t base = c * cs;
  const float sc = scale[c];
  const float fw = static_cast<float>(world);
  const float off = __fmul_rn(fw, zp[c]);
  const float inv_w = __frcp_rn(fw);
  auto value = [&](int8_t k) {
    const float v = __fadd_rn(__fmul_rn(sc, static_cast<float>(k)), off);
    return mean ? __fmul_rn(v, inv_w) : v;
  };
  if (cs % 4 == 0 && base + cs <= n && aligned16(out + base) &&
      (reinterpret_cast<uintptr_t>(sumq + base) & 3) == 0) {
    const char4* q4 = reinterpret_cast<const char4*>(sumq + base);
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int j = lane; j < cs / 4; j += 32) {
      const char4 k = q4[j];
      o4[j] = make_float4(value(k.x), value(k.y), value(k.z), value(k.w));
    }
  } else {
    for (int j = lane; j < cs; j += 32) {
      const int64_t i = base + j;
      if (i < n) out[i] = value(sumq[i]);
    }
  }
}

// -- the tiled shape: one block a TILE of one chunk ---------------------------

// the tile of block b: its chunk, and [lo, hi) in the payload's elements
struct Span {
  int64_t c, lo, hi;
};

__device__ __forceinline__ Span tile_span(int cs, int64_t tiles) {
  Span sp;
  sp.c = blockIdx.x / tiles;
  const int64_t t = blockIdx.x % tiles;
  sp.lo = sp.c * cs + t * TILE;
  sp.hi = sp.c * cs + min(static_cast<int64_t>(cs), (t + 1) * TILE);
  return sp;
}

// the whole tile lies below n and starts on 16 bytes in every array named
__device__ __forceinline__ bool vector_tile(const Span& sp, int64_t n, const void* a,
                                            const void* b, const void* c) {
  return (sp.lo & 3) == 0 && sp.hi - sp.lo == TILE && sp.hi <= n &&
         aligned16(a) && (b == nullptr || aligned16(b)) && (c == nullptr || aligned16(c));
}

// (lo, hi) of the block, NaN-propagating, into thread 0
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[WARPS], s_hi[WARPS];
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      lo = nan_min(lo, s_lo[w]);
      hi = nan_max(hi, s_hi[w]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
minmax_tiles_kernel(Src s, int cs, int64_t tiles, float* __restrict__ partial,
                    int64_t n_part) {
  const Span sp = tile_span(cs, tiles);
  float lo = INFINITY, hi = -INFINITY;
  if (vector_tile(sp, s.n, s.g + sp.lo, s.e ? s.e + sp.lo : nullptr, nullptr)) {
    const float4* g4 = reinterpret_cast<const float4*>(s.g + sp.lo);
    const float4* e4 = s.e ? reinterpret_cast<const float4*>(s.e + sp.lo) : nullptr;
#pragma unroll
    for (int k = 0; k < PER_THREAD / 4; ++k) {
      const int j = threadIdx.x + k * THREADS;
      float4 v = __ldg(g4 + j);
      if (e4) v = add4(v, __ldg(e4 + j));
      lo = nan_min(nan_min(lo, v.x), nan_min(v.y, nan_min(v.z, v.w)));
      hi = nan_max(nan_max(hi, v.x), nan_max(v.y, nan_max(v.z, v.w)));
    }
  } else {
    for (int64_t i = sp.lo + threadIdx.x; i < sp.hi; i += THREADS) {
      const float v = load_p(s, i);
      lo = nan_min(lo, v);
      hi = nan_max(hi, v);
    }
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = lo;
    partial[n_part + blockIdx.x] = hi;
  }
}

// one block a chunk: the chunk's range over its tiles' (min, max)
__global__ void __launch_bounds__(THREADS)
minmax_finish_kernel(const float* __restrict__ partial, int64_t n_part, int64_t tiles,
                     int64_t n_chunks, float* __restrict__ ranges) {
  const int64_t c = blockIdx.x;
  float lo = INFINITY, hi = -INFINITY;
  for (int64_t t = threadIdx.x; t < tiles; t += THREADS) {
    lo = nan_min(lo, partial[c * tiles + t]);
    hi = nan_max(hi, partial[n_part + c * tiles + t]);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    ranges[c] = -lo;
    ranges[n_chunks + c] = hi;
  }
}

__device__ __forceinline__ Grid chunk_grid(const float* ranges, int64_t c, int64_t n_chunks,
                                           int qmax) {
  const float gmin = -ranges[c];
  const float gmax = ranges[n_chunks + c];
  Grid gr;
  gr.zp = __fmul_rn(__fadd_rn(gmax, gmin), 0.5f);
  const float half = __fmul_rn(__fsub_rn(gmax, gmin), 0.5f);
  gr.fq = static_cast<float>(qmax);
  gr.scale = half > 0.f ? __fmul_rn(half, __frcp_rn(gr.fq)) : 1.f;
  return gr;
}

// e may alias e_out, as in encode_kernel
__global__ void __launch_bounds__(THREADS)
encode_tiles_kernel(Src s, int cs, int64_t tiles, int64_t n_chunks,
                    const float* __restrict__ ranges, int qmax, int8_t* __restrict__ q,
                    float* __restrict__ scale_out, float* __restrict__ zp_out, float* e_out) {
  const Span sp = tile_span(cs, tiles);
  const Grid gr = chunk_grid(ranges, sp.c, n_chunks, qmax);
  if (threadIdx.x == 0 && blockIdx.x % tiles == 0) {
    scale_out[sp.c] = gr.scale;
    zp_out[sp.c] = gr.zp;
  }
  if (vector_tile(sp, s.n, s.g + sp.lo, s.e ? s.e + sp.lo : nullptr,
                  e_out ? e_out + sp.lo : nullptr) &&
      (reinterpret_cast<uintptr_t>(q + sp.lo) & 3) == 0) {
    const float4* g4 = reinterpret_cast<const float4*>(s.g + sp.lo);
    const float4* e4 = s.e ? reinterpret_cast<const float4*>(s.e + sp.lo) : nullptr;
    char4* q4 = reinterpret_cast<char4*>(q + sp.lo);
    float4* o4 = e_out ? reinterpret_cast<float4*>(e_out + sp.lo) : nullptr;
#pragma unroll
    for (int k = 0; k < PER_THREAD / 4; ++k) {
      const int j = threadIdx.x + k * THREADS;
      float4 p = g4[j];
      if (e4) p = add4(p, e4[j]);
      char4 kq;
      kq.x = code(gr, p.x);
      kq.y = code(gr, p.y);
      kq.z = code(gr, p.z);
      kq.w = code(gr, p.w);
      q4[j] = kq;
      if (o4) o4[j] = make_float4(resid(gr, p.x, kq.x), resid(gr, p.y, kq.y),
                                  resid(gr, p.z, kq.z), resid(gr, p.w, kq.w));
    }
  } else {
    for (int64_t i = sp.lo + threadIdx.x; i < sp.hi; i += THREADS) {
      const float p = load_p(s, i);
      const int8_t k = code(gr, p);
      q[i] = k;
      if (e_out && i < s.n) e_out[i] = resid(gr, p, k);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
decode_tiles_kernel(const int8_t* __restrict__ sumq, const float* __restrict__ scale,
                    const float* __restrict__ zp, int64_t n, int cs, int64_t tiles,
                    int world, int mean, float* __restrict__ out) {
  const Span sp = tile_span(cs, tiles);
  const float sc = scale[sp.c];
  const float fw = static_cast<float>(world);
  const float off = __fmul_rn(fw, zp[sp.c]);
  const float inv_w = __frcp_rn(fw);
  auto value = [&](int8_t k) {
    const float v = __fadd_rn(__fmul_rn(sc, static_cast<float>(k)), off);
    return mean ? __fmul_rn(v, inv_w) : v;
  };
  if (vector_tile(sp, n, out + sp.lo, nullptr, nullptr) &&
      (reinterpret_cast<uintptr_t>(sumq + sp.lo) & 3) == 0) {
    const char4* q4 = reinterpret_cast<const char4*>(sumq + sp.lo);
    float4* o4 = reinterpret_cast<float4*>(out + sp.lo);
#pragma unroll
    for (int k = 0; k < PER_THREAD / 4; ++k) {
      const int j = threadIdx.x + k * THREADS;
      const char4 kq = q4[j];
      o4[j] = make_float4(value(kq.x), value(kq.y), value(kq.z), value(kq.w));
    }
  } else {
    const int64_t hi = min(sp.hi, n);
    for (int64_t i = sp.lo + threadIdx.x; i < hi; i += THREADS) out[i] = value(sumq[i]);
  }
}

inline unsigned blocks(int64_t n_chunks) {
  return static_cast<unsigned>((n_chunks + WARPS - 1) / WARPS);
}

inline int64_t tiles_of(int cs) { return (cs + TILE - 1) / TILE; }

}  // namespace quant_int8_k

using namespace quant_int8_k;

extern "C" int quant_minmax(const void* g, const void* e, long long n, int cs,
                            long long n_chunks, void* ranges, void* partial,
                            long long partial_len, void* stream) {
  if (n_chunks <= 0) return 0;
  Src s{static_cast<const float*>(g), static_cast<const float*>(e), n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cs <= WARP_CHUNK_MAX) {
    minmax_kernel<<<blocks(n_chunks), THREADS, 0, st>>>(s, cs, n_chunks,
                                                        static_cast<float*>(ranges));
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = tiles_of(cs);
  const int64_t n_part = n_chunks * tiles;
  if (partial == nullptr || partial_len < 2 * n_part) return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(partial);
  minmax_tiles_kernel<<<static_cast<unsigned>(n_part), THREADS, 0, st>>>(s, cs, tiles, part,
                                                                          n_part);
  minmax_finish_kernel<<<static_cast<unsigned>(n_chunks), THREADS, 0, st>>>(
      part, n_part, tiles, n_chunks, static_cast<float*>(ranges));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quant_encode(const void* g, const void* e, long long n, int cs,
                            long long n_chunks, const void* ranges, int qmax, void* q,
                            void* scale, void* zp, void* e_out, void* stream) {
  if (n_chunks <= 0) return 0;
  Src s{static_cast<const float*>(g), static_cast<const float*>(e), n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cs <= WARP_CHUNK_MAX) {
    encode_kernel<<<blocks(n_chunks), THREADS, 0, st>>>(
        s, cs, n_chunks, static_cast<const float*>(ranges), qmax, static_cast<int8_t*>(q),
        static_cast<float*>(scale), static_cast<float*>(zp), static_cast<float*>(e_out));
  } else {
    const int64_t tiles = tiles_of(cs);
    encode_tiles_kernel<<<static_cast<unsigned>(n_chunks * tiles), THREADS, 0, st>>>(
        s, cs, tiles, n_chunks, static_cast<const float*>(ranges), qmax,
        static_cast<int8_t*>(q), static_cast<float*>(scale), static_cast<float*>(zp),
        static_cast<float*>(e_out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quant_decode(const void* sumq, const void* scale, const void* zp, long long n,
                            int cs, long long n_chunks, int world, int mean, void* out,
                            void* stream) {
  if (n_chunks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(sumq);
  const float* sc = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  float* o = static_cast<float*>(out);
  if (cs <= WARP_CHUNK_MAX) {
    decode_kernel<<<blocks(n_chunks), THREADS, 0, st>>>(q, sc, z, n, cs, n_chunks, world, mean,
                                                        o);
  } else {
    const int64_t tiles = tiles_of(cs);
    decode_tiles_kernel<<<static_cast<unsigned>(n_chunks * tiles), THREADS, 0, st>>>(
        q, sc, z, n, cs, tiles, world, mean, o);
  }
  return static_cast<int>(cudaGetLastError());
}
