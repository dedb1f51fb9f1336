// flash_fwd<T, DP, CAUSAL>: exact softmax attention forward, O and the
// row logsumexp, with the (L, L) scores never in device memory.
//
// Replaces (tpu_syncbn/ops/pallas_attention.py):
//   * _attn_kernel_causal + _attend_tile, the causal walk over live tiles
//     (CAUSAL = true; loop bounds take the place of the scalar-prefetched
//     tile lists, and Hopper needs no _MAX_CAUSAL_TILES cap);
//   * _attn_kernel_rect, the rectangular grid (CAUSAL = false).
//
// Layout: q, k, v are (B, L, H, D) with any batch/row/head strides and D
// contiguous (views into a fused QKV product are read in place); o is
// (B, L, H, D), lse is (B*H, L) float32. T is float or bf16.
//
// Design (FlashAttention-2): one block of 4 warps per (query tile of 64
// rows, b*h); each warp owns 16 query rows. The block streams 64-row K and
// V tiles through shared memory, up to the diagonal when causal. Per tile a
// warp computes S = Q K^T on the tensor cores (bf16 mma.sync, f32
// accumulators; f32 inputs run the same product in f32 on the CUDA cores),
// scales and masks it (columns >= L, and columns > row when causal, set to
// NEG_BIG as the JAX kernel does), updates its running max and denominator
// in f32 registers, rounds P to T and adds P V into an f32 register
// accumulator. At the end l = max(l, 1e-30), O = acc / l in T and
// lse = m + log l.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4*L*L*D
// operations per (b, h) (two products; half of them when causal) against
// 4 reads/writes of B*L*H*D elements. At the LM path's shape (B 2, L 8192,
// H 8, D 64, causal) that is 137 GFLOP -> 139 us against 34 MB -> 10 us:
// bound by the tensor cores. The design answers that bound only in part:
// every score is computed once on the tensor cores and nothing of (L, L)
// touches device memory, but operands come from shared memory through
// mma.sync fragments without a copy pipeline (no TMA, no wgmma), so the
// kernel reaches a fraction of the tensor-core peak. Query tiles run
// heaviest first (reversed tile order) so causal blocks finish together.

#include "flash_common.cuh"

namespace flash {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  Strides sq, sk, sv, so;
  int H, L, d;
  float scale;
};

template <typename T, int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * ((BLOCK_M + 2 * BLOCK_N) * (DP + Pad<T>::v) +
                      WARPS * 16 * (BLOCK_N + Pad<T>::v));
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FwdParams p) {
  constexpr int LD = DP + Pad<T>::v;
  constexpr int LDP = BLOCK_N + Pad<T>::v;
  constexpr int NTS = BLOCK_N / 8;  // n-tiles of a score row block
  constexpr int NTD = DP / 8;       // n-tiles of an output row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BLOCK_M * LD;
  T* sV = sK + BLOCK_N * LD;
  T* sP = sV + BLOCK_N * LD;

  const int L = p.L, d = p.d;
  const int n_q = cdiv(L, BLOCK_M);
  const int qi = n_q - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = qi * BLOCK_M;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  T* sPw = sP + warp * 16 * LDP;

  load_tile<T, BLOCK_M, DP, LD>(sQ, qg, p.sq.r, q0, L, d);

  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
  float acc[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_kv = cdiv(L, BLOCK_N);
  if (CAUSAL) n_kv = min(n_kv, (q0 + BLOCK_M - 1) / BLOCK_N + 1);

  for (int kj = 0; kj < n_kv; ++kj) {
    const int k0 = kj * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<T, BLOCK_N, DP, LD>(sK, kg, p.sk.r, k0, L, d);
    load_tile<T, BLOCK_N, DP, LD>(sV, vg, p.sv.r, k0, L, d);
    __syncthreads();

    float s[NTS][4];
#pragma unroll
    for (int i = 0; i < NTS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    warp_gemm<T, DP / 16, NTS, false>(s, sQ + warp * 16 * LD, LD, sK, LD);

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + nt * 8 + 2 * t + (j & 1);
        const int row = j < 2 ? r0 : r0 + 8;
        const bool live = col < L && (!CAUSAL || row >= col);
        s[nt][j] = live ? s[nt][j] * p.scale : NEG_BIG;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four threads of a row hold its columns: reduce across them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // l holds this thread's share of the row sum; the shares are summed at
    // the end (every share is rescaled by the same factor)
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int i = 0; i < NTD; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }
    store_tile<T, NTS>(sPw, LDP, s);  // P, rounded to T, as the A operand
    __syncwarp();
    warp_gemm<T, BLOCK_N / 16, NTD, true>(acc, sPw, LDP, sV, LD);
    __syncwarp();  // P is read by every lane before the next tile rewrites it
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  T* og = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
  store_rows<T, NTD>(og, p.so.r, r0, L, d, acc, 1.f / l0, 1.f / l1);
  if (t == 0) {
    float* lse = p.lse + (int64_t)bh * L;
    if (r0 < L) lse[r0] = m0 + logf(l0);
    if (r0 + 8 < L) lse[r0 + 8] = m1 + logf(l1);
  }
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_fwd(const FwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, DP>();
  auto kernel = flash_fwd_kernel<T, DP, CAUSAL>;
  static bool done[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(p.L, BLOCK_M), B * p.H);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash

// dtype: 0 float32, 1 bfloat16. strides: 12 values, (batch, row, head) of
// q, k, v, o in elements. Returns the launch's cudaError_t.
extern "C" int flash_fwd(int dtype, int causal, const void* q, const void* k,
                         const void* v, void* o, float* lse, int B, int H,
                         int L, int d, const long long* strides, float scale,
                         void* stream) {
  flash::FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sq = flash::strides_at(strides, 0);
  p.sk = flash::strides_at(strides, 1);
  p.sv = flash::strides_at(strides, 2);
  p.so = flash::strides_at(strides, 3);
  p.H = H;
  p.L = L;
  p.d = d;
  p.scale = scale;
  FLASH_DISPATCH(flash::launch_fwd, dtype, causal, d, p, B,
                 static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}
