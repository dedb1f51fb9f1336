// flash_bwd_dkdv<T, DP, CAUSAL>: dK and dV of exact softmax attention,
// with P recomputed tile by tile from the forward's logsumexp.
//
// Replaces (tpu_syncbn/ops/pallas_attention.py):
//   * _bwd_kv_kernel_c + _bwd_p_ds, the causal walk over live (ki, qi)
//     tiles (CAUSAL = true; the query loop starts at the first tile that
//     reaches this KV tile's columns, as _causal_tiles_kv enumerates);
//   * _bwd_kv_kernel, the rectangular grid (CAUSAL = false).
//
// Inputs: q, k, v, dout (B, L, H, D) with any batch/row/head strides and D
// contiguous; lse and delta = rowsum(dO * O) as (B*H, L) float32. Outputs
// dk, dv (B, L, H, D) in T.
//
// Design (FlashAttention-2): one block of 4 warps per (KV tile of 64 rows,
// b*h); each warp owns 16 KV rows and keeps their dK and dV in f32
// registers. K and V stay in shared memory; the block streams 64-row Q,
// dO, lse and delta tiles. Per tile a warp computes, all in the transposed
// (KV rows x query columns) orientation so no warp needs another's rows:
//   S^T = K Q^T;  P^T = exp(S^T * scale - lse), dead entries selected to 0
//   (query rows >= L, KV rows >= L, and query < key when causal), as
//   _bwd_p_ds does;  dV += P^T dO;  dP^T = V dO^T;
//   dS^T = P^T * (dP^T - delta);  dK += dS^T Q;
// and at the end dK *= scale. P^T and dS^T are rounded to T on their way
// to the tensor cores. No atomics: each block owns its rows of dK and dV,
// so the result repeats exactly from run to run.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): four products,
// 8*L*L*D operations per (b, h) (half when causal), against reads of q, k,
// v, dO and writes of dK, dV. At the LM path's shape (B 2, L 8192, H 8,
// D 64, causal): 275 GFLOP -> 278 us against 51 MB -> 15 us: bound by the
// tensor cores. As in the forward, operands reach mma.sync from shared
// memory without a copy pipeline, so the kernel runs at a fraction of it.

#include "flash_common.cuh"

namespace flash {

template <typename T, int DP>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(T) * ((2 * BLOCK_M + 2 * BLOCK_N) * (DP + Pad<T>::v) +
                      WARPS * 16 * (BLOCK_N + Pad<T>::v)) +
         sizeof(float) * 2 * BLOCK_N;
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(BwdParams p) {
  constexpr int LD = DP + Pad<T>::v;
  constexpr int LDP = BLOCK_N + Pad<T>::v;
  constexpr int NTS = BLOCK_N / 8;
  constexpr int NTD = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BLOCK_M * LD;
  T* sQ = sV + BLOCK_M * LD;
  T* sO = sQ + BLOCK_N * LD;  // dO
  T* sP = sO + BLOCK_N * LD;
  float* sLse = reinterpret_cast<float*>(sP + WARPS * 16 * LDP);
  float* sDelta = sLse + BLOCK_N;

  const int L = p.L, d = p.d;
  const int k0 = blockIdx.x * BLOCK_M;  // causal: the busiest tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* og = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const float* lse = p.lse + (int64_t)bh * L;
  const float* delta = p.delta + (int64_t)bh * L;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + warp * 16 + g;  // this thread's KV rows: kr0, kr0 + 8
  T* sPw = sP + warp * 16 * LDP;

  load_tile<T, BLOCK_M, DP, LD>(sK, kg, p.sk.r, k0, L, d);
  load_tile<T, BLOCK_M, DP, LD>(sV, vg, p.sv.r, k0, L, d);

  float dk[NTD][4], dv[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int n_q = cdiv(L, BLOCK_N);
  for (int qj = CAUSAL ? k0 / BLOCK_N : 0; qj < n_q; ++qj) {
    const int q0 = qj * BLOCK_N;
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<T, BLOCK_N, DP, LD>(sQ, qg, p.sq.r, q0, L, d);
    load_tile<T, BLOCK_N, DP, LD>(sO, og, p.sdo.r, q0, L, d);
    load_rows(sLse, lse, q0, L, BLOCK_N);
    load_rows(sDelta, delta, q0, L, BLOCK_N);
    __syncthreads();

    float pt[NTS][4];
#pragma unroll
    for (int i = 0; i < NTS; ++i) pt[i][0] = pt[i][1] = pt[i][2] = pt[i][3] = 0.f;
    warp_gemm<T, DP / 16, NTS, false>(pt, sK + warp * 16 * LD, LD, sQ, LD);
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = nt * 8 + 2 * t + (j & 1);  // query column in the tile
        const int kr = j < 2 ? kr0 : kr0 + 8;
        const bool live = q0 + qc < L && kr < L && (!CAUSAL || q0 + qc >= kr);
        pt[nt][j] = live ? expf(pt[nt][j] * p.scale - sLse[qc]) : 0.f;
      }
    }
    store_tile<T, NTS>(sPw, LDP, pt);
    __syncwarp();
    warp_gemm<T, BLOCK_N / 16, NTD, true>(dv, sPw, LDP, sO, LD);

    float dpt[NTS][4];
#pragma unroll
    for (int i = 0; i < NTS; ++i) dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    warp_gemm<T, DP / 16, NTS, false>(dpt, sV + warp * 16 * LD, LD, sO, LD);
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = nt * 8 + 2 * t + (j & 1);
        dpt[nt][j] = pt[nt][j] * (dpt[nt][j] - sDelta[qc]);
      }
    }
    __syncwarp();  // every lane has read P^T before dS^T replaces it
    store_tile<T, NTS>(sPw, LDP, dpt);
    __syncwarp();
    warp_gemm<T, BLOCK_N / 16, NTD, true>(dk, sPw, LDP, sQ, LD);
  }

  const int64_t gb = b * p.sg.b + h * p.sg.h;
  store_rows<T, NTD>(static_cast<T*>(p.dk) + gb, p.sg.r, kr0, L, d, dk, p.scale, p.scale);
  store_rows<T, NTD>(static_cast<T*>(p.dv) + gb, p.sg.r, kr0, L, d, dv, 1.f, 1.f);
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_dkdv(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<T, DP>();
  auto kernel = flash_bwd_dkdv_kernel<T, DP, CAUSAL>;
  static bool done[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(p.L, BLOCK_M), B * p.H);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash

// dtype: 0 float32, 1 bfloat16. strides: 15 values, (batch, row, head) of
// q, k, v, dout and of the outputs dk, dv (which share one layout), in
// elements. Returns the launch's cudaError_t.
extern "C" int flash_bwd_dkdv(int dtype, int causal, const void* q,
                              const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk,
                              void* dv, int B, int H, int L, int d,
                              const long long* strides, float scale,
                              void* stream) {
  flash::BwdParams p = flash::bwd_params(q, k, v, dout, lse, delta, strides,
                                         H, L, d, scale);
  p.dk = dk;
  p.dv = dv;
  FLASH_DISPATCH(flash::launch_dkdv, dtype, causal, d, p, B,
                 static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}
