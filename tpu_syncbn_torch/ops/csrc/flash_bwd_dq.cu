// flash_bwd_dq<T, DP, CAUSAL>: dQ of exact softmax attention, with P
// recomputed tile by tile from the forward's logsumexp.
//
// Replaces (tpu_syncbn/ops/pallas_attention.py):
//   * _bwd_q_kernel_c + _bwd_p_ds, the causal walk over live (qi, ki)
//     tiles (CAUSAL = true; the KV loop stops at the diagonal);
//   * _bwd_q_kernel, the rectangular grid (CAUSAL = false).
//
// Inputs as flash_bwd_dkdv; output dq (B, L, H, D) in T.
//
// Design (FlashAttention-2): one block of 4 warps per (query tile of 64
// rows, b*h); each warp owns 16 query rows, whose Q and dO tiles stay in
// shared memory and whose lse and delta stay in registers. The block
// streams 64-row K and V tiles. Per tile a warp computes S = Q K^T,
// P = exp(S * scale - lse) with dead entries selected to 0, dP = dO V^T,
// dS = P * (dP - delta), and dQ += dS K in f32 registers; dQ *= scale at
// the end. The dK/dV and dQ kernels stay two launches, as in the JAX
// package: each block owns its output rows, there are no atomics, and the
// result repeats exactly from run to run.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): three
// products, 6*L*L*D operations per (b, h) (half when causal). At the LM
// path's shape (B 2, L 8192, H 8, D 64, causal): 206 GFLOP -> 208 us
// against 42 MB -> 13 us: bound by the tensor cores, reached in part for
// the reasons given in flash_fwd.cu.

#include "flash_common.cuh"

namespace flash {

template <typename T, int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * ((2 * BLOCK_M + 2 * BLOCK_N) * (DP + Pad<T>::v) +
                      WARPS * 16 * (BLOCK_N + Pad<T>::v));
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int LD = DP + Pad<T>::v;
  constexpr int LDP = BLOCK_N + Pad<T>::v;
  constexpr int NTS = BLOCK_N / 8;
  constexpr int NTD = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + BLOCK_M * LD;  // dO
  T* sK = sO + BLOCK_M * LD;
  T* sV = sK + BLOCK_N * LD;
  T* sP = sV + BLOCK_N * LD;

  const int L = p.L, d = p.d;
  const int n_q = cdiv(L, BLOCK_M);
  const int qi = n_q - 1 - (int)blockIdx.x;  // causal: the busiest tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = qi * BLOCK_M;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* og = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  T* sPw = sP + warp * 16 * LDP;

  load_tile<T, BLOCK_M, DP, LD>(sQ, qg, p.sq.r, q0, L, d);
  load_tile<T, BLOCK_M, DP, LD>(sO, og, p.sdo.r, q0, L, d);
  const float* lse = p.lse + (int64_t)bh * L;
  const float* delta = p.delta + (int64_t)bh * L;
  const float lse0 = r0 < L ? lse[r0] : 0.f, lse1 = r0 + 8 < L ? lse[r0 + 8] : 0.f;
  const float dl0 = r0 < L ? delta[r0] : 0.f, dl1 = r0 + 8 < L ? delta[r0 + 8] : 0.f;

  float dq[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  int n_kv = cdiv(L, BLOCK_N);
  if (CAUSAL) n_kv = min(n_kv, (q0 + BLOCK_M - 1) / BLOCK_N + 1);

  for (int kj = 0; kj < n_kv; ++kj) {
    const int k0 = kj * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<T, BLOCK_N, DP, LD>(sK, kg, p.sk.r, k0, L, d);
    load_tile<T, BLOCK_N, DP, LD>(sV, vg, p.sv.r, k0, L, d);
    __syncthreads();

    float s[NTS][4], dp[NTS][4];
#pragma unroll
    for (int i = 0; i < NTS; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    warp_gemm<T, DP / 16, NTS, false>(s, sQ + warp * 16 * LD, LD, sK, LD);
    warp_gemm<T, DP / 16, NTS, false>(dp, sO + warp * 16 * LD, LD, sV, LD);
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + nt * 8 + 2 * t + (j & 1);
        const int row = j < 2 ? r0 : r0 + 8;
        const bool live = row < L && col < L && (!CAUSAL || row >= col);
        const float pv = live ? expf(s[nt][j] * p.scale - (j < 2 ? lse0 : lse1)) : 0.f;
        dp[nt][j] = pv * (dp[nt][j] - (j < 2 ? dl0 : dl1));
      }
    }
    store_tile<T, NTS>(sPw, LDP, dp);  // dS, rounded to T
    __syncwarp();
    warp_gemm<T, BLOCK_N / 16, NTD, true>(dq, sPw, LDP, sK, LD);
    __syncwarp();  // dS is read by every lane before the next tile rewrites it
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.sg.b + h * p.sg.h;
  store_rows<T, NTD>(dqg, p.sg.r, r0, L, d, dq, p.scale, p.scale);
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<T, DP>();
  auto kernel = flash_bwd_dq_kernel<T, DP, CAUSAL>;
  static bool done[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(p.L, BLOCK_M), B * p.H);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash

// dtype: 0 float32, 1 bfloat16. strides: 15 values, (batch, row, head) of
// q, k, v, dout and of the output dq, in elements. Returns the launch's
// cudaError_t.
extern "C" int flash_bwd_dq(int dtype, int causal, const void* q,
                            const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            int B, int H, int L, int d,
                            const long long* strides, float scale,
                            void* stream) {
  flash::BwdParams p = flash::bwd_params(q, k, v, dout, lse, delta, strides,
                                         H, L, d, scale);
  p.dq = dq;
  FLASH_DISPATCH(flash::launch_dq, dtype, causal, d, p, B,
                 static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}
