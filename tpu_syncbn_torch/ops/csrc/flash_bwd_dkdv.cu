// flash_bwd_dkdv: dK and dV of exact softmax attention, with P recomputed
// tile by tile from the forward's logsumexp.
//
// Replaces (tpu_syncbn/ops/pallas_attention.py):
//   * _bwd_kv_kernel_c + _bwd_p_ds, the causal walk over live (ki, qi)
//     tiles (CAUSAL = true; the query loop starts at the first tile that
//     reaches this KV tile's columns, as _causal_tiles_kv enumerates);
//   * _bwd_kv_kernel, the rectangular grid (CAUSAL = false).
//
// Inputs: q, k, v, dout (B, L, H, D) with any batch/row/head strides and D
// contiguous; lse and delta = rowsum(dO * O) as (B*H, L) float32. Outputs
// dk, dv (B, L, H, D) in the input type. Both designs below compute, in the
// transposed (KV rows x query columns) orientation so each block owns its
// rows of dK and dV:
//   S^T = K Q^T;  P^T = exp(S^T * scale - lse), dead entries selected to 0
//   (query rows >= L, KV rows >= L, and query < key when causal), as
//   _bwd_p_ds does;  dV += P^T dO;  dP^T = V dO^T;
//   dS^T = P^T * (dP^T - delta);  dK += dS^T Q;
// and at the end dK *= scale. P^T and dS^T are rounded to the input type
// on their way to the tensor cores. No atomics: the result repeats exactly
// from run to run.
//
// bf16 (sm90::dkdv_kernel, the Hopper design). One block per (128 KV rows,
// b*h): two consumer warpgroups of 64 KV rows each and a producer
// warpgroup whose first warp loads (setmaxnreg moves the producer's
// registers to the consumers). The producer loads K and V once by TMA,
// then streams tiles of 64 query rows (32 at D = 128, for registers) of
// Q and dO by TMA, and their lse (times log2 e) and delta by its 32 lanes
// while the TMA runs, through a 3-stage shared-memory ring guarded by
// "full" and "empty" mbarriers. Per tile a consumer warpgroup issues four
// wgmma, none of which passes P or dS through shared memory: S^T = K Q^T
// and dP^T = V dO^T (A from shared memory, B K-major), then dV += P^T dO
// and dK += dS^T Q with P^T and dS^T packed to bf16 straight from the
// accumulators as register A operands, B (dO, Q) read MN-major. P^T is
// computed while dP^T is in flight; dV retires before dS^T is formed, so
// P^T's registers are free for it. The two warpgroups take turns issuing
// their first two products (named barriers), so one computes P^T and dS^T
// while the other's products run. dQ is the separate flash_bwd_dq kernel,
// so dS never leaves registers. Query tiles that lie wholly before a
// warpgroup's rows (causal) are skipped; blocks start busiest tile first
// across every head.
//
// f32 (flash_bwd_dkdv_kernel<float>): one block of 4 warps
// per 64 KV rows, Q and dO tiles copied into padded shared memory by every
// thread, full f32 tile products on the CUDA cores (no TF32).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): four products,
// 8*L*L*D operations per (b, h) (half when causal), against reads of q, k,
// v, dO and writes of dK, dV. At the LM path's shape (B 2, L 8192, H 8,
// D 64, causal): 275 GFLOP -> 278 us against 51 MB -> 15 us: bound by the
// tensor cores.

#include "flash_common.cuh"
#include "hopper.cuh"

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

// -- bf16 on Hopper: TMA, mbarrier ring, producer warpgroup, wgmma ------------

namespace sm90 {

using namespace hopper;

constexpr int KV_ROWS = 128;  // KV rows of a block: two warpgroups of 64
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte aligned base: K, V, the Q and
// dO rings, the lse and delta rings, then the barriers (kv, full[STAGES],
// empty[STAGES]). BQ query rows a tile.
template <int DP>
struct DkdvLayout {
  static constexpr int BQ = DP == 64 ? 64 : 32;
  static constexpr int PANELS = DP / 64;  // 64-column, 128-byte-row panels
  static constexpr int KV_PANEL = KV_ROWS * 128;
  static constexpr int Q_PANEL = BQ * 128;
  static constexpr int Q_TILE = PANELS * Q_PANEL;
  static constexpr int K = 0;
  static constexpr int V = K + PANELS * KV_PANEL;
  static constexpr int Q = V + PANELS * KV_PANEL;
  static constexpr int DO = Q + STAGES * Q_TILE;
  static constexpr int LSE = DO + STAGES * Q_TILE;  // f32 [STAGES][BQ]
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  static constexpr int BARS = DELTA + STAGES * BQ * 4;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo, BwdParams p) {
  using Lay = DkdvLayout<DP>;
  constexpr int BQ = Lay::BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* s_lse = reinterpret_cast<float*>(smem_raw + (base - raw) + Lay::LSE);
  float* s_delta = reinterpret_cast<float*>(smem_raw + (base - raw) + Lay::DELTA);
  const uint32_t bar_kv = base + Lay::BARS;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * STAGES;

  const int L = p.L;
  // blocks start in x-fastest order: with (b*h) on x and KV tiles on y,
  // the busiest causal tiles (the first ones) of every head start first
  const int k0 = blockIdx.y * KV_ROWS;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int qt0 = CAUSAL ? k0 / BQ : 0;  // first query tile that reaches k0
  const int n_it = cdiv(L, BQ) - qt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);               // the loading warp's lanes
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // producer warpgroup; its first warp loads
    reg_dealloc<24>();
    if (warp == CONSUMERS / 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * Lay::PANELS * Lay::KV_PANEL);
        for (int pn = 0; pn < Lay::PANELS; ++pn) {
          tma_load(base + Lay::K + pn * Lay::KV_PANEL, &tk, bar_kv, 64 * pn, h, k0, b);
          tma_load(base + Lay::V + pn * Lay::KV_PANEL, &tv, bar_kv, 64 * pn, h, k0, b);
        }
      }
      const float* lse = p.lse + (int64_t)bh * L;
      const float* delta = p.delta + (int64_t)bh * L;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, q0 = (qt0 + it) * BQ;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        if (lane == 0) {  // the Q and dO tiles first: TMA runs during the loads below
          mbar_expect_tx(full, 2 * Lay::Q_TILE);
          for (int pn = 0; pn < Lay::PANELS; ++pn) {
            const uint32_t off = s * Lay::Q_TILE + pn * Lay::Q_PANEL;
            tma_load(base + Lay::Q + off, &tq, full, 64 * pn, h, q0, b);
            tma_load(base + Lay::DO + off, &tdo, full, 64 * pn, h, q0, b);
          }
        }
        // rows >= L read as 0: their entries are dead wherever they are used
        for (int i = lane; i < BQ; i += 32) {
          const bool in = q0 + i < L;
          s_lse[s * BQ + i] = in ? lse[q0 + i] * LOG2E : 0.f;
          s_delta[s * BQ + i] = in ? delta[q0 + i] : 0.f;
        }
        mbar_arrive(full);  // each lane, after its stores
      }
    }
  } else {  // consumers: warpgroup wg owns KV rows k0 + 64 wg .. + 63
    reg_alloc<240>();
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int wk0 = k0 + 64 * wg;
    const int kr0 = wk0 + 16 * (warp & 3) + g;  // this thread's KV rows: kr0, kr0 + 8
    const uint32_t k_tile = base + Lay::K + 64 * 128 * wg;
    const uint32_t v_tile = base + Lay::V + 64 * 128 * wg;
    const float sl2 = p.scale * LOG2E;

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(bar_kv, 0);
    // the two warpgroups take turns issuing S^T and dP^T
    const TakeTurns turns{wg};
    turns.start();
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES, q0 = (qt0 + it) * BQ;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      if (CAUSAL && q0 + BQ - 1 < wk0) {  // every query precedes every KV row here
        turns.turn();
        turns.pass(it + 1 == n_it);
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t q_tile = base + Lay::Q + s * Lay::Q_TILE;
      const uint32_t do_tile = base + Lay::DO + s * Lay::Q_TILE;
      float pt[BQ / 2], dpt[BQ / 2];  // S^T (then P^T) and dP^T: 64 KV rows x BQ
      turns.turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // 16-wide k step within a panel
        Wgmma<BQ>::ss(pt, desc(k_tile + (kk >> 2) * Lay::KV_PANEL + col, 16, 1024),
                      desc(q_tile + (kk >> 2) * Lay::Q_PANEL + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        Wgmma<BQ>::ss(dpt, desc(v_tile + (kk >> 2) * Lay::KV_PANEL + col, 16, 1024),
                      desc(do_tile + (kk >> 2) * Lay::Q_PANEL + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      turns.pass(it + 1 == n_it);
      wgmma_wait<1>();  // S^T is done; dP^T may still be in flight
      fence_regs(pt);

      const float* ls = s_lse + s * BQ;
      const float* dl = s_delta + s * BQ;
      const bool edge = q0 + BQ > L || wk0 + 64 > L || (CAUSAL && q0 < wk0 + 63);
      uint32_t pa[BQ / 4];  // P^T in bf16, the A operand of dV += P^T dO
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = exp2f(pt[4 * j + c] * sl2 - ((c & 1) ? l2.y : l2.x));
          if (edge) {
            const int qc = q0 + 8 * j + 2 * t + (c & 1);
            const int kr = c < 2 ? kr0 : kr0 + 8;
            if (!(qc < L && kr < L && (!CAUSAL || qc >= kr))) x = 0.f;
          }
          pt[4 * j + c] = x;
        }
        pa[2 * j] = pack_bf16(pt[4 * j], pt[4 * j + 1]);
        pa[2 * j + 1] = pack_bf16(pt[4 * j + 2], pt[4 * j + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(dv, pa + 4 * kk, desc(do_tile + kk * 16 * 128, Lay::Q_PANEL, 1024));
      wgmma_commit();
      wgmma_wait<0>();  // dP^T and dV are done: P^T's registers are free for dS^T
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(dpt);

      uint32_t da[BQ / 4];  // dS^T in bf16, the A operand of dK += dS^T Q
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
        da[2 * j] = pack_bf16(pt[4 * j] * (dpt[4 * j] - d2.x),
                              pt[4 * j + 1] * (dpt[4 * j + 1] - d2.y));
        da[2 * j + 1] = pack_bf16(pt[4 * j + 2] * (dpt[4 * j + 2] - d2.x),
                                  pt[4 * j + 3] * (dpt[4 * j + 3] - d2.y));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(dk, da + 4 * kk, desc(q_tile + kk * 16 * 128, Lay::Q_PANEL, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }

    const int64_t gb = b * p.sg.b + h * p.sg.h;
    store_rows<bf16, DP / 8>(static_cast<bf16*>(p.dk) + gb, p.sg.r, kr0, L, p.d,
                             reinterpret_cast<const float(&)[DP / 8][4]>(dk), p.scale,
                             p.scale);
    store_rows<bf16, DP / 8>(static_cast<bf16*>(p.dv) + gb, p.sg.r, kr0, L, p.d,
                             reinterpret_cast<const float(&)[DP / 8][4]>(dv), 1.f, 1.f);
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int BQ = DkdvLayout<DP>::BQ;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bhld_map(&tq, p.q, B, p.L, p.H, p.d, p.sq.b, p.sq.r, p.sq.h, BQ);
  if (err == cudaSuccess)
    err = bhld_map(&tk, p.k, B, p.L, p.H, p.d, p.sk.b, p.sk.r, p.sk.h, KV_ROWS);
  if (err == cudaSuccess)
    err = bhld_map(&tv, p.v, B, p.L, p.H, p.d, p.sv.b, p.sv.r, p.sv.h, KV_ROWS);
  if (err == cudaSuccess)
    err = bhld_map(&tdo, p.dout, B, p.L, p.H, p.d, p.sdo.b, p.sdo.r, p.sdo.h, BQ);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkdvLayout<DP>::BYTES;
  auto kernel = dkdv_kernel<DP, CAUSAL>;
  static bool done[kMaxDevices] = {};
  err = allow_dynamic_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * p.H, cdiv(p.L, KV_ROWS)), THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

}  // namespace sm90

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 8 || d > 128 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {  // bf16: the Hopper design, D padded to 64 or 128
    if (d <= 64)
      return (int)(causal ? flash::sm90::launch<64, true>(p, B, s)
                          : flash::sm90::launch<64, false>(p, B, s));
    return (int)(causal ? flash::sm90::launch<128, true>(p, B, s)
                        : flash::sm90::launch<128, false>(p, B, s));
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH_DP(flash::launch_dkdv, float, causal, flash::padded_head_dim(d), p, B, s);
  return (int)cudaErrorInvalidValue;
}
