// flash_bwd_dq: dQ of exact softmax attention, with P recomputed tile by
// tile from the forward's logsumexp.
//
// Replaces (tpu_syncbn/ops/pallas_attention.py):
//   * _bwd_q_kernel_c + _bwd_p_ds, the causal walk over live (qi, ki)
//     tiles (CAUSAL = true; the KV loop stops at the diagonal);
//   * _bwd_q_kernel, the rectangular grid (CAUSAL = false).
//
// Inputs as flash_bwd_dkdv; output dq (B, L, H, D) in the input type. Both
// designs below compute, per query row:
//   S = Q K^T;  P = exp(S * scale - lse), dead entries selected to 0 (keys
//   >= L, and keys after the row when causal), as _bwd_p_ds does;
//   dP = dO V^T;  dS = P * (dP - delta);  dQ += dS K;
// and at the end dQ *= scale. dS is rounded to the input type on its way
// to the tensor cores. dQ stays a kernel of its own beside dK/dV, as in the
// JAX package: each block owns its rows of dQ, there are no atomics, and
// the result repeats exactly from run to run.
//
// bf16 (sm90::dq_kernel, the Hopper design). One block per (128 query
// rows, b*h): two consumer warpgroups of 64 query rows each and a producer
// warpgroup whose first thread loads (setmaxnreg moves the producer's
// registers to the consumers). The producer loads the block's Q and dO
// tiles once by TMA, then streams tiles of 64 keys (32 at D = 128, for
// registers) of K and V by TMA through a 3-stage shared-memory ring
// guarded by "full" and "empty" mbarriers. Each consumer thread keeps its
// two rows' lse (times log2 e) and delta in registers. Per tile a consumer
// warpgroup issues three wgmma, none of which passes dS through shared
// memory: S = Q K^T and dP = dO V^T (A and B K-major), then dQ += dS K with
// dS packed to bf16 straight from the accumulators as the register A
// operand and the same K tile read MN-major, so K needs no second copy.
// A tile's S and dP are issued ahead of the previous tile's dQ, so P is
// computed (exp2 on the special-function unit alone) while dP and that dQ
// run, and dS while the dQ finishes. The two warpgroups take turns issuing
// their products (named barriers), so one computes P and dS while the
// other's products run. Masking runs on edge tiles only, and only on keys:
// rows >= L load as zeros with lse and delta read as 0, so their entries
// stay finite, and their dQ is never written. The causal KV loop stops at
// the block's diagonal; warpgroup 0 takes the block's last tiles (one of
// 64 keys, two of 32), which lie wholly after its rows, masked whole, so
// that neither warpgroup waits out a turn of the other's. Blocks start busiest tile first across every head.
//
// f32 (flash_bwd_dq_kernel<float>): one block of 4 warps per 64 query
// rows, 64-row K and V tiles copied into padded shared memory by every
// thread, full f32 tile products on the CUDA cores (no TF32).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): three
// products, 6*L*L*D operations per (b, h) (half when causal), against
// reads of q, k, v, dO, lse, delta and the write of dQ. At the LM path's
// shape (B 2, L 8192, H 8, D 64, causal): 206 GFLOP -> 208 us against
// 42 MB -> 13 us: bound by the tensor cores.

#include "flash_common.cuh"
#include "hopper.cuh"

#include <type_traits>

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

// -- bf16 on Hopper: TMA, mbarrier ring, producer warpgroup, wgmma ------------

namespace sm90 {

using namespace hopper;

constexpr int ROWS = 128;  // query rows of a block: two warpgroups of 64
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte aligned base: the Q and dO
// tiles, the K and V rings, then the barriers (q, full[STAGES],
// empty[STAGES]). BK keys a streamed tile.
template <int DP>
struct DqLayout {
  static constexpr int BK = DP == 64 ? 64 : 32;
  static constexpr int PANELS = DP / 64;  // 64-column, 128-byte-row panels
  static constexpr int Q_PANEL = ROWS * 128;
  static constexpr int KV_PANEL = BK * 128;
  static constexpr int KV_TILE = PANELS * KV_PANEL;
  static constexpr int Q = 0;
  static constexpr int DO = Q + PANELS * Q_PANEL;
  static constexpr int K = DO + PANELS * Q_PANEL;
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BARS = V + STAGES * KV_TILE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, BwdParams p) {
  using Lay = DqLayout<DP>;
  constexpr int BK = Lay::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + Lay::BARS;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;

  const int L = p.L;
  // blocks start in x-fastest order: with (b*h) on x and query tiles
  // reversed on y, the busiest causal tiles of every head start first
  const int q0 = (cdiv(L, ROWS) - 1 - (int)blockIdx.y) * ROWS;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  int n_kv = cdiv(L, BK);
  if (CAUSAL) n_kv = min(n_kv, (q0 + ROWS - 1) / BK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // producer warpgroup: one thread issues every load
    reg_dealloc<24>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * Lay::PANELS * Lay::Q_PANEL);
      for (int pn = 0; pn < Lay::PANELS; ++pn) {
        tma_load(base + Lay::Q + pn * Lay::Q_PANEL, &tq, bar_q, 64 * pn, h, q0, b);
        tma_load(base + Lay::DO + pn * Lay::Q_PANEL, &tdo, bar_q, 64 * pn, h, q0, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % STAGES;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full, 2 * Lay::KV_TILE);
        for (int pn = 0; pn < Lay::PANELS; ++pn) {
          const uint32_t off = s * Lay::KV_TILE + pn * Lay::KV_PANEL;
          tma_load(base + Lay::K + off, &tk, full, 64 * pn, h, it * BK, b);
          tma_load(base + Lay::V + off, &tv, full, 64 * pn, h, it * BK, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    reg_alloc<240>();
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int wq0 = q0 + 64 * wg;
    const int r0 = wq0 + 16 * (warp & 3) + g;  // this thread's rows: r0, r0 + 8
    const uint32_t q_tile = base + Lay::Q + 64 * 128 * wg;
    const uint32_t do_tile = base + Lay::DO + 64 * 128 * wg;
    const float sl2 = p.scale * LOG2E;
    const float* lse = p.lse + (int64_t)bh * L;
    const float* delta = p.delta + (int64_t)bh * L;
    // rows >= L read as 0: with their zero Q and dO rows, P = 1 and dS = 0
    const float ls0 = r0 < L ? lse[r0] * LOG2E : 0.f;
    const float ls1 = r0 + 8 < L ? lse[r0 + 8] * LOG2E : 0.f;
    const float dl0 = r0 < L ? delta[r0] : 0.f, dl1 = r0 + 8 < L ? delta[r0 + 8] : 0.f;
    auto release = [&](int it) {  // tile it's K and V are no longer read
      if (lane == 0) mbar_arrive(bar_empty + 8 * (it % STAGES));
    };

    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    // the two warpgroups take turns issuing their products
    const TakeTurns turns{wg};
    float sc[BK / 2], dp[BK / 2];  // S (then P, then dS) and dP: 64 query rows x BK
    uint32_t ds[BK / 4];           // dS in bf16, the A operand of dQ += dS K
    auto k_tile = [&](int it) { return base + Lay::K + (it % STAGES) * Lay::KV_TILE; };
    // dQ += dS K of tile it (one group)
    auto issue_dq = [&](int it) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<DP>::rs(dq, ds + 4 * kk, desc(k_tile(it) + kk * 16 * 128, Lay::KV_PANEL, 1024));
      wgmma_commit();
    };
    // Tile it: S and dP are issued ahead of the previous tile's dQ, so P is
    // computed while dP and that dQ run, and dS while the dQ finishes.
    auto step = [&](int it, auto first) {
      constexpr bool FIRST = decltype(first)::value;
      const int k0 = it * BK;
      const uint32_t kt = k_tile(it);
      const uint32_t vt = base + Lay::V + (it % STAGES) * Lay::KV_TILE;
      mbar_wait(bar_full + 8 * (it % STAGES), (it / STAGES) & 1);
      turns.turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // 16-wide k step within a panel
        Wgmma<BK>::ss(sc, desc(q_tile + (kk >> 2) * Lay::Q_PANEL + col, 16, 1024),
                      desc(kt + (kk >> 2) * Lay::KV_PANEL + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        Wgmma<BK>::ss(dp, desc(do_tile + (kk >> 2) * Lay::Q_PANEL + col, 16, 1024),
                      desc(vt + (kk >> 2) * Lay::KV_PANEL + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if constexpr (!FIRST) issue_dq(it - 1);
      turns.pass(it + 1 == n_kv);
      wgmma_wait<FIRST ? 1 : 2>();  // S is done
      fence_regs(sc);
      const bool edge = k0 + BK > L || (CAUSAL && k0 + BK - 1 > wq0);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = exp2_approx(sc[4 * j + c] * sl2 - (c < 2 ? ls0 : ls1));
          if (edge) {
            const int kc = k0 + 8 * j + 2 * t + (c & 1);
            const int qr = c < 2 ? r0 : r0 + 8;
            if (kc >= L || (CAUSAL && kc > qr)) x = 0.f;
          }
          sc[4 * j + c] = x;
        }
      }
      wgmma_wait<FIRST ? 0 : 1>();  // dP is done
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] *= dp[4 * j] - dl0;
        sc[4 * j + 1] *= dp[4 * j + 1] - dl0;
        sc[4 * j + 2] *= dp[4 * j + 2] - dl1;
        sc[4 * j + 3] *= dp[4 * j + 3] - dl1;
      }
      if constexpr (!FIRST) {
        wgmma_wait<0>();  // the previous dQ is done: its dS and K tile are free
        fence_regs(dq);
        fence_regs(ds);
        release(it - 1);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        ds[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        ds[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };

    mbar_wait(bar_q, 0);
    turns.start();
    step(0, std::true_type{});
    for (int it = 1; it < n_kv; ++it) step(it, std::false_type{});
    wgmma_fence();
    issue_dq(n_kv - 1);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds);
    release(n_kv - 1);

    const int64_t gb = b * p.sg.b + h * p.sg.h;
    store_rows<bf16, DP / 8>(static_cast<bf16*>(p.dq) + gb, p.sg.r, r0, L, p.d,
                             reinterpret_cast<const float(&)[DP / 8][4]>(dq), p.scale,
                             p.scale);
  }
}

// Named apart from flash_bwd_dkdv.cu's sm90::launch, which takes the same
// parameters: the static flags of a template launcher are shared, by name,
// by every library loaded in the process.
template <int DP, bool CAUSAL>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int BK = DqLayout<DP>::BK;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bhld_map(&tq, p.q, B, p.L, p.H, p.d, p.sq.b, p.sq.r, p.sq.h, ROWS);
  if (err == cudaSuccess)
    err = bhld_map(&tk, p.k, B, p.L, p.H, p.d, p.sk.b, p.sk.r, p.sk.h, BK);
  if (err == cudaSuccess)
    err = bhld_map(&tv, p.v, B, p.L, p.H, p.d, p.sv.b, p.sv.r, p.sv.h, BK);
  if (err == cudaSuccess)
    err = bhld_map(&tdo, p.dout, B, p.L, p.H, p.d, p.sdo.b, p.sdo.r, p.sdo.h, ROWS);
  if (err != cudaSuccess) return err;
  constexpr int smem = DqLayout<DP>::BYTES;
  auto kernel = dq_kernel<DP, CAUSAL>;
  static bool done[kMaxDevices] = {};
  err = allow_dynamic_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * p.H, cdiv(p.L, ROWS)), THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

}  // namespace sm90

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 8 || d > 128 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {  // bf16: the Hopper design, D padded to 64 or 128
    if (d <= 64)
      return (int)(causal ? flash::sm90::launch_dq<64, true>(p, B, s)
                          : flash::sm90::launch_dq<64, false>(p, B, s));
    return (int)(causal ? flash::sm90::launch_dq<128, true>(p, B, s)
                        : flash::sm90::launch_dq<128, false>(p, B, s));
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH_DP(flash::launch_dq, float, causal, flash::padded_head_dim(d), p, B, s);
  return (int)cudaErrorInvalidValue;
}
