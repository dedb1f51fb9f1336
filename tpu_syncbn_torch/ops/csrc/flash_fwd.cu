// flash_fwd: exact softmax attention forward, O and the row logsumexp,
// with the (L, L) scores never in device memory.
//
// Replaces (tpu_syncbn/ops/pallas_attention.py):
//   * _attn_kernel_causal + _attend_tile, the causal walk over live tiles
//     (CAUSAL = true; loop bounds take the place of the scalar-prefetched
//     tile lists, and Hopper needs no _MAX_CAUSAL_TILES cap);
//   * _attn_kernel_rect, the rectangular grid (CAUSAL = false).
//
// Layout: q, k, v are (B, L, H, D) with any batch/row/head strides and D
// contiguous (views into a fused QKV product are read in place); o is
// (B, L, H, D), lse is (B*H, L) float32. Both designs below compute, per
// query row, S = scale * q K^T with masked logits (keys >= L, and keys
// after the row when causal) set to the finite NEG_BIG as the JAX kernel
// does, an online softmax in f32, P rounded to the input type for P V,
// and at the end l = max(l, 1e-30), O = acc / l and lse = m + log l.
//
// bf16 (sm90::fwd_kernel, the Hopper design). One block per (128 query
// rows, b*h): two consumer warpgroups of 64 query rows each and a producer
// warpgroup (one thread of it loads; setmaxnreg moves its registers to the
// consumers). The producer loads the block's Q tile once and streams
// 128-key K and V tiles through a 3-stage shared-memory ring, all by TMA
// (hopper.cuh), each stage guarded by "full" mbarriers for K and for V
// (TMA bytes landed) and an "empty" one (both warpgroups done with it).
// A consumer warpgroup computes S = Q K^T with wgmma (Q and K from shared
// memory, K-major), scales by scale * log2(e) before masking (so NEG_BIG
// stays finite) and updates its running max and denominator in registers
// with exp2; P goes from the S accumulator straight into bf16 A-operand
// registers, and O += P V is a register-sourced wgmma reading V MN-major.
// The loop is software-pipelined: S of tile j and P V of tile j - 1 are
// issued together, and tile j's softmax runs while P V is still on the
// tensor cores (O is rescaled once that product has retired). D is padded
// to 64 or 128 in shared memory only (TMA fills the columns past d with
// zeros). Blocks start heaviest causal tile first across every head, so
// causal blocks finish together; O is written with plain stores.
//
// f32 (flash_fwd_kernel<float>). One block of 4 warps per
// (64 query rows, b*h), 64-row K and V tiles copied into padded shared
// memory by every thread, and the 16x8x16 tile products of
// flash_common.cuh in full f32 on the CUDA cores: wgmma's only 32-bit input
// is TF32, which would not meet the float32 gate.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4*L*L*D
// operations per (b, h) (two products; half of them when causal) against
// 4 reads/writes of B*L*H*D elements. At the LM path's shape (B 2, L 8192,
// H 8, D 64, causal) that is 137 GFLOP -> 139 us against 34 MB -> 10 us:
// bound by the tensor cores, which the bf16 design feeds from TMA-filled
// shared memory through wgmma, with the softmax in registers between.

#include "flash_common.cuh"
#include "hopper.cuh"

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

// -- bf16 on Hopper: TMA, mbarrier ring, producer warpgroup, wgmma ------------

namespace sm90 {

using namespace hopper;

constexpr int ROWS = 128;  // query rows of a block: two warpgroups of 64
constexpr int KEYS = 128;  // keys of a streamed K or V tile
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, in bytes from a 1024-byte aligned base: the Q tile, the
// K and V rings, then the barriers (q, k_full[STAGES], v_full[STAGES],
// empty[STAGES]).
template <int DP>
struct FwdLayout {
  static constexpr int PANELS = DP / 64;  // 64-column, 128-byte-row panels
  static constexpr int Q_PANEL = ROWS * 128;
  static constexpr int KV_PANEL = KEYS * 128;
  static constexpr int KV_TILE = PANELS * KV_PANEL;
  static constexpr int Q = 0;
  static constexpr int K = Q + PANELS * Q_PANEL;
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BARS = V + STAGES * KV_TILE;
  static constexpr int BYTES = BARS + 8 * (1 + 3 * STAGES) + 1024;
};

// One consumer warpgroup's state and steps (see fwd_kernel).
template <int DP, bool CAUSAL>
struct FwdConsumer {
  using Lay = FwdLayout<DP>;
  uint32_t q_tile;  // this warpgroup's 64 rows of Q
  int L, wq0, r0, t;
  float sl2;        // scale * log2(e)
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  // S = Q K^T of the K tile at k_tile (committed as one group)
  __device__ __forceinline__ void issue_s(float (&sc)[KEYS / 2], uint32_t k_tile) const {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // 16-wide k step within a panel
      Wgmma<KEYS>::ss(sc, desc(q_tile + (kk >> 2) * Lay::Q_PANEL + col, 16, 1024),
                      desc(k_tile + (kk >> 2) * Lay::KV_PANEL + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
  }

  // O += P V with P in registers, V at v_tile read MN-major (one group)
  __device__ __forceinline__ static void issue_pv(float (&o)[DP / 2],
                                                  const uint32_t (&pa)[KEYS / 4],
                                                  uint32_t v_tile) {
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      Wgmma<DP>::rs(o, pa + 4 * kk, desc(v_tile + kk * 16 * 128, Lay::KV_PANEL, 1024));
    wgmma_commit();
  }

  // Online softmax of the finished S of the tile at key k0: updates the
  // running max and row sums, returns P in bf16 (pn) and the factors
  // (c0, c1) that rescale O to the new max.
  __device__ __forceinline__ void softmax(float (&sc)[KEYS / 2], int k0,
                                          uint32_t (&pn)[KEYS / 4], float& c0,
                                          float& c1) {
    // scale to log2 units, then mask: NEG_BIG stays finite
    const bool edge = k0 + KEYS > L || (CAUSAL && k0 + KEYS - 1 > wq0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = sc[4 * j + c] * sl2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (c & 1);
          const int row = c < 2 ? r0 : r0 + 8;
          if (col >= L || (CAUSAL && col > row)) x = NEG_BIG;
        }
        sc[4 * j + c] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // the four threads of a row hold its columns: reduce across them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    c0 = exp2f(m0 - mx0);
    c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // l: this thread's share of the row sum, summed across the row at the end
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const float p0 = exp2f(sc[4 * j] - m0), p1 = exp2f(sc[4 * j + 1] - m0);
      const float p2 = exp2f(sc[4 * j + 2] - m1), p3 = exp2f(sc[4 * j + 3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pn[2 * j] = pack_bf16(p0, p1);
      pn[2 * j + 1] = pack_bf16(p2, p3);
    }
  }
};

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, FwdParams p) {
  using Lay = FwdLayout<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + Lay::BARS;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES;
  const uint32_t bar_empty = bar_v + 8 * STAGES;

  const int L = p.L;
  // blocks start in x-fastest order: with (b*h) on x and query tiles
  // reversed on y, the heaviest causal tiles of every head start first
  const int q0 = (cdiv(L, ROWS) - 1 - (int)blockIdx.y) * ROWS;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  int n_kv = cdiv(L, KEYS);
  if (CAUSAL) n_kv = min(n_kv, (q0 + ROWS - 1) / KEYS + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // producer warpgroup: one thread issues every load
    reg_dealloc<24>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_arrive_expect_tx(bar_q, Lay::PANELS * Lay::Q_PANEL);
      for (int pn = 0; pn < Lay::PANELS; ++pn)
        tma_load(base + Lay::Q + pn * Lay::Q_PANEL, &tq, bar_q, 64 * pn, h, q0, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_k + 8 * s, Lay::KV_TILE);
        for (int pn = 0; pn < Lay::PANELS; ++pn)
          tma_load(base + Lay::K + s * Lay::KV_TILE + pn * Lay::KV_PANEL, &tk,
                   bar_k + 8 * s, 64 * pn, h, it * KEYS, b);
        mbar_arrive_expect_tx(bar_v + 8 * s, Lay::KV_TILE);
        for (int pn = 0; pn < Lay::PANELS; ++pn)
          tma_load(base + Lay::V + s * Lay::KV_TILE + pn * Lay::KV_PANEL, &tv,
                   bar_v + 8 * s, 64 * pn, h, it * KEYS, b);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    reg_alloc<240>();
    const int wg = warp >> 2;
    FwdConsumer<DP, CAUSAL> c;
    c.q_tile = base + Lay::Q + 64 * 128 * wg;
    c.L = L;
    c.wq0 = q0 + 64 * wg;
    c.r0 = c.wq0 + 16 * (warp & 3) + (lane >> 2);  // this thread's rows: r0, r0 + 8
    c.t = lane & 3;
    c.sl2 = p.scale * LOG2E;
    auto k_tile = [&](int it) { return base + Lay::K + (it % STAGES) * Lay::KV_TILE; };
    auto v_tile = [&](int it) { return base + Lay::V + (it % STAGES) * Lay::KV_TILE; };
    auto k_full = [&](int it) { mbar_wait(bar_k + 8 * (it % STAGES), (it / STAGES) & 1); };
    auto v_full = [&](int it) { mbar_wait(bar_v + 8 * (it % STAGES), (it / STAGES) & 1); };
    auto release = [&](int it) {  // tile it's K and V are no longer read
      if (lane == 0) mbar_arrive(bar_empty + 8 * (it % STAGES));
    };

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float sc[KEYS / 2];     // S = Q K^T, 64 rows x KEYS
    uint32_t pa[KEYS / 4];  // P of the previous tile in bf16: the A operand of P V
    float c0, c1;
    mbar_wait(bar_q, 0);

    // tile 0: S and its softmax (O is still 0)
    k_full(0);
    wgmma_fence();
    c.issue_s(sc, k_tile(0));
    wgmma_wait<0>();
    fence_regs(sc);
    c.softmax(sc, 0, pa, c0, c1);
    // tile it: S of tile it and P V of tile it - 1 in flight together; the
    // softmax of tile it runs while P V is still on the tensor cores
    for (int it = 1; it < n_kv; ++it) {
      k_full(it);
      v_full(it - 1);
      wgmma_fence();
      c.issue_s(sc, k_tile(it));
      FwdConsumer<DP, CAUSAL>::issue_pv(o, pa, v_tile(it - 1));
      wgmma_wait<1>();  // S is done
      fence_regs(sc);
      uint32_t pn[KEYS / 4];
      c.softmax(sc, it * KEYS, pn, c0, c1);
      wgmma_wait<0>();  // P V of tile it - 1 is done
      fence_regs(o);
      fence_regs(pa);  // pa stays allocated apart from pn until P V has read it
      release(it - 1);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {  // rescale O to tile it's max
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
#pragma unroll
      for (int i = 0; i < KEYS / 4; ++i) pa[i] = pn[i];
    }
    // the last tile's P V
    v_full(n_kv - 1);
    wgmma_fence();
    FwdConsumer<DP, CAUSAL>::issue_pv(o, pa, v_tile(n_kv - 1));
    wgmma_wait<0>();
    fence_regs(o);
    release(n_kv - 1);

    float l0 = c.l0, l1 = c.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    bf16* og = static_cast<bf16*>(p.o) + b * p.so.b + h * p.so.h;
    store_rows<bf16, DP / 8>(og, p.so.r, c.r0, L, p.d,
                             reinterpret_cast<const float(&)[DP / 8][4]>(o),
                             1.f / l0, 1.f / l1);
    if (c.t == 0) {  // natural-log lse from the log2-unit max
      float* lse = p.lse + (int64_t)bh * L;
      if (c.r0 < L) lse[c.r0] = (c.m0 + log2f(l0)) * LN2;
      if (c.r0 + 8 < L) lse[c.r0 + 8] = (c.m1 + log2f(l1)) * LN2;
    }
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = bhld_map(&tq, p.q, B, p.L, p.H, p.d, p.sq.b, p.sq.r, p.sq.h, ROWS);
  if (err == cudaSuccess)
    err = bhld_map(&tk, p.k, B, p.L, p.H, p.d, p.sk.b, p.sk.r, p.sk.h, KEYS);
  if (err == cudaSuccess)
    err = bhld_map(&tv, p.v, B, p.L, p.H, p.d, p.sv.b, p.sv.r, p.sv.h, KEYS);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdLayout<DP>::BYTES;
  auto kernel = fwd_kernel<DP, CAUSAL>;
  static bool done[kMaxDevices] = {};
  err = allow_dynamic_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * p.H, cdiv(p.L, ROWS)), THREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace sm90

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
  FLASH_DISPATCH_DP(flash::launch_fwd, float, causal, flash::padded_head_dim(d), p, B, s);
  return (int)cudaErrorInvalidValue;
}
