// The backward of flash attention on Hopper's tensor cores: the bfloat16
// instance, sm_90a.
//
// The gradient of src/repro/kernels/flash_attention.py:96 (flash_attention)
// as the port computes it (the reference differentiates jnp at
// src/repro/models/attention.py:328-360 and has no backward kernel): the
// gradient of the forward kernels' exact function, as
// csrc/flash_attention_bwd.cu computes it on float32 FMAs, which stays the
// float32 instance and is built for bf16 too, so that a check can hold this
// kernel against it.  The contract is that file's: q, o, do (B, H, Sq, D);
// k, v (B, KVH, Sk, D); lse (B, H, Sq) float32, the forward's log-sum-exp
// (+inf for a row with no admitted key, whose p and dq are then 0); key j
// admitted for query i when j < Sk, j <= i (causal) and j > i - window
// (window > 0), positions from 0 also when Sq != Sk; head h reads KV head
// h * KVH / H; dq and dk carry `scale`; every sum float32; the gradients
// bf16, each rounded once.  D in {16, 32, 64, 128, 256}.  Every tensor
// contiguous and 16-byte aligned.
//
// Bound by operations: 10 * D counted a head and admitted (query, key)
// pair (q.k, do.v, p^T do, ds^T q, ds k, two operations a product term).
// At qwen2-1.5b's train shape (q (2, 12, 4096, 128), causal) that is
// 2.58e11 operations, 0.261 ms at the bf16 tensor cores' 989 TFLOP/s.  The
// tensor cores execute 20 * D a pair (28 * D at D 256, below), 0.52 ms
// there: the scores are recomputed in both kernels (2 * 2 * D more), and p
// and ds each enter their products as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi), two products each (3 * 2 * D more).  One bf16 term
// each moves every gradient by about four bf16 roundings against the
// float32 oracle (tools/flash_bwd_rounding.py), four times the limit the
// chip check holds it to; two terms are within float32's reach.
//
// Design: three launches on the caller's stream, no atomics, so two runs
// give the same bits.
// 1. rows: each row's lse * log2 e and delta = rowsum(do * o), float32,
//    into the caller's scratch, rows padded to a multiple of 128 (+inf and
//    0 on the padding), so that a tile's rows come in by one 1-D bulk copy.
// 2. dk, dv: one CTA of two warpgroups per (64-key tile, KV head, batch).
//    K and V come once through TMA; then the CTA walks the H / KVH query
//    heads of its KV head and, for each, only the 64-query tiles that admit
//    one of its keys ([q_lo, q_hi)), so the sum over a GQA group is the
//    CTA's own loop.  The warpgroups take alternate steps, each with its
//    own ring of Q, dO, lse and delta tiles on mbarriers (TMA into the
//    128-byte swizzle, rows past Sq as zeros), each summing dK and dV of
//    all 64 keys in registers; at the end warpgroup 1 hands its sums to
//    warpgroup 0 through shared memory, which adds them in a fixed order.
//    (One CTA a 128-key tile, a warpgroup a half, would walk twice the
//    steps on the first tiles of a causal call: its longest CTA twice the
//    average, against about equal here.)  A step, on a warpgroup:
//      S^T = K Q^T and dP^T = V dO^T on wgmma (m64 n64 k16, both from
//      shared memory, K-major); P^T = exp2(scale log2e s - lse log2e) on
//      the accumulator fragments, masked only on a tile that straddles the
//      diagonal, the window's edge, Sq or Sk; split into hi and lo;
//      dV += P^T dO on wgmma with P^T in registers (the accumulator's
//      fragment is the A operand's layout) and dO read MN-major from its
//      tile, as the forward reads V; while it runs, dS^T = P^T (dP^T -
//      delta), P^T taken back as hi + lo; then split, and dK += dS^T Q the
//      same way.  dK and dV (128 f32 registers a thread at D 128) stay in
//      registers across the walk; the order above keeps one 64 x 64 f32
//      tile and one pair of bf16 fragments beside them.
// 3. dq: one CTA of three warpgroups per (192-query tile, head, batch): Q
//    and dO once, K and V in steps of 64 keys through a ring over the keys
//    the tile admits ([k_lo, k_hi)), the forward's loop with one more
//    product: S = Q K^T, dP = dO V^T (wgmma, shared memory), dS = P (dP -
//    delta) split into hi and lo, dQ += dS K with K read MN-major.  At D
//    128 a thread needs 168 registers, what three warpgroups leave it:
//    the third keeps the tensor cores fed while two work on their
//    fragments (on an H100, dq 0.410 ms at the train shape against 0.460
//    with two warpgroups and 0.435 with two and steps of 128 keys;
//    tools/flash_ab.py --backward).
// At D 256 a warpgroup cannot hold dK and dV of 64 keys (256 registers),
// nor dQ of 64 rows beside the scores: there two warpgroups work on the
// same step and split D, each summing its 128 columns of dK, dV (dQ) and
// each computing the scores itself, so 28 * D execute; the dq CTA takes
// 64 rows.  CTAs are numbered tile-major, the tiles with the most
// work first, so the card takes the longest of every head first.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given, does not synchronise, allocates nothing (the rows'
// scratch, repro_flash_attention_bwd_tc_scratch floats, is the caller's),
// and returns cudaGetLastError() (0 = launched; an unsupported D or dtype,
// or a tensor map cuTensorMapEncodeTiled refuses, returns
// cudaErrorInvalidValue without launching).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

constexpr int kThreads = 256;         // two warpgroups (rows, dk/dv)
constexpr int kTile = 64;             // rows of every tile
constexpr int kPadRows = 128;         // the rows' scratch is padded to this
constexpr int kSmemMax = 232448;      // shared memory a block can use
constexpr float kLog2e = 1.4426950408889634f;
// The dq kernel below D 256: 64 keys a step, three warpgroups of 64 query
// rows (PERF.md section 6 compares 128 keys and two warpgroups)
constexpr int kDqKeys = 64;
constexpr int kDqGroups = 3;

template <int D>
struct Bwd {
  // D 256: the two warpgroups split D (above)
  static constexpr bool SPLITD = D > 128;
  static constexpr int DW = SPLITD ? D / 2 : D;         // columns a warpgroup
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // bytes a smem row
  static constexpr int CW = SW / 2;                     // elements a row
  static constexpr int NCH = D / CW;                    // column chunks
  // wgmma's swizzle code: 1 = 128 bytes, 2 = 64, 3 = 32
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int CHUNK = kTile * SW;              // bytes
  static constexpr int TILE_BYTES = NCH * CHUNK;        // a 64-row tile
  static constexpr int ROW_BYTES = 2 * kTile * 4;       // lse2, delta
  // dk/dv: K, V, and rings of (Q, dO) tiles with their rows (a warpgroup
  // each, or one shared when they split D), an mbarrier for K/V and for
  // each stage, a release count a stage, 1024 bytes to align to the
  // swizzle's atom
  static constexpr int RINGS = SPLITD ? 1 : 2;
  static constexpr size_t kv_bytes(int ns) {
    return 1024 + 2 * (size_t)TILE_BYTES +
           (size_t)RINGS * ns * (2 * TILE_BYTES + ROW_BYTES) +
           8 * (1 + RINGS * ns) + 4 * RINGS * ns;
  }
  static constexpr int NS = kv_bytes(4) <= kSmemMax   ? 4
                            : kv_bytes(3) <= kSmemMax ? 3
                                                      : 2;
  static constexpr size_t kv_smem = kv_bytes(NS);
  // dq: WG warpgroups, BM query rows of Q and dO, and a ring of K, V
  // tiles of BK keys
  static constexpr int WG = SPLITD ? 2 : kDqGroups;
  static constexpr int DQ_THREADS = 128 * WG;
  static constexpr int BM = SPLITD ? kTile : WG * kTile;
  static constexpr int Q_CHUNK = BM * SW;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int BK = SPLITD ? kTile : kDqKeys;
  static constexpr int K_CHUNK = BK * SW;
  static constexpr int K_BYTES = NCH * K_CHUNK;
  static constexpr size_t q_bytes(int st) {
    return 1024 + 2 * (size_t)Q_BYTES + 2 * (size_t)st * K_BYTES +
           8 * (1 + 2 * st) + 4 * st;
  }
  static constexpr int STAGES = q_bytes(4) <= kSmemMax   ? 4
                                : q_bytes(3) <= kSmemMax ? 3
                                                         : 2;
  static constexpr size_t q_smem = q_bytes(STAGES);
};
static_assert(Bwd<128>::kv_smem <= kSmemMax && Bwd<256>::kv_smem <= kSmemMax,
              "dk/dv exceeds shared memory");
static_assert(Bwd<128>::q_smem <= kSmemMax && Bwd<256>::q_smem <= kSmemMax,
              "dq exceeds shared memory");
// warpgroup 1's ring tiles take its dK and dV sums at the end
static_assert(Bwd<128>::NS * 2 * Bwd<128>::TILE_BYTES >= 2 * kTile * 128 * 4,
              "the ring cannot hold the sums");

// K-major (both operands of S^T = K Q^T, S = Q K^T): rows of SW bytes,
// 8-row groups SBO apart; a 16-element step along K is an offset of the
// start address
template <class C>
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return smem_desc(addr, 16, 8 * C::SW, C::LAYOUT);
}

// MN-major (dO, Q or K as B of a product with A in registers): N (D) along
// the swizzled row, its next 64-column chunk `chunk` bytes away; K (the
// tile's rows) down the rows, 8-row groups SBO apart
template <class C>
__device__ __forceinline__ uint64_t mndesc(uint32_t addr, uint32_t chunk) {
  return smem_desc(addr, chunk, 8 * C::SW, C::LAYOUT);
}

__device__ __forceinline__ float2 bf16x2_float2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// -- 1. the rows: lse * log2 e and delta = rowsum(do * o) ------------------

// One warp a row of the padded (B * H, Sq_pad) scratch: lse2 in the first
// plane, delta in the second; padding rows +inf and 0.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ rows,
                int Sq, int Sq_pad, long long n_rows) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const long long bh = row / Sq_pad;
  const int qi = (int)(row % Sq_pad);
  float acc = 0.f, l2 = __int_as_float(0x7f800000);
  if (qi < Sq) {
    const long long src = (bh * Sq + qi) * D;
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 a = bf16x2_float2(
          *reinterpret_cast<const uint32_t*>(o + src + d));
      const float2 g = bf16x2_float2(
          *reinterpret_cast<const uint32_t*>(dout + src + d));
      acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l2 = lse[bh * Sq + qi] * kLog2e;   // +inf stays +inf
  }
  if (lane == 0) {
    rows[row] = l2;
    rows[n_rows + row] = acc;
  }
}

// -- 2. dk, dv ----------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ rows,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int B, int H, int KVH,
                   int Sq, int Sk, int Sq_pad, int causal, int window,
                   float scale, float scale_log2) {
  using C = Bwd<D>;
  constexpr int T = kTile, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // shared memory: K | V | rings of (Q, dO) | their rows | mbarriers | counts
  const uint32_t s_k = (raw + 1023) & ~1023u;
  const uint32_t s_v = s_k + C::TILE_BYTES;
  const uint32_t s_ring = s_v + C::TILE_BYTES;
  const uint32_t s_rows = s_ring + C::RINGS * NS * 2 * C::TILE_BYTES;
  const uint32_t bars = s_rows + C::RINGS * NS * C::ROW_BYTES;
  const uint32_t kv_full = bars;
  auto full = [&](int r, int s) { return bars + 8 * (1 + r * NS + s); };
  auto q_tile = [&](int r, int s) {
    return s_ring + (r * NS + s) * 2 * C::TILE_BYTES;   // dO TILE_BYTES on
  };
  auto row_vals = [&](int r, int s) {
    return s_rows + (r * NS + s) * C::ROW_BYTES;        // lse2, then delta
  };
  int* released = reinterpret_cast<int*>(
      smem_raw + (bars + 8 * (1 + C::RINGS * NS) - raw));

  // the block: (KV tile, KV head, batch), the tiles with the most queries
  // (the first, in a causal call) first
  const int hb = blockIdx.x % (KVH * B);
  const int k0 = blockIdx.x / (KVH * B) * T;
  const int kvh = hb % KVH, b = hb / KVH;
  const int G = H / KVH;
  // the queries any key of this tile is admitted by: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq, k0 + T - 1 + window) : Sq;
  const int t_lo = q_lo / T;
  const int nt = q_hi > q_lo ? (q_hi + T - 1) / T - t_lo : 0;
  const int n = G * nt;                 // the CTA's (query head, tile) steps
  const size_t plane = (size_t)B * H * Sq_pad;

  const int wg = threadIdx.x / 128;
  const int ring = C::SPLITD ? 0 : wg;
  // a warpgroup's steps: all of them when the warpgroups split D, else
  // every other one
  const int n_mine = C::SPLITD ? n : (n - wg + 1) / 2;

  // step j of ring r (the CTA's step j, or 2 j + r) into stage j % NS
  auto load = [&](int r, int j) {
    const int i = C::SPLITD ? j : 2 * j + r;
    const int q0 = (t_lo + i % nt) * T;
    const int bh = b * H + kvh * G + i / nt;
    const int s = j % NS;
    const uint32_t bar = full(r, s), qs = q_tile(r, s);
    mbar_expect_tx(bar, 2 * C::TILE_BYTES + C::ROW_BYTES);
    for (int c = 0; c < C::NCH; ++c) {
      tma_load_3d(qs + c * C::CHUNK, &tq, bar, c * C::CW, q0, bh);
      tma_load_3d(qs + C::TILE_BYTES + c * C::CHUNK, &tdo, bar, c * C::CW,
                  q0, bh);
    }
    const float* src = rows + (size_t)bh * Sq_pad + q0;
    bulk_load(row_vals(r, s), src, T * 4, bar);
    bulk_load(row_vals(r, s) + T * 4, src + plane, T * 4, bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int r = 0; r < C::RINGS; ++r)
      for (int s = 0; s < NS; ++s) {
        mbar_init(full(r, s), 1);
        released[r * NS + s] = 0;
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) {
      mbar_expect_tx(kv_full, 2 * C::TILE_BYTES);
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_3d(s_k + c * C::CHUNK, &tk, kv_full, c * C::CW, k0,
                    b * KVH + kvh);
        tma_load_3d(s_v + c * C::CHUNK, &tv, kv_full, c * C::CW, k0,
                    b * KVH + kvh);
      }
    }
  }
  __syncthreads();
  // each ring's first tiles, by its warpgroup's first thread
  if (threadIdx.x % 128 == 0 && wg < C::RINGS)
    for (int j = 0; j < min(NS, n_mine); ++j) load(ring, j);

  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int kr = warp * 16 + lane / 4;    // this thread's keys kr, kr + 8
  const int c0 = 2 * (lane % 4);          // its columns of each 8
  const int dcol = C::SPLITD ? wg * C::DW : 0;   // its first column of D
  const float* rows_sh =
      reinterpret_cast<const float*>(smem_raw + (s_rows - raw));
  auto ok = [&](int qi, int kj) {
    return qi < Sq && admitted(qi, kj, Sk, causal, window);
  };

  // fragment element 4 j + e: key kr + 8 (e >> 1), column 8 j + c0 + (e & 1)
  float adk[C::DW / 2], adv[C::DW / 2];
#pragma unroll
  for (int e = 0; e < C::DW / 2; ++e) adk[e] = adv[e] = 0.f;

  if (n_mine > 0) mbar_wait(kv_full, 0);
  for (int j = 0; j < n_mine; ++j) {
    const int i = C::SPLITD ? j : 2 * j + wg;
    const int q0 = (t_lo + i % nt) * T;
    const int s = j % NS;
    const uint32_t qs = q_tile(ring, s), dos = qs + C::TILE_BYTES;
    const float* lse2 = rows_sh + (ring * NS + s) * 2 * T;
    const float* dl = lse2 + T;
    mbar_wait(full(ring, s), (j / NS) & 1);

    // S^T = K Q^T and dP^T = V dO^T: keys x queries
    float st[T / 2], dpt[T / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
      wgmma_ss<T>(st, kdesc<C>(s_k + c * C::CHUNK + off),
                  kdesc<C>(qs + c * C::CHUNK + off), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
      wgmma_ss<T>(dpt, kdesc<C>(s_v + c * C::CHUNK + off),
                  kdesc<C>(dos + c * C::CHUNK + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T, masked only on a tile that straddles an edge, as the A operand
    // 16 queries a step: registers (key, queries) (kr, 2c), (kr + 8, 2c),
    // (kr, 2c + 8), (kr + 8, 2c + 8), hi and lo
    const bool edge = (causal && k0 + T - 1 > q0) ||
                      (window && k0 <= q0 + T - 1 - window) ||
                      q0 + T > Sq || k0 + T > Sk;
    uint32_t hi[T / 16][4], lo[T / 16][4];
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int f = 4 * (2 * kk + (g >> 1)) + 2 * (g & 1);
        const int col = 8 * (2 * kk + (g >> 1)) + c0;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
        float p0 = exp2f(fmaf(st[f], scale_log2, -l2.x));
        float p1 = exp2f(fmaf(st[f + 1], scale_log2, -l2.y));
        if (edge) {
          const int kj = k0 + kr + 8 * (g & 1);
          if (!ok(q0 + col, kj)) p0 = 0.f;
          if (!ok(q0 + col + 1, kj)) p1 = 0.f;
        }
        split_bf16x2(p0, p1, hi[kk][g], lo[kk][g]);
      }

    // dV += P^T dO
    fence_regs(adv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      const uint64_t bd =
          mndesc<C>(dos + dcol / C::CW * C::CHUNK + kk * 16 * C::SW,
                    C::CHUNK);
      wgmma_rs<C::DW>(adv, hi[kk], bd);
      wgmma_rs<C::DW>(adv, lo[kk], bd);
    }
    wgmma_commit();
    // dP^T is in; while dV's products run, dS^T = P^T (dP^T - delta)
    wgmma_wait<1>();
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int f = 4 * (2 * kk + (g >> 1)) + 2 * (g & 1);
        const int col = 8 * (2 * kk + (g >> 1)) + c0;
        const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
        const float2 ph = bf16x2_float2(hi[kk][g]);
        const float2 pl = bf16x2_float2(lo[kk][g]);
        dpt[f] = (ph.x + pl.x) * (dpt[f] - d2.x);
        dpt[f + 1] = (ph.y + pl.y) * (dpt[f + 1] - d2.y);
      }
    wgmma_wait<0>();
    fence_regs(adv);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int f = 4 * (2 * kk + (g >> 1)) + 2 * (g & 1);
        split_bf16x2(dpt[f], dpt[f + 1], hi[kk][g], lo[kk][g]);
      }

    // dK += dS^T Q
    fence_regs(adk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      const uint64_t bd =
          mndesc<C>(qs + dcol / C::CW * C::CHUNK + kk * 16 * C::SW,
                    C::CHUNK);
      wgmma_rs<C::DW>(adk, hi[kk], bd);
      wgmma_rs<C::DW>(adk, lo[kk], bd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adk);

    // the warpgroup is done with stage s; the last of its consumers loads
    // the ring's step NS on into it
    named_barrier_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      __threadfence_block();
      if (atomicAdd(&released[ring * NS + s], 1) == (C::SPLITD ? 1 : 0)) {
        released[ring * NS + s] = 0;
        __threadfence_block();
        if (j + NS < n_mine) load(ring, j + NS);
      }
    }
  }

  if constexpr (!C::SPLITD) {
    // warpgroup 1 hands its sums to warpgroup 0 through its own ring's
    // tiles, which no load writes any more; warpgroup 0 adds them
    float* x = reinterpret_cast<float*>(smem_raw + (q_tile(1, 0) - raw));
    const int t = threadIdx.x % 128;
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < C::DW / 2; ++e) {
        x[e * 128 + t] = adk[e];
        x[(C::DW / 2 + e) * 128 + t] = adv[e];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < C::DW / 2; ++e) {
      adk[e] += x[e * 128 + t];
      adv[e] += x[(C::DW / 2 + e) * 128 + t];
    }
  }
  // the epilogue: dK * scale and dV, the keys below Sk, this warpgroup's
  // columns
  const size_t kv_row0 = ((size_t)b * KVH + kvh) * Sk + k0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr + 8 * r;
    if (k0 + key >= Sk) continue;
    __nv_bfloat16* pk = dk + (kv_row0 + key) * D + dcol;
    __nv_bfloat16* pv = dv + (kv_row0 + key) * D + dcol;
#pragma unroll
    for (int jj = 0; jj < C::DW / 8; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(pk + 8 * jj + c0) =
          __floats2bfloat162_rn(adk[4 * jj + 2 * r] * scale,
                                adk[4 * jj + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(pv + 8 * jj + c0) =
          __floats2bfloat162_rn(adv[4 * jj + 2 * r],
                                adv[4 * jj + 2 * r + 1]);
    }
  }
}

// -- 3. dq --------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Bwd<D>::DQ_THREADS, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ rows,
                 __nv_bfloat16* __restrict__ dq, int B, int H, int KVH,
                 int Sq, int Sk, int Sq_pad, int causal, int window,
                 float scale, float scale_log2) {
  using C = Bwd<D>;
  constexpr int BK = C::BK, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // shared memory: Q | dO | K ring | V ring | mbarriers | release counts
  const uint32_t s_q = (raw + 1023) & ~1023u;
  const uint32_t s_do = s_q + C::Q_BYTES;
  const uint32_t s_k = s_do + C::Q_BYTES;
  const uint32_t s_v = s_k + ST * C::K_BYTES;
  const uint32_t bars = s_v + ST * C::K_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + ST + s); };
  int* released =
      reinterpret_cast<int*>(smem_raw + (bars + 8 * (1 + 2 * ST) - raw));

  // the block: (query tile, head, batch), the tiles with the most keys
  // (the last, in a causal call) first
  const int n_qt = gridDim.x / (H * B);
  const int hb = blockIdx.x % (H * B);
  const int q0 = (n_qt - 1 - blockIdx.x / (H * B)) * C::BM;
  const int h = hb % H, b = hb / H;
  const int q_valid = min(C::BM, Sq - q0);
  // the keys any row of this tile admits: [k_lo, k_hi)
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + q_valid) : Sk;
  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - t_lo : 0;
  const int bh = b * H + h, bh_kv = b * KVH + h * KVH / H;

  // tile i of the walk into stage i % ST: K and V
  auto load_kv = [&](int i) {
    const int s = i % ST, k0 = (t_lo + i) * BK;
    mbar_expect_tx(k_full(s), C::K_BYTES);
    for (int c = 0; c < C::NCH; ++c)
      tma_load_3d(s_k + s * C::K_BYTES + c * C::K_CHUNK, &tk, k_full(s),
                  c * C::CW, k0, bh_kv);
    mbar_expect_tx(v_full(s), C::K_BYTES);
    for (int c = 0; c < C::NCH; ++c)
      tma_load_3d(s_v + s * C::K_BYTES + c * C::K_CHUNK, &tv, v_full(s),
                  c * C::CW, k0, bh_kv);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_3d(s_q + c * C::Q_CHUNK, &tq, q_full, c * C::CW, q0, bh);
        tma_load_3d(s_do + c * C::Q_CHUNK, &tdo, q_full, c * C::CW, q0, bh);
      }
    }
    for (int i = 0; i < min(n_tiles, ST); ++i) load_kv(i);
  }
  __syncthreads();

  // a warpgroup: 64 query rows (the same rows for both at D 256)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row_off = C::SPLITD ? 0 : wg * 64;
  const int qw0 = q0 + row_off;
  const int r0 = qw0 + warp * 16 + lane / 4;    // this thread's rows r0, r0+8
  const int c0 = 2 * (lane % 4);
  const int dcol = C::SPLITD ? wg * C::DW : 0;
  // the rows' lse2 and delta; a row past Sq has none (p = 0)
  const float* lrow = rows + (size_t)bh * Sq_pad;
  const size_t plane = (size_t)B * H * Sq_pad;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    l2[r] = qi < Sq ? lrow[qi] : __int_as_float(0x7f800000);
    dl[r] = qi < Sq ? lrow[plane + qi] : 0.f;
  }

  float adq[C::DW / 2];
#pragma unroll
  for (int e = 0; e < C::DW / 2; ++e) adq[e] = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  const uint32_t q_wg = s_q + row_off * C::SW;
  const uint32_t do_wg = s_do + row_off * C::SW;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const uint32_t phase = (i / ST) & 1;
    const int k0 = (t_lo + i) * BK;
    const uint32_t ks = s_k + s * C::K_BYTES, vs = s_v + s * C::K_BYTES;

    // S = Q K^T, dP = dO V^T
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(k_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
      wgmma_ss<BK>(sc, kdesc<C>(q_wg + c * C::Q_CHUNK + off),
                   kdesc<C>(ks + c * C::K_CHUNK + off), kk > 0);
    }
    wgmma_commit();
    mbar_wait(v_full(s), phase);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
      wgmma_ss<BK>(dp, kdesc<C>(do_wg + c * C::Q_CHUNK + off),
                   kdesc<C>(vs + c * C::K_CHUNK + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P, masked only on a tile that straddles an edge
    const bool edge = (causal && k0 + BK - 1 > qw0) ||
                      (window && k0 <= qw0 + 63 - window) || k0 + BK > Sk;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[4 * jj + e], scale_log2, -l2[e >> 1]));
        if (edge && !admitted(r0 + 8 * (e >> 1), k0 + 8 * jj + c0 + (e & 1),
                              Sk, causal, window))
          p = 0.f;
        sc[4 * jj + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P (dP - delta) as the A operand, hi and lo
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int f = 4 * (2 * kk + (g >> 1)) + 2 * (g & 1);
        split_bf16x2(sc[f] * (dp[f] - dl[g & 1]),
                     sc[f + 1] * (dp[f + 1] - dl[g & 1]), hi[kk][g],
                     lo[kk][g]);
      }

    // dQ += dS K
    fence_regs(adq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t bd = mndesc<C>(
          ks + dcol / C::CW * C::K_CHUNK + kk * 16 * C::SW, C::K_CHUNK);
      wgmma_rs<C::DW>(adq, hi[kk], bd);
      wgmma_rs<C::DW>(adq, lo[kk], bd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adq);
    // the warpgroup is done with stage s; the last of them to be done
    // loads the tile ST on into it
    named_barrier_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1) == C::WG - 1) {
        released[s] = 0;
        __threadfence_block();
        if (i + ST < n_tiles) load_kv(i + ST);
      }
    }
  }

  // the epilogue: dQ * scale, the rows below Sq
  const size_t head = (size_t)bh * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (head + qi) * D + dcol;
#pragma unroll
    for (int jj = 0; jj < C::DW / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * jj + c0) =
          __floats2bfloat162_rn(adq[4 * jj + 2 * r] * scale,
                                adq[4 * jj + 2 * r + 1] * scale);
  }
}

// -- the host side ------------------------------------------------------------

long long padded_rows(int Sq) {
  return (long long)(Sq + kPadRows - 1) / kPadRows * kPadRows;
}

// A map over a (planes, rows, D) bf16 tensor, boxes of (1, box_rows, CW);
// out-of-bounds rows read as zeros.  Returns 0 when the map was made.
template <int D>
int encode(CUtensorMap* map, const void* base, int rows, int planes,
           int box_rows) {
  using C = Bwd<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return 1;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)C::CW, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = C::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                 const_cast<void*>(base), dims, strides, box, unit,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* rows, void* dq,
           void* dk, void* dv, int B, int H, int KVH, int Sq, int Sk,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Bwd<D>;
  CUtensorMap tq, tdo, tk, tv, tqm, tdom, tkd, tvd;
  if (encode<D>(&tq, q, Sq, B * H, kTile) ||
      encode<D>(&tdo, dout, Sq, B * H, kTile) ||
      encode<D>(&tk, k, Sk, B * KVH, kTile) ||
      encode<D>(&tv, v, Sk, B * KVH, kTile) ||
      encode<D>(&tkd, k, Sk, B * KVH, C::BK) ||
      encode<D>(&tvd, v, Sk, B * KVH, C::BK) ||
      encode<D>(&tqm, q, Sq, B * H, C::BM) ||
      encode<D>(&tdom, dout, Sq, B * H, C::BM))
    return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  int rc = (int)cudaFuncSetAttribute(
      bwd_dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kv_smem);
  if (rc) return rc;
  rc = (int)cudaFuncSetAttribute(bwd_dq_tc_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)C::q_smem);
  if (rc) return rc;
  const int sq_pad = (int)padded_rows(Sq);
  const long long n_rows = (long long)B * H * sq_pad;
  const int per_block = kThreads / 32;
  bwd_rows_kernel<D><<<(unsigned)((n_rows + per_block - 1) / per_block),
                       kThreads, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, rows, Sq,
      sq_pad, n_rows);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const float scale_log2 = scale * kLog2e;
  const unsigned kv_blocks = (unsigned)((Sk + kTile - 1) / kTile) * KVH * B;
  bwd_dkdv_tc_kernel<D><<<kv_blocks, kThreads, C::kv_smem, stream>>>(
      tq, tdo, tk, tv, rows, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B, H,
      KVH, Sq, Sk, sq_pad, causal, window, scale, scale_log2);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const unsigned q_blocks = (unsigned)((Sq + C::BM - 1) / C::BM) * H * B;
  bwd_dq_tc_kernel<D><<<q_blocks, C::DQ_THREADS, C::q_smem, stream>>>(
      tqm, tdom, tkd, tvd, rows, (__nv_bfloat16*)dq, B, H, KVH, Sq, Sk,
      sq_pad, causal, window, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of the rows' scratch that repro_flash_attention_bwd_tc needs for
// (B, H, Sq): lse2 and delta, each (B * H) rows of Sq padded to 128.
long long repro_flash_attention_bwd_tc_scratch(int B, int H, int Sq) {
  return 2LL * B * H * padded_rows(Sq);
}

// The arguments of repro_flash_attention_bwd (csrc/flash_attention_bwd.cu);
// dtype 1 (bfloat16) only; delta: the caller's float32 scratch of
// repro_flash_attention_bwd_tc_scratch(B, H, Sq) floats, 16-byte aligned.
int repro_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int dtype, int B, int H,
                                 int KVH, int Sq, int Sk, int D, int causal,
                                 int window, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* r = (float*)delta;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define REPRO_BWD_TC(DD)                                                    \
  case DD:                                                                  \
    return launch<DD>(q, k, v, o, dout, l, r, dq, dk, dv, B, H, KVH, Sq,    \
                      Sk, causal, window, scale, st);
  switch (D) {
    REPRO_BWD_TC(16)
    REPRO_BWD_TC(32)
    REPRO_BWD_TC(64)
    REPRO_BWD_TC(128)
    REPRO_BWD_TC(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD_TC
}

}  // extern "C"
