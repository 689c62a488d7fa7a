// Flash attention on Hopper's tensor cores: the bfloat16 instance, sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py:96 (flash_attention; its
// pallas_call at :131) for bfloat16 inputs; csrc/flash_attention.cu holds
// the float32 instance.  The contract is the same: q (B, H, Sq, D); k, v
// (B, KVH, Sk, D); out (B, H, Sq, D), all bfloat16, contiguous and 16-byte
// aligned; D in {16, 32, 64, 128, 256}.  Head h reads KV head h * KVH / H.
// Key j is admitted for query i when j < Sk, j <= i (causal) and
// j > i - window (window > 0), positions from 0 also when Sq != Sk.
// Accumulation is float32.  A row with no admissible key is written as 0.
// With a non-null lse pointer the epilogue also writes each row's
// log-sum-exp of the scaled scores, float32 (B, H, Sq), for the backward
// (csrc/flash_attention_bwd.cu); +inf for a row with no admissible key.
// The serving path passes null and the kernel writes nothing more.
//
// Bound by operations: 4 * D operations per admitted (query, key) pair and
// head.  At the chip check's shapes (S = 32768, B = 1), against 989 TFLOP/s
// of dense bf16: qwen2-1.5b (H 12, KVH 2, D 128, causal) 3.30e12
// operations, 3.34 ms; gemma3-1b global (H 4, KVH 1, D 256, causal)
// 2.20e12, 2.22 ms; gemma3-1b local (window 512) 0.069 ms (0.050 ms by
// bytes).
//
// Design:
// - One CTA of 256 threads per (128-row query tile, head, batch): two
//   warpgroups of 64 query rows each.  There is no producer warp: the SM
//   deals warps to its four sub-partitions of 16384 registers, so a ninth
//   warp puts three on one of them and caps every thread at 168 registers,
//   fewer than O (128 f32 registers a thread at D 256) with S and P beside
//   it; with eight warps a thread may hold 255.  (A producer warpgroup
//   handing its registers over with setmaxnreg did not help: ptxas
//   allocated the consumer code at 168 with or without it.)  The grid
//   launches the tiles with the most keys (the last query tiles of a
//   causal call) first.
// - Q once, then K and V tile by tile, through TMA: 3-D tensor maps over
//   (D, S, B * heads) with the widest swizzle a row allows (128 bytes from
//   D 64 up; 64 and 32 bytes for D 32 and 16), rows of 64 elements at most,
//   so a wider head is loaded as D / 64 column chunks.  Rows past Sq or Sk
//   come back as zeros, so a ragged tail needs no padded copy.  K and V
//   pass through a ring of three stages (two at D 256); each load completes
//   on an mbarrier (one for K, one for V).  Thread 0 loads Q and the ring's
//   first tiles; after that the second warpgroup to be done with a stage
//   (a count in shared memory says which) loads the tile three (two) on
//   into it, so neither warpgroup waits on the other.
// - The CTA walks only the KV tiles that hold an admissible key for one of
//   its rows, [k_lo, k_hi), so an above-diagonal or out-of-window tile is
//   never loaded; the per-element mask runs only on a tile that straddles
//   the diagonal, the window's edge or Sk.
// - S = Q K^T on wgmma (m64 n BK k16, both operands from shared memory,
//   K-major), f32 accumulators; the online softmax on the accumulator
//   fragments (exp2 with the scale folded in as scale * log2 e, the row max
//   and sum over the 4 threads of a quad).
// - O += P V on wgmma with P in registers (the S accumulator's fragment is
//   the A operand's layout) and V read MN-major from the same tile K came
//   in.  P goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
//   two products: the reference keeps p in float32, and p rounded once to
//   bf16 moves outputs by more than one bf16 rounding, the limit the chip
//   check holds the full-width calls to.  So the tensor cores execute 6 * D
//   operations a pair for the 4 * D counted.
// - Tiles: BK = 128 keys up to D 128 (S 64 and O 64 f32 registers a
//   thread at D 128), 64 at D 256 (O 128 registers a thread); shared
//   memory 29 KB (D 16) to 225 KB (D 128).
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched; an unsupported D or dtype, or a tensor
// map cuTensorMapEncodeTiled refuses, returns cudaErrorInvalidValue without
// launching).
// cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
// library links against the runtime only.  The helpers this kernel shares
// with its backward (csrc/flash_attention_bwd_tc.cu) are in
// csrc/flash_tc.cuh.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

constexpr int kBQ = 128;                         // query rows a CTA
constexpr int kWarpgroups = 2;                   // of 64 query rows each
constexpr int kThreads = 128 * kWarpgroups;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;        // keys a KV tile
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // bytes a smem row
  static constexpr int CW = SW / 2;                     // elements a row
  static constexpr int NCH = D / CW;                    // column chunks
  static constexpr int Q_CHUNK = kBQ * SW;              // bytes
  static constexpr int KV_CHUNK = BK * SW;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;       // one K or V tile
  // wgmma's swizzle code: 1 = 128 bytes, 2 = 64, 3 = 32
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  // Q, a ring of `stages` K and V tiles, an mbarrier for Q and for each
  // K and V, a release count a stage, and 1024 bytes of slack to align the
  // tiles to the swizzle's 1024-byte atom
  static constexpr size_t bytes(int stages) {
    return 1024 + Q_BYTES + 2 * stages * KV_BYTES + 8 * (1 + 2 * stages) +
           4 * stages;
  }
  // the K/V ring: three stages where they fit, else two
  static constexpr int STAGES = bytes(3) <= 232448 ? 3 : 2;
  static constexpr int N_BARS = 1 + 2 * STAGES;
  static constexpr size_t smem_bytes = bytes(STAGES);
};
static_assert(Cfg<256>::smem_bytes <= 232448, "D 256 exceeds shared memory");
static_assert(Cfg<128>::smem_bytes <= 232448, "D 128 exceeds shared memory");

// -- wgmma operand descriptors ------------------------------------------------

// K-major (Q, and K for S = Q K^T): rows of SW bytes, 8-row groups SBO
// apart; a 16-element step along K stays inside the swizzled row, so it is
// an offset of the start address and LBO is not read.
template <class C>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 8 * C::SW, C::LAYOUT);
}

// MN-major (V for O += P V): the N direction (D) runs along the swizzled
// row, its next 64-column chunk LBO = KV_CHUNK away; the K direction (keys)
// runs down the rows, 8-row groups SBO apart.
template <class C>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, C::KV_CHUNK, 8 * C::SW, C::LAYOUT);
}

// -- the kernel ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int H, int KVH, int Sq, int Sk, int causal, int window,
                float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  // shared memory: Q | K ring | V ring | mbarriers | release counts
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + C::Q_BYTES;
  const uint32_t s_v = s_k + C::STAGES * C::KV_BYTES;
  const uint32_t bars = s_v + C::STAGES * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + C::STAGES + s); };
  // how many warpgroups are done with each stage's tile
  int* released = reinterpret_cast<int*>(
      smem_raw + (bars + 8 * C::N_BARS - smem_u32(smem_raw)));

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_valid = min(kBQ, Sq - q0);
  // the keys any row of this tile admits: [k_lo, k_hi)
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + q_valid) : Sk;
  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - t_lo : 0;
  const int bh_kv = b * KVH + h * KVH / H;

  // tile i of the walk into stage i % STAGES: K and V, D / 64 chunks each
  auto load_kv = [&](int i) {
    const int s = i % C::STAGES, k0 = (t_lo + i) * BK;
    mbar_expect_tx(k_full(s), C::KV_BYTES);
    for (int c = 0; c < C::NCH; ++c)
      tma_load_3d(s_k + s * C::KV_BYTES + c * C::KV_CHUNK, &tk, k_full(s),
                  c * C::CW, k0, bh_kv);
    mbar_expect_tx(v_full(s), C::KV_BYTES);
    for (int c = 0; c < C::NCH; ++c)
      tma_load_3d(s_v + s * C::KV_BYTES + c * C::KV_CHUNK, &tv, v_full(s),
                  c * C::CW, k0, bh_kv);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q, and the ring's first tiles
    if (n_tiles > 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load_3d(s_q + c * C::Q_CHUNK, &tq, q_full, c * C::CW, q0,
                    b * H + h);
    }
    for (int i = 0; i < min(n_tiles, C::STAGES); ++i) load_kv(i);
  }
  __syncthreads();

  // a warpgroup: 64 query rows
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qw0 = q0 + wg * 64;                   // the warpgroup's first row
  const int r0 = qw0 + warp * 16 + lane / 4;      // this thread's rows r0, r0+8
  const int c0 = 2 * (lane % 4);                  // its columns of each 8
  const float neg_inf = __uint_as_float(0xff800000u);

  // fragment element 4 j + e: row r0 + 8 (e >> 1), column 8 j + c0 + (e & 1)
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(q_full, 0);
  const uint32_t q_wg = s_q + wg * 64 * C::SW;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES;
    const uint32_t phase = (i / C::STAGES) & 1;
    const int k0 = (t_lo + i) * BK;
    const uint32_t ks = s_k + s * C::KV_BYTES, vs = s_v + s * C::KV_BYTES;

    // S = Q K^T
    float sc[BK / 2];
    mbar_wait(k_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
      wgmma_ss<BK>(sc, kmajor_desc<C>(q_wg + c * C::Q_CHUNK + off),
                   kmajor_desc<C>(ks + c * C::KV_CHUNK + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // the mask, only on a tile that straddles an edge
    const bool edge = (causal && k0 + BK - 1 > qw0) ||
                      (window && k0 <= qw0 + 63 - window) || k0 + BK > Sk;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!admitted(r0 + 8 * (e >> 1), k0 + 8 * j + c0 + (e & 1), Sk,
                        causal, window))
            sc[4 * j + e] = neg_inf;
    }

    // the online softmax of each of the thread's two rows
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no key yet keeps m = -inf: exponents from 0, p = 0
      base[r] = mx[r] == neg_inf ? 0.f : mx[r] * scale_log2;
      alpha[r] = exp2f(m[r] * scale_log2 - base[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -base[e >> 1]));
        sc[4 * j + e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];

    // P as the A operand, 16 keys a step: registers (row, keys) (r0, 2c),
    // (r0 + 8, 2c), (r0, 2c + 8), (r0 + 8, 2c + 8), hi and lo
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int f = 4 * (2 * kk + (g >> 1)) + 2 * (g & 1);
        split_bf16x2(sc[f], sc[f + 1], p_hi[kk][g], p_lo[kk][g]);
      }

    // O += P V
    mbar_wait(v_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = mnmajor_desc<C>(vs + kk * 16 * C::SW);
      wgmma_rs<D>(o, p_hi[kk], dv);
      wgmma_rs<D>(o, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    // the warpgroup is done with stage s; the last of the two to be done
    // loads the tile STAGES on into it
    named_barrier_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1) == kWarpgroups - 1) {
        released[s] = 0;
        __threadfence_block();
        if (i + C::STAGES < n_tiles) load_kv(i + C::STAGES);
      }
    }
  }

  // the epilogue: each row's sum over its quad, O / l (l == 0: 0 / 1)
  const size_t head = ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r0 + 8 * r;
    if (qi >= Sq) continue;
    // the row's log-sum-exp of the scaled scores (natural log), for the
    // backward: p = 2^(s * scale_log2 - m * scale_log2) summed to l, so
    // lse = (m * scale_log2 + log2 l) * ln 2; +inf for a row with no key
    if (lse != nullptr && c0 == 0)
      lse[head + qi] = l[r] == 0.f
                           ? __int_as_float(0x7f800000)
                           : (m[r] * scale_log2 + log2f(l[r])) *
                                 0.6931471805599453f;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* row = out + (head + qi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
          __floats2bfloat162_rn(__fdividef(o[4 * j + 2 * r], safe),
                                __fdividef(o[4 * j + 2 * r + 1], safe));
  }
}

// -- the host side ------------------------------------------------------------


// A map over a (planes, rows, D) bf16 tensor, boxes of (1, box_rows, CW);
// out-of-bounds rows read as zeros.  Returns 0 when the map was made.
template <int D>
int encode(CUtensorMap* map, const void* base, int rows, int planes,
           int box_rows) {
  using C = Cfg<D>;
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
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int KVH, int Sq, int Sk, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (encode<D>(&tq, q, Sq, B * H, kBQ) ||
      encode<D>(&tk, k, Sk, B * KVH, C::BK) ||
      encode<D>(&tv, v, Sk, B * KVH, C::BK))
    return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  const int rc = (int)cudaFuncSetAttribute(flash_tc_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)C::smem_bytes);
  if (rc) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_tc_kernel<D><<<grid, kThreads, C::smem_bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, H, KVH, Sq, Sk, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 1 bfloat16 (the only one this instance takes).  Every tensor
// contiguous and 16-byte aligned.  lse: null, or float32 (B, H, Sq) for
// each row's log-sum-exp.
int repro_flash_attention_tc(const void* q, const void* k, const void* v,
                             void* out, void* lse_, int dtype, int B, int H,
                             int KVH, int Sq, int Sk, int D, int causal,
                             int window, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float* lse = (float*)lse_;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch<16>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 32: return launch<32>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 64: return launch<64>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 256: return launch<256>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
