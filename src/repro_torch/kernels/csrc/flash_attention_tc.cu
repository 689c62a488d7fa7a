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
// library links against the runtime only.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// -- shared memory, mbarriers, TMA -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// bar.sync on barrier `id` for `n` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_barrier_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait longer than
// 10 s can only be a lost arrival: it traps, so that a fault is reported
// instead of a card that never finishes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spins & 0xffff) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle code.  Tiles are 1024-byte aligned, so
// the base-offset field stays 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | ((uint64_t)layout << 62);
}

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading or writing accumulator registers across
// the asynchronous product: every use after the wait goes through this.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (N = BK columns) from two shared-memory descriptors; scale_d 0 zeroes
// the accumulator first.  PTX names every accumulator register, so the
// operand lists are written out.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// O (N = D columns) += A from registers x B MN-major from shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// -- the kernel ---------------------------------------------------------------

__device__ __forceinline__ bool admitted(int qi, int kj, int sk, int causal,
                                         int window) {
  return kj < sk && (!causal || kj <= qi) && (!window || kj > qi - window);
}

// p, q as a bf16 pair (p in the low half) and the pair of what rounding
// left over
__device__ __forceinline__ void split_bf16x2(float p, float q, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p, q);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p - hf.x, q - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int H, int KVH, int Sq,
                int Sk, int causal, int window, float scale_log2) {
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

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
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KVH, int Sq, int Sk, int causal, int window,
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
      tq, tk, tv, (__nv_bfloat16*)out, H, KVH, Sq, Sk, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 1 bfloat16 (the only one this instance takes).  Every tensor
// contiguous and 16-byte aligned.
int repro_flash_attention_tc(const void* q, const void* k, const void* v,
                             void* out, int dtype, int B, int H, int KVH,
                             int Sq, int Sk, int D, int causal, int window,
                             float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch<16>(q, k, v, out, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 32: return launch<32>(q, k, v, out, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 64: return launch<64>(q, k, v, out, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, out, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 256: return launch<256>(q, k, v, out, B, H, KVH, Sq, Sk, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
