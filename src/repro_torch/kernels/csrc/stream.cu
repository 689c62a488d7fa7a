// Sequential bandwidth kernels (strategy letters r/s/w/y/x/c/b, and the
// STREAM triad) for sm_90a.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
//
// Buffers are (rows, 128) float32 (bf16 for one rmw flavour; the copy takes
// any element type as bytes): one 512-byte float32 row is one "line".  The
// kernels move 16-byte units (a thread's access, or a bulk copy's grain);
// `n_vec` counts them, so any whole number of rows divides.
//
// The two reads also take a stack of `members` such buffers, member m at
// x + m * member_stride (in 16-byte units; a stack may be a strided view):
// the port of the reference's jax.vmap over a leading member axis.  The
// stream spreads every member's blocks over the whole card in one launch;
// the on-chip read spreads each member over the same CTAs and walks the
// members back to back in each CTA, so its time is the sum of the members'
// walks, as the reference's per-member split of the pass time assumes.
//
// Four designs:
//   (B) a grid-stride stream of 16-byte loads with a block reduction to one
//       partial per CTA: read
//   (C) the buffer spread over the shared memory of up to every SM, each
//       CTA walking its slice `repeats` times: read_tile / write_tile (the
//       on-chip residency pair); the read sums its partials in the launch
//   (D) one chunk a CTA, through one TMA bulk copy an input into shared
//       memory and one back: rmw, copy, triad
//   (E) one chunk a CTA of 16-byte stores, no shared memory: write,
//       write_seeded
//   (-) an empty kernel, to time a bare launch, and a hold kernel that keeps
//       the stream busy for a given time while the host enqueues the work
//       it is followed by
//
// The read's body is roles.cuh's sum_strided, which the contention ladder
// (contention.cu) runs for its r/s roles too: one code for both.  The
// ladder's w/y, x and c roles run roles.cuh's fill_strided, add1_strided
// and copy_strided; the writes, rmw and copy here are designs of their own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roles.cuh"

namespace {

using roles::block_sum;

__device__ __forceinline__ long long global_thread() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_threads() {
  return (long long)gridDim.x * blockDim.x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- (B) read: every 16 bytes loaded once, one partial sum per CTA --------
// The loads are live only because the partial is stored.  blockIdx.y is the
// member.
__global__ void read_kernel(const float4* __restrict__ x,
                            float* __restrict__ partials, long long n_vec,
                            long long member_stride) {
  x += blockIdx.y * member_stride;
  partials += (long long)blockIdx.y * gridDim.x;
  const float s = block_sum(
      roles::sum_strided(x, global_thread(), n_vec, grid_threads()));
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// ---- (D) one chunk a CTA: rmw, copy, triad -------------------------------
// Replace repro/kernels/stream.py:rmw_hbm (x + 1 into a new buffer),
// :copy_hbm (x into a new buffer) and :triad_hbm (b + scalar * c into a new
// buffer).  Bound by bytes: each 16-byte unit of every input read once and
// each unit of the output written once (rmw and copy 2 GiB for a 1 GiB
// buffer, 0.641 ms at 3.35 TB/s; triad 3 GiB, 0.962 ms).  Design (A)'s
// grid stride put a thread's four units 4.3 MB apart, and its reads and
// writes mixed at 85-87 % of the bound where each alone streams at 93 %.
//
// The chunk rule (stream.chunk_grid, stream.chunk_range): each buffer is
// cut into chunks of a kernel's chunk units, the last one short, and CTA b
// owns chunk b of every buffer.  The grid is one CTA a chunk, so the CTAs
// resident at any moment work on one window of neighbouring chunks that
// sweeps the buffers once: the reads, and the writes, of the whole card
// stay in a few MB.  One wave of persistent CTAs, each walking a contiguous
// range (through a ring of 4 x 32 KiB bulk copies) or chunks a grid apart,
// mixed the reads and writes worse (tools/stream_ab.py on an H100,
// PERF.md).
//
// Thread 0 fills the CTA's tiles in shared memory with one 1-D TMA bulk
// copy an input (cp.async.bulk), all completing on one mbarrier that one
// arrive.expect_tx arms for their bytes together; the threads apply the
// op to their units in shared memory, into the first tile; and thread 0
// writes that tile back with one bulk store.  The tiles of the CTAs
// resident on an SM are its bytes in flight, whatever the registers
// (tools/stream_ab.py on an H100 picked each chunk, PERF.md):
//   rmw    10 KiB x 512 threads, 4 CTAs and 40 KiB an SM; 32-36 KiB in
//          flight an SM was too few, 56 KiB or more too many.
//   copy   9 KiB, one warp: no op, so thread 0 alone waits for its tile
//          and stores it.  The CTA asks for shared memory it does not use,
//          so that 4 fit on an SM (36 KiB; 30 too few, 48 too many); one
//          warp launches and retires faster than 512 threads of which one
//          works, and without the cap 20 CTAs (200 KiB) opened too many
//          DRAM pages.
//   triad  10 KiB of each input x 512 threads: 4 CTAs and 80 KiB of reads
//          an SM.  With two read streams for one write, 40-48 KiB of
//          reads an SM starved it; 4-5 KiB chunks ran slower still.
// The bulk copies read and write pinned host memory too (over PCIe,
// through the same pointer).
//
// No L2 eviction hints: with an L2::evict_first policy on the loads and
// stores the steady state gained under 0.1 %, and lines that other kernels
// left in L2 at normal priority outlived the stream's evict_first lines, so
// the first calls after other work ran about 1 % slower (PERF.md).
//
// f32 and bf16 rmw move the same bytes; only the +1 differs (bf16: one
// rounding of the float32 sum).  The triad rounds the product and the sum
// apart, as the plain version does (a fused multiply-add would round once
// and differ).  tools/stream_ab.py rebuilds this file with
// -DREPRO_{RMW,COPY,TRIAD}_CHUNK_KIB or -DREPRO_{RMW,COPY,TRIAD}_THREADS to
// try another chunk (the triad's chunk is an input's: two tiles a CTA), and
// -DREPRO_COPY_CTAS_PER_SM another cap.
#ifndef REPRO_RMW_CHUNK_KIB
#define REPRO_RMW_CHUNK_KIB 10
#endif
#ifndef REPRO_RMW_THREADS
#define REPRO_RMW_THREADS 512
#endif
#ifndef REPRO_COPY_CHUNK_KIB
#define REPRO_COPY_CHUNK_KIB 9
#endif
#ifndef REPRO_COPY_THREADS
#define REPRO_COPY_THREADS 32
#endif
// CTAs of the copy an SM, held there by shared memory the CTA asks for and
// does not use (0: as many as the threads and the tile let fit)
#ifndef REPRO_COPY_CTAS_PER_SM
#define REPRO_COPY_CTAS_PER_SM 4
#endif
#ifndef REPRO_TRIAD_CHUNK_KIB
#define REPRO_TRIAD_CHUNK_KIB 10
#endif
#ifndef REPRO_TRIAD_THREADS
#define REPRO_TRIAD_THREADS 512
#endif
constexpr int kRmwChunkBytes = REPRO_RMW_CHUNK_KIB * 1024;
constexpr int kCopyChunkBytes = REPRO_COPY_CHUNK_KIB * 1024;
constexpr int kTriadChunkBytes = REPRO_TRIAD_CHUNK_KIB * 1024;

__device__ __forceinline__ uint32_t bf16x2_add1(uint32_t packed) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&packed);
  float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(f.x + 1.f, f.y + 1.f);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t triad1(uint32_t b, uint32_t c, float s) {
  return __float_as_uint(
      __fadd_rn(__uint_as_float(b), __fmul_rn(s, __uint_as_float(c))));
}

// The ops of design (D): kInputs tiles in, the result into the first; an
// op without kPass has no threads' pass (the copy).
struct AddOneF32 {
  static constexpr int kInputs = 1;
  static constexpr bool kPass = true;
  __device__ __forceinline__ static uint4 apply(uint4 v, uint4, float) {
    return make_uint4(__float_as_uint(__uint_as_float(v.x) + 1.f),
                      __float_as_uint(__uint_as_float(v.y) + 1.f),
                      __float_as_uint(__uint_as_float(v.z) + 1.f),
                      __float_as_uint(__uint_as_float(v.w) + 1.f));
  }
};

struct AddOneBf16 {
  static constexpr int kInputs = 1;
  static constexpr bool kPass = true;
  __device__ __forceinline__ static uint4 apply(uint4 v, uint4, float) {
    return make_uint4(bf16x2_add1(v.x), bf16x2_add1(v.y), bf16x2_add1(v.z),
                      bf16x2_add1(v.w));
  }
};

struct Copy {
  static constexpr int kInputs = 1;
  static constexpr bool kPass = false;
  __device__ __forceinline__ static uint4 apply(uint4 v, uint4, float) {
    return v;
  }
};

struct Triad {
  static constexpr int kInputs = 2;
  static constexpr bool kPass = true;
  __device__ __forceinline__ static uint4 apply(uint4 b, uint4 c, float s) {
    return make_uint4(triad1(b.x, c.x, s), triad1(b.y, c.y, s),
                      triad1(b.z, c.z, s), triad1(b.w, c.w, s));
  }
};

// Waits for the mbarrier's first phase to complete.  A wait longer than
// 10 s can only be a lost arrival: it traps, so that a fault is reported
// instead of a card that never finishes.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(0u) : "memory");
    if (done) return;
    if ((spins & 0xffff) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// global -> shared, `bytes` completing on the mbarrier `bar`, which an
// arrive.expect_tx has armed for them
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global; returns once the store has read the shared memory
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// out = Op(a[, b]) over CTA blockIdx.x's chunk of kChunkBytes an input
template <class Op, int kChunkBytes, int kThreads>
__global__ void __launch_bounds__(kThreads)
    bulk_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                uint4* __restrict__ out, long long n_vec, float scalar) {
  constexpr int kChunkVec = kChunkBytes / 16;
  static_assert(Op::kInputs * kChunkBytes < 48 * 1024,
                "a CTA's tiles are static shared memory");
  __shared__ __align__(128) uint4 tile[Op::kInputs][kChunkVec];
  __shared__ __align__(8) uint64_t full;
  const long long base = (long long)blockIdx.x * kChunkVec;
  const long long left = n_vec - base;
  const int len = left < kChunkVec ? (int)left : kChunkVec;
  const uint32_t bar = smem_addr(&full);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar), "r"(Op::kInputs * len * 16) : "memory");
    bulk_load(smem_addr(tile[0]), a + base, len * 16, bar);
    if constexpr (Op::kInputs == 2)
      bulk_load(smem_addr(tile[Op::kInputs - 1]), b + base, len * 16, bar);
  }
  if constexpr (Op::kPass) {
    __syncthreads();   // the mbarrier is initialised before anyone waits
    mbar_wait(bar);
    for (int i = threadIdx.x; i < len; i += kThreads)
      tile[0][i] = Op::apply(tile[0][i], tile[Op::kInputs - 1][i], scalar);
    // this thread's stores to the tile are visible to the bulk store
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  } else {
    if (threadIdx.x != 0) return;
    mbar_wait(bar);
  }
  if (threadIdx.x == 0) bulk_store(out + base, smem_addr(tile[0]), len * 16);
}

// ---- (E) write: one chunk a CTA of pure stores ------------------------------
// Replaces repro/kernels/stream.py:write_hbm (value into every unit) and
// :write_hbm_seeded (value + seed[0, 0]).  Bound by bytes: each 16-byte
// unit written once (1 GiB: 0.3205 ms at 3.35 TB/s).  Design (A)'s grid
// stride put a thread's units 4.3 MB apart, and its warps drifted apart
// over the buffer, so the card's stores spread over many open DRAM pages
// (1.04x torch.full at 1 GiB, 1.055x at 1/3 GiB).  Now the chunk rule of
// rmw, copy and triad: CTA b stores chunk b, so the CTAs resident at any
// moment store into one window that sweeps the buffer once.  No shared
// memory: each thread stores 16-byte units (st.global.v4) blockDim apart
// inside its CTA's chunk.  The ragged last chunk stores only its own
// units, no byte past n_vec.
//
// tools/stream_ab.py on an H100 picked the chunk (PERF.md): 8 KiB of 256
// threads, two stores a thread, 4 CTAs and 32 KiB an SM.  Chunks of 4-32
// KiB ran within 0.1 % of torch.full and of each other; without the cap
// (8 CTAs an SM) the seeded write ran 0.35 % slower; 64 KiB chunks ran
// 0.6 % slower.  Design (D) (the threads fill one shared-memory tile,
// thread 0 stores it with one TMA bulk store, as rmw and copy do) ran
// 0.05-1.3 % slower at every chunk tried.  torch.full's own launch is
// 4 KiB a CTA of 128 threads.
//
// The seeded flavour reads the (1, 1) seed on the device, once a CTA
// (thread 0, through shared memory: the seed may lie in pinned host
// memory), and stores __fadd_rn(value, seed): value rounded to float32,
// then a float32 add, as the reference's full_like(value) + seed.
// tools/stream_ab.py rebuilds this file with -DREPRO_WRITE_CHUNK_KIB,
// -DREPRO_WRITE_THREADS or -DREPRO_WRITE_CTAS_PER_SM to try another.
#ifndef REPRO_WRITE_CHUNK_KIB
#define REPRO_WRITE_CHUNK_KIB 8
#endif
#ifndef REPRO_WRITE_THREADS
#define REPRO_WRITE_THREADS 256
#endif
// CTAs of the write an SM, held there by shared memory the CTA asks for
// and does not use (0: as many as the threads let fit)
#ifndef REPRO_WRITE_CTAS_PER_SM
#define REPRO_WRITE_CTAS_PER_SM 4
#endif
constexpr int kWriteChunkBytes = REPRO_WRITE_CHUNK_KIB * 1024;

template <bool SEEDED>
__device__ __forceinline__ uint4 fill_value(float value,
                                            const float* __restrict__ seed) {
  float f = value;
  if constexpr (SEEDED) {
    __shared__ float seeded;
    if (threadIdx.x == 0) seeded = __fadd_rn(value, *seed);
    __syncthreads();
    f = seeded;
  }
  const uint32_t u = __float_as_uint(f);
  return make_uint4(u, u, u, u);
}

template <bool SEEDED, int kChunkBytes, int kThreads>
__global__ void __launch_bounds__(kThreads)
    write_kernel(uint4* __restrict__ out, long long n_vec, float value,
                 const float* __restrict__ seed) {
  constexpr int kChunkVec = kChunkBytes / 16;
  static_assert(kChunkVec % kThreads == 0, "whole stores a thread");
  const long long base = (long long)blockIdx.x * kChunkVec;
  const long long left = n_vec - base;
  const int len = left < kChunkVec ? (int)left : kChunkVec;
  const uint4 v = fill_value<SEEDED>(value, seed);
  uint4* o = out + base;
  if (len == kChunkVec) {
#pragma unroll
    for (int k = 0; k < kChunkVec / kThreads; ++k)
      o[threadIdx.x + k * kThreads] = v;
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) o[i] = v;
  }
}

// ---- (C) on-chip residency pair ---------------------------------------------
// Replaces repro/kernels/stream.py:read_vmem and :write_vmem, which hold the
// buffer in the VMEM of the TPU's one TensorCore: all of that chip.  Here
// the buffer is spread over the shared memory of up to every SM: CTA b owns
// vectors [b*slice_vec, min(n_vec, (b+1)*slice_vec)) in its dynamic shared
// memory (the wrapper's `vmem_layout` picks the slice and the grid), with
// kVmemThreads threads.  One
// CTA an SM: each asks for at least kOneCtaPerSmBytes, so that two never fit
// on one SM and every CTA walks its slice at a whole SM's rate.
// Bound: walks x bytes over the shared memory of the SMs spanned (128 B a
// clock each, 33.45 TB/s over 132 SMs at 1.98 GHz), plus the tile once
// through the buffer's memory.
//
// The slice is loaded into (or built in) shared memory once and walked
// `repeats` times with no global traffic.  A walk moves 8 bytes a thread an
// access, so that a slice of 1 KiB keeps 4 warps busy, one on each of the
// SM's four schedulers: a warp reaches only about half of its share of the
// SM's shared-memory rate (tools/stream_ab.py on an H100).  The walks'
// accesses are volatile PTX (ld/st.volatile.shared, each thread at the
// 32-bit shared address of its own slot, computed once), so no compiler may
// merge, hoist or delete a repeated load or store; the empty asm with a
// "memory" clobber after each walk (each group of kWalks walks in the read)
// keeps the rest of the code from being moved across them.
//
// A slice of a few KiB is one or two slots a thread, so a walk at a time
// would be bound by the load's latency, not by the shared memory: the read
// issues kWalks walks' loads of a slot before their adds, each walk into
// its own accumulator.
//
// The read ends in the same launch: each CTA stores one partial a member;
// the last CTA to finish (a ticket taken by one release-acquire atomic, in
// place of __threadfence and an atomicAdd: 0.3 us less a call on an H100,
// tools/stream_ab.py) sums them in a fixed order and resets the ticket.
// One launch a call, and the same bits from call to call.  The members of a
// stack run back to back in each CTA, so the launch takes the sum of their
// walks.
constexpr int kWalks = 8;
// two CTAs would need 2 x (116 KiB + 1 KiB reserved) of the SM's 228 KiB
constexpr int kOneCtaPerSmBytes = 116 * 1024;
// threads a CTA: 4 warps, one a scheduler.  tools/stream_ab.py's layout
// sweep rebuilds this file with -DREPRO_VMEM_THREADS=N to try another count.
#ifndef REPRO_VMEM_THREADS
#define REPRO_VMEM_THREADS 128
#endif
constexpr int kVmemThreads = REPRO_VMEM_THREADS;

__device__ __forceinline__ float2 lds_volatile(uint32_t a) {
  float2 v;
  asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts_volatile(uint32_t a, float f) {
  asm volatile("st.volatile.shared.v2.f32 [%0], {%1, %1};"
               :: "r"(a), "f"(f) : "memory");
}

__device__ __forceinline__ int slice_len(long long n_vec, int slice_vec) {
  const long long left = n_vec - (long long)blockIdx.x * slice_vec;
  return left < slice_vec ? (int)left : slice_vec;
}

// This thread's share of `repeats` walks of the n 8-byte slots of tile:
// each of its slots read `repeats` times.
__device__ __forceinline__ float walk_sum(const float2* tile, int n,
                                          int repeats) {
  float2 a[kWalks];
#pragma unroll
  for (int w = 0; w < kWalks; ++w) a[w] = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t slot = smem_addr(tile + i);
    int r = 0;
    for (; r + kWalks <= repeats; r += kWalks) {
      float2 v[kWalks];
#pragma unroll
      for (int w = 0; w < kWalks; ++w) v[w] = lds_volatile(slot);
#pragma unroll
      for (int w = 0; w < kWalks; ++w) {
        a[w].x += v[w].x;
        a[w].y += v[w].y;
      }
      asm volatile("" ::: "memory");
    }
    for (; r < repeats; ++r) {
      const float2 v = lds_volatile(slot);
      a[0].x += v.x;
      a[0].y += v.y;
      asm volatile("" ::: "memory");
    }
  }
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWalks; ++w) t += a[w].x + a[w].y;
  return t;
}

__global__ void read_tile_kernel(const float4* __restrict__ x,
                                 float* __restrict__ partials,
                                 float* __restrict__ out,
                                 unsigned int* __restrict__ ticket,
                                 long long n_vec, long long member_stride,
                                 int members, int slice_vec, int repeats) {
  extern __shared__ float4 tile[];
  __shared__ bool last;
  const long long base = (long long)blockIdx.x * slice_vec;
  const int n = slice_len(n_vec, slice_vec);
  for (int m = 0; m < members; ++m) {
    const float4* xm = x + m * member_stride + base;
    // the previous member's walks and reduction are done before its slice
    // is overwritten
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = xm[i];
    __syncthreads();
    const float s = block_sum(
        walk_sum(reinterpret_cast<const float2*>(tile), 2 * n, repeats));
    if (threadIdx.x == 0) partials[(long long)m * gridDim.x + blockIdx.x] = s;
  }
  if (threadIdx.x == 0) {
    // release: the partials this thread stored are visible before its
    // ticket; acquire: the last CTA sees every other CTA's partials
    unsigned int t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(t) : "l"(ticket) : "memory");
    last = t == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // each warp sums a member's partials: lane l takes CTAs l, l + 32, ...
  // in order, then the lanes fold in a fixed tree
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < members; m += blockDim.x >> 5) {
    const float* p = partials + (long long)m * gridDim.x;
    float s = 0.f;
    for (int c = lane; c < (int)gridDim.x; c += 32) s += __ldcg(p + c);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[m] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;   // ready for the next launch
}

__global__ void write_tile_kernel(float4* __restrict__ out, long long n_vec,
                                  int slice_vec, int repeats) {
  extern __shared__ float4 tile[];
  const long long base = (long long)blockIdx.x * slice_vec;
  const int n = slice_len(n_vec, slice_vec);
  const float2* tile2 = reinterpret_cast<const float2*>(tile);
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const uint32_t slot = smem_addr(tile2 + i);
    float f = 0.f;      // float(r), exact below 2^24
#pragma unroll 4
    for (int r = 0; r < repeats; ++r, f += 1.f) {
      sts_volatile(slot, f);
      asm volatile("" ::: "memory");
    }
  }
  __syncthreads();   // the slice is stored in 16-byte units
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + i] = tile[i];
}

__global__ void empty_kernel() {}

// One thread sleeps until `ns` nanoseconds of the global timer have passed.
__global__ void hold_kernel(long long ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    __nanosleep(1000);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while ((long long)(t - t0) < ns);
}

constexpr int kStreamThreads = 256;

template <typename K>
int allow_dynamic_smem(K kernel, size_t bytes) {
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The shared memory a CTA of `kernel` asks for beyond its static shared
// memory on the current card, so that at most `ctas_per_sm` fit on an SM
// (1 KiB a CTA is the system's); 0 for no cap, < 0 on an error.
template <typename K>
int pad_bytes(K kernel, int ctas_per_sm) {
  if (ctas_per_sm == 0) return 0;
  int dev = 0, per_sm = 0;
  cudaFuncAttributes fa;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (!rc) rc = (int)cudaFuncGetAttributes(&fa, kernel);
  if (rc) return -rc;
  int pad = (per_sm / ctas_per_sm - 1024 - (int)fa.sharedSizeBytes)
            / 1024 * 1024;
  pad = pad > 0 ? pad : 0;
  rc = allow_dynamic_smem(kernel, pad);
  return rc ? -rc : pad;
}

template <bool SEEDED>
int launch_write(void* out, long long n_vec, float value, const void* seed,
                 int grid, cudaStream_t st) {
  auto kernel =
      write_kernel<SEEDED, kWriteChunkBytes, REPRO_WRITE_THREADS>;
  const int pad = pad_bytes(kernel, REPRO_WRITE_CTAS_PER_SM);
  if (pad < 0) return -pad;
  kernel<<<grid, REPRO_WRITE_THREADS, pad, st>>>(
      (uint4*)out, n_vec, value, (const float*)seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int repro_stream_threads() { return kStreamThreads; }

// partials: (members, grid) floats
int repro_read_hbm(const void* x, void* partials, long long n_vec,
                   long long member_stride, int members, int grid,
                   void* stream) {
  read_kernel<<<dim3(grid, members), kStreamThreads, 0,
                (cudaStream_t)stream>>>(
      (const float4*)x, (float*)partials, n_vec, member_stride);
  return (int)cudaGetLastError();
}

// seed == nullptr: write_hbm; else write_hbm_seeded (one template
// parameter).  grid: one CTA a chunk (stream.chunk_grid).
int repro_write_hbm(void* out, long long n_vec, float value, const void* seed,
                    int grid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return seed ? launch_write<true>(out, n_vec, value, seed, grid, st)
              : launch_write<false>(out, n_vec, value, nullptr, grid, st);
}

// The bytes of a chunk (stream.chunk_grid) of the write, and of one input
// of rmw, copy and triad.
int repro_write_chunk_bytes() { return kWriteChunkBytes; }
int repro_rmw_chunk_bytes() { return kRmwChunkBytes; }
int repro_copy_chunk_bytes() { return kCopyChunkBytes; }
int repro_triad_chunk_bytes() { return kTriadChunkBytes; }

// grid: one CTA a chunk (stream.chunk_grid); bf16: the element type (0
// float32).
int repro_rmw_hbm(const void* x, void* out, long long n_vec, int grid,
                  int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    bulk_kernel<AddOneBf16, kRmwChunkBytes, REPRO_RMW_THREADS>
        <<<grid, REPRO_RMW_THREADS, 0, st>>>((const uint4*)x, nullptr,
                                             (uint4*)out, n_vec, 0.f);
  else
    bulk_kernel<AddOneF32, kRmwChunkBytes, REPRO_RMW_THREADS>
        <<<grid, REPRO_RMW_THREADS, 0, st>>>((const uint4*)x, nullptr,
                                             (uint4*)out, n_vec, 0.f);
  return (int)cudaGetLastError();
}

// grid: one CTA a chunk (stream.chunk_grid)
int repro_copy_hbm(const void* x, void* out, long long n_vec, int grid,
                   void* stream) {
  auto kernel = bulk_kernel<Copy, kCopyChunkBytes, REPRO_COPY_THREADS>;
  const int pad = pad_bytes(kernel, REPRO_COPY_CTAS_PER_SM);
  if (pad < 0) return -pad;
  kernel<<<grid, REPRO_COPY_THREADS, pad, (cudaStream_t)stream>>>(
      (const uint4*)x, nullptr, (uint4*)out, n_vec, 0.f);
  return (int)cudaGetLastError();
}

// grid: one CTA a chunk of each input (stream.chunk_grid)
int repro_triad_hbm(const void* b, const void* c, void* out, long long n_vec,
                    float scalar, int grid, void* stream) {
  bulk_kernel<Triad, kTriadChunkBytes, REPRO_TRIAD_THREADS>
      <<<grid, REPRO_TRIAD_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint4*)b, (const uint4*)c, (uint4*)out, n_vec, scalar);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a CTA of the on-chip pair asks for.
int repro_vmem_smem_bytes(int slice_vec) {
  const int bytes = slice_vec * (int)sizeof(float4);
  return bytes > kOneCtaPerSmBytes ? bytes : kOneCtaPerSmBytes;
}

// CTAs of the on-chip pair that fit on one SM at a slice of slice_vec:
// the read's kernel (write 0) or the write's (write 1); < 0 on an error.
int repro_vmem_ctas_per_sm(int write, int slice_vec) {
  const int smem = repro_vmem_smem_bytes(slice_vec);
  int rc = write ? allow_dynamic_smem(write_tile_kernel, smem)
                 : allow_dynamic_smem(read_tile_kernel, smem);
  if (rc) return -rc;
  int n = 0;
  rc = write ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, write_tile_kernel, kVmemThreads, smem)
             : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, read_tile_kernel, kVmemThreads, smem);
  return rc ? -rc : n;
}

// grid = ceil(n_vec / slice_vec) CTAs of kVmemThreads; partials: (members,
// grid) floats of scratch; out: (members,) floats; ticket: one zeroed
// unsigned int, left zeroed, that no other launch uses at the same time.
int repro_read_vmem(const void* x, void* partials, void* out, void* ticket,
                    long long n_vec, long long member_stride, int members,
                    int slice_vec, int repeats, void* stream) {
  const int smem = repro_vmem_smem_bytes(slice_vec);
  const int rc = allow_dynamic_smem(read_tile_kernel, smem);
  if (rc) return rc;
  const int grid = (int)((n_vec + slice_vec - 1) / slice_vec);
  read_tile_kernel<<<grid, kVmemThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)x, (float*)partials, (float*)out,
      (unsigned int*)ticket, n_vec, member_stride, members, slice_vec,
      repeats);
  return (int)cudaGetLastError();
}

int repro_write_vmem(void* out, long long n_vec, int slice_vec, int repeats,
                     void* stream) {
  const int smem = repro_vmem_smem_bytes(slice_vec);
  const int rc = allow_dynamic_smem(write_tile_kernel, smem);
  if (rc) return rc;
  const int grid = (int)((n_vec + slice_vec - 1) / slice_vec);
  write_tile_kernel<<<grid, kVmemThreads, smem, (cudaStream_t)stream>>>(
      (float4*)out, n_vec, slice_vec, repeats);
  return (int)cudaGetLastError();
}

int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int repro_hold(long long ns, void* stream) {
  hold_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
