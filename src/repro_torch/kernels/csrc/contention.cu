// The multi-engine contention ladder as one persistent cooperative kernel,
// and the kernel-support probe, for sm_90a.
//
// contention_ladder replaces src/repro/core/exec/program.py:318
// build_ladder_program with the role bodies of :134 _pallas_branch_fn: the
// TPU program that runs every engine of an ("engine",) mesh between two
// psum barriers per rung sample and stamps the engine-leader's clock around
// each.  Here an engine is a disjoint group of `ctas` CTAs, one CTA on each
// SM (the dynamic shared memory asked for leaves room for one CTA an SM),
// and the whole table of steps (waves x rungs x samples) runs in one launch:
//
//   for each step s:  start barrier of my group -> the group leader stamps
//                     t0 -> every engine runs its role of step s -> stop
//                     barrier of my group -> the leader stamps t1
//
// A group is one engine subset of a width-packed dispatch (its own
// barrier), the leftover engines (another), or every engine (unpacked).
// Barriers are generation counters in global memory, one per group, zeroed
// before the launch: a CTA's thread 0 arrives with __threadfence() +
// atomicAdd (release) and polls with ld.acquire.gpu behind a __nanosleep
// backoff, so a waiting CTA issues about one load every 256 ns and not a
// stream that would contend with the engines still working.  The launch is
// cooperative: every CTA is resident, or the launch is refused and the
// error returned; the grid is never shrunk.
//
// Roles (the arithmetic of _pallas_branch_fn, pass by pass):
//   read (r/s)      acc = acc*0.5 + sum(x[:rows])
//   seeded (y)      seed = x[0,0] + acc*1e-30; x[:rows] <- 1 + seed into
//                   dst; acc = acc*0.5 + (1 + seed)
//   rmw (w/x)       dst = (pass 0 ? x : dst) + 1; result dst[0,0]
//   copy (c)        ping-pong x -> dst -> x ...; result of the last copy
//   mixed (b)       acc = acc*0.5 + sum(x[:read_rows]) + sum(one written
//                   row); dst[:write_rows] <- 1 + x[0,0]
//   chase global    acc += chase(xi[:rows], rows hops), CTA 0's thread 0
//   chase shared    the same chase after CTA 0 stages the chain on chip
//   idle (i)        acc = x[0,0]*1e-30, then n*8 times acc*0.999 + 1, in
//                   registers (thread 0 of CTA 0)
// A stream role splits its rows over the engine's CTAs by a FIXED range for
// every pass, and a thread's 16-byte units are the same on every pass: the
// carried rmw, copy and seeded write of pass t+1 read only what that thread
// wrote in pass t, so no barrier is needed inside an engine.  Chases run in
// one thread, exactly one load in flight; the engine's other CTAs go
// straight to the stop barrier.
//
// Bound by bytes: each engine's role moves its rows' bytes once a pass,
// every engine at once; the ladder's least time is all engines' bytes of the
// slowest group over the device memory's rate.  The chases are bound by the
// latency of one load.
//
// Outputs per step: a partial per (engine, CTA) that the wrapper sums into
// the engine's value (the TPU program returns one scalar an engine), the
// leaders' [s, ns] stamp pairs in the TPU program's (n_eng, steps, 2) int32
// layout, and per (CTA, step) the global-timer ns at which the CTA arrived
// at the start barrier, began its role, and ended it: the fence check
// (core/exec/fence.py) verifies from them that no engine began before the
// last of its group arrived, and that the leader's stop stamp follows every
// engine's end.
//
// probe_add_one replaces src/repro/compat.py:129 (pallas_supported's
// pallas_call): out = x + 1 on an (8, 128) float32 block.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// a cudaError_t (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

#include "roles.cuh"

namespace {

using roles::kLineVec;

enum RoleCode : int {
  kIdle = 0,
  kRead = 1,
  kSeededWrite = 2,
  kRmw = 3,
  kCopy = 4,
  kMixed = 5,
  kChaseGlobal = 6,
  kChaseShared = 7,
};
// a role: code, rows, passes, read rows, written rows, 3 spare
constexpr int kRoleFields = 8;
constexpr int kThreads = 1024;
// more than half of the SM's 228 KB: two CTAs of the ladder never share one
constexpr int kOneCtaPerSmBytes = 116 << 10;
constexpr unsigned kMaxBackoffNs = 256;

struct Ladder {
  float* xf;              // (n_eng, rows_max, 128) f32
  const int* xi;          // (n_eng, rows_max, 128) int32
  float* dst;             // (n_eng, rows_max, 128) f32
  long long eng_stride;   // elements of one engine's operand
  const int* table;       // (steps, n_eng) role ids
  const int* roles;       // (n_roles, kRoleFields)
  const int* group_of;    // (n_eng) barrier group of each engine
  const int* leader;      // (n_eng) 1 where the engine stamps its group
  unsigned* counters;     // (n_eng) one barrier counter a group, zeroed
  float* partials;        // (n_eng, steps, ctas)
  int* t0s;               // (n_eng, steps, 2) [s, ns]
  int* t1s;
  long long* stamps;      // (n_eng * ctas, steps, 3) arrive, begin, end
  int n_eng, steps, ctas;
  long long skew_ns;      // engine e sleeps e * skew_ns before arriving
  int skip_start_wait;    // arrive at the start barrier but do not wait
  long long timeout_ns;   // a barrier wait longer than this traps
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread 0 of a CTA only.  The __syncthreads() before it orders the CTA's
// work before the fence; the fence is cumulative.
__device__ __forceinline__ void arrive(unsigned* ctr) {
  __threadfence();
  atomicAdd(ctr, 1u);
}

__device__ __forceinline__ void wait_for(const unsigned* ctr, unsigned target,
                                         long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  unsigned ns = 32;
  while ((int)(ld_acquire(ctr) - target) < 0) {
    __nanosleep(ns);
    if (ns < kMaxBackoffNs) ns <<= 1;
    // a barrier that never completes is a fault of the launch, not a wait:
    // end the kernel with an error instead of holding the card
    if ((long long)(global_ns() - t0) > timeout_ns) __trap();
  }
  __threadfence();
}

__device__ __forceinline__ void stamp(int* out, unsigned long long t) {
  out[0] = (int)(t / 1000000000ull);
  out[1] = (int)(t % 1000000000ull);
}

// rows [lo, hi) of `total` that CTA c of C owns, the same on every pass
__device__ __forceinline__ void split(long long total, int c, int C,
                                      long long* lo, long long* hi) {
  *lo = total * c / C;
  *hi = total * (c + 1) / C;
}

__device__ __forceinline__ void compiler_barrier() {
  asm volatile("" ::: "memory");
}

// One role of one engine on CTA c of C.  Returns the CTA's share of the
// engine's value, valid in thread 0.  Branches are uniform over the CTA.
__device__ float run_role(const int* role, float* xf, const int* xi,
                          float* dst, int c, int C, int4* staged) {
  const int code = role[0], rows = role[1], n = role[2];
  const int tid = threadIdx.x, nt = blockDim.x;
  float4* xf4 = reinterpret_cast<float4*>(xf);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  long long lo, hi;
  switch (code) {
    case kRead: {
      split(rows, c, C, &lo, &hi);
      float acc = 0.f;
      for (int t = 0; t < n; ++t)
        acc = acc * 0.5f +
              roles::sum_strided(xf4, lo * kLineVec + tid, hi * kLineVec, nt);
      return roles::block_sum(acc);
    }
    case kSeededWrite: {
      split(rows, c, C, &lo, &hi);
      const float x00 = xf[0];
      float acc = 0.f;
      for (int t = 0; t < n; ++t) {
        // the seed depends on the previous pass; the stores on the seed
        const float seed = __fadd_rn(x00, __fmul_rn(acc, 1e-30f));
        const float f = __fadd_rn(1.0f, seed);
        roles::fill_strided(dst4, lo * kLineVec + tid, hi * kLineVec, nt, f);
        acc = __fadd_rn(__fmul_rn(acc, 0.5f), f);
        compiler_barrier();
      }
      return c == 0 ? acc : 0.f;
    }
    case kRmw: {
      split(rows, c, C, &lo, &hi);
      for (int t = 0; t < n; ++t) {
        roles::add1_strided(t == 0 ? xf4 : dst4, dst4, lo * kLineVec + tid,
                            hi * kLineVec, nt);
        compiler_barrier();
      }
      // thread 0 of the CTA that owns row 0 wrote dst[0] itself
      return (lo == 0 && hi > 0) ? dst[0] : 0.f;
    }
    case kCopy: {
      split(rows, c, C, &lo, &hi);
      for (int t = 0; t < n; ++t) {
        const bool even = (t & 1) == 0;
        roles::copy_strided(reinterpret_cast<const uint4*>(even ? xf4 : dst4),
                            reinterpret_cast<uint4*>(even ? dst4 : xf4),
                            lo * kLineVec + tid, hi * kLineVec, nt);
        compiler_barrier();
      }
      const float* last = (n & 1) ? dst : xf;
      return (lo == 0 && hi > 0) ? last[0] : 0.f;
    }
    case kMixed: {
      long long wlo, whi;
      split(role[3], c, C, &lo, &hi);
      split(role[4], c, C, &wlo, &whi);
      const bool owns_row0 = wlo == 0 && whi > 0;
      const float f = __fadd_rn(1.0f, xf[0]);  // value + seed, seed = x[0,0]
      float acc = 0.f;
      for (int t = 0; t < n; ++t) {
        const float p =
            roles::sum_strided(xf4, lo * kLineVec + tid, hi * kLineVec, nt);
        roles::fill_strided(dst4, wlo * kLineVec + tid, whi * kLineVec, nt, f);
        float row = 0.f;
        if (owns_row0) {  // consume one written row, read back
          __syncthreads();
          float v = 0.f;
          if (tid < kLineVec) {
            const float4 q = dst4[tid];
            v = (q.x + q.y) + (q.z + q.w);
          }
          row = roles::block_sum(v);
        }
        acc = acc * 0.5f + p + (tid == 0 ? row : 0.f);
        compiler_barrier();
      }
      return roles::block_sum(acc);
    }
    case kChaseGlobal: {
      if (c != 0 || tid != 0) return 0.f;
      float acc = 0.f;
      for (int t = 0; t < n; ++t)
        acc = acc + (float)roles::chase_global(xi, rows);
      return acc;
    }
    case kChaseShared: {
      if (c != 0) return 0.f;
      float acc = 0.f;
      for (int t = 0; t < n; ++t) {
        __syncthreads();  // the previous pass's chase is done
        roles::stage_chain(staged, reinterpret_cast<const int4*>(xi),
                           rows * kLineVec);
        __syncthreads();
        if (tid == 0) acc = acc + (float)roles::chase_staged(staged, rows);
      }
      return acc;
    }
    default: {  // kIdle: the memory-idle spin, in registers
      if (c != 0 || tid != 0) return 0.f;
      float acc = __fmul_rn(xf[0], 1e-30f);
      for (int k = 0; k < n * 8; ++k)
        acc = __fadd_rn(__fmul_rn(acc, 0.999f), 1.0f);
      return acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) ladder_kernel(const Ladder L) {
  extern __shared__ int4 staged[];
  const int e = blockIdx.x / L.ctas, c = blockIdx.x % L.ctas;
  const int g = L.group_of[e];
  unsigned group_ctas = 0;
  for (int j = 0; j < L.n_eng; ++j) group_ctas += L.group_of[j] == g;
  group_ctas *= (unsigned)L.ctas;
  unsigned* ctr = L.counters + g;
  const bool clock = L.leader[e] != 0 && c == 0;
  float* xf = L.xf + e * L.eng_stride;
  const int* xi = L.xi + e * L.eng_stride;
  float* dst = L.dst + e * L.eng_stride;
  long long* mine = L.stamps + (long long)blockIdx.x * L.steps * 3;
  unsigned target = 0;  // thread 0: arrivals the counter must reach

  for (int s = 0; s < L.steps; ++s) {
    const int* role =
        L.roles + L.table[(long long)s * L.n_eng + e] * kRoleFields;
    const long long slot = (long long)e * L.steps + s;
    __syncthreads();
    if (threadIdx.x == 0) {
      if (L.skew_ns) {
        const unsigned long long until = global_ns() + e * L.skew_ns;
        while (global_ns() < until) __nanosleep(1000);
      }
      mine[s * 3 + 0] = (long long)global_ns();
      arrive(ctr);
      target += group_ctas;
      if (!L.skip_start_wait) wait_for(ctr, target, L.timeout_ns);
      if (clock) stamp(L.t0s + slot * 2, global_ns());
      mine[s * 3 + 1] = (long long)global_ns();
    }
    __syncthreads();
    const float v = run_role(role, xf, xi, dst, c, L.ctas, staged);
    __syncthreads();
    if (threadIdx.x == 0) {
      mine[s * 3 + 2] = (long long)global_ns();
      arrive(ctr);
      target += group_ctas;
      wait_for(ctr, target, L.timeout_ns);
      if (clock) stamp(L.t1s + slot * 2, global_ns());
      L.partials[slot * L.ctas + c] = v;
    }
  }
}

// The kernel-support probe (replaces the pallas_call of
// repro/compat.py:pallas_supported): out = x + 1 on one (8, 128) float32
// block.  Bound by the launch (4 KiB in, 4 KiB out), so the body is one
// memory round trip: kProbeThreads threads, each one 16-byte read-only load
// and one 16-byte store; no loop.
constexpr int kProbeThreads = 256;

__global__ void __launch_bounds__(kProbeThreads)
    add_one_kernel(const float4* __restrict__ x, float4* __restrict__ out) {
  float4 v = __ldg(x + threadIdx.x);
  v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
  out[threadIdx.x] = v;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// chase_smem_bytes: the largest chain a shared-memory chase role stages
int repro_contention_ladder(void* xf, const void* xi, void* dst,
                            long long eng_stride, const void* table,
                            int steps, const void* roles_,
                            const void* group_of, const void* leader,
                            void* counters, void* partials, void* t0s,
                            void* t1s, void* stamps, int n_eng, int ctas,
                            long long skew_ns, int skip_start_wait,
                            long long timeout_ns, int chase_smem_bytes,
                            void* stream) {
  const int smem = chase_smem_bytes > kOneCtaPerSmBytes ? chase_smem_bytes
                                                        : kOneCtaPerSmBytes;
  cudaError_t rc = cudaFuncSetAttribute(
      ladder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return (int)rc;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ladder_kernel,
                                                     kThreads, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = n_eng * ctas;
  if (per_sm < 1 || (long long)per_sm * sms < grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  Ladder L;
  L.xf = (float*)xf;
  L.xi = (const int*)xi;
  L.dst = (float*)dst;
  L.eng_stride = eng_stride;
  L.table = (const int*)table;
  L.roles = (const int*)roles_;
  L.group_of = (const int*)group_of;
  L.leader = (const int*)leader;
  L.counters = (unsigned*)counters;
  L.partials = (float*)partials;
  L.t0s = (int*)t0s;
  L.t1s = (int*)t1s;
  L.stamps = (long long*)stamps;
  L.n_eng = n_eng;
  L.steps = steps;
  L.ctas = ctas;
  L.skew_ns = skew_ns;
  L.skip_start_wait = skip_start_wait;
  L.timeout_ns = timeout_ns;
  void* args[] = {&L};
  rc = cudaLaunchCooperativeKernel((const void*)ladder_kernel, dim3(grid),
                                   dim3(kThreads), args, (size_t)smem,
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// n: the block's floats, 4 * kProbeThreads and nothing else
int repro_probe_add_one(const void* x, void* out, int n, void* stream) {
  if (n != 4 * kProbeThreads) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<1, kProbeThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
