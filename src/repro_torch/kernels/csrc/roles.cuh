// Role bodies shared by the single-observer kernels (stream.cu, chase.cu)
// and the persistent contention ladder (contention.cu), for sm_90a.
//
// One code for a role wherever it runs: the stream kernels call these over
// the whole grid (first = global thread, step = grid threads), the ladder
// over the fixed row range of one CTA of an engine (first = range start +
// thread, step = block threads).  Every body accesses 16 bytes a thread per
// step; `first`, `end` and `step` count 16-byte units.
//
// Loads that must reach memory on every pass use ld.global.cg through
// volatile asm: the load bypasses L1 (a CTA re-reading its range on the
// next pass must not be served by its own L1) and the compiler can neither
// merge nor hoist it.  Pointers here carry no __restrict__: the ladder runs
// rmw in place.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace roles {

constexpr int kLineInts = 128;  // one 512-byte line of int32
constexpr int kLineVec = 32;    // 16-byte units of a line

__device__ __forceinline__ float4 ld_cg(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld_cg(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_cg(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Sum over the block; the result is valid in thread 0.  Uses 128 bytes of
// static shared memory.  Every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call's reads of warp_part are done
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < n_warps) ? warp_part[threadIdx.x] : 0.f;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// r / s: this thread's share of the sum, four float32 accumulators (they
// keep the adds off the loads' critical path and shorten each chain).
// Four loads are issued before their adds: the volatile loads keep their
// order, so without the batch a thread would have one load in flight, and
// one CTA an SM too few bytes in flight to stream.
__device__ __forceinline__ float sum_strided(const float4* x, long long first,
                                             long long end, long long step) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  long long i = first;
  for (; i + 3 * step < end; i += 4 * step) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = ld_cg(x + i + k * step);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a.x += v[k].x; a.y += v[k].y; a.z += v[k].z; a.w += v[k].w;
    }
  }
  for (; i < end; i += step) {
    const float4 v = ld_cg(x + i);
    a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
  }
  return (a.x + a.y) + (a.z + a.w);
}

// w / y and the write half of b: pure stores.
__device__ __forceinline__ void fill_strided(float4* out, long long first,
                                             long long end, long long step,
                                             float f) {
  const float4 v = make_float4(f, f, f, f);
  for (long long i = first; i < end; i += step) out[i] = v;
}

// x (and w inside the ladder): out = x + 1, every line read then written.
// Four loads are issued before their four stores; in place (out == x) each
// thread still reads a unit before it writes it.
__device__ __forceinline__ void add1_strided(const float4* x, float4* out,
                                             long long first, long long end,
                                             long long step) {
  long long i = first;
  for (; i + 3 * step < end; i += 4 * step) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = ld_cg(x + i + k * step);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k].x += 1.f; v[k].y += 1.f; v[k].z += 1.f; v[k].w += 1.f;
      out[i + k * step] = v[k];
    }
  }
  for (; i < end; i += step) {
    float4 v = ld_cg(x + i);
    v.x += 1.f; v.y += 1.f; v.z += 1.f; v.w += 1.f;
    out[i] = v;
  }
}

// c: copy, four loads before their four stores.
__device__ __forceinline__ void copy_strided(const uint4* x, uint4* out,
                                             long long first, long long end,
                                             long long step) {
  long long i = first;
  for (; i + 3 * step < end; i += 4 * step) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = ld_cg(x + i + k * step);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[i + k * step] = v[k];
  }
  for (; i < end; i += step) out[i] = ld_cg(x + i);
}

// m / t / large l: `n_steps` dependent loads from line 0, one in flight.
__device__ __forceinline__ int chase_global(const int* chain, int n_steps) {
  int idx = 0;
  for (int s = 0; s < n_steps; ++s)
    idx = ld_cg(chain + (size_t)idx * kLineInts);
  return idx;
}

// l on chip: the whole block stages the chain (lines keep their 512-byte
// pitch), then one thread chases it in shared memory.
__device__ __forceinline__ void stage_chain(int4* staged, const int4* chain,
                                            int n_vec) {
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) staged[i] = chain[i];
}

__device__ __forceinline__ int chase_staged(const int4* staged, int n_steps) {
  const volatile int* lines = reinterpret_cast<const volatile int*>(staged);
  int idx = 0;
  for (int s = 0; s < n_steps; ++s) idx = lines[(size_t)idx * kLineInts];
  return idx;
}

}  // namespace roles
