// Sequential bandwidth kernels (strategy letters r/s/w/y/x/c/b, and the
// STREAM triad) for sm_90a.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
//
// Buffers are (rows, 128) float32 (bf16 for one rmw flavour): one 512-byte
// row is one "line".  All kernels move 16 bytes per thread and access;
// `n_vec` counts those 16-byte units, so any whole number of rows divides.
//
// The two reads also take a stack of `members` such buffers, member m at
// x + m * member_stride (in 16-byte units; a stack may be a strided view):
// the port of the reference's jax.vmap over a leading member axis.  The
// stream spreads every member's blocks over the whole card in one launch;
// the on-chip read walks the members back to back in each CTA, so its time
// is the sum of the members' walks, as the reference's per-member split of
// the pass time assumes.
//
// Four designs:
//   (A) grid-stride stream of 16-byte accesses: write, write_seeded, rmw,
//       copy, triad
//   (B) the same stream with a block reduction to one partial per CTA: read
//   (C) a CTA keeps its tile in shared memory and walks it `repeats` times:
//       read_tile / write_tile (the on-chip residency pair)
//   (-) an empty kernel, to time a bare launch, and a hold kernel that keeps
//       the stream busy for a given time while the host enqueues the work
//       it is followed by
//
// The bodies of r/s, w/y, x and c are the role bodies of roles.cuh, which
// the contention ladder (contention.cu) runs too: one code for both.
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

// ---- (A) write: pure store stream; SEEDED adds the (1,1) seed operand ------
template <bool SEEDED>
__global__ void write_kernel(float4* __restrict__ out, long long n_vec,
                             float value, const float* __restrict__ seed) {
  const float f = SEEDED ? value + seed[0] : value;
  roles::fill_strided(out, global_thread(), n_vec, grid_threads(), f);
}

// ---- (A) rmw: x + 1 into a second buffer (line read, then written) ---------
__global__ void rmw_f32_kernel(const float4* __restrict__ x,
                               float4* __restrict__ out, long long n_vec) {
  roles::add1_strided(x, out, global_thread(), n_vec, grid_threads());
}

__device__ __forceinline__ uint32_t bf16x2_add1(uint32_t packed) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&packed);
  float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(f.x + 1.f, f.y + 1.f);
  return *reinterpret_cast<uint32_t*>(&h);
}

__global__ void rmw_bf16_kernel(const uint4* __restrict__ x,
                                uint4* __restrict__ out, long long n_vec) {
  const long long step = grid_threads();
  for (long long i = global_thread(); i < n_vec; i += step) {
    uint4 v = x[i];
    v.x = bf16x2_add1(v.x); v.y = bf16x2_add1(v.y);
    v.z = bf16x2_add1(v.z); v.w = bf16x2_add1(v.w);
    out[i] = v;
  }
}

// ---- (A) copy --------------------------------------------------------------
__global__ void copy_kernel(const uint4* __restrict__ x,
                            uint4* __restrict__ out, long long n_vec) {
  roles::copy_strided(x, out, global_thread(), n_vec, grid_threads());
}

// ---- (A) triad: b + scalar * c into a third buffer ---------------------------
// Two roundings, as the plain version takes them: the product, then the sum
// (a fused multiply-add would round once and differ).  Four units of each
// operand are loaded before their four stores.
__device__ __forceinline__ float4 triad4(float4 b, float4 c, float s) {
  return make_float4(__fadd_rn(b.x, __fmul_rn(s, c.x)),
                     __fadd_rn(b.y, __fmul_rn(s, c.y)),
                     __fadd_rn(b.z, __fmul_rn(s, c.z)),
                     __fadd_rn(b.w, __fmul_rn(s, c.w)));
}

__global__ void triad_kernel(const float4* __restrict__ b,
                             const float4* __restrict__ c,
                             float4* __restrict__ out, long long n_vec,
                             float scalar) {
  const long long step = grid_threads();
  long long i = global_thread();
  for (; i + 3 * step < n_vec; i += 4 * step) {
    float4 vb[4], vc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vb[k] = b[i + k * step];
      vc[k] = c[i + k * step];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[i + k * step] = triad4(vb[k], vc[k], scalar);
  }
  for (; i < n_vec; i += step) out[i] = triad4(b[i], c[i], scalar);
}

// ---- (C) on-chip residency pair ---------------------------------------------
// CTA b owns vectors [b*tile_vec, min(n_vec, (b+1)*tile_vec)).  The tile is
// loaded into (or built in) dynamic shared memory once and walked `repeats`
// times with no global traffic.  The empty asm with a "memory" clobber at
// the end of each walk tells the compiler that shared memory may have been
// read and changed there: without it the repeated loads of an unchanged
// tile are hoisted out of the loop and all but the last of the repeated
// stores are deleted, and the kernel would time nothing.  The read walks
// member 0's tile, then member 1's, ...: one partial per (member, CTA).
__global__ void read_tile_kernel(const float4* __restrict__ x,
                                 float* __restrict__ partials,
                                 long long n_vec, long long member_stride,
                                 int members, int tile_vec, int repeats) {
  extern __shared__ float4 tile[];
  const long long base = (long long)blockIdx.x * tile_vec;
  const long long left = n_vec - base;
  const int n = left < tile_vec ? (int)left : tile_vec;
  for (int m = 0; m < members; ++m) {
    const float4* xm = x + m * member_stride + base;
    // the previous member's walks and reduction are done before its tile
    // is overwritten
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = xm[i];
    __syncthreads();
    float acc = 0.f;
    for (int r = 0; r < repeats; ++r) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float4 v = tile[i];
        a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
      }
      acc += (a.x + a.y) + (a.z + a.w);
      asm volatile("" ::: "memory");
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[(long long)m * gridDim.x + blockIdx.x] = acc;
  }
}

__global__ void write_tile_kernel(float4* __restrict__ out, long long n_vec,
                                  int tile_vec, int repeats) {
  extern __shared__ float4 tile[];
  const long long base = (long long)blockIdx.x * tile_vec;
  const long long left = n_vec - base;
  const int n = left < tile_vec ? (int)left : tile_vec;
  for (int r = 0; r < repeats; ++r) {
    const float f = (float)r;
    const float4 v = make_float4(f, f, f, f);
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = v;
    asm volatile("" ::: "memory");
  }
  // each thread stores the entries it wrote itself: no barrier needed
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
constexpr int kTileThreads = 1024;

template <typename K>
int allow_dynamic_smem(K kernel, size_t bytes) {
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

// seed == nullptr: write_hbm; else write_hbm_seeded (one template parameter)
int repro_write_hbm(void* out, long long n_vec, float value, const void* seed,
                    int grid, void* stream) {
  if (seed)
    write_kernel<true><<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(
        (float4*)out, n_vec, value, (const float*)seed);
  else
    write_kernel<false><<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(
        (float4*)out, n_vec, value, nullptr);
  return (int)cudaGetLastError();
}

int repro_rmw_hbm_f32(const void* x, void* out, long long n_vec, int grid,
                      void* stream) {
  rmw_f32_kernel<<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, n_vec);
  return (int)cudaGetLastError();
}

int repro_rmw_hbm_bf16(const void* x, void* out, long long n_vec, int grid,
                       void* stream) {
  rmw_bf16_kernel<<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, n_vec);
  return (int)cudaGetLastError();
}

int repro_copy_hbm(const void* x, void* out, long long n_vec, int grid,
                   void* stream) {
  copy_kernel<<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, n_vec);
  return (int)cudaGetLastError();
}

int repro_triad_hbm(const void* b, const void* c, void* out, long long n_vec,
                    float scalar, int grid, void* stream) {
  triad_kernel<<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)b, (const float4*)c, (float4*)out, n_vec, scalar);
  return (int)cudaGetLastError();
}

// partials: (members, ceil(n_vec / tile_vec)) floats
int repro_read_vmem(const void* x, void* partials, long long n_vec,
                    long long member_stride, int members, int tile_vec,
                    int repeats, void* stream) {
  const size_t smem = (size_t)tile_vec * sizeof(float4);
  const int rc = allow_dynamic_smem(read_tile_kernel, smem);
  if (rc) return rc;
  const int grid = (int)((n_vec + tile_vec - 1) / tile_vec);
  read_tile_kernel<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)x, (float*)partials, n_vec, member_stride, members,
      tile_vec, repeats);
  return (int)cudaGetLastError();
}

int repro_write_vmem(void* out, long long n_vec, int tile_vec, int repeats,
                     void* stream) {
  const size_t smem = (size_t)tile_vec * sizeof(float4);
  const int rc = allow_dynamic_smem(write_tile_kernel, smem);
  if (rc) return rc;
  const int grid = (int)((n_vec + tile_vec - 1) / tile_vec);
  write_tile_kernel<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
      (float4*)out, n_vec, tile_vec, repeats);
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
