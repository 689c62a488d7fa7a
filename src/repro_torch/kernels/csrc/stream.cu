// Sequential bandwidth kernels (strategy letters r/s/w/y/x/c/b) for sm_90a.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
//
// Buffers are (rows, 128) float32 (bf16 for one rmw flavour): one 512-byte
// row is one "line".  All kernels move 16 bytes per thread and access;
// `n_vec` counts those 16-byte units, so any whole number of rows divides.
//
// Four designs:
//   (A) grid-stride stream of 16-byte accesses: write, write_seeded, rmw, copy
//   (B) the same stream with a block reduction to one partial per CTA: read
//   (C) a CTA keeps its tile in shared memory and walks it `repeats` times:
//       read_tile / write_tile (the on-chip residency pair)
//   (-) an empty kernel, to time a bare launch
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long global_thread() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_threads() {
  return (long long)gridDim.x * blockDim.x;
}

// Sum over the block; the result is valid in thread 0.  Uses 128 bytes of
// static shared memory, which the tile kernels' dynamic size leaves free.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < n_warps) ? warp_part[threadIdx.x] : 0.f;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// ---- (B) read: every 16 bytes loaded once, one partial sum per CTA --------
// The loads are live only because the partial is stored.  Four independent
// accumulators per thread keep the adds off the loads' critical path and
// shorten each float32 summation chain.
__global__ void read_kernel(const float4* __restrict__ x,
                            float* __restrict__ partials, long long n_vec) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long step = grid_threads();
#pragma unroll 4
  for (long long i = global_thread(); i < n_vec; i += step) {
    const float4 v = x[i];
    a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
  }
  const float s = block_sum((a.x + a.y) + (a.z + a.w));
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// ---- (A) write: pure store stream; SEEDED adds the (1,1) seed operand ------
template <bool SEEDED>
__global__ void write_kernel(float4* __restrict__ out, long long n_vec,
                             float value, const float* __restrict__ seed) {
  const float f = SEEDED ? value + seed[0] : value;
  const float4 v = make_float4(f, f, f, f);
  const long long step = grid_threads();
  for (long long i = global_thread(); i < n_vec; i += step) out[i] = v;
}

// ---- (A) rmw: x + 1 into a second buffer (line read, then written) ---------
__global__ void rmw_f32_kernel(const float4* __restrict__ x,
                               float4* __restrict__ out, long long n_vec) {
  const long long step = grid_threads();
  for (long long i = global_thread(); i < n_vec; i += step) {
    float4 v = x[i];
    v.x += 1.f; v.y += 1.f; v.z += 1.f; v.w += 1.f;
    out[i] = v;
  }
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
  const long long step = grid_threads();
  for (long long i = global_thread(); i < n_vec; i += step) out[i] = x[i];
}

// ---- (C) on-chip residency pair ---------------------------------------------
// CTA b owns vectors [b*tile_vec, min(n_vec, (b+1)*tile_vec)).  The tile is
// loaded into (or built in) dynamic shared memory once and walked `repeats`
// times with no global traffic.  The empty asm with a "memory" clobber at
// the end of each walk tells the compiler that shared memory may have been
// read and changed there: without it the repeated loads of an unchanged
// tile are hoisted out of the loop and all but the last of the repeated
// stores are deleted, and the kernel would time nothing.
__global__ void read_tile_kernel(const float4* __restrict__ x,
                                 float* __restrict__ partials,
                                 long long n_vec, int tile_vec, int repeats) {
  extern __shared__ float4 tile[];
  const long long base = (long long)blockIdx.x * tile_vec;
  const long long left = n_vec - base;
  const int n = left < tile_vec ? (int)left : tile_vec;
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = x[base + i];
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
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
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

int repro_read_hbm(const void* x, void* partials, long long n_vec, int grid,
                   void* stream) {
  read_kernel<<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float*)partials, n_vec);
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

int repro_read_vmem(const void* x, void* partials, long long n_vec,
                    int tile_vec, int repeats, void* stream) {
  const size_t smem = (size_t)tile_vec * sizeof(float4);
  const int rc = allow_dynamic_smem(read_tile_kernel, smem);
  if (rc) return rc;
  const int grid = (int)((n_vec + tile_vec - 1) / tile_vec);
  read_tile_kernel<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)x, (float*)partials, n_vec, tile_vec, repeats);
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

}  // extern "C"
