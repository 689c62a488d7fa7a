// Data-dependent pointer-chase latency kernels (strategy letters l/m/t)
// for sm_90a.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
//
// buf is (n_lines, 128) int32: one 512-byte row per "line", element [i, 0]
// holds the successor of line i.  One thread follows `idx = buf[idx, 0]`
// for `n_steps` hops from 0, so exactly one load is outstanding at any
// time; the final index is stored, so no hop is dead.  The entries must lie
// in [0, n_lines): the caller builds the chain, the kernel does not check.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLineInts = 128;
constexpr int kStageThreads = 1024;

// (D) chain in global memory (device memory or mapped pinned host memory).
// ld.global.cg keeps the load out of L1, so every hop goes to L2 and, past
// it, to the memory behind.
__global__ void chase_global_kernel(const int* __restrict__ buf, int n_steps,
                                    int* __restrict__ out) {
  int idx = 0;
  for (int s = 0; s < n_steps; ++s)
    idx = __ldcg(buf + (size_t)idx * kLineInts);
  *out = idx;
}

// (D) chain staged into shared memory by the whole block, then chased there
// by one thread.  The lines keep their 512-byte pitch.
__global__ void chase_shared_kernel(const int4* __restrict__ buf, int n_vec,
                                    int n_steps, int* __restrict__ out) {
  extern __shared__ int4 staged[];
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) staged[i] = buf[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    const volatile int* lines = reinterpret_cast<const volatile int*>(staged);
    int idx = 0;
    for (int s = 0; s < n_steps; ++s) idx = lines[(size_t)idx * kLineInts];
    *out = idx;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int repro_chase_hbm(const void* buf, int n_steps, void* out, void* stream) {
  chase_global_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)buf, n_steps, (int*)out);
  return (int)cudaGetLastError();
}

int repro_chase_vmem(const void* buf, int n_lines, int n_steps, void* out,
                     void* stream) {
  const int n_vec = n_lines * (kLineInts / 4);
  const size_t smem = (size_t)n_vec * sizeof(int4);
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  const cudaError_t rc = cudaFuncSetAttribute(
      chase_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  chase_shared_kernel<<<1, kStageThreads, smem, (cudaStream_t)stream>>>(
      (const int4*)buf, n_vec, n_steps, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
