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
//
// Both kernels also take a stack of `members` chains, member m at
// buf + m * member_stride (in ints): the port of the reference's jax.vmap
// over a leading member axis.  The one thread chases member 0's chain, then
// member 1's, and so on, storing each final index in out[m]: the chains run
// back to back, never side by side, so the time of the launch is the sum of
// the members' chases, as the reference's per-member split of the pass time
// assumes.
//
// The chases themselves are the role bodies of roles.cuh, which the
// contention ladder (contention.cu) runs too: one code for both.
#include <cuda_runtime.h>
#include <stdint.h>

#include "roles.cuh"

namespace {

using roles::kLineInts;
constexpr int kStageThreads = 1024;

// (D) chain in global memory (device memory or mapped pinned host memory).
// ld.global.cg keeps the load out of L1, so every hop goes to L2 and, past
// it, to the memory behind.
__global__ void chase_global_kernel(const int* __restrict__ buf,
                                    long long member_stride, int members,
                                    int n_steps, int* __restrict__ out) {
  for (int m = 0; m < members; ++m)
    out[m] = roles::chase_global(buf + m * member_stride, n_steps);
}

// (D) chain staged into shared memory by the whole block, then chased there
// by one thread.  The lines keep their 512-byte pitch.  Members: stage
// member 0's chain, chase it, stage member 1's, ...
__global__ void chase_shared_kernel(const int4* __restrict__ buf,
                                    long long member_stride, int members,
                                    int n_vec, int n_steps,
                                    int* __restrict__ out) {
  extern __shared__ int4 staged[];
  for (int m = 0; m < members; ++m) {
    const int4* chain = buf + m * member_stride;
    __syncthreads();  // the previous member's chase is done
    roles::stage_chain(staged, chain, n_vec);
    __syncthreads();
    if (threadIdx.x == 0) out[m] = roles::chase_staged(staged, n_steps);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// member_stride in ints; out: `members` ints
int repro_chase_hbm(const void* buf, long long member_stride, int members,
                    int n_steps, void* out, void* stream) {
  chase_global_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)buf, member_stride, members, n_steps, (int*)out);
  return (int)cudaGetLastError();
}

int repro_chase_vmem(const void* buf, long long member_stride, int members,
                     int n_lines, int n_steps, void* out, void* stream) {
  const int n_vec = n_lines * (kLineInts / 4);
  const size_t smem = (size_t)n_vec * sizeof(int4);
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  const cudaError_t rc = cudaFuncSetAttribute(
      chase_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  chase_shared_kernel<<<1, kStageThreads, smem, (cudaStream_t)stream>>>(
      (const int4*)buf, member_stride / 4, members, n_vec, n_steps,
      (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
