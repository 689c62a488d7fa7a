// Memory-idle compute probe (strategy letter i) for sm_90a.
//
// Replaces src/repro/kernels/compute_probe.py:mxu_probe, the TPU's chain of
// (128, 128) products on an operand held on chip.  Computes a^(iters+1) for
// a (128, 128) float32 `a` in full float32: acc = a, then `iters` times
// acc = acc @ a.  After the one load of `a` nothing touches device memory
// until the one store of the result: the paper's memory-idle core.
//
// Bound by operations: iters * 2 * 128^3 float32 operations (at iters=64,
// 268.4 MFLOP: 4.0 us at the card's 67 TFLOP/s float32 outside the tensor
// cores).  The products are dependent, so one CTA does the whole chain and
// its ceiling is one SM's share of that rate (128 FMA a clock, about 0.51
// TFLOP/s at 1.98 GHz): 0.53 ms at iters=64.  That is the design's choice:
// one SM busy, the rest of the card and its memory idle.
//
// Design: one CTA of 256 threads (16 x 16), each owning an 8 x 8 tile of
// the product in registers.  `a` and the running product (stored
// transposed, so that a thread reads the 8 rows of its tile as two float4)
// live in 128 KiB of dynamic shared memory, opted in with
// cudaFuncSetAttribute.  Per step: 128 rank-1 updates of the register tile
// with fp32 FMAs, a barrier, the tile written back, a barrier.  Tensor
// cores (3xTF32) are left to a later version: plain TF32 keeps about three
// decimal digits, too few for the reference's tolerance.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
#include <cuda_runtime.h>

namespace {

constexpr int kN = 128;
constexpr int kTile = 8;
constexpr int kThreads = (kN / kTile) * (kN / kTile);  // 256
constexpr size_t kSmemBytes = 2 * kN * kN * sizeof(float);

__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const float* __restrict__ a_in, float* __restrict__ out,
             int iters) {
  extern __shared__ float4 smem4[];
  float* a = reinterpret_cast<float*>(smem4);  // a[k * kN + j]
  float* acc_t = a + kN * kN;                  // acc_t[k * kN + i] = acc[i][k]
  const int tx = threadIdx.x % (kN / kTile);   // column tile
  const int ty = threadIdx.x / (kN / kTile);   // row tile

  for (int e = threadIdx.x; e < kN * kN; e += kThreads) {
    const float v = a_in[e];
    a[e] = v;
    acc_t[(e % kN) * kN + e / kN] = v;
  }
  __syncthreads();
  if (iters == 0) {
    for (int e = threadIdx.x; e < kN * kN; e += kThreads) out[e] = a[e];
    return;
  }

  for (int s = 0; s < iters; ++s) {
    float c[kTile][kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int q = 0; q < kTile; ++q) c[r][q] = 0.f;

#pragma unroll 2
    for (int k = 0; k < kN; ++k) {
      const float4* pr = reinterpret_cast<const float4*>(acc_t + k * kN +
                                                         ty * kTile);
      const float4* qr = reinterpret_cast<const float4*>(a + k * kN +
                                                         tx * kTile);
      const float4 p0 = pr[0], p1 = pr[1], q0 = qr[0], q1 = qr[1];
      const float p[kTile] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float q[kTile] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int j = 0; j < kTile; ++j) c[r][j] = fmaf(p[r], q[j], c[r][j]);
    }
    __syncthreads();  // every thread is done reading this step's acc_t

    if (s + 1 < iters) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float4* dst = reinterpret_cast<float4*>(
            acc_t + (tx * kTile + j) * kN + ty * kTile);
        dst[0] = make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
        dst[1] = make_float4(c[4][j], c[5][j], c[6][j], c[7][j]);
      }
      __syncthreads();
    } else {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        float4* dst = reinterpret_cast<float4*>(
            out + (ty * kTile + r) * kN + tx * kTile);
        dst[0] = make_float4(c[r][0], c[r][1], c[r][2], c[r][3]);
        dst[1] = make_float4(c[r][4], c[r][5], c[r][6], c[r][7]);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int repro_mxu_probe(const void* a, void* out, int iters, void* stream) {
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  const cudaError_t rc = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  probe_kernel<<<1, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)a, (float*)out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
