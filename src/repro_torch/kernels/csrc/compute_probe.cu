// Memory-idle compute probe (strategy letter i) for sm_90a.
//
// Replaces src/repro/kernels/compute_probe.py:mxu_probe, the TPU's chain of
// (128, 128) products on an operand held on chip.  Computes a^(iters+1) for
// a (128, 128) float32 `a` to float32 accuracy: acc = a, then `iters` times
// acc = acc @ a.  After the one load of `a` nothing touches device memory
// until the one store of the result: the paper's memory-idle core.
//
// Bound by operations: iters * 2 * 128^3 float32 operations (at iters=64,
// 268.4 MFLOP: 4.0 us at the card's 67 TFLOP/s float32 outside the tensor
// cores).  The products are dependent, so one CTA does the whole chain: the
// design's choice is one SM busy, the rest of the card and its memory idle.
// One SM's share of the card's 495 TFLOP/s of TF32 is about 3.7 TFLOP/s;
// the three passes below make 805 MFLOP of TF32 at iters=64, 0.22 ms at
// that rate (against 0.53 ms for one SM's float32 FMAs).
//
// Design (3xTF32 on the tensor cores of one SM): each float32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and each product is
// lo*hi + hi*lo + hi*hi on mma.sync.m16n8k8 TF32, float32 accumulators.
// hi + lo holds 22 of float32's 24 significand bits and the dropped lo*lo
// is 2^-22 of a term.  The tensor cores' accumulator does not round to
// nearest: added into one running sum, its error leans one way and grows
// with the chain, past the 1e-5 of the largest entry the probe is held to
// at iters=64 on an H100 80GB HBM3.  So each 16-wide k slice is
// summed on the tensor cores from 0, and the slices are added into the
// running sum on the CUDA cores, rounded to nearest.  One CTA of 256
// threads, 8 warps, each owning a 32 x 64 tile of the product.  `a` is
// split once, into hi and lo copies stored transposed; the running product
// is kept once as float32 and split as its fragments are read.  Rows are 132
// floats apart in shared memory, so that the 32 lanes' fragment reads fall
// on 32 banks.  Per step: 16 k-steps of 48 mma each a warp, 8 slices added,
// a barrier, the product written back, a barrier.
// Shared memory: 3 x 128 x 132 floats = 198 KiB.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 128;
constexpr int kP = kN + 4;             // row pitch in floats
constexpr int kThreads = 256;          // 8 warps: 4 row strips x 2 halves
constexpr int kWarpRows = 32, kWarpCols = 64;
constexpr int kMT = kWarpRows / 16, kNT = kWarpCols / 8;  // mma tiles a warp
constexpr int kSliceK = 16;            // k a partial sum on the tensor cores
constexpr size_t kSmemBytes = 3 * kN * kP * sizeof(float);

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (at most 2^-22 |x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const float* __restrict__ a_in, float* __restrict__ out,
             int iters) {
  extern __shared__ float4 smem4[];
  // bt_hi / bt_lo: a's split, transposed (bt[n * kP + k] = a[k][n]);
  // acc: the running product, acc[m * kP + k]
  uint32_t* bt_hi = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* bt_lo = bt_hi + kN * kP;
  float* acc = reinterpret_cast<float*>(bt_lo + kN * kP);

  for (int e = threadIdx.x; e < kN * kN; e += kThreads) {
    const int r = e / kN, c = e % kN;
    const float v = a_in[e];
    split(v, bt_hi[c * kP + r], bt_lo[c * kP + r]);
    acc[r * kP + c] = v;
  }
  __syncthreads();
  if (iters == 0) {
    for (int e = threadIdx.x; e < kN * kN; e += kThreads)
      out[e] = acc[(e / kN) * kP + e % kN];
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;          // the mma fragment's indices
  const int row0 = (warp / 2) * kWarpRows;       // this warp's tile
  const int col0 = (warp % 2) * kWarpCols;

  for (int s = 0; s < iters; ++s) {
    // the product so far, [m tile][n tile][fragment]
    float sum[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) sum[i][j][f] = 0.f;

    for (int kp = 0; kp < kN; kp += kSliceK) {
      // this slice's lo*hi + hi*lo + hi*hi on the tensor cores, from 0
      float part[kMT][kNT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int f = 0; f < 4; ++f) part[i][j][f] = 0.f;
#pragma unroll
      for (int k0 = kp; k0 < kp + kSliceK; k0 += 8) {
        // A fragments: (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* p = acc + (row0 + 16 * i + g) * kP + k0 + t;
          split(p[0], a_hi[i][0], a_lo[i][0]);
          split(p[8 * kP], a_hi[i][1], a_lo[i][1]);
          split(p[4], a_hi[i][2], a_lo[i][2]);
          split(p[8 * kP + 4], a_hi[i][3], a_lo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          // B fragment: (k t, column g), (k t + 4, column g)
          const int o = (col0 + 8 * j + g) * kP + k0 + t;
          const uint32_t bh0 = bt_hi[o], bh1 = bt_hi[o + 4];
          const uint32_t bl0 = bt_lo[o], bl1 = bt_lo[o + 4];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            mma_tf32(part[i][j], a_lo[i], bh0, bh1);
            mma_tf32(part[i][j], a_hi[i], bl0, bl1);
            mma_tf32(part[i][j], a_hi[i], bh0, bh1);
          }
        }
      }
      // rounded to nearest on the CUDA cores
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int f = 0; f < 4; ++f) sum[i][j][f] += part[i][j][f];
    }
    __syncthreads();  // every warp is done reading this step's acc

    // fragment f: row g + 8 (f >> 1), column 2 t + (f & 1)
    const bool last = s + 1 == iters;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 16 * i + g + 8 * h, c = col0 + 8 * j + 2 * t;
          const float2 v = make_float2(sum[i][j][2 * h],
                                       sum[i][j][2 * h + 1]);
          if (last)
            *reinterpret_cast<float2*>(out + r * kN + c) = v;
          else
            *reinterpret_cast<float2*>(acc + r * kP + c) = v;
        }
    __syncthreads();
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
