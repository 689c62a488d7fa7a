// Flash attention (online softmax, causal + sliding window, GQA) for sm_90a:
// the float32 instance, on FMAs.
//
// Replaces src/repro/kernels/flash_attention.py:96 (flash_attention; its
// pallas_call at :131) for float32 inputs; bfloat16 calls go to the
// tensor-core kernel, csrc/flash_attention_tc.cu.  This kernel also builds
// for bfloat16, so that a check can hold the tensor-core kernel against it
// on the same inputs.  q (B, H, Sq, D); k, v (B, KVH, Sk, D); out
// (B, H, Sq, D) in q's dtype, float32 or bfloat16; D in {16, 32, 64, 128,
// 256}.  Head h reads KV head h * KVH / H.  Causal and window positions both
// count from 0 (top-left alignment, also when Sq != Sk): key j is admitted
// for query i when j < Sk, j <= i (causal) and j > i - window (window > 0).
// Accumulation is float32 for either input type.  A row with no admissible
// key is written as 0, as the reference divides by 1 where l == 0.  With a
// non-null lse pointer the epilogue also writes each row's log-sum-exp of
// the scaled scores, m + log(l), float32 (B, H, Sq), for the backward
// (csrc/flash_attention_bwd.cu); +inf for a row with no admissible key.
// The serving path passes null and the kernel writes nothing more.
//
// Bound by operations: 4 * D float operations per admitted (query, key) pair
// and head (q.k and p.v, a multiply and an add each).  At the shapes the
// chip check runs, S = 32768, B = 1, against the bf16 tensor-core peak of
// 989 TFLOP/s: qwen2-1.5b (H 12, KVH 2, D 128, causal) 3.30e12 operations,
// 3.34 ms; gemma3-1b global (H 4, KVH 1, D 256, causal) 2.20e12, 2.22 ms;
// gemma3-1b local (window 512) 6.82e10, 0.069 ms (0.050 ms by bytes).  This
// kernel runs its products as float32 FMAs on the CUDA cores (67 TFLOP/s:
// 49 ms is its own floor for the qwen2 call), because an f32 input must hold
// 2e-5 of the dense oracle and TF32 keeps about three digits.
//
// Design: one CTA of 256 threads (16 x 16) per (64-row query tile, head,
// batch).  The query tile is staged once in shared memory as float32; then
// the CTA walks ONLY the KV tiles that hold an admissible key for one of its
// rows, [k_lo, k_hi) from the causal and window predicates, so an
// above-diagonal or out-of-window tile is never loaded.  Per KV tile: K and V
// staged in shared memory as float32 (keys past Sk as zeros: the ragged tail
// is masked here, the wrapper makes no padded copy); S = Q K^T with each
// thread holding 4 rows x BK/16 keys in registers; the online softmax per
// row (max and sum over the 16 threads of a row by warp shuffles, expf);
// P^T through shared memory; O += P V with each thread holding 4 rows x
// D/16 columns of O in registers.  The tiles per head dim: BK = 64 keys up
// to D = 64, 32 above, so that a CTA's shared memory stays at 32 KB (D 16)
// to 141 KB (D 256).
// The tiles with the most keys (the last query tiles of a causal call) are
// launched first.  The result does not depend on the reference's
// block_q/block_k, which the plain version takes.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched; an unsupported D or dtype returns
// cudaErrorInvalidValue without launching).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;         // query rows a CTA
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = 4;        // query rows a thread: ty * 4 .. ty * 4 + 3
constexpr int kPad = 4;         // floats of padding on a Q or K row in smem
constexpr int kPS = kBQ + 4;    // row pitch of P^T in smem

template <int D>
struct Tile {
  static constexpr int BK = D <= 64 ? 64 : 32;   // keys a KV tile
  static constexpr int QS = D + kPad;            // pitch of a Q or K row
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)kBQ * QS + (size_t)BK * QS + (size_t)BK * D +
                       (size_t)BK * kPS);
};

// 16 bytes of the input as float32
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// `rows` rows of D elements from global memory (pitch D) into shared memory
// as float32 (pitch `pitch`); rows from `n_valid` on are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      int rows, int n_valid) {
  constexpr int E = 16 / sizeof(T);   // elements a 16-byte load
  constexpr int VPR = D / E;          // loads a row
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * E;
    float f[E];
    if (r < n_valid) {
      load16(src + (size_t)r * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(dst + r * pitch + c + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// VEC consecutive floats of shared memory
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  } else {
    f[0] = *p;
  }
}

__device__ __forceinline__ bool admitted(int qi, int kj, int sk, int causal,
                                         int window) {
  return kj < sk && (!causal || kj <= qi) && (!window || kj > qi - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int H, int KVH, int Sq, int Sk,
             int causal, int window, float scale) {
  constexpr int BK = Tile<D>::BK, QS = Tile<D>::QS;
  constexpr int NC = BK / 16;           // keys a thread in S
  constexpr int CPT = D / 16;           // columns of O a thread
  constexpr int VEC = CPT < 4 ? CPT : 4;
  constexpr int NG = CPT / VEC;         // groups of VEC columns, 16*VEC apart

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBQ][QS]
  float* sK = sQ + kBQ * QS;                     // [BK][QS]
  float* sV = sK + BK * QS;                      // [BK][D]
  float* sPT = sV + BK * D;                      // [BK][kPS]: P transposed

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KVH / H;
  const int q_valid = min(kBQ, Sq - q0);

  const T* qp = q + (((size_t)b * H + h) * Sq + q0) * D;
  const T* kp = k + ((size_t)b * KVH + kvh) * Sk * D;
  const T* vp = v + ((size_t)b * KVH + kvh) * Sk * D;
  T* op = out + (((size_t)b * H + h) * Sq + q0) * D;

  // the keys any row of this tile admits: [k_lo, k_hi)
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + q_valid) : Sk;
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;

  stage<T, D>(sQ, QS, qp, kBQ, q_valid);

  float acc[kRows][CPT], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // Q staged; the last tile's K, V and P^T all read
    stage<T, D>(sK, QS, kp + (size_t)k0 * D, BK, min(BK, Sk - k0));
    stage<T, D>(sV, D, vp + (size_t)k0 * D, BK, min(BK, Sk - k0));
    __syncthreads();

    // S = Q K^T: rows ty*4 + i, keys tx + 16*j
    float s[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * kRows + i) * QS + d);
#pragma unroll
      for (int j = 0; j < NC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // the online softmax of each row; p replaces s
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      bool ok[NC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        ok[j] = admitted(qi, k0 + tx + 16 * j, Sk, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
      *reinterpret_cast<float4*>(sPT + (tx + 16 * j) * kPS + ty * kRows) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V: rows ty*4 + i, columns VEC*tx + 16*VEC*g + e
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(sPT + kk * kPS +
                                                        ty * kRows);
      const float pr[kRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float vv[VEC];
        load_vec<VEC>(sV + kk * D + VEC * tx + 16 * VEC * g, vv);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][g * VEC + e] = fmaf(pr[i], vv[e], acc[i][g * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= q_valid) continue;
    // the row's log-sum-exp of the scaled scores, for the backward; +inf
    // marks a row with no admitted key (its p = exp(s - lse) is 0)
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] =
          l[i] == 0.f ? __int_as_float(0x7f800000) : m[i] + logf(l[i]);
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store1(op + (size_t)r * D + VEC * tx + 16 * VEC * g + e,
               acc[i][g * VEC + e] / safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int KVH, int Sq, int Sk, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = Tile<D>::smem_bytes;
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  const int rc = (int)cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, KVH, Sq, Sk,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int KVH, int Sq, int Sk, int causal,
               int window, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    case 256: return launch<T, 256>(q, k, v, out, lse, B, H, KVH, Sq, Sk, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 float32, 1 bfloat16.  Every tensor contiguous, 16-byte aligned.
// lse: null, or float32 (B, H, Sq) for each row's log-sum-exp.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, void* lse, int dtype, int B, int H,
                          int KVH, int Sq, int Sk, int D, int causal,
                          int window, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, l, B, H, KVH, Sq, Sk, causal,
                             window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, l, B, H, KVH, Sq, Sk,
                                     causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
