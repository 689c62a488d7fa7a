// The backward of flash attention (causal + sliding window, GQA) for sm_90a,
// on float32 FMAs.
//
// The gradient of src/repro/kernels/flash_attention.py:96 (flash_attention)
// as the port computes it: the reference has no backward kernel, its
// gradient of attention is XLA's autodiff of the jnp attention at
// src/repro/models/attention.py:328-360; the port's train attention runs the
// forward kernels (csrc/flash_attention_tc.cu, csrc/flash_attention.cu), so
// this kernel gives the gradient of their exact function:
// o = softmax(scale * q k^T, masked) v, key j admitted for query i when
// j < Sk, j <= i (causal) and j > i - window (window > 0), positions from 0
// also when Sq != Sk, head h reading KV head h * KVH / H, a row with no
// admitted key 0.  Inputs: q (B, H, Sq, D); k, v (B, KVH, Sk, D); o and do
// (B, H, Sq, D); lse (B, H, Sq) float32, the forward's m + log(l) (+inf for
// a row with no admitted key, whose p is then 0).  Outputs dq, dk, dv in
// the inputs' dtype, float32 or bfloat16; D in {16, 32, 64, 128, 256}.
// Accumulation is float32 for either dtype.
//
// Bound by operations: 10 * D operations per admitted (query, key) pair and
// head (q.k, do.v, p^T do, ds^T q, ds k: two operations a product term;
// the kernels recompute q.k and do.v once more, 14 * D).  At the train
// shape of qwen2-1.5b (q (2, 12, 4096, 128), causal) that is 2.58e11
// operations, 0.26 ms at the bf16 tensor cores' 989 TFLOP/s and 3.9 ms at
// the 67 TFLOP/s of float32 FMAs, which this kernel runs on.
//
// Design: the standard recomputation schedule, three launches on the
// caller's stream, no atomics, so the result is the same every run.
// 1. delta = rowsum(do * o), float32 (B, H, Sq): one warp a row.
// 2. dk, dv: one CTA of 256 threads (16 x 16) a (KV tile of BT keys, KV
//    head, batch).  K and V are staged once in shared memory as float32;
//    the CTA walks the H / KVH query heads that read this KV head and, for
//    each, only the query tiles that admit one of its keys (q >= k0 causal,
//    q < k0 + BT - 1 + window), staging q, do, lse and delta; per tile it
//    recomputes S = q k^T and dP = do v^T (each thread 4 rows x BT/16 keys
//    in registers), p = exp(scale * s - lse), ds = p * (dP - delta), puts
//    p and ds in shared memory, and accumulates dv += p^T do and
//    dk += ds^T q in registers (each thread BT/16 keys x D/16 columns).
//    The sum over the query heads of a group is the CTA's own loop.
// 3. dq: one CTA a (query tile, head, batch): q, do, lse and delta staged
//    once; it walks the KV tiles that hold an admitted key (the forward's
//    [k_lo, k_hi)), recomputes p and ds and accumulates dq += ds k.
// BT = 64 rows and keys a tile up to D 128, 32 at D 256: shared memory
// 56 KB (D 16) to 167 KB (D 128).  The tiles with the most work are
// launched first.  A tile straddling Sq or Sk is masked here (staged
// zeros, lse +inf); the wrapper makes no padded copy.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given, does not synchronise, allocates nothing (delta is
// the caller's scratch), and returns cudaGetLastError() (0 = launched; an
// unsupported D or dtype returns cudaErrorInvalidValue without launching).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kPad = 4;         // floats of padding on a staged row

template <int D>
struct Tile {
  static constexpr int BT = D <= 128 ? 64 : 32;   // rows of a q tile, keys
  static constexpr int R = BT / 16;               // rows (keys) a thread
  static constexpr int QS = D + kPad;             // pitch of a staged row
  static constexpr int PS = BT + kPad;            // pitch of a p or ds tile
  // q, do, k, v staged; lse and delta of the q tile; p and ds (dk, dv) or
  // ds transposed (dq)
  static constexpr size_t dkdv_bytes =
      sizeof(float) * (4 * (size_t)BT * QS + 2 * (size_t)BT * PS + 2 * BT);
  static constexpr size_t dq_bytes =
      sizeof(float) * (4 * (size_t)BT * QS + (size_t)BT * PS + 2 * BT);
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

// the tile's lse and delta into shared memory; rows past Sq get lse +inf
// (p = 0) and delta 0
__device__ __forceinline__ void stage_rows(float* s_lse, float* s_delta,
                                           const float* lse,
                                           const float* delta, int rows,
                                           int n_valid) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool ok = i < n_valid;
    s_lse[i] = ok ? lse[i] : __int_as_float(0x7f800000);
    s_delta[i] = ok ? delta[i] : 0.f;
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

// acc[i][j] += a_row(ty*R + i) . b_row(tx + 16 j) over D: rows of `a` and
// `b` staged with pitch QS
template <int D, int R, int NC, int QS>
__device__ __forceinline__ void dot_tile(float (&acc)[R][NC], const float* a,
                                         const float* b, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[NC];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * R + i) * QS + d);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * QS + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float x = acc[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        acc[i][j] = x;
      }
  }
}

// p and ds of a (q tile, KV tile) pair from S = q k^T and dP = do v^T, in
// place: s becomes p, dp becomes ds.  Rows q0 + ty*R + i, keys
// k0 + tx + 16 j.
template <int R, int NC>
__device__ __forceinline__ void p_and_ds(float (&s)[R][NC],
                                         float (&dp)[R][NC],
                                         const float* s_lse,
                                         const float* s_delta, int q0,
                                         int k0, int tx, int ty, int Sk,
                                         int causal, int window,
                                         float scale) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    const float lse = s_lse[r], delta = s_delta[r];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const bool ok =
          admitted(q0 + r, k0 + tx + 16 * j, Sk, causal, window);
      const float p = ok ? expf(fmaf(s[i][j], scale, -lse)) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta);
    }
  }
}

// (B, H, Sq) rows: delta = sum over D of do * o, float32; one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(load1(o + row * D + d), load1(dout + row * D + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int H, int KVH, int Sq, int Sk,
                int causal, int window, float scale) {
  using C = Tile<D>;
  constexpr int BT = C::BT, R = C::R, QS = C::QS, PS = C::PS;
  constexpr int NC = BT / 16;          // keys a thread in S, p, ds
  constexpr int CPT = D / 16;          // columns of dk, dv a thread
  constexpr int VEC = CPT < 4 ? CPT : 4;
  constexpr int NG = CPT / VEC;        // groups of VEC columns, 16*VEC apart

  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [BT][QS]
  float* sV = sK + BT * QS;                      // [BT][QS]
  float* sQ = sV + BT * QS;                      // [BT][QS]
  float* sO = sQ + BT * QS;                      // [BT][QS]: do
  float* sP = sO + BT * QS;                      // [BT q][PS]: p
  float* sS = sP + BT * PS;                      // [BT q][PS]: ds
  float* sL = sS + BT * PS;                      // [BT]: lse
  float* sD = sL + BT;                           // [BT]: delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BT;      // the first tiles have the most rows
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k_valid = min(BT, Sk - k0);
  const int G = H / KVH;

  const size_t kv_off = (((size_t)b * KVH + kvh) * Sk + k0) * D;
  stage<T, D>(sK, QS, k + kv_off, BT, k_valid);
  stage<T, D>(sV, QS, v + kv_off, BT, k_valid);

  // the queries any key of this tile is admitted by: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq, k0 + BT - 1 + window) : Sq;
  const int t_lo = q_lo / BT;
  const int t_hi = q_hi > q_lo ? (q_hi + BT - 1) / BT : t_lo;

  float ak[R][CPT], av[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t row0 = ((size_t)b * H + h) * Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BT;
      const int q_valid = min(BT, Sq - q0);
      __syncthreads();   // K, V staged; the last tile's q, do, p, ds read
      stage<T, D>(sQ, QS, q + (row0 + q0) * D, BT, q_valid);
      stage<T, D>(sO, QS, dout + (row0 + q0) * D, BT, q_valid);
      stage_rows(sL, sD, lse + row0 + q0, delta + row0 + q0, BT, q_valid);
      __syncthreads();

      float s[R][NC], dp[R][NC];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
      dot_tile<D, R, NC, QS>(s, sQ, sK, tx, ty);
      dot_tile<D, R, NC, QS>(dp, sO, sV, tx, ty);
      p_and_ds<R, NC>(s, dp, sL, sD, q0, k0, tx, ty, Sk, causal, window,
                      scale);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          sP[(ty * R + i) * PS + tx + 16 * j] = s[i][j];
          sS[(ty * R + i) * PS + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dv += p^T do, dk += ds^T q: keys ty*R + i, columns
      // VEC*tx + 16*VEC*gg + e
#pragma unroll 2
      for (int qq = 0; qq < BT; ++qq) {
        float pr[R], sr[R];
        load_vec<R>(sP + qq * PS + ty * R, pr);
        load_vec<R>(sS + qq * PS + ty * R, sr);
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          float ov[VEC], qv[VEC];
          load_vec<VEC>(sO + qq * QS + VEC * tx + 16 * VEC * gg, ov);
          load_vec<VEC>(sQ + qq * QS + VEC * tx + 16 * VEC * gg, qv);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              av[i][gg * VEC + e] = fmaf(pr[i], ov[e], av[i][gg * VEC + e]);
              ak[i][gg * VEC + e] = fmaf(sr[i], qv[e], ak[i][gg * VEC + e]);
            }
        }
      }
    }
  }

  T* dkp = dk + kv_off;
  T* dvp = dv + kv_off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    if (r >= k_valid) continue;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = VEC * tx + 16 * VEC * gg + e;
        store1(dkp + (size_t)r * D + c, ak[i][gg * VEC + e] * scale);
        store1(dvp + (size_t)r * D + c, av[i][gg * VEC + e]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H,
              int KVH, int Sq, int Sk, int causal, int window, float scale) {
  using C = Tile<D>;
  constexpr int BT = C::BT, R = C::R, QS = C::QS, PS = C::PS;
  constexpr int NC = BT / 16;
  constexpr int CPT = D / 16;
  constexpr int VEC = CPT < 4 ? CPT : 4;
  constexpr int NG = CPT / VEC;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [BT][QS]
  float* sO = sQ + BT * QS;                      // [BT][QS]: do
  float* sK = sO + BT * QS;                      // [BT][QS]
  float* sV = sK + BT * QS;                      // [BT][QS]
  float* sT = sV + BT * QS;                      // [BT key][PS]: ds^T
  float* sL = sT + BT * PS;                      // [BT]: lse
  float* sD = sL + BT;                           // [BT]: delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KVH / H;
  const int q_valid = min(BT, Sq - q0);
  const size_t row0 = ((size_t)b * H + h) * Sq + q0;
  const size_t kv0 = ((size_t)b * KVH + kvh) * Sk;

  stage<T, D>(sQ, QS, q + row0 * D, BT, q_valid);
  stage<T, D>(sO, QS, dout + row0 * D, BT, q_valid);
  stage_rows(sL, sD, lse + row0, delta + row0, BT, q_valid);

  // the keys any row of this tile admits: [k_lo, k_hi)
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + q_valid) : Sk;
  const int t_lo = k_lo / BT;
  const int t_hi = k_hi > k_lo ? (k_hi + BT - 1) / BT : t_lo;

  float aq[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) aq[i][c] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BT;
    __syncthreads();   // q, do staged; the last tile's K, V and ds^T read
    stage<T, D>(sK, QS, k + (kv0 + k0) * D, BT, min(BT, Sk - k0));
    stage<T, D>(sV, QS, v + (kv0 + k0) * D, BT, min(BT, Sk - k0));
    __syncthreads();

    float s[R][NC], dp[R][NC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tile<D, R, NC, QS>(s, sQ, sK, tx, ty);
    dot_tile<D, R, NC, QS>(dp, sO, sV, tx, ty);
    p_and_ds<R, NC>(s, dp, sL, sD, q0, k0, tx, ty, Sk, causal, window,
                    scale);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < R; ++i)
        sT[(tx + 16 * j) * PS + ty * R + i] = dp[i][j];
    __syncthreads();

    // dq += ds k: rows ty*R + i, columns VEC*tx + 16*VEC*gg + e
#pragma unroll 2
    for (int kk = 0; kk < BT; ++kk) {
      float sr[R];
      load_vec<R>(sT + kk * PS + ty * R, sr);
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        float kv[VEC];
        load_vec<VEC>(sK + kk * QS + VEC * tx + 16 * VEC * gg, kv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            aq[i][gg * VEC + e] = fmaf(sr[i], kv[e], aq[i][gg * VEC + e]);
      }
    }
  }

  T* dqp = dq + row0 * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    if (r >= q_valid) continue;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store1(dqp + (size_t)r * D + VEC * tx + 16 * VEC * gg + e,
               aq[i][gg * VEC + e] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KVH, int Sq, int Sk,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Tile<D>;
  // above 48 KB a kernel must opt in; a refusal is reported, not ignored
  int rc = (int)cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::dkdv_bytes);
  if (rc) return rc;
  rc = (int)cudaFuncSetAttribute(bwd_dq_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)C::dq_bytes);
  if (rc) return rc;
  const long long rows = (long long)B * H * Sq;
  const int per_block = kThreads / 32;
  bwd_delta_kernel<T, D><<<(unsigned)((rows + per_block - 1) / per_block),
                           kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, rows);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid_kv((Sk + C::BT - 1) / C::BT, KVH, B);
  bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, C::dkdv_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, KVH, Sq, Sk, causal, window, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid_q((Sq + C::BT - 1) / C::BT, H, B);
  bwd_dq_kernel<T, D><<<grid_q, kThreads, C::dq_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, H, KVH, Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int B, int H,
               int KVH, int Sq, int Sk, int causal, int window, float scale,
               cudaStream_t st) {
#define REPRO_BWD(DD)                                                       \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,    \
                         KVH, Sq, Sk, causal, window, scale, st);
  switch (D) {
    REPRO_BWD(16)
    REPRO_BWD(32)
    REPRO_BWD(64)
    REPRO_BWD(128)
    REPRO_BWD(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 float32, 1 bfloat16, for q, k, v, o, do, dq, dk, dv alike; lse
// and delta float32 (B, H, Sq), delta the caller's scratch.  Every tensor
// contiguous and 16-byte aligned.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int dtype, int B, int H,
                              int KVH, int Sq, int Sk, int D, int causal,
                              int window, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, H,
                             KVH, Sq, Sk, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv,
                                     B, H, KVH, Sq, Sk, causal, window,
                                     scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
