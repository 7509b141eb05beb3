// Shared SIMT tile machinery for the scan kernels (mips_scan.cu) and the
// chunk-max kernels of the two-phase and PCA searches (two_phase.cu).
//
// A block of 256 threads scores a tile of QB=64 query rows, held in shared
// memory for the whole block, against row tiles of RB=128 index rows that
// stream through shared memory KW=16 32-bit words at a time.  Thread
// (ty, tx) owns queries ty + 16*i (i < 4) and rows tx + 16*j (j < 8), so the
// 16 threads that share a query sit in one half-warp and can merge their
// results with shuffles.  Row tiles use a padded stride of 20 words: the
// eight rows one quarter-warp reads with 16-byte loads then fall into eight
// disjoint bank groups.  The next k-step is loaded into registers while the
// current one is consumed.
//
// Element types are read as packed 32-bit words: int8 (4 per word, __dp4a,
// exact int32 sums), bf16 (2 per word, fp32 FMA) and fp32 (1 per word).
// Elem<T>::word accumulates one word pair (dot4 four), and Elem<T>::score
// turns a sum into the fp32 score (int8: float(raw) * d_scale[row], one
// rounding, the JAX kernels' order; the query scale is the caller's).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdrt {

constexpr float NEG_INF = -3.0e38f;  // the JAX package's mask value
constexpr int QB = 64;
constexpr int RB = 128;
constexpr int KW = 16;
constexpr int RSTRIDE = KW + 4;
constexpr int NTHREADS = 256;
constexpr int TQ = QB / 16;
constexpr int TR = RB / 16;

template <typename T> struct Elem;

template <> struct Elem<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ void word(Acc& acc, int a, int b) {
    acc = __dp4a(a, b, acc);
  }
  static __device__ __forceinline__ float score(Acc acc, const float* d_scale,
                                                long long row) {
    return __fmul_rn(__int2float_rn(acc), __ldg(d_scale + row));
  }
};

template <> struct Elem<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float2 f2(int w) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ void word(Acc& acc, int a, int b) {
    float2 x = f2(a), y = f2(b);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  static __device__ __forceinline__ float score(Acc acc, const float*,
                                                long long) {
    return acc;
  }
};

template <> struct Elem<float> {
  using Acc = float;
  static __device__ __forceinline__ void word(Acc& acc, int a, int b) {
    acc = fmaf(__int_as_float(a), __int_as_float(b), acc);
  }
  static __device__ __forceinline__ float score(Acc acc, const float*,
                                                long long) {
    return acc;
  }
};

// Four word pairs, in order.
template <typename T>
__device__ __forceinline__ void dot4(typename Elem<T>::Acc& acc,
                                     const int4& a, const int4& b) {
  Elem<T>::word(acc, a.x, b.x);
  Elem<T>::word(acc, a.y, b.y);
  Elem<T>::word(acc, a.z, b.z);
  Elem<T>::word(acc, a.w, b.w);
}

// Shared memory a block needs for a query tile of `w` words per row.
inline size_t tile_smem_bytes(int w) {
  return sizeof(int) * (size_t(QB) * (w + 4) + size_t(RB) * RSTRIDE);
}

// Load the block's query tile (rows q0 .. q0+QB, zero past `b`) into qs.
__device__ __forceinline__ void load_query_tile(int* qs, const int4* q, int b,
                                                int q0, int w) {
  const int w4 = w / 4, qstride = w + 4;
  for (int idx = threadIdx.x; idx < QB * w4; idx += NTHREADS) {
    int r = idx / w4, c = idx % w4;
    int4 v = make_int4(0, 0, 0, 0);
    if (q0 + r < b) v = __ldg(q + size_t(q0 + r) * w4 + c);
    *reinterpret_cast<int4*>(qs + r * qstride + c * 4) = v;
  }
}

// Score the query tile in shared memory against index rows r0 .. r0+RB
// (rows at or past n_rows read as zero).  acc[i][j] receives the dot
// product of query ty+16i with row r0+tx+16j.
template <typename T>
__device__ __forceinline__ void score_row_tile(
    typename Elem<T>::Acc (&acc)[TQ][TR], const int* qs, int* rs,
    const int4* rows, long long r0, long long n_rows, int w) {
  using Acc = typename Elem<T>::Acc;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int w4 = w / 4, qstride = w + 4;
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = Acc(0);

  // each thread moves two 16-byte pieces of the (RB x KW) slice per step
  int4 pre[2];
  auto fetch = [&](int kw0) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int idx = threadIdx.x + t * NTHREADS;
      int r = idx / (KW / 4), c = idx % (KW / 4);
      long long row = r0 + r;
      pre[t] = row < n_rows ? __ldg(rows + row * w4 + kw0 / 4 + c)
                            : make_int4(0, 0, 0, 0);
    }
  };
  fetch(0);
  for (int kw0 = 0; kw0 < w; kw0 += KW) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int idx = threadIdx.x + t * NTHREADS;
      int r = idx / (KW / 4), c = idx % (KW / 4);
      *reinterpret_cast<int4*>(rs + r * RSTRIDE + c * 4) = pre[t];
    }
    __syncthreads();
    if (kw0 + KW < w) fetch(kw0 + KW);
#pragma unroll
    for (int c = 0; c < KW / 4; ++c) {
      int4 qv[TQ], rv[TR];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        qv[i] = *reinterpret_cast<const int4*>(qs + (ty + 16 * i) * qstride +
                                               kw0 + c * 4);
#pragma unroll
      for (int j = 0; j < TR; ++j)
        rv[j] = *reinterpret_cast<const int4*>(rs + (tx + 16 * j) * RSTRIDE +
                                               c * 4);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) dot4<T>(acc[i][j], qv[i], rv[j]);
    }
  }
}

}  // namespace mdrt
