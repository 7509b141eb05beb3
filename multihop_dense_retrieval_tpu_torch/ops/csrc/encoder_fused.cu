// Kernels 9-11: one pass for each elementwise chain between two matmuls of
// an encoder layer (models/encoder.py, wrappers in ops/encoder_fused.py).
//
// They replace no TPU kernel: the JAX package wrote no Pallas kernel for
// these chains and left them to XLA's fusion inside jit.  PyTorch runs them
// op by op, one pass over device memory an op, so they are the port's own
// cost (an erf-GELU chain of 8 ops, a masked softmax of 9, a bias +
// residual + LayerNorm of about 13).
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Each chain does a few dozen
// fp32 operations an element against 4-6 bytes an element, far below the
// card's balance of operations to bytes.  What the design does about it:
// each kernel reads the matmul's output once and writes the next matmul's
// input once, in the compute dtype; every intermediate of the chain lives
// in registers (a whole row where the chain reduces over it), and biases,
// LayerNorm parameters and the mask bias are rows of a few KB that stay in
// L1/L2.  At mhop.beam5.b100's shapes that is about 36 GB a batch for the
// three chains against about 500 GB op by op.
//
// The arithmetic is the plain path's, operation for operation and rounding
// for rounding: __fadd_rn / __fmul_rn / __fsub_rn / __fdiv_rn so that no
// multiply-add is contracted into an FMA where the plain path rounds
// between two ops, erff / expf / rsqrtf as PyTorch's CUDA kernels call
// them, and a round to the compute dtype T (bf16 round-to-nearest-even)
// wherever the plain path stores a tensor in T.  The only freedom taken is
// the order of a row's sums (softmax denominator, LayerNorm moments).
//
//   bias_gelu (kernel 9): out = gelu(round_T(y + b)), gelu(x) = (x * 0.5) *
//     (1 + erff(x * float(0.7071067811865476))) in fp32, one round to T.
//     Bit-equal to the plain path.  One thread a 16-byte pack (8 bf16 or 4
//     fp32); VEC = 1 where the width or an address is off 16 bytes.
//
//   masked_softmax (kernel 10): scores (rows, L) as the attention matmul
//     leaves them, rows = B * nh * Lq, and the (B, L) fp32 0 / -1e9 bias.
//     The plain path divides by a CPU 0-dim tensor, which PyTorch's CUDA
//     division computes as a * (1 / b) in fp32 (the wrapper passes 1 / b),
//     rounded to T.  Then, with fp32 scores: + bias, max, expf(s - m), sum,
//     e / sum in fp32, one round to T.  With bf16 scores (ROUND): the bias
//     rounded to T, and the sum, the subtraction, the exp, the row sum and
//     the division each rounded to T, as the plain path's bf16 tensors are.
//     One warp a row, the row in registers (L <= 514: 17 a lane), read and
//     written once; the bias row is shared by a batch row's heads (cache).
//
//   add_layer_norm (kernel 11): h = round_T(res + round_T(y + b)), then
//     fp32 statistics as the plain path's CUDA mean takes them (the sum
//     times fp32(1 / N)): mean, E[h^2], var = max(E[h^2] - mean^2, 0),
//     mul = rsqrtf(var + eps) * w, out = round_T((h - mean) * mul + beta).
//     One warp a row (N <= 1024, 32 a lane), 16-byte packs; the residual
//     comes with its own row stride (x[:, :1] under cls_only).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mdrt_enc {

constexpr int NT = 256;          // threads a block
constexpr int WARPS = NT / 32;   // rows a block (softmax, LayerNorm)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// the value a tensor of dtype T stores for the fp32 x
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& x) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;   // the same in every lane: each step adds the same two terms
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// models/encoder.py::gelu_exact on one fp32 value: xf * 0.5 * (1.0 +
// erf(xf * 0.7071067811865476)), each op rounded, the Python float constant
// taken to fp32 as PyTorch's scalar is
__device__ __forceinline__ float gelu(float x) {
  const float half = __fmul_rn(x, 0.5f);
  const float e = erff(__fmul_rn(x, static_cast<float>(0.7071067811865476)));
  return __fmul_rn(half, __fadd_rn(e, 1.0f));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
bias_gelu_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                 T* __restrict__ out, long long packs, int col_packs) {
  const long long i = blockIdx.x * (long long)NT + threadIdx.x;
  if (i >= packs) return;
  const Pack<T, VEC> a = load<T, VEC>(y + i * VEC);
  const Pack<T, VEC> b = load<T, VEC>(bias + (i % col_packs) * VEC);
  Pack<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    o.v[e] = from_f<T>(gelu(rnd<T>(__fadd_rn(to_f(a.v[e]), to_f(b.v[e])))));
  store<T, VEC>(out + i * VEC, o);
}

template <typename T, bool ROUND, int KPL>
__global__ void __launch_bounds__(NT)
masked_softmax_kernel(const T* __restrict__ s, const float* __restrict__ bias,
                      T* __restrict__ out, long long rows, int rows_per_bias,
                      int L, float inv_scale) {
  const long long row = blockIdx.x * (long long)WARPS + threadIdx.x / 32;
  if (row >= rows) return;          // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const T* sr = s + row * L;
  const float* br = bias + (row / rows_per_bias) * L;
  float v[KPL];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int j = lane + 32 * k;
    if (j < L) {
      float x = rnd<T>(__fmul_rn(to_f(sr[j]), inv_scale));
      x = ROUND ? rnd<T>(__fadd_rn(x, rnd<T>(br[j]))) : __fadd_rn(x, br[j]);
      v[k] = x;
      m = fmaxf(m, x);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    if (lane + 32 * k < L) {
      float d = __fsub_rn(v[k], m);
      if (ROUND) d = rnd<T>(d);
      float e = expf(d);
      if (ROUND) e = rnd<T>(e);
      v[k] = e;
      sum = __fadd_rn(sum, e);
    }
  }
  sum = warp_sum(sum);
  if (ROUND) sum = rnd<T>(sum);
  T* orow = out + row * L;
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int j = lane + 32 * k;
    if (j < L) orow[j] = from_f<T>(__fdiv_rn(v[k], sum));
  }
}

template <typename T, int VEC, int KPL>
__global__ void __launch_bounds__(NT)
add_layer_norm_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                      const T* __restrict__ res, long long res_stride,
                      const float* __restrict__ w,
                      const float* __restrict__ beta, T* __restrict__ out,
                      long long rows, int n, float inv_n, float eps) {
  const long long row = blockIdx.x * (long long)WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int packs = n / VEC;
  const T* yr = y + row * n;
  const T* rr = res + row * res_stride;
  float h[KPL][VEC];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int c = lane + 32 * k;
    if (c < packs) {
      const Pack<T, VEC> a = load<T, VEC>(yr + c * VEC);
      const Pack<T, VEC> b = load<T, VEC>(bias + c * VEC);
      const Pack<T, VEC> r = load<T, VEC>(rr + c * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float att = rnd<T>(__fadd_rn(to_f(a.v[e]), to_f(b.v[e])));
        const float x = rnd<T>(__fadd_rn(to_f(r.v[e]), att));
        h[k][e] = x;
        s1 = __fadd_rn(s1, x);
        s2 = __fadd_rn(s2, __fmul_rn(x, x));
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = __fmul_rn(s1, inv_n);
  const float var =
      fmaxf(__fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(mean, mean)), 0.f);
  const float r = rsqrtf(__fadd_rn(var, eps));
  T* orow = out + row * n;
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int c = lane + 32 * k;
    if (c < packs) {
      const Pack<float, VEC> wv = load<float, VEC>(w + c * VEC);
      const Pack<float, VEC> bv = load<float, VEC>(beta + c * VEC);
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float mul = __fmul_rn(r, wv.v[e]);
        o.v[e] = from_f<T>(
            __fadd_rn(__fmul_rn(__fsub_rn(h[k][e], mean), mul), bv.v[e]));
      }
      store<T, VEC>(orow + c * VEC, o);
    }
  }
}

inline unsigned blocks(long long work, int per_block) {
  return unsigned((work + per_block - 1) / per_block);
}

template <typename T>
int gelu_launch(int vec, const void* y, const void* bias, void* out,
                long long rows, int cols, cudaStream_t st) {
  const long long n = rows * cols;
  const T* yp = static_cast<const T*>(y);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    bias_gelu_kernel<T, V><<<blocks(n / V, NT), NT, 0, st>>>(
        yp, bp, op, n / V, cols / V);
  } else if (vec == 1) {
    bias_gelu_kernel<T, 1><<<blocks(n, NT), NT, 0, st>>>(yp, bp, op, n, cols);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

template <typename T, bool ROUND>
int softmax_launch(const void* s, const float* bias, void* out,
                   long long rows, int rows_per_bias, int L, float inv_scale,
                   cudaStream_t st) {
  const T* sp = static_cast<const T*>(s);
  T* op = static_cast<T*>(out);
  const unsigned g = blocks(rows, WARPS);
  if (L <= 128)
    masked_softmax_kernel<T, ROUND, 4><<<g, NT, 0, st>>>(
        sp, bias, op, rows, rows_per_bias, L, inv_scale);
  else if (L <= 256)
    masked_softmax_kernel<T, ROUND, 8><<<g, NT, 0, st>>>(
        sp, bias, op, rows, rows_per_bias, L, inv_scale);
  else
    masked_softmax_kernel<T, ROUND, 17><<<g, NT, 0, st>>>(
        sp, bias, op, rows, rows_per_bias, L, inv_scale);
  return int(cudaGetLastError());
}

template <typename T>
int ln_launch(int vec, const void* y, const void* bias, const void* res,
              long long res_stride, const float* w, const float* b,
              void* out, long long rows, int n, float inv_n, float eps,
              cudaStream_t st) {
  const T* yp = static_cast<const T*>(y);
  const T* bp = static_cast<const T*>(bias);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  const unsigned g = blocks(rows, WARPS);
  constexpr int V = 16 / sizeof(T);
  if (vec == V)   // 32 values a lane at most: n <= 1024
    add_layer_norm_kernel<T, V, 32 / V><<<g, NT, 0, st>>>(
        yp, bp, rp, res_stride, w, b, op, rows, n, inv_n, eps);
  else if (vec == 1)
    add_layer_norm_kernel<T, 1, 32><<<g, NT, 0, st>>>(
        yp, bp, rp, res_stride, w, b, op, rows, n, inv_n, eps);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

}  // namespace mdrt_enc

// dtype: 1 bf16, 2 fp32 (ops/mips.py::_FLOAT_CODES).  vec: 16 / element
// size (16-byte packs) or 1.  Pointers on the device; the wrapper checks
// shapes, contiguity and alignment.

// out (rows, cols) = gelu(round(y + bias)), bias (cols,)
extern "C" int bias_gelu(int dtype, int vec, const void* y, const void* bias,
                         void* out, long long rows, int cols, void* stream) {
  if (rows < 0 || cols < 1 || (vec > 1 && cols % vec))
    return int(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return mdrt_enc::gelu_launch<__nv_bfloat16>(vec, y, bias, out, rows,
                                                   cols, st);
    case 2:
      return mdrt_enc::gelu_launch<float>(vec, y, bias, out, rows, cols, st);
  }
  return int(cudaErrorInvalidValue);
}

// scores (rows, L), row r's bias row r / rows_per_bias of bias (., L) fp32;
// round_steps: the bf16 score path (dtype 1 only)
extern "C" int masked_softmax(int dtype, int round_steps, const void* scores,
                              const void* bias, void* out, long long rows,
                              int rows_per_bias, int L, float inv_scale,
                              void* stream) {
  if (rows < 0 || rows_per_bias < 1 || L < 1 || L > 544)
    return int(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (dtype == 1 && round_steps)
    return mdrt_enc::softmax_launch<__nv_bfloat16, true>(
        scores, bp, out, rows, rows_per_bias, L, inv_scale, st);
  if (dtype == 1)
    return mdrt_enc::softmax_launch<__nv_bfloat16, false>(
        scores, bp, out, rows, rows_per_bias, L, inv_scale, st);
  if (dtype == 2)
    return mdrt_enc::softmax_launch<float, false>(
        scores, bp, out, rows, rows_per_bias, L, inv_scale, st);
  return int(cudaErrorInvalidValue);
}

// out (rows, n) = LayerNorm(res + round(y + bias)); y, out rows of n,
// res rows res_stride apart; w, b (n,) fp32
extern "C" int add_layer_norm(int dtype, int vec, const void* y,
                              const void* bias, const void* res,
                              long long res_stride, const void* w,
                              const void* b, void* out, long long rows, int n,
                              float inv_n, float eps, void* stream) {
  if (rows < 0 || n < 1 || n > 1024 || (vec > 1 && n % vec))
    return int(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  switch (dtype) {
    case 1:
      return mdrt_enc::ln_launch<__nv_bfloat16>(vec, y, bias, res, res_stride,
                                                wp, bp, out, rows, n, inv_n,
                                                eps, st);
    case 2:
      return mdrt_enc::ln_launch<float>(vec, y, bias, res, res_stride, wp, bp,
                                        out, rows, n, inv_n, eps, st);
  }
  return int(cudaErrorInvalidValue);
}
