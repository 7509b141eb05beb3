// Kernel 8: fused short-sequence multi-head attention.
//
// Replaces the JAX package's ops/fused_attention.py::_attn_kernel (per-head)
// and ::_attn_kernel_paired (head pairs), both reached through
// fused_attention (:139).  The paired TPU kernel zeroes the other head's half
// of q and contracts over 128 lanes, which in exact arithmetic is the
// per-head product, so one kernel serves both.  The TPU's batch block
// (_pick_block, block_b) sized a VMEM window and has no counterpart here.
//
// q (B, Wq, H), k and v (B, W, H) stay in the projection layout: head h is
// the column slice [h*d, (h+1)*d) of every row, so no head transpose is ever
// written.  mask (B, W) int32, nonzero where attendable.  Per (batch, head,
// query row), in the JAX kernel's arithmetic:
//   s = fp32(q_h . k_h) * scale + bias    scale = fp32(1/sqrt(d)), a multiply;
//                                         bias 0 or -1e9 from the mask
//   p = exp(s - max s) / sum(exp(...))    expf and an IEEE division
//   o = fp32(round_T(p) . v_h)            p rounded to the input type first
// and o is rounded to the output type.  Masked keys are not skipped, so a
// fully masked row is the softmax over s - 1e9, as in JAX (no NaN).
//
// Design (a first, simple version): one block of 256 threads owns QT = 32
// query rows of one head of one batch row; grid (B, nh, ceil(Wq / QT)).  The
// block's q rows sit in shared memory as fp32; k then v stream through one
// KT = 64-row fp32 tile; the (QT, W) fp32 score rows live in dynamic shared
// memory (W <= 514: 66 KB) and never reach device memory.  Phase 1: each
// thread scores one key of the tile against 8 query rows (the query reads
// are warp broadcasts, the key rows padded to d + 1 words against bank
// conflicts).  Phase 2: one warp a row takes the max, the exponentials and
// their sum with shuffles, and writes p rounded to the input type.  Phase 3:
// each thread accumulates QT*d/256 outputs (one column, rows 256/d apart) in
// fp32 registers over the v tiles.  All products are fp32 FMAs on the CUDA
// cores; tensor cores (mma.sync / wgmma) are later work.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): at the corpus shape
// (B=256, W=Wq=300, H=768, nh=12, bf16) the function reads q, k, v and the
// mask and writes o once, 0.47 GB (0.14 ms), and does 4*B*nh*Wq*W*d = 71
// GFLOP (0.07 ms): it is bound by bytes.  This kernel rereads each head's k
// and v once per query tile (from L2) and runs at the CUDA-core FMA rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mdrt_attn {

constexpr int QT = 32;    // query rows a block
constexpr int KT = 64;    // key (value) rows a shared-memory tile
constexpr int NT = 256;   // threads a block
constexpr float MASK_BIAS = -1e9f;

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

// rows [r0, r0 + KT) of one head of `src` (row stride hs) into `dst` as fp32,
// row stride D + 1; rows >= w are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int w, int hs) {
  for (int i = threadIdx.x; i < KT * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < w ? to_f(src[size_t(r0 + r) * hs + c])
                                      : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ mask, int wq,
            int w, int nh, float scale, T* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][D]
  float* kv = qs + QT * D;           // [KT][D + 1]
  float* ss = kv + KT * (D + 1);     // [QT][w]
  const int bi = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * QT;
  const int t = threadIdx.x;
  const int hs = nh * D;
  const T* qb = q + size_t(bi) * wq * hs + h * D;
  const T* kb = k + size_t(bi) * w * hs + h * D;
  const T* vb = v + size_t(bi) * w * hs + h * D;
  const int* mb = mask + size_t(bi) * w;
  const int nq = min(QT, wq - q0);

  for (int i = t; i < QT * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[i] = r < nq ? to_f(qb[size_t(q0 + r) * hs + c]) : 0.f;
  }

  // phase 1: scores of QT query rows against each key tile
  constexpr int QPT = QT * KT / NT;   // query rows a thread: 8
  constexpr int QSTEP = NT / KT;      // 4 rows apart
  const int kj = t % KT, qg = t / KT;
  for (int k0 = 0; k0 < w; k0 += KT) {
    __syncthreads();
    load_tile<T, D>(kv, kb, k0, w, hs);
    __syncthreads();
    if (k0 + kj < w) {
      float acc[QPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) acc[i] = 0.f;
      const float* kr = kv + kj * (D + 1);
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float kc = kr[c];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          acc[i] = fmaf(qs[(qg + QSTEP * i) * D + c], kc, acc[i]);
      }
      const float bias = mb[k0 + kj] != 0 ? 0.f : MASK_BIAS;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int r = qg + QSTEP * i;
        if (r < nq) ss[r * w + k0 + kj] = __fadd_rn(__fmul_rn(acc[i], scale),
                                                    bias);
      }
    }
  }
  __syncthreads();

  // phase 2: softmax, one warp a row
  const int lane = t % 32, warp = t / 32;
  for (int r = warp; r < nq; r += NT / 32) {
    float* row = ss + r * w;
    float m = __int_as_float(0xff800000);   // -inf
    for (int j = lane; j < w; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < w; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < w; j += 32)
      row[j] = to_f(from_f<T>(__fdiv_rn(row[j], sum)));
  }

  // phase 3: o = p . v over the value tiles
  constexpr int OPT = QT * D / NT;    // outputs a thread: 1 (d=8) .. 16
  constexpr int RSTEP = NT / D;       // their rows are RSTEP apart
  const int c = t % D, rg = t / D;
  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < w; k0 += KT) {
    __syncthreads();
    load_tile<T, D>(kv, vb, k0, w, hs);
    __syncthreads();
    const int kn = min(KT, w - k0);
    for (int j = 0; j < kn; ++j) {
      const float vj = kv[j * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < OPT; ++i)
        acc[i] = fmaf(ss[(rg + RSTEP * i) * w + k0 + j], vj, acc[i]);
    }
  }
  T* ob = out + size_t(bi) * wq * hs + h * D;
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int r = rg + RSTEP * i;
    if (r < nq) ob[size_t(q0 + r) * hs + c] = from_f<T>(acc[i]);
  }
}

inline size_t smem_bytes(int d, int w) {
  return sizeof(float) * (size_t(QT) * d + size_t(KT) * (d + 1) +
                          size_t(QT) * w);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask,
           int b, int wq, int w, int nh, float scale, void* out,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D, w);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(b, nh, (wq + QT - 1) / QT);
  attn_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask), wq, w, nh,
      scale, static_cast<T*>(out));
  return int(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* mask,
             int b, int wq, int w, int nh, int d, float scale, void* out,
             cudaStream_t s) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, mask, b, wq, w, nh, scale, out, s);
    case 16:
      return launch<T, 16>(q, k, v, mask, b, wq, w, nh, scale, out, s);
    case 32:
      return launch<T, 32>(q, k, v, mask, b, wq, w, nh, scale, out, s);
    case 64:
      return launch<T, 64>(q, k, v, mask, b, wq, w, nh, scale, out, s);
    case 128:
      return launch<T, 128>(q, k, v, mask, b, wq, w, nh, scale, out, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace mdrt_attn

// dtype: 1 bf16, 2 fp32.  q (b, wq, nh * d), k and v (b, w, nh * d) of that
// dtype, contiguous; mask (b, w) int32; out (b, wq, nh * d) of that dtype.
// d in {8, 16, 32, 64, 128}, 1 <= wq <= w <= 514; scale = fp32(1/sqrt(d)).
extern "C" int fused_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* mask, int b, int wq,
                               int w, int nh, int d, float scale, void* out,
                               void* stream) {
  using namespace mdrt_attn;
  if (b < 1 || nh < 1 || wq < 1 || wq > w || w > 514)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, mask, b, wq, w, nh, d, scale,
                                     out, s);
    case 2:
      return launch_d<float>(q, k, v, mask, b, wq, w, nh, d, scale, out, s);
  }
  return int(cudaErrorInvalidValue);
}
