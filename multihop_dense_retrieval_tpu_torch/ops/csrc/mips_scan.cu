// Exact MIPS scan with a fused top-k: kernels 1 and 2 of the port.
//
// Replaces the JAX package's ops/mips.py::_mips_kernel_int8 (int8 rows,
// called from mips_topk_pallas_int8) and ops/mips.py::_mips_kernel
// (bf16/fp32 rows, from mips_topk_pallas), with their shared merge
// _merge_chunk_topk.  Scores never reach device memory: each block keeps,
// per query, the best KMAX (row, score) pairs of its rows.
//
// Pass 1 (mips_scan_kernel): grid = (query tiles of 64) x (row splits).
//   Each block scores its query tile against its split's rows through the
//   shared tile machinery (tile_dot.cuh), keeps a per-thread sorted list,
//   merges the 16 lists of a query with half-warp shuffles and writes
//   (B, splits, KMAX) partials.
// Pass 2 (mips_merge_kernel): one thread per query merges the splits.
// Order is (score desc, row id asc) everywhere, the JAX tie rule; lists
// start as (NEG_INF, 0) fillers, so a query with fewer than k valid rows
// gets (NEG_INF, 0) entries, as the JAX merge gives.  Rows >= n_valid are
// never inserted.
//
// int8 epilogue: float(raw) * q_scale[b] * d_scale[r], in that order
// (mips.py:333-335), so scores are bit-equal to the JAX package.
//
// Bound on an H100 SXM (B=192, D=768, N=1,048,576): 0.805 GB of int8 rows
// at 3.35 TB/s, 0.24 ms; 0.30 T int8 ops at 1979 TOP/s, 0.15 ms.  This
// template runs on the CUDA cores (__dp4a / fp32 FMA), so it is bound by
// their rate, not by memory.  It serves int8 rows (kernel 1), fp32 rows,
// and bf16 rows whose width is not a multiple of 64; the other bf16 rows
// take the tensor-core template of mips_scan_mma.cu.
#include "tile_dot.cuh"
#include "topk.cuh"

namespace mdrt {

using mdrt_topk::insert;

template <typename T, int KMAX>
__global__ void __launch_bounds__(NTHREADS)
mips_scan_kernel(const int4* __restrict__ q, const float* __restrict__ q_scale,
                 const int4* __restrict__ index,
                 const float* __restrict__ d_scale, int b, long long n,
                 long long n_valid, int w, long long rows_per_split,
                 float* __restrict__ part_vals, int* __restrict__ part_ids) {
  using Acc = typename Elem<T>::Acc;
  extern __shared__ int4 smem4[];
  int* qs = reinterpret_cast<int*>(smem4);
  int* rs = qs + QB * (w + 4);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const long long r_begin = split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > n) r_end = n;

  load_query_tile(qs, q, b, q0, w);

  float tv[TQ][KMAX];
  int ti[TQ][KMAX];
  float qsc[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    int qi = q0 + ty + 16 * i;
    qsc[i] = (q_scale != nullptr && qi < b) ? q_scale[qi] : 1.0f;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) { tv[i][s] = NEG_INF; ti[i][s] = 0; }
  }

  for (long long r0 = r_begin; r0 < r_end; r0 += RB) {
    Acc acc[TQ][TR];
    score_row_tile<T>(acc, qs, rs, index, r0, r_end, w);
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      long long r = r0 + tx + 16 * j;
      if (r >= r_end || r >= n_valid) continue;
      float dsc = d_scale != nullptr ? d_scale[r] : 1.0f;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        float v;
        if (d_scale != nullptr)
          v = __fmul_rn(__fmul_rn(__int2float_rn(int(acc[i][j])), qsc[i]), dsc);
        else
          v = float(acc[i][j]);
        insert<KMAX>(tv[i], ti[i], v, int(r));
      }
    }
  }

  // merge the 16 lists of each query (one half-warp) with shuffles
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      float ov[KMAX];
      int oi[KMAX];
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        ov[s] = __shfl_xor_sync(0xffffffffu, tv[i][s], off);
        oi[s] = __shfl_xor_sync(0xffffffffu, ti[i][s], off);
      }
#pragma unroll
      for (int s = 0; s < KMAX; ++s) insert<KMAX>(tv[i], ti[i], ov[s], oi[s]);
    }
    int qi = q0 + ty + 16 * i;
    if (tx == 0 && qi < b) {
      size_t base = (size_t(qi) * n_splits + split) * KMAX;
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        part_vals[base + s] = tv[i][s];
        part_ids[base + s] = ti[i][s];
      }
    }
  }
}

template <int KMAX>
__global__ void mips_merge_kernel(const float* __restrict__ part_vals,
                                  const int* __restrict__ part_ids, int b,
                                  int n_splits, int k,
                                  float* __restrict__ out_vals,
                                  int* __restrict__ out_ids) {
  int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= b) return;
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) { tv[s] = NEG_INF; ti[s] = 0; }
  const size_t base = size_t(qi) * n_splits * KMAX;
  for (int p = 0; p < n_splits * KMAX; ++p)
    insert<KMAX>(tv, ti, part_vals[base + p], part_ids[base + p]);
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      out_vals[size_t(qi) * k + s] = tv[s];
      out_ids[size_t(qi) * k + s] = ti[s];
    }
  }
}

template <typename T, int KMAX>
cudaError_t launch(const void* q, const float* q_scale, const void* index,
                   const float* d_scale, int b, long long n, long long n_valid,
                   int w, int n_splits, long long rows_per_split, int k,
                   float* part_vals, int* part_ids, float* out_vals,
                   int* out_ids, cudaStream_t stream) {
  size_t smem = tile_smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      mips_scan_kernel<T, KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, n_splits);
  mips_scan_kernel<T, KMAX><<<grid, NTHREADS, smem, stream>>>(
      reinterpret_cast<const int4*>(q), q_scale,
      reinterpret_cast<const int4*>(index), d_scale, b, n, n_valid, w,
      rows_per_split, part_vals, part_ids);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mips_merge_kernel<KMAX><<<(b + 127) / 128, 128, 0, stream>>>(
      part_vals, part_ids, b, n_splits, k, out_vals, out_ids);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int kmax, const void* q, const float* q_scale,
                     const void* index, const float* d_scale, int b,
                     long long n, long long n_valid, int w, int n_splits,
                     long long rows_per_split, int k, float* pv, int* pi,
                     float* ov, int* oi, cudaStream_t s) {
  switch (kmax) {
    case 1: return launch<T, 1>(q, q_scale, index, d_scale, b, n, n_valid, w,
                                n_splits, rows_per_split, k, pv, pi, ov, oi, s);
    case 2: return launch<T, 2>(q, q_scale, index, d_scale, b, n, n_valid, w,
                                n_splits, rows_per_split, k, pv, pi, ov, oi, s);
    case 4: return launch<T, 4>(q, q_scale, index, d_scale, b, n, n_valid, w,
                                n_splits, rows_per_split, k, pv, pi, ov, oi, s);
    case 8: return launch<T, 8>(q, q_scale, index, d_scale, b, n, n_valid, w,
                                n_splits, rows_per_split, k, pv, pi, ov, oi, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mdrt

// dtype: 0 = int8 (q_scale and d_scale required), 1 = bf16, 2 = fp32.
// w = D * itemsize / 4 words per row, a multiple of 16.  kmax in
// {1, 2, 4, 8} with k <= kmax; partials are (b, n_splits, kmax).
extern "C" int mips_scan_topk(const void* q, const void* q_scale,
                              const void* index, const void* d_scale,
                              int dtype, int b, long long n,
                              long long n_valid, int w, int n_splits,
                              long long rows_per_split, int k, int kmax,
                              void* part_vals, void* part_ids, void* out_vals,
                              void* out_ids, void* stream) {
  using namespace mdrt;
  const float* qs = static_cast<const float*>(q_scale);
  const float* ds = static_cast<const float*>(d_scale);
  float* pv = static_cast<float*>(part_vals);
  int* pi = static_cast<int*>(part_ids);
  float* ov = static_cast<float*>(out_vals);
  int* oi = static_cast<int*>(out_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w % KW != 0 || k > kmax) return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return int(launch_k<int8_t>(kmax, q, qs, index, ds, b, n, n_valid,
                                        w, n_splits, rows_per_split, k, pv, pi,
                                        ov, oi, s));
    case 1: return int(launch_k<__nv_bfloat16>(kmax, q, nullptr, index,
                                               nullptr, b, n, n_valid, w,
                                               n_splits, rows_per_split, k, pv,
                                               pi, ov, oi, s));
    case 2: return int(launch_k<float>(kmax, q, nullptr, index, nullptr, b, n,
                                       n_valid, w, n_splits, rows_per_split, k,
                                       pv, pi, ov, oi, s));
    default: return int(cudaErrorInvalidValue);
  }
}
