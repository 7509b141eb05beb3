// The PCA-prefiltered certified search's two kernels: kernels 3 and 4.
//
// Kernel 3 (pca_chunk_max_kernel) replaces the JAX package's
// ops/mips.py::_chunk_max_fine_kernel (phase 1 of mips_topk_pca): for every
// query and every cand_rows-row candidate chunk, the max over the chunk's
// valid rows of the bf16 dot q_proj . P[row] (fp32 sums), written straight
// as (B, num_cand).  A block scores a 64-query tile (tile_dot.cuh) against
// `chunks_per_block` consecutive chunks; the 16 threads of a query reduce
// their maxima with half-warp shuffles.  Chunks with no valid row give
// NEG_INF, as the JAX kernel's mask does.  Bound on an H100 SXM (B=192,
// R=128, N=1,048,576): 0.27 GB of bf16 projection at 3.35 TB/s, 0.08 ms;
// like the scan it runs on CUDA-core FMAs in this first version.
//
// Kernel 4 (pca_rescan_int8_kernel) replaces ops/mips.py::_rescan_kernel_int8
// (phase 2, via _sparse_rescan): one block per (query, selected chunk).
// The TPU prefetched the chunk ids as scalars to drive its DMA; here the
// block loads its own id.  Each warp walks rows of the chunk; lane l holds
// query words l, l+32, ... in registers and reads the same words of the
// row (128-byte coalesced loads), __dp4a accumulates exactly in int32 and
// a shuffle tree sums the lanes.  The output is float(raw) * d_scale[row]
// (mips.py:566); the caller multiplies by the query scale afterwards
// (mips.py:988), so the order (raw*dsc)*q_scale is kept.  Rows >= n_valid
// give NEG_INF.  Bound (B=192, kc=8, 512-row chunks, D=768): 0.60 GB of
// int8 rows at 3.35 TB/s, 0.18 ms.
#include "tile_dot.cuh"

namespace mdrt {

__global__ void __launch_bounds__(NTHREADS)
pca_chunk_max_kernel(const int4* __restrict__ qp, const int4* __restrict__ proj,
                     int b, long long n, long long n_valid, int w,
                     int cand_rows, int num_cand, int chunks_per_block,
                     float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* qs = reinterpret_cast<int*>(smem4);
  int* rs = qs + QB * (w + 4);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * QB;
  load_query_tile(qs, qp, b, q0, w);

  const int c_begin = blockIdx.y * chunks_per_block;
  int c_end = c_begin + chunks_per_block;
  if (c_end > num_cand) c_end = num_cand;
  for (int c = c_begin; c < c_end; ++c) {
    float m[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) m[i] = NEG_INF;
    const long long c0 = (long long)c * cand_rows;
    for (long long r0 = c0; r0 < c0 + cand_rows; r0 += RB) {
      float acc[TQ][TR];
      score_row_tile<__nv_bfloat16>(acc, qs, rs, proj, r0, n, w);
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        long long r = r0 + tx + 16 * j;
        if (r >= n_valid) continue;
#pragma unroll
        for (int i = 0; i < TQ; ++i) m[i] = fmaxf(m[i], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
      int qi = q0 + ty + 16 * i;
      if (tx == 0 && qi < b) out[size_t(qi) * num_cand + c] = m[i];
    }
  }
}

constexpr int RESCAN_MAXM = 8;  // query words per lane: D <= 1024

__global__ void __launch_bounds__(256)
pca_rescan_int8_kernel(const int* __restrict__ chunk_ids,
                       const int* __restrict__ q, const int* __restrict__ index,
                       const float* __restrict__ d_scale, int kc, int w,
                       int cand_rows, long long n_valid,
                       float* __restrict__ out) {
  const int kk = blockIdx.x, bq = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const long long row0 = (long long)chunk_ids[bq * kc + kk] * cand_rows;
  int qw[RESCAN_MAXM];
#pragma unroll
  for (int m = 0; m < RESCAN_MAXM; ++m) {
    int c = lane + 32 * m;
    qw[m] = c < w ? __ldg(q + size_t(bq) * w + c) : 0;
  }
  float* dst = out + (size_t(bq) * kc + kk) * cand_rows;
  for (int j = warp; j < cand_rows; j += n_warps) {
    const long long row = row0 + j;
    const int* src = index + row * w;
    int acc = 0;
#pragma unroll
    for (int m = 0; m < RESCAN_MAXM; ++m) {
      int c = lane + 32 * m;
      if (c < w) acc = __dp4a(__ldg(src + c), qw[m], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      dst[j] = row < n_valid ? __fmul_rn(__int2float_rn(acc), d_scale[row])
                             : NEG_INF;
  }
}

}  // namespace mdrt

// qp (b, R) bf16, proj (n, R) bf16, w = R / 2 words (a multiple of 16);
// out (b, num_cand) fp32 with num_cand = n / cand_rows, cand_rows % 128 == 0.
extern "C" int pca_chunk_max(const void* qp, const void* proj, int b,
                             long long n, long long n_valid, int w,
                             int cand_rows, int chunks_per_block, void* out,
                             void* stream) {
  using namespace mdrt;
  if (w % KW != 0 || cand_rows % RB != 0 || n % cand_rows != 0 ||
      chunks_per_block < 1)
    return int(cudaErrorInvalidValue);
  const int num_cand = int(n / cand_rows);
  size_t smem = tile_smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      pca_chunk_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((b + QB - 1) / QB,
            (num_cand + chunks_per_block - 1) / chunks_per_block);
  pca_chunk_max_kernel<<<grid, NTHREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(qp), reinterpret_cast<const int4*>(proj),
      b, n, n_valid, w, cand_rows, num_cand, chunks_per_block,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

// chunk_ids (b, kc) int32; q (b, D) int8; index (n, D) int8; d_scale (n,)
// fp32; w = D / 4 words (<= 256); out (b, kc * cand_rows) fp32.
extern "C" int pca_rescan_int8(const void* chunk_ids, const void* q,
                               const void* index, const void* d_scale, int b,
                               int kc, int w, int cand_rows,
                               long long n_valid, void* out, void* stream) {
  using namespace mdrt;
  if (w > 32 * RESCAN_MAXM) return int(cudaErrorInvalidValue);
  dim3 grid(kc, b);
  pca_rescan_int8_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(chunk_ids), static_cast<const int*>(q),
      static_cast<const int*>(index), static_cast<const float*>(d_scale), kc,
      w, cand_rows, n_valid, static_cast<float*>(out));
  return int(cudaGetLastError());
}
