// The two phases shared by the exact two-phase search and the PCA-prefiltered
// certified search, as SIMT templates for the rows the tensor-core
// templates do not take: per-chunk maxima (kernels 3, 6, 7), then a rescan
// of each query's selected chunks (kernels 4, 5).  Bounds below are for an H100
// SXM (3.35 TB/s; 989 TFLOP/s bf16, 1,979 TOP/s int8 on the tensor cores).
//
// chunk_max_kernel<T> replaces three TPU kernels of the JAX package's
// ops/mips.py:
//   kernel 3  _chunk_max_fine_kernel  bf16 q_proj . P[row], cand_rows chunks
//             (phase 1 of mips_topk_pca; B=192, R=128, N=1M: 0.27 GB of
//             projection, bytes-bound, 0.08 ms);
//   kernel 6  _chunk_max_kernel       q . x[row] over fp32 rows, and bf16
//             rows whose width is not a multiple of 64 (phase 1 of
//             mips_topk_two_phase; the other bf16 rows, the FEVER CLI's
//             among them, run on the tensor-core template of
//             chunk_max_mma.cu);
//   kernel 7  _chunk_max_kernel_int8  float(raw) * d_scale[row] (the query
//             scale is left out: it does not change a query's ranking), in
//             the JAX order with one rounding, so the maxima are bit-equal
//             (B=384, D=768, N=1M int8: 0.62 T int8 ops, 0.31 ms, against
//             0.24 ms of bytes).
// For every query and every chunk it writes the max over the chunk's valid
// rows straight as (B, num_chunks); the TPU's transposed (num_chunks, B)
// blocks were a Mosaic layout.  A block scores a 64-query tile (tile_dot.cuh)
// against `chunks_per_block` consecutive chunks, 128 rows at a time; the 16
// threads of a query reduce their maxima with half-warp shuffles.  Rows >=
// n_valid never enter a max, and a chunk with no valid row gives NEG_INF, as
// the JAX kernels' masks do.  The grid is (query tiles) x (chunk ranges), so
// at B=200 and 128 chunks of 2048 rows it has 512 blocks for 132 SMs.  Like
// the scan it runs on CUDA-core FMAs / __dp4a in this first version.
//
// rescan_kernel<T> replaces ops/mips.py::_rescan_kernel_int8 (kernel 4) and
// ::_rescan_kernel (kernel 5), the two bodies of _sparse_rescan, for the
// rows the chunk-major tensor-core template of rescan_mma.cu does not take:
// fp32 rows, int8 rows off a multiple of 128 bytes and bf16 rows off a
// multiple of 64.  One block per (query, selected chunk).  The TPU prefetched the chunk ids as scalars
// to drive its DMA; here the block loads its own id.  Each warp walks rows of
// the chunk; lane l holds query words l, l+32, ... in registers (MAXM words:
// 8, 16 or 32, picked by the row width, so D <= 1024 fp32 / 2048 bf16 / 4096
// int8) and reads the same words of the row (128-byte coalesced loads); a
// shuffle tree sums the lanes.  int8: __dp4a in int32, exact, then
// float(raw) * d_scale[row] (mips.py:566; the caller multiplies by the query
// scale afterwards, mips.py:988, so the order (raw*dsc)*q_scale is kept).
// bf16/fp32: the query arrives in the index dtype (the caller casts, as
// mips.py:942 does) and products accumulate in fp32.  Rows >= n_valid give
// NEG_INF.  Bound: the distinct selected chunks read once.  Every block
// reads its own chunk, so queries that share a chunk read it again (from
// L2 when it is still there).
#include "tile_dot.cuh"

namespace mdrt {

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
chunk_max_kernel(const int4* __restrict__ q, const int4* __restrict__ rows,
                 const float* __restrict__ d_scale, int b, long long n,
                 long long n_valid, int w, int chunk_rows, int num_chunks,
                 int chunks_per_block, float* __restrict__ out) {
  using Acc = typename Elem<T>::Acc;
  extern __shared__ int4 smem4[];
  int* qs = reinterpret_cast<int*>(smem4);
  int* rs = qs + QB * (w + 4);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * QB;
  load_query_tile(qs, q, b, q0, w);

  const int c_begin = blockIdx.y * chunks_per_block;
  int c_end = c_begin + chunks_per_block;
  if (c_end > num_chunks) c_end = num_chunks;
  for (int c = c_begin; c < c_end; ++c) {
    float m[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) m[i] = NEG_INF;
    const long long c0 = (long long)c * chunk_rows;
    for (long long r0 = c0; r0 < c0 + chunk_rows; r0 += RB) {
      Acc acc[TQ][TR];
      score_row_tile<T>(acc, qs, rs, rows, r0, n, w);
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        long long r = r0 + tx + 16 * j;
        if (r >= n_valid) continue;
#pragma unroll
        for (int i = 0; i < TQ; ++i)
          m[i] = fmaxf(m[i], Elem<T>::score(acc[i][j], d_scale, r));
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
      int qi = q0 + ty + 16 * i;
      if (tx == 0 && qi < b) out[size_t(qi) * num_chunks + c] = m[i];
    }
  }
}

template <typename T, int MAXM>
__global__ void __launch_bounds__(256)
rescan_kernel(const int* __restrict__ chunk_ids, const int* __restrict__ q,
              const int* __restrict__ index, const float* __restrict__ d_scale,
              int kc, int w, int cand_rows, long long n_valid,
              float* __restrict__ out) {
  using Acc = typename Elem<T>::Acc;
  const int kk = blockIdx.x, bq = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const long long row0 = (long long)chunk_ids[bq * kc + kk] * cand_rows;
  int qw[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    int c = lane + 32 * m;
    qw[m] = c < w ? __ldg(q + size_t(bq) * w + c) : 0;
  }
  float* dst = out + (size_t(bq) * kc + kk) * cand_rows;
  for (int j = warp; j < cand_rows; j += n_warps) {
    const long long row = row0 + j;
    const int* src = index + row * w;
    Acc acc = Acc(0);
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      int c = lane + 32 * m;
      if (c < w) Elem<T>::word(acc, __ldg(src + c), qw[m]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      dst[j] = row < n_valid ? Elem<T>::score(acc, d_scale, row) : NEG_INF;
  }
}

template <typename T>
int launch_chunk_max(const void* q, const void* rows, const void* d_scale,
                     int b, long long n, long long n_valid, int w,
                     int chunk_rows, int chunks_per_block, void* out,
                     cudaStream_t stream) {
  const int num_chunks = int(n / chunk_rows);
  size_t smem = tile_smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((b + QB - 1) / QB,
            (num_chunks + chunks_per_block - 1) / chunks_per_block);
  chunk_max_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const int4*>(q), static_cast<const int4*>(rows),
      static_cast<const float*>(d_scale), b, n, n_valid, w, chunk_rows,
      num_chunks, chunks_per_block, static_cast<float*>(out));
  return int(cudaGetLastError());
}

template <typename T, int MAXM>
int launch_rescan_m(const void* chunk_ids, const void* q, const void* index,
                    const void* d_scale, int b, int kc, int w, int cand_rows,
                    long long n_valid, void* out, cudaStream_t stream) {
  rescan_kernel<T, MAXM><<<dim3(kc, b), 256, 0, stream>>>(
      static_cast<const int*>(chunk_ids), static_cast<const int*>(q),
      static_cast<const int*>(index), static_cast<const float*>(d_scale), kc,
      w, cand_rows, n_valid, static_cast<float*>(out));
  return int(cudaGetLastError());
}

template <typename T>
int launch_rescan(const void* chunk_ids, const void* q, const void* index,
                  const void* d_scale, int b, int kc, int w, int cand_rows,
                  long long n_valid, void* out, cudaStream_t stream) {
  const int per_lane = (w + 31) / 32;
  if (per_lane <= 8)
    return launch_rescan_m<T, 8>(chunk_ids, q, index, d_scale, b, kc, w,
                                 cand_rows, n_valid, out, stream);
  if (per_lane <= 16)
    return launch_rescan_m<T, 16>(chunk_ids, q, index, d_scale, b, kc, w,
                                  cand_rows, n_valid, out, stream);
  return launch_rescan_m<T, 32>(chunk_ids, q, index, d_scale, b, kc, w,
                                cand_rows, n_valid, out, stream);
}

}  // namespace mdrt

// dtype: 0 int8 (d_scale (n,) fp32 required), 1 bf16, 2 fp32.  q (b, D) and
// rows (n, D) of that dtype with w = D * itemsize / 4 words, a multiple of
// 16; n a multiple of chunk_rows, itself a multiple of 128; out (b, n /
// chunk_rows) fp32.
extern "C" int chunk_max(int dtype, const void* q, const void* rows,
                         const void* d_scale, int b, long long n,
                         long long n_valid, int w, int chunk_rows,
                         int chunks_per_block, void* out, void* stream) {
  using namespace mdrt;
  if (w % KW != 0 || chunk_rows % RB != 0 || n % chunk_rows != 0 ||
      chunks_per_block < 1 || (dtype == 0 && d_scale == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_chunk_max<int8_t>(q, rows, d_scale, b, n, n_valid, w,
                                      chunk_rows, chunks_per_block, out, s);
    case 1:
      return launch_chunk_max<__nv_bfloat16>(q, rows, d_scale, b, n, n_valid,
                                             w, chunk_rows, chunks_per_block,
                                             out, s);
    case 2:
      return launch_chunk_max<float>(q, rows, d_scale, b, n, n_valid, w,
                                     chunk_rows, chunks_per_block, out, s);
  }
  return int(cudaErrorInvalidValue);
}

// dtype as above; chunk_ids (b, kc) int32; q (b, D) and index (n, D) of that
// dtype, w = D * itemsize / 4 words (<= 1024); d_scale (n,) fp32 for int8;
// out (b, kc * cand_rows) fp32.
extern "C" int rescan(int dtype, const void* chunk_ids, const void* q,
                      const void* index, const void* d_scale, int b, int kc,
                      int w, int cand_rows, long long n_valid, void* out,
                      void* stream) {
  using namespace mdrt;
  if (w < 1 || w > 32 * 32 || (dtype == 0 && d_scale == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_rescan<int8_t>(chunk_ids, q, index, d_scale, b, kc, w,
                                   cand_rows, n_valid, out, s);
    case 1:
      return launch_rescan<__nv_bfloat16>(chunk_ids, q, index, d_scale, b, kc,
                                          w, cand_rows, n_valid, out, s);
    case 2:
      return launch_rescan<float>(chunk_ids, q, index, d_scale, b, kc, w,
                                  cand_rows, n_valid, out, s);
  }
  return int(cudaErrorInvalidValue);
}
