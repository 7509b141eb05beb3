// Kernel 7 on the tensor cores: chunk maxima over int8 rows with per-row
// scales.
//
// Replaces the JAX package's ops/mips.py::_chunk_max_kernel_int8 (:506),
// phase 1 of mips_topk_two_phase (:646), for int8 rows whose width is a
// multiple of 128 bytes.  For every query b and every chunk c it writes
// max over the chunk's valid rows r of __fmul_rn(float(raw_br), d_scale[r])
// as out[b, c] (B, N / chunk_rows), raw_br the exact s32 dot of the int8
// rows; there is no query scale (mips.py:512-516: a positive per-query
// constant, folded in by phase 2).  Rows at or past n_valid never enter a
// max, and a chunk with no valid row gives NEG_INF (-3e38), as the JAX
// kernel's mask does.  The dot is an exact integer whatever the order of
// its sums, so the maxima are bit-equal to the JAX kernel's and the plain
// twin's.  Narrower int8 rows stay on the SIMT template of two_phase.cu.
//
// Bound on an H100 SXM (3.35 TB/s; 1,979 TOP/s int8): at leg d's shape
// (B=384, N=1,048,576, D=768, 2048-row chunks) 0.62 T int8 operations,
// 0.313 ms, against 0.81 GB of rows and scales, 0.242 ms: bound by
// operations.  The SIMT template read the index once per 64-query tile (six
// times at B=384) and multiplied with __dp4a on the CUDA cores.
//
// Design: chunk_max_mma.cu's resident template (kernels 3 and 6), with
// mma.sync.m16n8k32 s8 x s8 -> s32 in place of the bf16 m16n8k16 (the
// stage of i8_stage.cuh, which kernel 1 shares; the same fragments byte for
// byte, mma.cuh): index rows are the M side in tiles of MT=128, all
// queries of a query tile (QN = 32 * NW <= 256, zero rows past B, never
// stored) the N side, warps split a tile 2 (64 rows) x 4 (QN / 4 queries),
// and a row's k-slice of KS=128 bytes streams through a 4-stage cp.async
// ring of 144-byte rows.  Each tile's 128 row scales ride with its last
// k-slice into a per-stage slot of shared memory (4-byte cp.async).
// After a tile's last k-slice each thread folds float(acc) * d_scale into a
// running max per query column in registers; at a chunk's end the maxima
// are reduced across the 8 lanes and the 2 row warps that share a column
// and written once.  A block walks `chunks_per_block` consecutive chunks,
// the ring flowing on across their boundaries.  Two query layouts, chosen
// by the wrapper's plan:
//   * resident (where the tile fits beside the ring: 192 x (768 + 16) bytes
//     at leg d's shape, two query tiles of 192, about one block an SM): the
//     query tile is loaded once into [QN][d + 16] bytes;
//   * streamed (one block a chunk): each stage carries the same k-slice of
//     the query tile beside the index rows, reread from L2 once per tile
//     (1.31 ms at leg d's shape against the resident layout's 1.10, H100
//     SXM, scripts_dev/kernel_variants.py).
// Without its fold the loop runs in 0.39 ms there, 1.25x the bound: the
// fold (a conversion, a multiply and a max a value, while every warp's
// tensor work waits) is most of the time.
#include <stdint.h>

#include "i8_stage.cuh"

namespace mdrt_cmax_i8 {

using namespace mdrt_i8;

constexpr float NEG_INF = -3.0e38f;  // the JAX package's mask value

// the ring (index rows, and the query slices when streamed), the tiles'
// row scales, the resident query tile ([qn][d + 16]) and the row warps'
// maxima ([2][qn] fp32)
inline size_t smem_bytes(int qn, int d, bool resident) {
  return size_t(STAGES) * (MT + (resident ? 0 : qn)) * LDS +
         size_t(STAGES) * MT * sizeof(float) +
         (resident ? size_t(qn) * (d + 16) : 0) +
         size_t(2) * qn * sizeof(float);
}

template <int NW, bool RESIDENT>
__global__ void __launch_bounds__(NT, 1)
chunk_max_i8_kernel(const int8_t* __restrict__ q,
                    const int8_t* __restrict__ rows,
                    const float* __restrict__ d_scale, int b, long long n,
                    long long n_valid, int d, int chunk_rows, int num_chunks,
                    int chunks_per_block, float* __restrict__ out) {
  constexpr int QN = 32 * NW;          // queries a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem_raw);  // [STAGES][MT][LDS]
  int8_t* sb = sa + STAGES * MT * LDS;   // streamed: [STAGES][QN][LDS]
  float* ssc = reinterpret_cast<float*>(
      sb + (RESIDENT ? 0 : STAGES * QN * LDS));         // [STAGES][MT]
  int8_t* sq = reinterpret_cast<int8_t*>(ssc + STAGES * MT);
  const int ldq = d + 16;                // resident: [QN][ldq]
  float* red = reinterpret_cast<float*>(sq + (RESIDENT ? QN * ldq : 0));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int c_begin = blockIdx.x * chunks_per_block;
  const int q0 = blockIdx.y * QN;
  const long long row0 = (long long)c_begin * chunk_rows;
  const int ksteps = d / KS;
  const int per_chunk = chunk_rows / MT * ksteps;
  const int c_count = num_chunks - c_begin < chunks_per_block
                          ? num_chunks - c_begin : chunks_per_block;
  const int total = c_count * per_chunk;

  // resident: the whole query tile, committed with stage 0
  if constexpr (RESIDENT) load_queries<QN>(sq, q, q0, b, d, tid);
  // stage s: k-slice s % ksteps of the block's row tile s / ksteps (its
  // chunks are consecutive); with the tile's last k-slice its row scales,
  // and when streamed the same k-slice of the query tile
  auto load = [&](int s) {
    const int slot = s % STAGES;
    const int k0 = (s % ksteps) * KS;
    load_rows<false>(sa + slot * MT * LDS, ssc + slot * MT, rows, d_scale,
                     row0 + (long long)(s / ksteps) * MT, n, d, k0,
                     s % ksteps == ksteps - 1, tid);
    if constexpr (!RESIDENT) {
      int8_t* db = sb + slot * QN * LDS;
      for (int i = tid; i < QN * PK; i += NT) {
        const int r = i / PK, p = i % PK;
        const bool ok = q0 + r < b;
        cp_async16(db + r * LDS + p * 16,
                   ok ? q + size_t(q0 + r) * d + k0 + p * 16 : q,
                   ok ? 16 : 0);
      }
    }
  };

  int acc[4][NW][4];
  float best[NW][2];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    best[j][0] = best[j][1] = NEG_INF;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1's slot is free
    if (s + STAGES - 1 < total) load(s + STAGES - 1);
    cp_async_commit();
    const int slot = s % STAGES;
    mma_stage<NW>(acc, sa + (slot * MT + wm * 64) * LDS,
                  RESIDENT ? sq + (wn * 8 * NW) * ldq + (s % ksteps) * KS
                           : sb + (slot * QN + wn * 8 * NW) * LDS,
                  RESIDENT ? ldq : LDS, lane);
    if ((s + 1) % ksteps == 0) {
      // the row tile is complete: fold its valid rows into the maxima
      const long long tile0 = row0 + (long long)(s / ksteps) * MT;
      const bool full = tile0 + MT <= n_valid;
      const long long r_base = tile0 + wm * 64 + g;
      const float* sc = ssc + slot * MT + wm * 64 + g;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bool ok = full || r_base + mt * 16 + half * 8 < n_valid;
          const float dsc = sc[mt * 16 + half * 8];
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ok)
                best[j][e] = fmaxf(
                    best[j][e],
                    __fmul_rn(__int2float_rn(acc[mt][j][half * 2 + e]), dsc));
              acc[mt][j][half * 2 + e] = 0;
            }
        }
    }
    if ((s + 1) % per_chunk == 0) {
      // the chunk is complete: its maxima over the 8 row groups of a warp,
      // then its 2 row warps, written once (the next chunk's writes to red
      // come after the next stage's barrier)
      const int c = c_begin + s / per_chunk;
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = best[j][e];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (g == 0) red[wm * QN + wn * 8 * NW + j * 8 + 2 * t + e] = m;
          best[j][e] = NEG_INF;
        }
      __syncthreads();
      for (int i = tid; i < QN; i += NT)
        if (q0 + i < b)
          out[size_t(q0 + i) * num_chunks + c] = fmaxf(red[i], red[QN + i]);
    }
  }
}

template <int NW, bool RESIDENT>
int launch(const void* q, const void* rows, const void* d_scale, int b,
           long long n, long long n_valid, int d, int chunk_rows,
           int chunks_per_block, void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(32 * NW, d, RESIDENT);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_max_i8_kernel<NW, RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int num_chunks = int(n / chunk_rows);
  dim3 grid(unsigned((num_chunks + chunks_per_block - 1) / chunks_per_block),
            unsigned((b + 32 * NW - 1) / (32 * NW)));
  chunk_max_i8_kernel<NW, RESIDENT><<<grid, NT, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(rows),
      static_cast<const float*>(d_scale), b, n, n_valid, d, chunk_rows,
      num_chunks, chunks_per_block, static_cast<float*>(out));
  return int(cudaGetLastError());
}

template <bool RESIDENT>
int launch_qn(int q_tile, const void* q, const void* rows, const void* d_scale,
              int b, long long n, long long n_valid, int d, int chunk_rows,
              int chunks_per_block, void* out, cudaStream_t s) {
  switch (q_tile / 32) {
#define MDRT_CMAX_I8_CASE(NW)                                              \
    case NW:                                                               \
      return launch<NW, RESIDENT>(q, rows, d_scale, b, n, n_valid, d,      \
                                  chunk_rows, chunks_per_block, out, s);
    MDRT_CMAX_I8_CASE(1) MDRT_CMAX_I8_CASE(2) MDRT_CMAX_I8_CASE(3)
    MDRT_CMAX_I8_CASE(4) MDRT_CMAX_I8_CASE(5) MDRT_CMAX_I8_CASE(6)
    MDRT_CMAX_I8_CASE(7) MDRT_CMAX_I8_CASE(8)
#undef MDRT_CMAX_I8_CASE
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace mdrt_cmax_i8

// q (b, d) and rows (n, d) int8, contiguous, 16-byte aligned; d a multiple
// of 128; d_scale (n,) fp32; n a multiple of chunk_rows, itself a multiple
// of 128; q_tile the queries a block (a multiple of 32, at most 256), smem
// its dynamic shared memory, resident (the query tile kept in shared
// memory) and chunks_per_block (1 when streamed), all from the wrapper's
// plan (smem checked here against q_tile, d and resident); out (b, n /
// chunk_rows) fp32.
extern "C" int chunk_max_i8(const void* q, const void* rows,
                            const void* d_scale, int b, long long n,
                            long long n_valid, int d, int chunk_rows,
                            int q_tile, long long smem, int chunks_per_block,
                            int resident, void* out, void* stream) {
  using namespace mdrt_cmax_i8;
  if (b < 1 || d < KS || d % KS != 0 || chunk_rows < MT ||
      chunk_rows % MT != 0 || n < chunk_rows || n % chunk_rows != 0 ||
      n / chunk_rows > 0x7fffffffLL || q_tile % 32 != 0 || q_tile < 32 ||
      q_tile > 256 || chunks_per_block < 1 ||
      (resident != 0 && resident != 1) ||
      (resident == 0 && chunks_per_block != 1) ||
      smem != (long long)smem_bytes(q_tile, d, resident == 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resident ? launch_qn<true>(q_tile, q, rows, d_scale, b, n, n_valid,
                                    d, chunk_rows, chunks_per_block, out, s)
                  : launch_qn<false>(q_tile, q, rows, d_scale, b, n, n_valid,
                                     d, chunk_rows, 1, out, s);
}
