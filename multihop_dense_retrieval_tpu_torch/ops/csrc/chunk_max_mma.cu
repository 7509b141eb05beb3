// Kernels 6 and 3 on the tensor cores: chunk maxima over bf16 rows.
//
// Replaces the JAX package's ops/mips.py::_chunk_max_kernel (:489), phase 1
// of mips_topk_two_phase (:646), for bf16 rows (kernel 6), and
// ::_chunk_max_fine_kernel (:868), phase 1 of mips_topk_pca (:891), over
// the bf16 (N, R) PCA projections (kernel 3).  For every query b and
// every chunk c it writes max over the chunk's valid rows r of
// fp32(q_b . x_r) as out[b, c] (B, N / chunk_rows); rows at or past n_valid
// never enter a max, and a chunk with no valid row gives NEG_INF (-3e38),
// as the JAX kernels' masks do.  fp32 rows (a tensor-core product of fp32
// would be TF32) and bf16 rows whose width is not a multiple of 64 stay on
// the SIMT template of two_phase.cu, as does kernel 7.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): at the FEVER CLI's
// shape (B=200, N=262,144, D=768, 2048-row chunks) the index is 0.40 GB,
// 0.120 ms, against 80.5 GFLOP, 0.081 ms at the bf16 peak: bound by bytes,
// with the products close behind.  Kernel 3 at B=192, N=1,048,576, R=128,
// 512-row chunks: 0.27 GB of projections, 0.081 ms, against 51.5 GFLOP,
// 0.052 ms.  The SIMT template read the rows once per 64-query tile (four
// times at B=200) and multiplied on the CUDA cores.
//
// Design: the mma's M side is the index rows, so the index streams from
// device memory once.  A block of 8 warps walks its rows in tiles of MT=128
// rows; all queries of its query tile (QN = 32 * NW <= 256, zero rows past
// B, never stored; a grid dimension over query tiles for B > 256) are the
// N side.  Warps split the tile 2 (64 rows each) x 4 (QN / 4 queries
// each), so each thread keeps 16 * NW fp32 accumulators (208 registers at
// NW = 7: one block an SM).  D streams in k-slices of KS=64 bf16 (a row's
// 128 bytes, whole L2 lines) through a ring of STAGES=4 shared-memory
// stages filled by cp.async.  Rows are padded to 72 bf16 (144 bytes), so
// the eight rows of an ldmatrix fall in eight distinct 16-byte bank groups.
// After a tile's last k-slice each thread folds its accumulators into a
// running max per query column in registers; at a chunk's end the maxima
// are reduced across the 8 lanes and the 2 row warps that share a column
// and written once.  The B x N score matrix never exists.  Two templates:
//   * chunk_max_mma_kernel (kernel 6 at D=768): one block a chunk; each
//     stage carries index rows and the same k-slice of the query tile, so
//     the queries are reread from L2 once per row tile, 1.75x the index
//     bytes at B=200.
//   * chunk_max_resident_kernel (kernel 3; any width whose query tile fits
//     beside the ring, 192 x 136 bf16 at R=128): the query tile is loaded
//     once and stays in shared memory ([QN][d + 8]), the ring carries index
//     rows alone (at R=128 a stage's query slice was larger than its 128
//     index rows), and a block walks `chunks_per_block` consecutive chunks
//     (about one block an SM), the ring flowing on across their boundaries
//     (a 512-row chunk at R=128 is only 8 stages).  Folding the chunk walk
//     into the first template measured 8% slower at kernel 6's shape.
// Traps: rows at or past n_valid never enter a max (a chunk with none
// gives NEG_INF); the tensor cores sum a k16 step's products in their own
// order, so the values match an fp32 loop to the 1e-3 tolerance, not bit
// for bit.
#include "mma.cuh"

namespace mdrt_cmax {

using namespace mdrt_mma;
using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -3.0e38f;  // the JAX package's mask value
constexpr int MT = 128;              // index rows a tile
constexpr int KS = 64;               // bf16 columns a stage
constexpr int LDS = KS + 8;          // padded shared-memory row
constexpr int PK = KS / 8;           // 16-byte pieces of a row's k-slice
constexpr int STAGES = 4;
constexpr int NT = 256;              // threads: 2 x 4 warps

// resident: the query tile stays in shared memory ([qn][d + 8]) and the
// ring holds index rows only
inline size_t smem_bytes(int qn, int d, bool resident) {
  const size_t ring = size_t(STAGES) * (MT + (resident ? 0 : qn)) * LDS;
  const size_t tile = resident ? size_t(qn) * (d + 8) : 0;
  return (ring + tile) * sizeof(bf16) + size_t(2) * qn * sizeof(float);
}

template <int NW>
__global__ void __launch_bounds__(NT, 1)
chunk_max_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ rows,
                     int b, long long n_valid, int d, int chunk_rows,
                     float* __restrict__ out) {
  constexpr int QN = 32 * NW;          // queries a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);      // [STAGES][MT][LDS]
  bf16* sb = sa + STAGES * MT * LDS;                 // [STAGES][QN][LDS]
  float* red = reinterpret_cast<float*>(sb + STAGES * QN * LDS);  // [2][QN]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.x, num_chunks = gridDim.x;
  const int q0 = blockIdx.y * QN;
  const long long row0 = (long long)c * chunk_rows;
  const int ksteps = d / KS;
  const int total = chunk_rows / MT * ksteps;

  // stage s: k-slice s % ksteps of row tile s / ksteps, and the same
  // k-slice of the query tile (rows past b zero-filled, never stored)
  auto load = [&](int s) {
    const int slot = s % STAGES;
    const int k0 = (s % ksteps) * KS;
    const bf16* src = rows + (row0 + (long long)(s / ksteps) * MT) * d + k0;
    bf16* da = sa + slot * MT * LDS;
    for (int i = tid; i < MT * PK; i += NT) {
      const int r = i / PK, p = i % PK;
      cp_async16(da + r * LDS + p * 8, src + size_t(r) * d + p * 8, 16);
    }
    bf16* db = sb + slot * QN * LDS;
    for (int i = tid; i < QN * PK; i += NT) {
      const int r = i / PK, p = i % PK;
      const bool ok = q0 + r < b;
      cp_async16(db + r * LDS + p * 8,
                 ok ? q + size_t(q0 + r) * d + k0 + p * 8 : q, ok ? 16 : 0);
    }
  };

  float acc[4][NW][4];
  float best[NW][2];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    best[j][0] = best[j][1] = NEG_INF;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
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
    const bf16* ta = sa + (slot * MT + wm * 64) * LDS;
    const bf16* tb = sb + (slot * QN + wn * 8 * NW) * LDS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t bq[NW][2];
#pragma unroll
      for (int j = 0; j + 1 < NW; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, tb + (j * 8 + (lane / 16) * 8 + lane % 8) * LDS + kk +
                           ((lane / 8) % 2) * 8);
        bq[j][0] = r[0];
        bq[j][1] = r[1];
        bq[j + 1][0] = r[2];
        bq[j + 1][1] = r[3];
      }
      if constexpr (NW % 2 == 1) {
        uint32_t r[2];
        ldmatrix_x2(r, tb + ((NW - 1) * 8 + lane % 8) * LDS + kk +
                           ((lane / 8) % 2) * 8);
        bq[NW - 1][0] = r[0];
        bq[NW - 1][1] = r[1];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, ta + (mt * 16 + lane % 16) * LDS + kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NW; ++j) mma_bf16(acc[mt][j], a, bq[j][0], bq[j][1]);
      }
    }
    if ((s + 1) % ksteps == 0) {
      // the row tile is complete: fold its valid rows into the maxima
      const long long tile0 = row0 + (long long)(s / ksteps) * MT;
      const bool full = tile0 + MT <= n_valid;
      const long long r_base = tile0 + wm * 64 + g;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bool ok = full || r_base + mt * 16 + half * 8 < n_valid;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ok) best[j][e] = fmaxf(best[j][e], acc[mt][j][half * 2 + e]);
              acc[mt][j][half * 2 + e] = 0.f;
            }
        }
    }
  }

  // the chunk's maxima: over the 8 row groups of a warp, then its 2 row warps
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = best[j][e];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (g == 0) red[wm * QN + wn * 8 * NW + j * 8 + 2 * t + e] = m;
    }
  __syncthreads();
  for (int i = tid; i < QN; i += NT)
    if (q0 + i < b)
      out[size_t(q0 + i) * num_chunks + c] = fmaxf(red[i], red[QN + i]);
}

template <int NW>
__global__ void __launch_bounds__(NT, 1)
chunk_max_resident_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ rows, int b,
                          long long n_valid, int d, int chunk_rows,
                          int num_chunks, int chunks_per_block,
                          float* __restrict__ out) {
  constexpr int QN = 32 * NW;          // queries a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);      // [STAGES][MT][LDS]
  bf16* sq = sa + STAGES * MT * LDS;                 // [QN][d + 8]
  const int ldq = d + 8;
  float* red = reinterpret_cast<float*>(sq + QN * ldq);  // [2][QN]

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

  // the whole query tile, committed with stage 0 (rows past b zero-filled,
  // never stored)
  for (int i = tid; i < QN * (d / 8); i += NT) {
    const int r = i / (d / 8), p = i % (d / 8);
    const bool ok = q0 + r < b;
    cp_async16(sq + r * ldq + p * 8, ok ? q + size_t(q0 + r) * d + p * 8 : q,
               ok ? 16 : 0);
  }
  // stage s: k-slice s % ksteps of the block's row tile s / ksteps (its
  // chunks are consecutive)
  auto load = [&](int s) {
    const int slot = s % STAGES;
    const int k0 = (s % ksteps) * KS;
    const bf16* src = rows + (row0 + (long long)(s / ksteps) * MT) * d + k0;
    bf16* da = sa + slot * MT * LDS;
    for (int i = tid; i < MT * PK; i += NT) {
      const int r = i / PK, p = i % PK;
      cp_async16(da + r * LDS + p * 8, src + size_t(r) * d + p * 8, 16);
    }
  };

  float acc[4][NW][4];
  float best[NW][2];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    best[j][0] = best[j][1] = NEG_INF;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
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
    const bf16* ta = sa + (slot * MT + wm * 64) * LDS;
    const bf16* tb = sq + (wn * 8 * NW) * ldq + (s % ksteps) * KS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t bq[NW][2];
#pragma unroll
      for (int j = 0; j + 1 < NW; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, tb + (j * 8 + (lane / 16) * 8 + lane % 8) * ldq + kk +
                           ((lane / 8) % 2) * 8);
        bq[j][0] = r[0];
        bq[j][1] = r[1];
        bq[j + 1][0] = r[2];
        bq[j + 1][1] = r[3];
      }
      if constexpr (NW % 2 == 1) {
        uint32_t r[2];
        ldmatrix_x2(r, tb + ((NW - 1) * 8 + lane % 8) * ldq + kk +
                           ((lane / 8) % 2) * 8);
        bq[NW - 1][0] = r[0];
        bq[NW - 1][1] = r[1];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, ta + (mt * 16 + lane % 16) * LDS + kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NW; ++j) mma_bf16(acc[mt][j], a, bq[j][0], bq[j][1]);
      }
    }
    if ((s + 1) % ksteps == 0) {
      // the row tile is complete: fold its valid rows into the maxima
      const long long tile0 = row0 + (long long)(s / ksteps) * MT;
      const bool full = tile0 + MT <= n_valid;
      const long long r_base = tile0 + wm * 64 + g;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bool ok = full || r_base + mt * 16 + half * 8 < n_valid;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ok) best[j][e] = fmaxf(best[j][e], acc[mt][j][half * 2 + e]);
              acc[mt][j][half * 2 + e] = 0.f;
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
int launch(const void* q, const void* rows, int b, long long n,
           long long n_valid, int d, int chunk_rows, int chunks_per_block,
           void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(32 * NW, d, RESIDENT);
  cudaError_t err;
  if constexpr (RESIDENT)
    err = cudaFuncSetAttribute(chunk_max_resident_kernel<NW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  else
    err = cudaFuncSetAttribute(chunk_max_mma_kernel<NW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err != cudaSuccess) return int(err);
  const int num_chunks = int(n / chunk_rows);
  const unsigned q_tiles = unsigned((b + 32 * NW - 1) / (32 * NW));
  const auto* qb = static_cast<const bf16*>(q);
  const auto* rb = static_cast<const bf16*>(rows);
  float* o = static_cast<float*>(out);
  if constexpr (RESIDENT) {
    dim3 grid(unsigned((num_chunks + chunks_per_block - 1) / chunks_per_block),
              q_tiles);
    chunk_max_resident_kernel<NW><<<grid, NT, smem, stream>>>(
        qb, rb, b, n_valid, d, chunk_rows, num_chunks, chunks_per_block, o);
  } else {
    dim3 grid(unsigned(num_chunks), q_tiles);
    chunk_max_mma_kernel<NW><<<grid, NT, smem, stream>>>(qb, rb, b, n_valid, d,
                                                         chunk_rows, o);
  }
  return int(cudaGetLastError());
}

template <bool RESIDENT>
int launch_qn(int q_tile, const void* q, const void* rows, int b, long long n,
              long long n_valid, int d, int chunk_rows, int chunks_per_block,
              void* out, cudaStream_t s) {
  switch (q_tile / 32) {
#define MDRT_CMAX_CASE(NW)                                                 \
    case NW:                                                               \
      return launch<NW, RESIDENT>(q, rows, b, n, n_valid, d, chunk_rows,   \
                                  chunks_per_block, out, s);
    MDRT_CMAX_CASE(1) MDRT_CMAX_CASE(2) MDRT_CMAX_CASE(3) MDRT_CMAX_CASE(4)
    MDRT_CMAX_CASE(5) MDRT_CMAX_CASE(6) MDRT_CMAX_CASE(7) MDRT_CMAX_CASE(8)
#undef MDRT_CMAX_CASE
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace mdrt_cmax

// q (b, d) and rows (n, d) bf16, contiguous, 16-byte aligned; d a multiple
// of 64; n a multiple of chunk_rows, itself a multiple of 128; q_tile the
// queries a block (a multiple of 32, at most 256), smem its dynamic shared
// memory, resident (the query tile kept in shared memory: the resident
// template) and chunks_per_block (1 without it), all from the wrapper's
// plan (smem checked here against q_tile, d and resident); out (b, n /
// chunk_rows) fp32.
extern "C" int chunk_max_mma(const void* q, const void* rows, int b,
                             long long n, long long n_valid, int d,
                             int chunk_rows, int q_tile, long long smem,
                             int chunks_per_block, int resident, void* out,
                             void* stream) {
  using namespace mdrt_cmax;
  if (b < 1 || d < KS || d % KS != 0 || chunk_rows < MT ||
      chunk_rows % MT != 0 || n % chunk_rows != 0 ||
      n / chunk_rows > 0x7fffffffLL || q_tile % 32 != 0 || q_tile < 32 ||
      q_tile > 256 || chunks_per_block < 1 || (resident != 0 && resident != 1) ||
      (resident == 0 && chunks_per_block != 1) ||
      smem != (long long)smem_bytes(q_tile, d, resident == 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resident ? launch_qn<true>(q_tile, q, rows, b, n, n_valid, d,
                                    chunk_rows, chunks_per_block, out, s)
                  : launch_qn<false>(q_tile, q, rows, b, n, n_valid, d,
                                     chunk_rows, 1, out, s);
}
