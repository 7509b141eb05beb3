// Kernel 1 on the tensor cores: exact MIPS scan with a fused top-k over an
// int8 index with per-row scales.
//
// Replaces the JAX package's ops/mips.py::_mips_kernel_int8 (:316) with its
// merge _merge_chunk_topk (:165), reached through mips_topk_pallas_int8
// (:342), for int8 rows whose width is a multiple of 128 bytes.  For every
// query b it returns the top k <= 8 rows r by
// __fmul_rn(__fmul_rn(float(raw_br), q_scale[b]), d_scale[r]), raw_br the
// exact s32 dot of the int8 rows (the JAX order, mips.py:333-335), as (B, k)
// scores and int32 row ids: rows at or past n_valid never enter, ties go to
// the lower row (the order of topk.cuh), and a query with fewer than k
// valid rows keeps (NEG_INF, 0) fillers.  An int8 dot over D <= 1040 is an
// exact integer whatever the order of its sums, so scores and ids are
// bit-equal to the JAX kernel and to the plain twin, tie order included:
// unlike kernel 2 (mips_scan_mma.cu) there is no rescoring pass.  Narrower
// int8 rows stay on the SIMT template of mips_scan.cu.
//
// Bound on an H100 SXM (3.35 TB/s; 1,979 TOP/s int8): at B=192,
// N=1,048,576, D=768 the rows and their scales are 0.81 GB, 0.242 ms,
// against 0.31 T int8 operations, 0.156 ms: bound by bytes.  The SIMT
// template read the index once per 64-query tile (three times at B=192)
// and multiplied with __dp4a on the CUDA cores.
//
// Design: mips_scan_mma.cu's, with mma.sync.m16n8k32 s8 x s8 -> s32 in
// place of the bf16 m16n8k16 (the stage of i8_stage.cuh, which kernel 7
// shares).  Its fragments are the bf16 ones byte for byte (mma.cuh), so the
// 144-byte shared-memory rows, the cp.async ring and the ldmatrix addressing
// carry over; a stage is a row's KS=128 bytes (128 int8 columns, half the
// instructions of kernel 2 a row at D=768).  Index rows are the M side,
// every query of a query tile (QN = 32 * NW, zero rows past B, never
// stored) the N side, so the index streams from device memory once for B
// up to the tile width; the grid is (row splits) x (query tiles), about one
// block an SM.  The query tile is loaded once into shared memory ([QN][d +
// 16] bytes, 192 x 784 at the record shape) and the ring carries index rows
// alone: the wrapper's plan narrows the tile until it fits beside the ring
// (128 queries at D = 1024).  Streaming the query slices with the rows, as
// kernel 2 does, measured 0.73 ms at the record shape against 0.58
// resident (H100 SXM, scripts_dev/kernel_variants.py).  Each tile's 128 row
// scales ride with its last k-slice, so the fold reads them from shared
// memory; the query scales of a thread's 2 * NW columns sit in registers.
// After a tile's last k-slice each thread folds its s32 accumulators,
// scaled in the JAX order, into a register top-KMAX list per column (rows
// arrive in ascending order, so a strict compare keeps the lower of equal
// rows); at the block's end the lists merge across the 8 row lanes
// (shuffles) and the 2 row warps (shared memory, over the idle ring) into
// (B, splits, KMAX) partials, which a warp per query merges (topk.cuh's
// merge_kernel).  The lists cost 4 * NW * KMAX registers beside the 16 * NW
// accumulators, so the query tile narrows as KMAX grows (QN_K2, QN_K4,
// QN_K8 below).
#include <stdint.h>

#include "i8_stage.cuh"
#include "topk.cuh"

namespace mdrt_scan_i8 {

using namespace mdrt_i8;
using mdrt_topk::merge_kernel;
using mdrt_topk::push;
using mdrt_topk::store_partials;

constexpr float NEG_INF = -3.0e38f;  // the JAX package's mask value
// the widest query tile for each list length KMAX (<= 2, 4, 8)
constexpr int QN_K2 = 192;
constexpr int QN_K4 = 128;
constexpr int QN_K8 = 64;

constexpr int max_nw(int kmax) {
  return (kmax <= 2 ? QN_K2 : kmax == 4 ? QN_K4 : QN_K8) / 32;
}

// the ring of index rows, the tiles' row scales and the query tile ([qn][d
// + 16]); the two row warps' lists reuse the ring once the scan is done
inline size_t smem_bytes(int qn, int d) {
  return size_t(STAGES) * MT * LDS + size_t(STAGES) * MT * sizeof(float) +
         size_t(qn) * (d + 16);
}

template <int NW, int KMAX>
__global__ void __launch_bounds__(NT, 1)
mips_scan_i8_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ q_scale,
                    const int8_t* __restrict__ index,
                    const float* __restrict__ d_scale, int b, long long n,
                    long long limit, int d, long long rows_per_split,
                    float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int QN = 32 * NW;          // queries a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem_raw);  // [STAGES][MT][LDS]
  float* ssc = reinterpret_cast<float*>(sa + STAGES * MT * LDS);  // [STAGES][MT]
  int8_t* sq = reinterpret_cast<int8_t*>(ssc + STAGES * MT);      // [QN][ldq]
  const int ldq = d + 16;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int q0 = blockIdx.y * QN;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end =
      r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int ksteps = d / KS;
  const int total = int((r_end - r_begin + MT - 1) / MT) * ksteps;

  // the whole query tile, committed with stage 0
  load_queries<QN>(sq, q, q0, b, d, tid);
  // stage s: k-slice s % ksteps of row tile s / ksteps, with the tile's
  // last k-slice its row scales
  auto load = [&](int s) {
    const int slot = s % STAGES;
    load_rows<true>(sa + slot * MT * LDS, ssc + slot * MT, index, d_scale,
                    r_begin + (long long)(s / ksteps) * MT, n, d,
                    (s % ksteps) * KS, s % ksteps == ksteps - 1, tid);
  };

  int acc[4][NW][4];
  float tv[NW][2][KMAX];
  int ti[NW][2][KMAX];
  float qsc[NW][2];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = q0 + wn * 8 * NW + j * 8 + 2 * t + e;
      qsc[j][e] = col < b ? __ldg(q_scale + col) : 0.f;
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        tv[j][e][s] = NEG_INF;
        ti[j][e][s] = 0;
      }
    }
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
                  sq + (wn * 8 * NW) * ldq + (s % ksteps) * KS, ldq, lane);
    if ((s + 1) % ksteps == 0) {
      // the row tile is complete: fold its valid rows into the lists, each
      // score float(raw) * q_scale * d_scale in that order
      const long long tile0 = r_begin + (long long)(s / ksteps) * MT;
      const bool full = tile0 + MT <= limit;
      const long long r_base = tile0 + wm * 64 + g;
      const float* sc = ssc + slot * MT + wm * 64 + g;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long r = r_base + mt * 16 + half * 8;
          const bool ok = full || r < limit;
          const float dsc = sc[mt * 16 + half * 8];
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ok) {
                const float v = __fmul_rn(
                    __fmul_rn(__int2float_rn(acc[mt][j][half * 2 + e]),
                              qsc[j][e]),
                    dsc);
                push<KMAX>(tv[j][e], ti[j][e], v, int(r));
              }
              acc[mt][j][half * 2 + e] = 0;
            }
        }
    }
  }

  // the split's lists, merged through the ring (idle once every copy has
  // landed)
  cp_async_wait<0>();
  __syncthreads();
  float* red_v = reinterpret_cast<float*>(smem_raw);        // [2][QN][KMAX]
  int* red_i = reinterpret_cast<int*>(red_v + 2 * QN * KMAX);
  store_partials<NW, KMAX>(tv, ti, red_v, red_i, q0, b, split, n_splits,
                           part_v, part_i);
}

struct Args {
  const void *q, *q_scale, *index, *d_scale;
  int b;
  long long n, limit;
  int d, k;
  long long rows_per_split;
  int n_splits;
  void *part_v, *part_i, *out_v, *out_i;
  cudaStream_t stream;
};

template <int NW, int KMAX>
int launch(const Args& a) {
  const size_t smem = smem_bytes(32 * NW, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      mips_scan_i8_kernel<NW, KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(unsigned(a.n_splits), unsigned((a.b + 32 * NW - 1) / (32 * NW)));
  mips_scan_i8_kernel<NW, KMAX><<<grid, NT, smem, a.stream>>>(
      static_cast<const int8_t*>(a.q), static_cast<const float*>(a.q_scale),
      static_cast<const int8_t*>(a.index),
      static_cast<const float*>(a.d_scale), a.b, a.n, a.limit, a.d,
      a.rows_per_split, static_cast<float*>(a.part_v),
      static_cast<int*>(a.part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  merge_kernel<KMAX><<<(a.b + 3) / 4, 128, 0, a.stream>>>(
      static_cast<const float*>(a.part_v), static_cast<const int*>(a.part_i),
      a.b, a.n_splits, a.k, static_cast<float*>(a.out_v),
      static_cast<int*>(a.out_i));
  return int(cudaGetLastError());
}

// the instance for nw n8 tiles a warp, up to the widest tile of KMAX
template <int KMAX, int NW = 1>
int launch_nw(int nw, const Args& a) {
  if constexpr (NW > max_nw(KMAX)) {
    return int(cudaErrorInvalidValue);
  } else {
    if (nw == NW) return launch<NW, KMAX>(a);
    return launch_nw<KMAX, NW + 1>(nw, a);
  }
}

}  // namespace mdrt_scan_i8

// q (b, d) and index (n, d) int8, contiguous, 16-byte aligned; d a multiple
// of 128; q_scale (b,) and d_scale (n,) fp32; k <= kmax in {1, 2, 4, 8};
// q_tile (a multiple of 32, at most the widest tile of kmax, narrow enough
// for the tile to fit in shared memory), rows_per_split (a multiple of
// 128), n_splits (the splits that cover n) and smem from the wrapper's plan
// (checked here); partials (b, n_splits, kmax); out (b, k) fp32 scores and
// int32 row ids.
extern "C" int mips_scan_i8(const void* q, const void* q_scale,
                            const void* index, const void* d_scale, int b,
                            long long n, long long n_valid, int d, int k,
                            int kmax, int q_tile, long long rows_per_split,
                            int n_splits, long long smem, void* part_vals,
                            void* part_ids, void* out_vals, void* out_ids,
                            void* stream) {
  using namespace mdrt_scan_i8;
  const bool kmax_ok = kmax == 1 || kmax == 2 || kmax == 4 || kmax == 8;
  if (b < 1 || n < 1 || n > 0x7fffffffLL || d < KS || d % KS != 0 ||
      !kmax_ok || k < 1 || k > kmax || q_tile < 32 || q_tile % 32 != 0 ||
      q_tile > 32 * max_nw(kmax) || rows_per_split < MT ||
      rows_per_split % MT != 0 || n_splits < 1 ||
      (long long)(n_splits - 1) * rows_per_split >= n ||
      (long long)n_splits * rows_per_split < n ||
      smem != (long long)smem_bytes(q_tile, d))
    return int(cudaErrorInvalidValue);
  const Args a{q, q_scale, index, d_scale, b, n, n_valid < n ? n_valid : n,
               d, k, rows_per_split, n_splits, part_vals, part_ids, out_vals,
               out_ids, static_cast<cudaStream_t>(stream)};
  switch (kmax) {
    case 1: return launch_nw<1>(q_tile / 32, a);
    case 2: return launch_nw<2>(q_tile / 32, a);
    case 4: return launch_nw<4>(q_tile / 32, a);
    default: return launch_nw<8>(q_tile / 32, a);
  }
}
