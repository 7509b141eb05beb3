// Kernel 2 on the tensor cores: exact MIPS scan with a fused top-k over a
// bf16 index.
//
// Replaces the JAX package's ops/mips.py::_mips_kernel (:220) with its merge
// _merge_chunk_topk (:165), reached through mips_topk_pallas (:243), for
// bf16 rows whose width is a multiple of 64.  For every query b it returns
// the top k <= 8 rows r by fp32(q_b . x_r) as (B, k) scores and int32 row
// ids: rows at or past n_valid never enter, ties go to the lower row (the
// order of topk.cuh), and a query with fewer than k valid rows keeps
// (NEG_INF, 0) fillers, as the JAX merge gives.  fp32 rows (a tensor-core
// product of fp32 would be TF32) and narrower bf16 rows stay on the SIMT
// template of mips_scan.cu, as does the int8 scan (kernel 1).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): at B=192, N=1,048,576,
// D=768 the index is 1.61 GB, 0.48 ms, against 0.30 TFLOP, 0.31 ms at the
// bf16 peak: bound by bytes.  The SIMT template read the index once per
// 64-query tile (three times at B=192) and multiplied on the CUDA cores.
//
// Pass 1 (mips_scan_mma_kernel): chunk_max_mma.cu's layout.  Index rows are
// the M side of mma.sync.m16n8k16, every query of a query tile (QN = 32 * NW,
// zero rows past B, never stored) its N side, so the index streams from
// device memory once for B up to the tile width.  The grid is (row splits)
// x (query tiles), with about as many blocks as the card has SMs.  A block
// of 8 warps walks its split in tiles of MT=128 rows; D streams in k-slices
// of KS=64 bf16 through a ring of STAGES=4 shared-memory stages filled by
// cp.async (index rows and the query slice, rows padded to 72 bf16 so that
// ldmatrix is free of bank conflicts).  Warps split a tile 2 (64 rows) x 4
// (QN / 4 queries).  After a tile's last k-slice each thread folds its
// accumulators into a register top-KMAX list for each of the 2 * NW query
// columns it holds (rows g and g+8 of each m16 tile), a value entering only
// when it beats the list's last (a compare per value: prefiltering each
// column by its max, or starting a tile's sums with a zero-C mma instead
// of clearing them here, measured slower).  The lists cost 4 * NW * KMAX
// registers beside the 16 * NW accumulators, so the query tile narrows as
// KMAX grows (QN_K2, QN_K4, QN_K8 below).  At the block's end the lists
// merge across the 8 row lanes (shuffles) and the 2 row warps (shared
// memory) and are written as (B, splits, KMAX) partials (topk.cuh's
// store_partials, which kernel 1 shares).
//
// Pass 2 (scan_merge_kernel): a warp per query merges its partials
// (topk.cuh's warp_merge, which kernel 1's merge shares), then
// rescores each kept row in fp32 on the CUDA cores (each lane a sequential
// FMA sum of 8-element pieces, then a shuffle tree) and restores the order.
// The tensor cores add a k16 step's products in their own order and
// truncate, so their sums drift from an IEEE fp32 sum by up to ~10 ulps of
// sum |q_i x_i| at D=768; the returned scores are fp32 sums of the exact
// bf16 products, as the SIMT template's are.  Rows are still chosen by the
// tensor-core sums: two rows that tie within that drift may come out in
// either order.
#include "mma.cuh"
#include "topk.cuh"

namespace mdrt_scan {

using namespace mdrt_mma;
using bf16 = __nv_bfloat16;
using mdrt_topk::better;
using mdrt_topk::push;
using mdrt_topk::store_partials;
using mdrt_topk::store_list;
using mdrt_topk::warp_merge;

constexpr float NEG_INF = -3.0e38f;  // the JAX package's mask value
constexpr int MT = 128;              // index rows a tile
constexpr int KS = 64;               // bf16 columns a stage
constexpr int LDS = KS + 8;          // padded shared-memory row
constexpr int PK = KS / 8;           // 16-byte pieces of a row's k-slice
constexpr int STAGES = 4;
constexpr int NT = 256;              // threads: 2 x 4 warps
// the widest query tile for each list length KMAX (<= 2, 4, 8)
constexpr int QN_K2 = 192;
constexpr int QN_K4 = 128;
constexpr int QN_K8 = 64;
constexpr bool RESCORE = true;       // pass 2 rescores the kept rows in fp32

constexpr int max_nw(int kmax) {
  return (kmax <= 2 ? QN_K2 : kmax == 4 ? QN_K4 : QN_K8) / 32;
}

inline size_t smem_bytes(int qn, int kmax) {
  return size_t(STAGES) * (MT + qn) * LDS * sizeof(bf16) +
         size_t(2) * qn * kmax * (sizeof(float) + sizeof(int));
}

template <int NW, int KMAX>
__global__ void __launch_bounds__(NT, 1)
mips_scan_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ index,
                     int b, long long n, long long limit, int d,
                     long long rows_per_split, float* __restrict__ part_v,
                     int* __restrict__ part_i) {
  constexpr int QN = 32 * NW;          // queries a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);      // [STAGES][MT][LDS]
  bf16* sb = sa + STAGES * MT * LDS;                 // [STAGES][QN][LDS]
  float* red_v = reinterpret_cast<float*>(sb + STAGES * QN * LDS);
  int* red_i = reinterpret_cast<int*>(red_v + 2 * QN * KMAX);  // [2][QN][KMAX]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int q0 = blockIdx.y * QN;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end =
      r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int ksteps = d / KS;
  const int total = int((r_end - r_begin + MT - 1) / MT) * ksteps;

  // stage s: k-slice s % ksteps of row tile s / ksteps (rows past n and
  // queries past b zero-filled)
  auto load = [&](int s) {
    const int slot = s % STAGES;
    const int k0 = (s % ksteps) * KS;
    const long long tile0 = r_begin + (long long)(s / ksteps) * MT;
    bf16* da = sa + slot * MT * LDS;
    for (int i = tid; i < MT * PK; i += NT) {
      const int r = i / PK, p = i % PK;
      const bool ok = tile0 + r < n;
      cp_async16(da + r * LDS + p * 8,
                 ok ? index + (tile0 + r) * d + k0 + p * 8 : index, ok ? 16 : 0);
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
  float tv[NW][2][KMAX];
  int ti[NW][2][KMAX];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        tv[j][e][s] = NEG_INF;
        ti[j][e][s] = 0;
      }
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
      // the row tile is complete: fold its valid rows into the lists
      const long long tile0 = r_begin + (long long)(s / ksteps) * MT;
      const bool full = tile0 + MT <= limit;
      const long long r_base = tile0 + wm * 64 + g;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long r = r_base + mt * 16 + half * 8;
          const bool ok = full || r < limit;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ok) push<KMAX>(tv[j][e], ti[j][e], acc[mt][j][half * 2 + e],
                                 int(r));
              acc[mt][j][half * 2 + e] = 0.f;
            }
        }
    }
  }

  // the split's lists
  store_partials<NW, KMAX>(tv, ti, red_v, red_i, q0, b, split, n_splits,
                           part_v, part_i);
}

// fp32 dot of one bf16 query row and one bf16 index row (d a multiple of 8)
// by a warp: lane l sums elements 8l .. 8l+7, 8l+256 .. in order, then a
// butterfly, which leaves the same bits in every lane
__device__ __forceinline__ float warp_dot(const bf16* __restrict__ a,
                                          const bf16* __restrict__ x, int d,
                                          int lane) {
  float acc = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 av = *reinterpret_cast<const uint4*>(a + c);
    uint4 xv = *reinterpret_cast<const uint4*>(x + c);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&av);
    const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 af = __bfloat1622float2(ah[h]);
      const float2 xf = __bfloat1622float2(xh[h]);
      acc = fmaf(af.x, xf.x, acc);
      acc = fmaf(af.y, xf.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <int KMAX>
__global__ void __launch_bounds__(128)
scan_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, const bf16* __restrict__ q,
                  const bf16* __restrict__ index, int b, int d, int n_splits,
                  int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int qi = blockIdx.x * 4 + threadIdx.x / 32;
  if (qi >= b) return;  // the whole warp
  float tv[KMAX];
  int ti[KMAX];
  warp_merge<KMAX>(part_v, part_i, qi, n_splits, lane, tv, ti);
  if (RESCORE) {
    // every lane holds the same list; lane 0's entries are taken all the
    // same, so that the branch is warp-uniform whatever the data
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      tv[s] = __shfl_sync(0xffffffffu, tv[s], 0);
      ti[s] = __shfl_sync(0xffffffffu, ti[s], 0);
      if (tv[s] > NEG_INF)
        tv[s] = warp_dot(q + size_t(qi) * d, index + size_t(ti[s]) * d, d,
                         lane);
    }
#pragma unroll
    for (int s = 1; s < KMAX; ++s)
#pragma unroll
      for (int u = s; u > 0; --u)
        if (better(tv[u], ti[u], tv[u - 1], ti[u - 1])) {
          float fv = tv[u]; tv[u] = tv[u - 1]; tv[u - 1] = fv;
          int fi = ti[u]; ti[u] = ti[u - 1]; ti[u - 1] = fi;
        }
  }
  if (lane == 0) store_list<KMAX>(tv, ti, qi, k, out_v, out_i);
}

struct Args {
  const void* q;
  const void* index;
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
  const size_t smem = smem_bytes(32 * NW, KMAX);
  cudaError_t err = cudaFuncSetAttribute(
      mips_scan_mma_kernel<NW, KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(unsigned(a.n_splits), unsigned((a.b + 32 * NW - 1) / (32 * NW)));
  mips_scan_mma_kernel<NW, KMAX><<<grid, NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.index), a.b,
      a.n, a.limit, a.d, a.rows_per_split, static_cast<float*>(a.part_v),
      static_cast<int*>(a.part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  scan_merge_kernel<KMAX><<<(a.b + 3) / 4, 128, 0, a.stream>>>(
      static_cast<const float*>(a.part_v), static_cast<const int*>(a.part_i),
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.index), a.b,
      a.d, a.n_splits, a.k, static_cast<float*>(a.out_v),
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

}  // namespace mdrt_scan

// q (b, d) and index (n, d) bf16, contiguous, 16-byte aligned; d a multiple
// of 64; k <= kmax in {1, 2, 4, 8}; q_tile (a multiple of 32, at most the
// widest tile of kmax), rows_per_split (a multiple of 128), n_splits (the
// splits that cover n) and smem from the wrapper's plan (checked here);
// partials (b, n_splits, kmax); out (b, k) fp32 scores and int32 row ids.
extern "C" int mips_scan_mma(const void* q, const void* index, int b,
                             long long n, long long n_valid, int d, int k,
                             int kmax, int q_tile, long long rows_per_split,
                             int n_splits, long long smem, void* part_vals,
                             void* part_ids, void* out_vals, void* out_ids,
                             void* stream) {
  using namespace mdrt_scan;
  const bool kmax_ok = kmax == 1 || kmax == 2 || kmax == 4 || kmax == 8;
  if (b < 1 || n < 1 || n > 0x7fffffffLL || d < KS || d % KS != 0 ||
      !kmax_ok || k < 1 || k > kmax || q_tile < 32 || q_tile % 32 != 0 ||
      q_tile > 32 * max_nw(kmax) || rows_per_split < MT ||
      rows_per_split % MT != 0 || n_splits < 1 ||
      (long long)(n_splits - 1) * rows_per_split >= n ||
      (long long)n_splits * rows_per_split < n ||
      smem != (long long)smem_bytes(q_tile, kmax))
    return int(cudaErrorInvalidValue);
  const Args a{q, index, b, n, n_valid < n ? n_valid : n, d, k,
               rows_per_split, n_splits, part_vals, part_ids, out_vals,
               out_ids, static_cast<cudaStream_t>(stream)};
  switch (kmax) {
    case 1: return launch_nw<1>(q_tile / 32, a);
    case 2: return launch_nw<2>(q_tile / 32, a);
    case 4: return launch_nw<4>(q_tile / 32, a);
    default: return launch_nw<8>(q_tile / 32, a);
  }
}
