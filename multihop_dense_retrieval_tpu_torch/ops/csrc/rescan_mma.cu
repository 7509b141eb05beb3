// Kernels 4 and 5 on the tensor cores: the rescan of each query's selected
// chunks, chunk-major.
//
// Replaces the JAX package's ops/mips.py::_rescan_kernel_int8 (:554, kernel
// 4) and ::_rescan_kernel (:532, kernel 5), the two bodies of
// _sparse_rescan (:575): phase 2 of mips_topk_two_phase and of
// mips_topk_pca.  For query b and its kk-th selected chunk c =
// chunk_ids[b, kk] it writes out[b, kk * C + j] (B, kc * C fp32) as the
// score of row c * C + j:
//   * int8 (kernel 4): __fmul_rn(float(raw), d_scale[row]) with raw the
//     exact s32 dot; the caller multiplies by the query scale afterwards
//     (mips.py:988), so the JAX order (raw * d_scale) * q_scale holds and
//     the scores are bit-equal to the JAX kernel's and the plain twin's;
//   * bf16 (kernel 5): the dot of the query (cast to bf16 by the caller)
//     with the row, accumulated in fp32 by the tensor cores, which sum in
//     their own order: within 1e-3 of an IEEE fp32 loop at D=768 on N(0,1)
//     data, and exact on small integers;
// rows at or past n_valid give NEG_INF (-3e38), and a chunk id repeated in
// one query's list gives its scores twice.  int8 rows of a width off a
// multiple of 128 bytes, bf16 rows off a multiple of 64 and fp32 rows (on
// the tensor cores a TF32 product) stay on the SIMT template of
// two_phase.cu.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, the distinct selected chunks read
// once plus the scores written once.  Kernel 5 at leg c1's shape (B=200,
// kc=20, 2048-row chunks of a 262,144 x 768 bf16 index: 128 chunks, all
// selected) 0.40 GB + 33 MB, 0.13 ms; kernel 4 at leg d's (B=384, kc=20,
// 512 chunks of 2048 rows of the 1M x 768 int8 index) 0.81 GB + 63 MB,
// 0.26 ms.  The SIMT template ran one block per (query, selected chunk), so
// a chunk that q queries selected was read q times (~31 at c1, ~15 at leg
// d), and multiplied on the CUDA cores.
//
// Design: one block per (chunk, row range, tile group).  The block scans the
// (B, kc) id table (from L2, four 16-byte loads in flight a thread) for the
// slots b * kc + kk that selected its chunk and exits at once when there is
// none.  Each thread counts the matches among its ids, a block scan ranks
// them, and the ranks cut the matches into query tiles of QN = 32 * NW
// slots in a fixed order; block g of a row range takes tiles g, g + groups,
// ...  For each tile the slots' query rows are gathered into a resident
// [QN][row bytes + 16] shared tile (zero rows up to the next 8) and the
// block's rows stream through the 4-stage cp.async ring of 144-byte
// k-slices with ldmatrix (the stage of i8_stage.cuh, shared with kernels 1
// and 7): index rows are the mma's M side, the gathered queries its N side,
// and warps whose query groups hold no slot skip their mma's.  After a row
// tile's last k-slice each thread stores its scores straight to their fixed
// places: for one register the warp writes 4 slots x 8 consecutive rows,
// four whole 32-byte sectors.  So each selected chunk is read from device
// memory once per tile of QN slots.  The plan (ops/mips.py::rescan_plan)
// keeps QN as narrow as the slots a chunk holds on average allow: at 32
// slots an int8 block needs 101 KB of shared memory and two fit an SM, and
// on an H100 a wider tile than the chunks need cost 5-19% at one block an
// SM and 55-70% where it also took the second block away
// (scripts_dev/kernel_variants.py rescan).  A chunk that every query
// selected (the legs' planted rows make one) then takes ceil(B / QN)
// passes; up to 4 tile groups and 512-row ranges share them, which brought
// leg d's shape with such a chunk from 1.39 ms to 0.43 ms there, at 0-5%
// on the shapes without one.
#include <stdint.h>

#include "i8_stage.cuh"

namespace mdrt_rescan {

using namespace mdrt_i8;

constexpr float NEG_INF = -3.0e38f;  // the JAX package's mask value
constexpr int NWARPS = NT / 32;
constexpr int MAX_QN = 256;          // the widest query tile (NW = 8)

// the ring, the row scales of its stages (int8), the gathered query tile
// ([qn][row_bytes + 16]), the tile's slots and the warps' match counts
inline size_t smem_bytes(int qn, int row_bytes, bool scales) {
  return size_t(STAGES) * MT * LDS +
         (scales ? size_t(STAGES) * MT * sizeof(float) : 0) +
         size_t(qn) * (row_bytes + 16) + size_t(qn) * sizeof(int) + 64;
}

template <bool INT8> struct Score;
template <> struct Score<true> {
  using Acc = int;
  __device__ __forceinline__ static float of(int acc, float dsc) {
    return __fmul_rn(__int2float_rn(acc), dsc);
  }
};
template <> struct Score<false> {
  using Acc = float;
  __device__ __forceinline__ static float of(float acc, float) { return acc; }
};

template <bool INT8, int NW>
__global__ void __launch_bounds__(NT)
rescan_mma_kernel(const int* __restrict__ chunk_ids,
                  const int8_t* __restrict__ q,
                  const int8_t* __restrict__ rows,
                  const float* __restrict__ d_scale, int b, int kc,
                  long long n, long long n_valid, int row_bytes,
                  int cand_rows, int rows_per_split, int splits, int groups,
                  float* __restrict__ out) {
  using Acc = typename Score<INT8>::Acc;
  constexpr int QN = 32 * NW;          // slots a query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem_raw);  // [STAGES][MT][LDS]
  float* ssc = reinterpret_cast<float*>(sa + STAGES * MT * LDS);
  int8_t* sq = reinterpret_cast<int8_t*>(ssc + (INT8 ? STAGES * MT : 0));
  const int ldq = row_bytes + 16;      // [QN][ldq]
  int* slots = reinterpret_cast<int*>(sq + QN * ldq);  // [QN]
  int* wcount = slots + QN;                            // [NWARPS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.x;
  const long long chunk0 = (long long)c * cand_rows;
  const int r_begin = int(blockIdx.y % splits) * rows_per_split;
  const int group = int(blockIdx.y / splits);  // query tiles group, +groups
  const int r_count = min(rows_per_split, cand_rows - r_begin);
  const int ksteps = row_bytes / KS;
  const int total = r_count / MT * ksteps;
  const int n_ids = b * kc;

  // this thread's ids in a fixed order: 16-byte groups tid, tid + NT, ...
  // (four loads in flight at a time), then one of the last n_ids % 4
  auto each_id = [&](auto&& fn) {
    const int4* ids4 = reinterpret_cast<const int4*>(chunk_ids);
    const int quads = n_ids / 4;
    for (int i0 = tid; i0 < quads; i0 += 4 * NT) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * NT < quads) v[u] = __ldg(ids4 + i0 + u * NT);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT;
        if (i >= quads) break;
        fn(4 * i, v[u].x);
        fn(4 * i + 1, v[u].y);
        fn(4 * i + 2, v[u].z);
        fn(4 * i + 3, v[u].w);
      }
    }
    const int i = 4 * quads + tid;
    if (i < n_ids) fn(i, __ldg(chunk_ids + i));
  };

  // rank the slots that selected chunk c: this thread's matches take ranks
  // first .. first + mine - 1
  int mine = 0;
  each_id([&](int, int id) { mine += id == c; });
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wcount[warp] = incl;
  __syncthreads();
  int first = incl - mine, n_slots = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const int v = wcount[w];
    if (w < warp) first += v;
    n_slots += v;
  }
  if (n_slots <= group * QN) return;  // no tile of this block (uniform)

  const int pieces = row_bytes / 16;
  for (int p0 = group * QN; p0 < n_slots; p0 += groups * QN) {
    const int cnt = min(QN, n_slots - p0);
    if (mine > 0 && first < p0 + QN && first + mine > p0) {
      int r = first;
      each_id([&](int i, int id) {
        if (id == c) {
          if (r >= p0 && r < p0 + QN) slots[r - p0] = i;
          ++r;
        }
      });
    }
    __syncthreads();
    // the tile's query rows (slot s holds query s / kc), zero rows up to a
    // whole group of 8; committed with stage 0
    const int filled = (cnt + 7) / 8 * 8;
    for (int i = tid; i < filled * pieces; i += NT) {
      const int r = i / pieces, p = i % pieces;
      const bool ok = r < cnt;
      cp_async16(sq + r * ldq + p * 16,
                 ok ? q + size_t(slots[r] / kc) * row_bytes + p * 16 : q,
                 ok ? 16 : 0);
    }
    // the warp's query groups that hold a slot, and their slots
    const int col0 = wn * 8 * NW;
    const int active = cnt > col0 ? min(NW, (cnt - col0 + 7) / 8) : 0;
    int my_slot[NW][2];
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + j * 8 + 2 * t + e;
        my_slot[j][e] = col < cnt ? slots[col] : -1;
      }

    // stage s: k-slice s % ksteps of row tile s / ksteps of the range; with
    // the tile's last k-slice its row scales
    auto load = [&](int s) {
      const int slot = s % STAGES;
      load_rows<false>(sa + slot * MT * LDS, ssc + slot * MT, rows, d_scale,
                       chunk0 + r_begin + (long long)(s / ksteps) * MT, n,
                       row_bytes, (s % ksteps) * KS,
                       INT8 && s % ksteps == ksteps - 1, tid);
    };
    Acc acc[4][NW][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = Acc(0);
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
                    sq + col0 * ldq + (s % ksteps) * KS, ldq, lane, active);
      if ((s + 1) % ksteps == 0) {
        // the row tile is complete: store its scores
        const int tile_r = r_begin + (s / ksteps) * MT + wm * 64 + g;
        const float* sc = ssc + slot * MT + wm * 64 + g;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = tile_r + mt * 16 + half * 8;
            const bool ok = chunk0 + r < n_valid;
            const float dsc = INT8 ? sc[mt * 16 + half * 8] : 1.f;
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (j < active && my_slot[j][e] >= 0)
                  out[size_t(my_slot[j][e]) * cand_rows + r] =
                      ok ? Score<INT8>::of(acc[mt][j][half * 2 + e], dsc)
                         : NEG_INF;
                acc[mt][j][half * 2 + e] = Acc(0);
              }
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the tile's slots and queries are read before reuse
  }
}

template <bool INT8, int NW>
int launch(const void* chunk_ids, const void* q, const void* index,
           const void* d_scale, int b, int kc, long long n, long long n_valid,
           int row_bytes, int cand_rows, int rows_per_split, int splits,
           int groups, void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(32 * NW, row_bytes, INT8);
  cudaError_t err = cudaFuncSetAttribute(
      rescan_mma_kernel<INT8, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(unsigned(n / cand_rows), unsigned(splits * groups));
  rescan_mma_kernel<INT8, NW><<<grid, NT, smem, stream>>>(
      static_cast<const int*>(chunk_ids), static_cast<const int8_t*>(q),
      static_cast<const int8_t*>(index), static_cast<const float*>(d_scale),
      b, kc, n, n_valid, row_bytes, cand_rows, rows_per_split, splits,
      groups, static_cast<float*>(out));
  return int(cudaGetLastError());
}

template <bool INT8>
int launch_qn(int q_tile, const void* chunk_ids, const void* q,
              const void* index, const void* d_scale, int b, int kc,
              long long n, long long n_valid, int row_bytes, int cand_rows,
              int rows_per_split, int splits, int groups, void* out,
              cudaStream_t s) {
  switch (q_tile / 32) {
#define MDRT_RESCAN_CASE(NW)                                               \
    case NW:                                                               \
      return launch<INT8, NW>(chunk_ids, q, index, d_scale, b, kc, n,      \
                              n_valid, row_bytes, cand_rows,               \
                              rows_per_split, splits, groups, out, s);
    MDRT_RESCAN_CASE(1) MDRT_RESCAN_CASE(2) MDRT_RESCAN_CASE(3)
    MDRT_RESCAN_CASE(4) MDRT_RESCAN_CASE(5) MDRT_RESCAN_CASE(6)
    MDRT_RESCAN_CASE(7) MDRT_RESCAN_CASE(8)
#undef MDRT_RESCAN_CASE
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace mdrt_rescan

// dtype 0: int8 rows, d_scale (n,) fp32 required; 1: bf16 rows.
// chunk_ids (b, kc) int32 and q (b, d), index (n, d) of that dtype, all
// contiguous and 16-byte aligned; a row d * itemsize bytes, a multiple of
// 128; n a multiple of cand_rows, itself a multiple of 128; q_tile the slots
// a query tile (a multiple of 32, at most 256), rows_per_split (a multiple
// of 128) and splits (covering cand_rows, none empty) the row ranges of a
// chunk, groups the blocks that share a range's query tiles (block g of a
// range takes tiles g, g + groups, ...), smem the dynamic shared memory,
// all from the wrapper's plan (smem
// checked here against q_tile, the row width and dtype); out (b, kc *
// cand_rows) fp32.
extern "C" int rescan_mma(int dtype, const void* chunk_ids, const void* q,
                          const void* index, const void* d_scale, int b,
                          int kc, long long n, long long n_valid, int d,
                          int cand_rows, int q_tile, int rows_per_split,
                          int splits, int groups, long long smem, void* out,
                          void* stream) {
  using namespace mdrt_rescan;
  const long long row_bytes = (long long)d * (dtype == 0 ? 1 : 2);
  if ((dtype != 0 && dtype != 1) || (dtype == 0 && d_scale == nullptr) ||
      b < 1 || kc < 1 || (long long)b * kc > 0x7fffffffLL || d < 1 ||
      row_bytes % KS != 0 || row_bytes > 0x7fffffffLL || cand_rows < MT ||
      cand_rows % MT != 0 || n < cand_rows || n % cand_rows != 0 ||
      n / cand_rows > 0x7fffffffLL || q_tile % 32 != 0 || q_tile < 32 ||
      q_tile > MAX_QN || rows_per_split < MT || rows_per_split % MT != 0 ||
      splits < 1 || groups < 1 || (long long)splits * groups > 65535 ||
      (long long)splits * rows_per_split < cand_rows ||
      (long long)(splits - 1) * rows_per_split >= cand_rows ||
      reinterpret_cast<uintptr_t>(chunk_ids) % 16 != 0 ||
      smem != (long long)smem_bytes(q_tile, int(row_bytes), dtype == 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_qn<true>(q_tile, chunk_ids, q, index, d_scale, b, kc, n,
                               n_valid, int(row_bytes), cand_rows,
                               rows_per_split, splits, groups, out, s)
             : launch_qn<false>(q_tile, chunk_ids, q, index, d_scale, b, kc,
                                n, n_valid, int(row_bytes), cand_rows,
                                rows_per_split, splits, groups, out, s);
}
