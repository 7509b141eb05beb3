// The byte-wise tensor-core stage of kernels 1 and 7 (mips_scan_i8.cu,
// chunk_max_i8.cu) and of both rescan instances (rescan_mma.cu, kernels 4
// and 5).  Index rows are the M side of mma.sync (m16n8k32 s8 x s8 -> s32,
// or m16n8k16 bf16 x bf16 -> fp32: the same fragments byte for byte, and a
// k-step of 32 bytes in both, mma.cuh) in tiles of MT=128, the queries of a
// query tile (QN = 32 * NW) its N side.  A row's k-slice of KS=128 bytes
// streams through a ring of STAGES=4 shared-memory stages filled by
// cp.async, rows padded to LDS=144 bytes so that ldmatrix is free of bank
// conflicts.  Each tile's 128 fp32 row scales (int8) ride with its last
// k-slice into a per-stage slot.  A block of NT=256 threads splits a tile 2
// (64 rows) x 4 (QN / 4 queries) warps.
#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace mdrt_i8 {

using namespace mdrt_mma;

constexpr int MT = 128;              // index rows a tile
constexpr int KS = 128;              // int8 columns (bytes) a stage
constexpr int LDS = KS + 16;         // padded shared-memory row, bytes
constexpr int PK = KS / 16;          // 16-byte pieces of a row's k-slice
constexpr int STAGES = 4;
constexpr int NT = 256;              // threads: 2 x 4 warps

// the query tile's rows q0 .. q0 + QN - 1 into sq ([QN][d + 16] bytes),
// rows past b zero-filled (committed with the caller's next group)
template <int QN>
__device__ __forceinline__ void load_queries(int8_t* sq,
                                             const int8_t* __restrict__ q,
                                             int q0, int b, int d, int tid) {
  const int pieces = d / 16, ldq = d + 16;
  for (int i = tid; i < QN * pieces; i += NT) {
    const int r = i / pieces, p = i % pieces;
    const bool ok = q0 + r < b;
    cp_async16(sq + r * ldq + p * 16,
               ok ? q + size_t(q0 + r) * d + p * 16 : q, ok ? 16 : 0);
  }
}

// k-slice k0 of the MT rows from tile0 into da ([MT][LDS]); with a tile's
// last k-slice (`scales`) their row scales into sc ([MT] fp32).  BOUNDED:
// rows past n zero-filled; otherwise every row is below n (kernel 7's
// chunks), and the copies skip the compare (5% of kernel 7's time on an
// H100, scripts_dev/kernel_variants.py int8).
template <bool BOUNDED>
__device__ __forceinline__ void load_rows(int8_t* da, float* sc,
                                          const int8_t* __restrict__ rows,
                                          const float* __restrict__ d_scale,
                                          long long tile0, long long n,
                                          int d, int k0, bool scales,
                                          int tid) {
  const int8_t* src = rows + tile0 * d + k0;
  for (int i = tid; i < MT * PK; i += NT) {
    const int r = i / PK, p = i % PK;
    const bool ok = !BOUNDED || tile0 + r < n;
    cp_async16(da + r * LDS + p * 16, ok ? src + size_t(r) * d + p * 16 : rows,
               ok ? 16 : 0);
  }
  if (scales && tid < MT) {
    const bool ok = !BOUNDED || tile0 + tid < n;
    cp_async4(sc + tid, ok ? d_scale + tile0 + tid : d_scale, ok ? 4 : 0);
  }
}

// one 32-byte k-step of mma.sync, chosen by the accumulators' type
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  mma_s8(d, a, b0, b1);
}
__device__ __forceinline__ void mma_k32(float (&d)[4],
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  mma_bf16(d, a, b0, b1);
}

// a stage's products: acc[mt][j] += (the warp's rows mt * 16 .. at ta,
// [64][LDS]) x (its queries j * 8 .. at tb, rows ldb bytes apart) over KS
// bytes, for the warp's first `active` query groups j (the others, which
// hold no query, are skipped; kernels 1 and 7 pass NW)
template <int NW, typename Acc>
__device__ __forceinline__ void mma_stage(Acc (&acc)[4][NW][4],
                                          const int8_t* ta, const int8_t* tb,
                                          int ldb, int lane, int active = NW) {
  if (active <= 0) return;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 32) {
    uint32_t bq[NW][2];
#pragma unroll
    for (int j = 0; j + 1 < NW; j += 2) {
      if (j >= active) continue;
      uint32_t r[4];
      ldmatrix_x4(r, tb + (j * 8 + (lane / 16) * 8 + lane % 8) * ldb + kk +
                         ((lane / 8) % 2) * 16);
      bq[j][0] = r[0];
      bq[j][1] = r[1];
      bq[j + 1][0] = r[2];
      bq[j + 1][1] = r[3];
    }
    if constexpr (NW % 2 == 1) {
      if (NW - 1 < active) {
        uint32_t r[2];
        ldmatrix_x2(r, tb + ((NW - 1) * 8 + lane % 8) * ldb + kk +
                           ((lane / 8) % 2) * 16);
        bq[NW - 1][0] = r[0];
        bq[NW - 1][1] = r[1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, ta + (mt * 16 + lane % 16) * LDS + kk + (lane / 16) * 16);
#pragma unroll
      for (int j = 0; j < NW; ++j)
        if (j < active) mma_k32(acc[mt][j], a, bq[j][0], bq[j][1]);
    }
  }
}

}  // namespace mdrt_i8
