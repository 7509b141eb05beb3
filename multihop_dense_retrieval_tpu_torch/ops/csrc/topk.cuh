// The top-k order of the scan kernels (mips_scan.cu, mips_scan_mma.cu,
// mips_scan_i8.cu), and the tensor-core scans' merge of their partials:
// (score desc, row id asc), the JAX package's tie rule (lax.top_k gives the
// lower index).  A list holds KMAX (score, id) pairs in that order, and
// starts as (NEG_INF, 0) fillers.
#pragma once

namespace mdrt_topk {

constexpr float FILL = -3.0e38f;  // the fillers' score: the JAX mask value

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// (v, id) into a sorted list, exiting early when it cannot enter.
template <int KMAX>
__device__ __forceinline__ void insert(float (&tv)[KMAX], int (&ti)[KMAX],
                                       float v, int id) {
  if (!better(v, id, tv[KMAX - 1], ti[KMAX - 1])) return;
  tv[KMAX - 1] = v;
  ti[KMAX - 1] = id;
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (better(tv[s], ti[s], tv[s - 1], ti[s - 1])) {
      float fv = tv[s]; tv[s] = tv[s - 1]; tv[s - 1] = fv;
      int fi = ti[s]; ti[s] = ti[s - 1]; ti[s - 1] = fi;
    }
  }
}

// The tensor-core scans' per-thread fold: rows reach a thread's list in
// ascending order, so a value equal to one already kept loses, and ties go
// to the lower row without comparing ids.
template <int KMAX>
__device__ __forceinline__ void push(float (&tv)[KMAX], int (&ti)[KMAX],
                                     float v, int id) {
  if (!(v > tv[KMAX - 1])) return;
  tv[KMAX - 1] = v;
  ti[KMAX - 1] = id;
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (tv[s] > tv[s - 1]) {
      float fv = tv[s]; tv[s] = tv[s - 1]; tv[s - 1] = fv;
      int fi = ti[s]; ti[s] = ti[s - 1]; ti[s - 1] = fi;
    }
  }
}

// The end of a tensor-core scan block of 2 (row) x 4 (query) warps, whose
// threads hold lists for the 2 * NW query columns wn * 8 * NW + j * 8 + 2t
// + e (lane = 4g + t): the lists merged over the 8 row lanes of a warp
// (shuffles), then over its 2 row warps (red_v, red_i: [2][32 * NW][KMAX]
// in shared memory, free when called), and written as the block's
// partials (b, n_splits, KMAX) for the queries q0 + col below b.
template <int NW, int KMAX>
__device__ __forceinline__ void store_partials(
    float (&tv)[NW][2][KMAX], int (&ti)[NW][2][KMAX], float* red_v,
    int* red_i, int q0, int b, int split, int n_splits,
    float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int QN = 32 * NW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        float ov[KMAX];
        int oi[KMAX];
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          ov[s] = __shfl_xor_sync(0xffffffffu, tv[j][e][s], off);
          oi[s] = __shfl_xor_sync(0xffffffffu, ti[j][e][s], off);
        }
#pragma unroll
        for (int s = 0; s < KMAX; ++s)
          insert<KMAX>(tv[j][e], ti[j][e], ov[s], oi[s]);
      }
      if (g == 0) {
        const int col = wn * 8 * NW + j * 8 + 2 * t + e;
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          red_v[(wm * QN + col) * KMAX + s] = tv[j][e][s];
          red_i[(wm * QN + col) * KMAX + s] = ti[j][e][s];
        }
      }
    }
  __syncthreads();
  if (tid < QN && q0 + tid < b) {
    float mv[KMAX];
    int mi[KMAX];
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      mv[s] = red_v[tid * KMAX + s];
      mi[s] = red_i[tid * KMAX + s];
    }
#pragma unroll
    for (int s = 0; s < KMAX; ++s)
      insert<KMAX>(mv, mi, red_v[(QN + tid) * KMAX + s],
                   red_i[(QN + tid) * KMAX + s]);
    const size_t base = (size_t(q0 + tid) * n_splits + split) * KMAX;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      part_v[base + s] = mv[s];
      part_i[base + s] = mi[s];
    }
  }
}

// Pass 2 of the tensor-core scans, for the warp of query qi: its
// (n_splits, KMAX) partials merged (lane l takes entries l, l + 32, ...,
// then a butterfly of shuffles), which leaves the merged list in every lane.
template <int KMAX>
__device__ __forceinline__ void warp_merge(const float* __restrict__ part_v,
                                           const int* __restrict__ part_i,
                                           int qi, int n_splits, int lane,
                                           float (&tv)[KMAX],
                                           int (&ti)[KMAX]) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    tv[s] = FILL;
    ti[s] = 0;
  }
  const size_t base = size_t(qi) * n_splits * KMAX;
  for (int p = lane; p < n_splits * KMAX; p += 32)
    insert<KMAX>(tv, ti, part_v[base + p], part_i[base + p]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov[KMAX];
    int oi[KMAX];
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      ov[s] = __shfl_xor_sync(0xffffffffu, tv[s], off);
      oi[s] = __shfl_xor_sync(0xffffffffu, ti[s], off);
    }
#pragma unroll
    for (int s = 0; s < KMAX; ++s) insert<KMAX>(tv, ti, ov[s], oi[s]);
  }
}

// The first k entries of query qi's list into out (b, k)
template <int KMAX>
__device__ __forceinline__ void store_list(const float (&tv)[KMAX],
                                           const int (&ti)[KMAX], int qi,
                                           int k, float* __restrict__ out_v,
                                           int* __restrict__ out_i) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s)
    if (s < k) {
      out_v[size_t(qi) * k + s] = tv[s];
      out_i[size_t(qi) * k + s] = ti[s];
    }
}

// Pass 2 without rescoring (kernel 1: its int8 sums are exact): a warp per
// query, 4 a block
template <int KMAX>
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int b, int n_splits, int k, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int qi = blockIdx.x * 4 + threadIdx.x / 32;
  if (qi >= b) return;  // the whole warp
  float tv[KMAX];
  int ti[KMAX];
  warp_merge<KMAX>(part_v, part_i, qi, n_splits, lane, tv, ti);
  if (lane == 0) store_list<KMAX>(tv, ti, qi, k, out_v, out_i);
}

}  // namespace mdrt_topk
