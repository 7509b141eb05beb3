// The top-k order of the scan kernels (mips_scan.cu, mips_scan_mma.cu):
// (score desc, row id asc), the JAX package's tie rule (lax.top_k gives the
// lower index).  A list holds KMAX (score, id) pairs in that order, and
// starts as (NEG_INF, 0) fillers.
#pragma once

namespace mdrt_topk {

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

}  // namespace mdrt_topk
