// Kernel 8: fused short-sequence multi-head attention.
//
// Replaces the JAX package's ops/fused_attention.py::_attn_kernel (per-head)
// and ::_attn_kernel_paired (head pairs), both reached through
// fused_attention (:139).  The paired TPU kernel zeroes the other head's half
// of q and contracts over 128 lanes, which in exact arithmetic is the
// per-head product, so one kernel serves both.  The TPU's batch block
// (_pick_block, block_b) sized a VMEM window and has no counterpart here.
//
// q (B, Wq, H), k and v (B, W, H) stay in the projection layout: head h is
// the column slice [h*d, (h+1)*d) of every row, so no head transpose is ever
// written.  mask (B, W) int32, nonzero where attendable.  Per (batch, head,
// query row), in the JAX kernel's arithmetic:
//   s = fp32(q_h . k_h) * scale + bias    scale = fp32(1/sqrt(d)), a multiply;
//                                         bias 0 or -1e9 from the mask
//   p = exp(s - max s) / sum(exp(...))    expf and an IEEE division
//   o = fp32(round_T(p) . v_h)            p rounded to the input type first
// and o is rounded to the output type.  Masked keys are not skipped, so a
// fully masked row is the softmax over s - 1e9, as in JAX (no NaN).
//
// Three templates, routed by the wrapper's plan (ops/fused_attention.py::
// attention_plan, a fixed rule tested on the CPU):
//
// * attn_mma_kernel (route 1): bf16, Wq = W, d in {16, 32, 64, 128}; the
//   corpus square and every hop-1 and hop-2 bucket.  Tensor cores.
// * attn_row_kernel (route 2): bf16, Wq = 1; the cls_only layer.
// * attn_kernel (route 0, the first SIMT version): fp32 (a tensor-core
//   product of fp32 would be TF32, and the fp32 check is 1e-5), and bf16
//   squares with d = 8.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): at the corpus shape
// (B=256, W=Wq=300, H=768, nh=12, bf16) the function reads q, k, v and the
// mask and writes o once, 0.47 GB (0.14 ms), and does 4*B*nh*Wq*W*d = 71
// GFLOP (0.07 ms): it is bound by bytes.  At Wq = 1 it reads k and v once,
// 0.24 GB (0.07 ms).  What the tensor-core template does about it (times in
// PERF.md): the products leave the CUDA cores, each (head, 128 query rows)
// reads its k_h and v_h once, and the scores never reach memory; what is
// left over the bound is the softmax's fp32 arithmetic, done for three
// passes over the scores.
//
// attn_mma_kernel: one block of NW warps (8, or 4 for W <= 64) per (16 * NW
// query rows, head, batch row); warp i owns query rows 16i..16i+15, as mma
// A fragments loaded once from device memory.  cp.async stages all of k_h,
// one commit group per 64-key strip so that pass 1 starts on the first,
// and v_h through a ring of two 64-key strips (rows padded to d + 8 bf16,
// so an ldmatrix's eight rows fall in distinct bank groups); heads stay
// column slices of the (B, W, H) layout.  S = Q.K^T runs on
// mma.sync.m16n8k16 (bf16 -> fp32) in 32-key half strips.  The scores are
// never stored: at W=514 they would take 264 KB a block.  Each half strip
// is recomputed, with the same instruction sequence and so bit-identical
// values, in three passes: (1) the row max; (2) the row sum of expf(s - m);
// (3) p = round_bf16(e / sum) with e = expf(s - m), packed from the
// accumulator fragment straight into the A operand of the P.V mma, with v
// read through ldmatrix.trans.  This is the JAX kernel's one-pass softmax,
// not flash attention's running rescale, whose late division rounds p
// otherwise.  The scale stays __fmul_rn and the bias __fadd_rn, with expf;
// the division is div_rn below, the IEEE quotient without __fdiv_rn's
// branch.  Traps:
//   - key padding: keys W .. W rounded to 64 get a -inf bias (not -1e9), so
//     they leave the max and the sum, and the k and v rows of keys W .. W
//     rounded to 16 are zero-filled in shared memory (0 * garbage can be
//     NaN); a fully masked row is then JAX's uniform softmax over the W
//     real keys;
//   - padded query rows are zero and never stored; a warp whose rows all
//     lie past W skips the products but meets every barrier;
//   - the tensor cores sum the products of an instruction in their own
//     order and alignment; the bf16 check (2 ulps + 2^-7 * sum p|v|)
//     covers it, and chip_smoke.py prints the share beyond 2 ulps.
// Shared memory: k_h whole, two v strips and the biases of whole strips:
// 181 KB at d=128, W=514; 63.5 KB at d=64, W=300 (three blocks an SM by
// shared memory, two by registers).
//
// attn_row_kernel: one warp per (batch row, head), four a block.  A row of
// d bf16 is read as 16-byte pieces by d/8 lanes, so 256/d keys a step; the
// warp scores all W keys into shared memory (fp32 FMAs, a shuffle sum),
// takes the softmax there as the SIMT kernel does, then accumulates p . v
// with the same lane split and a shuffle sum across the key groups.  k_h
// and v_h are read once each; no query rows are wasted.
//
// attn_kernel (SIMT): one block of 256 threads owns QT = 32 query rows of
// one head of one batch row; grid (B, nh, ceil(Wq / QT)).  q rows sit in
// shared memory as fp32; k then v stream through one KT = 64-row fp32 tile;
// the (QT, W) fp32 score rows live in dynamic shared memory (W <= 514: 66
// KB).  Phase 1 scores, phase 2 one warp a row for the softmax, phase 3
// accumulates QT*d/256 outputs a thread over the v tiles, all on fp32 FMAs.
#include <type_traits>

#include "mma.cuh"

namespace mdrt_attn {

constexpr int QT = 32;    // query rows a block
constexpr int KT = 64;    // key (value) rows a shared-memory tile
constexpr int NT = 256;   // threads a block
constexpr float MASK_BIAS = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + KT) of one head of `src` (row stride hs) into `dst` as fp32,
// row stride D + 1; rows >= w are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int w, int hs) {
  for (int i = threadIdx.x; i < KT * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < w ? to_f(src[size_t(r0 + r) * hs + c])
                                      : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ mask, int wq,
            int w, int nh, float scale, T* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][D]
  float* kv = qs + QT * D;           // [KT][D + 1]
  float* ss = kv + KT * (D + 1);     // [QT][w]
  const int bi = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * QT;
  const int t = threadIdx.x;
  const int hs = nh * D;
  const T* qb = q + size_t(bi) * wq * hs + h * D;
  const T* kb = k + size_t(bi) * w * hs + h * D;
  const T* vb = v + size_t(bi) * w * hs + h * D;
  const int* mb = mask + size_t(bi) * w;
  const int nq = min(QT, wq - q0);

  for (int i = t; i < QT * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[i] = r < nq ? to_f(qb[size_t(q0 + r) * hs + c]) : 0.f;
  }

  // phase 1: scores of QT query rows against each key tile
  constexpr int QPT = QT * KT / NT;   // query rows a thread: 8
  constexpr int QSTEP = NT / KT;      // 4 rows apart
  const int kj = t % KT, qg = t / KT;
  for (int k0 = 0; k0 < w; k0 += KT) {
    __syncthreads();
    load_tile<T, D>(kv, kb, k0, w, hs);
    __syncthreads();
    if (k0 + kj < w) {
      float acc[QPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) acc[i] = 0.f;
      const float* kr = kv + kj * (D + 1);
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float kc = kr[c];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          acc[i] = fmaf(qs[(qg + QSTEP * i) * D + c], kc, acc[i]);
      }
      const float bias = mb[k0 + kj] != 0 ? 0.f : MASK_BIAS;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int r = qg + QSTEP * i;
        if (r < nq) ss[r * w + k0 + kj] = __fadd_rn(__fmul_rn(acc[i], scale),
                                                    bias);
      }
    }
  }
  __syncthreads();

  // phase 2: softmax, one warp a row
  const int lane = t % 32, warp = t / 32;
  for (int r = warp; r < nq; r += NT / 32) {
    float* row = ss + r * w;
    float m = __int_as_float(0xff800000);   // -inf
    for (int j = lane; j < w; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < w; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < w; j += 32)
      row[j] = to_f(from_f<T>(__fdiv_rn(row[j], sum)));
  }

  // phase 3: o = p . v over the value tiles
  constexpr int OPT = QT * D / NT;    // outputs a thread: 1 (d=8) .. 16
  constexpr int RSTEP = NT / D;       // their rows are RSTEP apart
  const int c = t % D, rg = t / D;
  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < w; k0 += KT) {
    __syncthreads();
    load_tile<T, D>(kv, vb, k0, w, hs);
    __syncthreads();
    const int kn = min(KT, w - k0);
    for (int j = 0; j < kn; ++j) {
      const float vj = kv[j * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < OPT; ++i)
        acc[i] = fmaf(ss[(rg + RSTEP * i) * w + k0 + j], vj, acc[i]);
    }
  }
  T* ob = out + size_t(bi) * wq * hs + h * D;
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int r = rg + RSTEP * i;
    if (r < nq) ob[size_t(q0 + r) * hs + c] = from_f<T>(acc[i]);
  }
}

inline size_t smem_bytes(int d, int w) {
  return sizeof(float) * (size_t(QT) * d + size_t(KT) * (d + 1) +
                          size_t(QT) * w);
}

// ---- route 1: tensor cores, Wq = W, bf16 ------------------------------------

using bf16 = __nv_bfloat16;
using namespace mdrt_mma;

constexpr int KSTRIP = 64;    // keys a strip (8 n8 tiles)
constexpr int MAX_STRIPS = 9; // W <= 514: 528 padded keys

__host__ __device__ constexpr int pad16(int w) { return (w + 15) / 16 * 16; }
__host__ __device__ constexpr int num_strips(int w) {
  return (pad16(w) + KSTRIP - 1) / KSTRIP;
}
static_assert(num_strips(514) == MAX_STRIPS,
              "cp_async_wait_upto covers MAX_STRIPS + 1 groups in flight");

// k_h whole and two v strips (rows of d + 8 bf16), and a bias for every key
// of every strip
inline size_t mma_smem_bytes(int d, int w) {
  return sizeof(bf16) * (size_t(pad16(w)) + 2 * KSTRIP) * (d + 8) +
         sizeof(float) * size_t(num_strips(w)) * KSTRIP;
}

// cp.async.wait_group takes an immediate: wait until at most n groups are
// in flight, for a count known only at run time (at most MAX_STRIPS + 1)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    default: cp_async_wait<10>(); break;
  }
}

// p = e / l rounded to nearest, the value __fdiv_rn(e, l) gives, without
// its per-call reciprocal and its branch to a slow path, which keep the
// compiler from overlapping one division with the next (scripts_dev/
// kernel_variants.py times both).  r = __frcp_rn(l) is taken once a row;
// then two FMA corrections (Markstein: with r the rounded reciprocal and q
// within an ulp of the quotient, the remainder a - q*l is exact, and
// q + rem*r rounds to the IEEE quotient).  e in [0, 1] is scaled by 2^64
// first, exactly, so every intermediate is a normal float; the scale comes
// off exactly unless the quotient is below 2^-126 (e < 2^-117 l), where it
// may differ from __fdiv_rn by one subnormal ulp.  attention_divide below
// exposes it to the card tests, which hold it to IEEE division bit for bit.
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  const float a = __fmul_rn(e, 0x1p64f);
  float q = __fmul_rn(a, r);
  q = __fmaf_rn(__fmaf_rn(-q, l, a), r, q);
  q = __fmaf_rn(__fmaf_rn(-q, l, a), r, q);
  return __fmul_rn(q, 0x1p-64f);
}

__global__ void divide_kernel(const float* __restrict__ e,
                              const float* __restrict__ l,
                              float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = div_rn(e[i], l[i], __frcp_rn(l[i]));
}

template <int D, int NW>
__global__ void __launch_bounds__(32 * NW, D >= 128 ? 1 : 16 / NW)
attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ mask,
                int w, int nh, float scale, bf16* __restrict__ out) {
  constexpr int NTH = 32 * NW;    // threads
  constexpr int MQ = 16 * NW;     // query rows a block
  constexpr int LD = D + 8;       // padded shared-memory row
  constexpr int PR = D / 8;       // 16-byte pieces a row
  constexpr int KD = D / 16;      // k16 steps of q . k
  constexpr int ND = D / 8;       // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = pad16(w), nstrips = num_strips(w);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);     // [wp][LD]
  bf16* vs = ks + wp * LD;                          // [2][KSTRIP][LD]
  float* bias = reinterpret_cast<float*>(vs + 2 * KSTRIP * LD);  // [strips*64]

  const int q0 = blockIdx.x * MQ, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int hs = nh * D;
  const size_t base = size_t(bi) * w * hs + h * D;
  const bf16 *qb = q + base, *kb = k + base, *vb = v + base;

  // groups 0 .. nstrips - 1: the key strips of k_h, so that pass 1 starts
  // on the first; pad keys (w .. wp) are zero-filled: 0 * garbage can be NaN
  for (int st = 0; st < nstrips; ++st) {
    const int r0 = st * KSTRIP, n = min(KSTRIP, wp - r0) * PR;
    for (int i = tid; i < n; i += NTH) {
      const int r = r0 + i / PR, p = i % PR;
      const bool ok = r < w;
      cp_async16(ks + r * LD + p * 8, ok ? kb + size_t(r) * hs + p * 8 : kb,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }
  // then v strips 0 and 1; later strips reuse their slots
  auto load_v = [&](int strip) {
    bf16* dst = vs + (strip % 2) * KSTRIP * LD;
    for (int i = tid; i < KSTRIP * PR; i += NTH) {
      const int r = i / PR, p = i % PR, key = strip * KSTRIP + r;
      const bool ok = key < w;
      cp_async16(dst + r * LD + p * 8, ok ? vb + size_t(key) * hs + p * 8 : vb,
                 ok ? 16 : 0);
    }
  };
  load_v(0);
  cp_async_commit();
  if (nstrips > 1) load_v(1);
  cp_async_commit();
  // the JAX bias (0 or -1e9) for real keys, -inf for every pad key of the
  // last strip: pad keys leave the max and the sum
  for (int j = tid; j < nstrips * KSTRIP; j += NTH)
    bias[j] = j < w ? (mask[size_t(bi) * w + j] != 0 ? 0.f : MASK_BIAS)
                    : neg_inf();

  // the warp's 16 query rows as mma A fragments, from device memory; rows
  // past w are zero and never stored, and a warp wholly past w skips the
  // products (it still meets every barrier)
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const bool live = q0 + warp * 16 < w;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = kd * 16 + 2 * t;
    auto ld = [&](int row, int col) -> uint32_t {
      return row < w ? __ldg(reinterpret_cast<const unsigned int*>(
                           qb + size_t(row) * hs + col))
                     : 0u;
    };
    qf[kd][0] = ld(ra, c);
    qf[kd][1] = ld(rb, c);
    qf[kd][2] = ld(ra, c + 8);
    qf[kd][3] = ld(rb, c + 8);
  }

  // s[j][e]: query row ra (e < 2) or rb (e >= 2), key k0 + 8j + 2t + (e & 1)
  // of a 32-key half strip; the same instructions in every pass, so the
  // same values.  Half strips keep the fragments in 16 registers.
  auto score_half = [&](float (&s)[4][4], int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        if (k0 + j * 8 < wp) {           // wp is a multiple of 16
          uint32_t r[4];
          ldmatrix_x4(r, ks + (k0 + j * 8 + (lane / 16) * 8 + lane % 8) * LD +
                             kd * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[j], qf[kd], r[0], r[1]);
          mma_bf16(s[j + 1], qf[kd], r[2], r[3]);
        }
      }
    // keys past wp kept s = 0, and their bias is -inf
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale),
                            bias[k0 + j * 8 + 2 * t + (e & 1)]);
  };

  // pass 1: the row maxima, each key strip as soon as it has landed
  float m0 = neg_inf(), m1 = neg_inf();
  for (int st = 0; st < nstrips; ++st) {
    cp_async_wait_upto(nstrips + 1 - st);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float s[4][4];
        score_half(s, st * KSTRIP + hf * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
          m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  // pass 2: the row sums of expf(s - m)
  float l0 = 0.f, l1 = 0.f;
  if (live) {
    for (int k0 = 0; k0 < nstrips * KSTRIP; k0 += 32) {
      float s[4][4];
      score_half(s, k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l0 += expf(s[j][0] - m0) + expf(s[j][1] - m0);
        l1 += expf(s[j][2] - m1) + expf(s[j][3] - m1);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
  // pass 3: o = round_bf16(p) . v over the v strips
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  for (int st = 0; st < nstrips; ++st) {
    cp_async_wait<1>();
    __syncthreads();                     // v strip st has landed
    if (live) {
      const bf16* vt = vs + (st % 2) * KSTRIP * LD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k0 = st * KSTRIP + hf * 32;
        float s[4][4];
        score_half(s, k0);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (k0 + kk * 16 >= wp) continue;
          const float(&s0)[4] = s[2 * kk];
          const float(&s1)[4] = s[2 * kk + 1];
          uint32_t a[4];
          a[0] = pack_bf16(div_rn(expf(s0[0] - m0), l0, r0),
                           div_rn(expf(s0[1] - m0), l0, r0));
          a[1] = pack_bf16(div_rn(expf(s0[2] - m1), l1, r1),
                           div_rn(expf(s0[3] - m1), l1, r1));
          a[2] = pack_bf16(div_rn(expf(s1[0] - m0), l0, r0),
                           div_rn(expf(s1[1] - m0), l0, r0));
          a[3] = pack_bf16(div_rn(expf(s1[2] - m1), l1, r1),
                           div_rn(expf(s1[3] - m1), l1, r1));
          const bf16* vk = vt + (hf * 32 + kk * 16) * LD;
#pragma unroll
          for (int nd = 0; nd < ND; nd += 2) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, vk + (lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                     nd * 8 + (lane / 16) * 8);
            mma_bf16(o[nd], a, r[0], r[1]);
            mma_bf16(o[nd + 1], a, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();                     // every warp is done with the slot
    if (st + 2 < nstrips) load_v(st + 2);
    cp_async_commit();
  }

  if (!live) return;
  bf16* ob = out + base;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (ra < w)
      *reinterpret_cast<uint32_t*>(ob + size_t(ra) * hs + col) =
          pack_bf16(o[nd][0], o[nd][1]);
    if (rb < w)
      *reinterpret_cast<uint32_t*>(ob + size_t(rb) * hs + col) =
          pack_bf16(o[nd][2], o[nd][3]);
  }
}

// ---- route 2: one warp per (batch row, head), Wq = 1, bf16 -----------------

constexpr int ROW_WARPS = 4;

inline size_t row_smem_bytes(int w) {
  return sizeof(float) * ROW_WARPS * size_t((w + 3) / 4 * 4);
}

template <int D>
__global__ void __launch_bounds__(ROW_WARPS * 32)
attn_row_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ mask,
                int b, int w, int nh, float scale, bf16* __restrict__ out) {
  constexpr int L = D / 8;        // lanes a row (16 bytes each)
  constexpr int G = 32 / L;       // rows a step
  extern __shared__ float srow[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int pair = blockIdx.x * ROW_WARPS + warp;
  if (pair >= b * nh) return;     // no block-wide barrier below
  const int bi = pair / nh, h = pair % nh;
  const int hs = nh * D, sub = lane % L, grp = lane / L;
  float* s = srow + warp * ((w + 3) / 4 * 4);
  const bf16* kb = k + size_t(bi) * w * hs + h * D + sub * 8;
  const bf16* vb = v + size_t(bi) * w * hs + h * D + sub * 8;
  const int* mb = mask + size_t(bi) * w;

  float qv[8];
  {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(
        q + size_t(bi) * hs + h * D + sub * 8));
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = __bfloat162float(e[i]);
  }
  // scores: L lanes a key, G keys a step, a shuffle sum over the L lanes
#pragma unroll 4
  for (int j0 = 0; j0 < w; j0 += G) {
    const int j = j0 + grp;
    float acc = 0.f;
    if (j < w) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(kb + size_t(j) * hs));
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(qv[i], __bfloat162float(e[i]), acc);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub == 0 && j < w)
      s[j] = __fadd_rn(__fmul_rn(acc, scale), mb[j] != 0 ? 0.f : MASK_BIAS);
  }
  __syncwarp();
  // softmax over the W real keys, as in the SIMT kernel's phase 2
  float m = neg_inf();
  for (int j = lane; j < w; j += 32) m = fmaxf(m, s[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.f;
  for (int j = lane; j < w; j += 32) {
    const float e = expf(s[j] - m);
    s[j] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  for (int j = lane; j < w; j += 32)
    s[j] = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(s[j], sum)));
  __syncwarp();
  // o = p . v: lane (grp, sub) sums dims sub*8.. over keys grp, grp + G, ...
  float o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
#pragma unroll 4
  for (int j = grp; j < w; j += G) {
    const float p = s[j];
    const int4 raw = __ldg(reinterpret_cast<const int4*>(vb + size_t(j) * hs));
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = fmaf(p, __bfloat162float(e[i]), o[i]);
  }
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
  if (grp == 0) {
    int4 raw;
    uint32_t* pk = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) pk[i] = pack_bf16(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<int4*>(out + size_t(bi) * hs + h * D + sub * 8) = raw;
  }
}

// ---- launches ----------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <int D, int NW>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const int* mask,
               int b, int w, int nh, float scale, size_t smem, bf16* out,
               cudaStream_t stream) {
  if (int err = set_smem(attn_mma_kernel<D, NW>, smem)) return err;
  attn_mma_kernel<D, NW><<<dim3((w + 16 * NW - 1) / (16 * NW), nh, b),
                           32 * NW, smem, stream>>>(q, k, v, mask, w, nh,
                                                    scale, out);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch(int route, int warps, const void* q, const void* k, const void* v,
           const void* mask, int b, int wq, int w, int nh, float scale,
           size_t smem, void* out, cudaStream_t stream) {
  const int* mk = static_cast<const int*>(mask);
  if constexpr (sizeof(T) == 2) {
    const bf16* qq = static_cast<const bf16*>(q);
    const bf16* kk = static_cast<const bf16*>(k);
    const bf16* vv = static_cast<const bf16*>(v);
    bf16* oo = static_cast<bf16*>(out);
    if constexpr (D >= 16) {
      if (route == 1) {
        if (wq != w || smem != mma_smem_bytes(D, w))
          return int(cudaErrorInvalidValue);
        if (warps == 4) return launch_mma<D, 4>(qq, kk, vv, mk, b, w, nh,
                                                scale, smem, oo, stream);
        if (warps == 8) return launch_mma<D, 8>(qq, kk, vv, mk, b, w, nh,
                                                scale, smem, oo, stream);
        return int(cudaErrorInvalidValue);
      }
    }
    if (route == 2) {
      if (wq != 1 || smem != row_smem_bytes(w))
        return int(cudaErrorInvalidValue);
      if (int err = set_smem(attn_row_kernel<D>, smem)) return err;
      const int blocks = (b * nh + ROW_WARPS - 1) / ROW_WARPS;
      attn_row_kernel<D><<<blocks, ROW_WARPS * 32, smem, stream>>>(
          qq, kk, vv, mk, b, w, nh, scale, oo);
      return int(cudaGetLastError());
    }
  }
  if (route != 0 || smem != smem_bytes(D, w))
    return int(cudaErrorInvalidValue);
  if (int err = set_smem(attn_kernel<T, D>, smem)) return err;
  dim3 grid(b, nh, (wq + QT - 1) / QT);
  attn_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mk, wq, w, nh, scale, static_cast<T*>(out));
  return int(cudaGetLastError());
}

template <typename T>
int launch_d(int route, int warps, const void* q, const void* k, const void* v,
             const void* mask, int b, int wq, int w, int nh, int d,
             float scale, size_t smem, void* out, cudaStream_t s) {
  auto go = [&](auto dim) {
    return launch<T, decltype(dim)::value>(route, warps, q, k, v, mask, b, wq,
                                           w, nh, scale, smem, out, s);
  };
  switch (d) {
    case 8: return go(std::integral_constant<int, 8>());
    case 16: return go(std::integral_constant<int, 16>());
    case 32: return go(std::integral_constant<int, 32>());
    case 64: return go(std::integral_constant<int, 64>());
    case 128: return go(std::integral_constant<int, 128>());
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace mdrt_attn

// route: 0 SIMT, 1 tensor cores (bf16, wq == w, d >= 16; warps 4 or 8 a
// block), 2 one warp per (batch row, head) (bf16, wq == 1); warps is read by
// route 1 only; smem the dynamic shared memory of the wrapper's plan,
// checked against the route's own count.  dtype: 1 bf16, 2 fp32.  q (b, wq,
// nh * d), k and v (b, w, nh * d) of that dtype, contiguous and 16-byte
// aligned; mask (b, w) int32; out (b, wq, nh * d) of that dtype.  d in {8,
// 16, 32, 64, 128}, 1 <= wq <= w <= 514; scale = fp32(1/sqrt(d)).
extern "C" int fused_attention(int route, int warps, int dtype, const void* q,
                               const void* k, const void* v, const void* mask,
                               int b, int wq, int w, int nh, int d,
                               float scale, long long smem, void* out,
                               void* stream) {
  using namespace mdrt_attn;
  if (b < 1 || nh < 1 || wq < 1 || wq > w || w > 514 || smem < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_d<__nv_bfloat16>(route, warps, q, k, v, mask, b, wq, w,
                                     nh, d, scale, size_t(smem), out, s);
    case 2:
      return launch_d<float>(route, warps, q, k, v, mask, b, wq, w, nh, d,
                             scale, size_t(smem), out, s);
  }
  return int(cudaErrorInvalidValue);
}

// The card tests' view of div_rn: out[i] = e[i] / l[i] as kernel 8's
// tensor-core template divides (e, l, out fp32 on the device, n >= 0).
extern "C" int attention_divide(const void* e, const void* l, void* out,
                                int n, void* stream) {
  if (n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  mdrt_attn::divide_kernel<<<(n + 255) / 256, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(l),
      static_cast<float*>(out), n);
  return int(cudaGetLastError());
}
