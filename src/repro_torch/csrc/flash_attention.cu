// K9: causal / sliding-window GQA attention forward with an online softmax.
//
// Replaces the JAX package's Pallas kernel
// kernels/flash_attention.py::flash_attention_fwd (pallas_call at :94, body
// _kernel). For q (B, Hq, S, D) and k, v (B, Hkv, Skv, D), kv head = q head /
// (Hq / Hkv):
//   s = (q . k) * scale, scale = 1 / sqrt(D), in f32;
//   masked scores -> NEG = -1e30 (top-left positions: k_pos <= q_pos when
//   causal, q_pos - k_pos < window when window > 0);
//   per kv tile: m' = max(m, max s), p = exp(s - m'), c = exp(m - m'),
//   l = l c + sum p, acc = acc c + p . v (p rounded to v's dtype first);
//   out = acc / max(l, 1e-30) in q's dtype.
// The plain version is repro_torch/kernels/flash_attention.py::
// flash_attention_plain (the naive full softmax of kernels/ref.py); the two
// agree to 2e-5 in f32 (sums in another order) and, in bf16, within
// flash_attention.py::bf16_error_bound (one output ulp plus the spread of
// the p roundings).
//
// Design. The TPU kernel ran a (b, h, q tile, kv tile) grid whose kv axis was
// sequential, with (m, l, acc) in VMEM scratch. Here one block takes one
// (batch, q head, q tile) and loops over the kv tiles itself, skipping the
// tiles wholly above the diagonal or wholly outside the window; the q tiles
// with the most work are launched first. m, l and the accumulator stay in
// registers. Keys past Skv (the ragged tile) score -inf, so they add exactly
// 0. A row with no valid key at all (only with a window, q_pos >= Skv +
// window - 1) would depend on which tiles are skipped; its q tile skips
// none, so the row gets the full softmax's answer, the mean of V.
//   bf16 at D = 64, 128, 256 (flash_bf16_wgmma): Hopper's warpgroup products.
//   A block of three warpgroups takes a 128-row q tile. Warpgroup 2 gives
//   its registers back (setmaxnreg) and one of its threads issues TMA loads:
//   Q once, then K and V tiles (128 keys; 64 at D = 256) through two-stage
//   rings, K and V each with a "full" and an "empty" mbarrier per stage, so
//   a K slot frees as soon as S is done. 3-D tensor maps (D, S, B * heads)
//   zero-fill a ragged tile without reading the next head's rows; the
//   128-byte swizzle lays a row out as 64-column boxes. Warpgroups 0 and 1
//   own 64 q rows each: S = Q K^T is wgmma m64nBKk16 with both operands in
//   shared memory; the online softmax runs on the accumulators (quad
//   shuffles for the row max and sum) with the exponent 2^(s c - m c),
//   c = scale log2(e), as one fused multiply-add and one ex2.approx; O += P V
//   is a wgmma with P rounded to bf16 in registers as the A operand and V
//   read in its [key][D] layout through the transposed-B descriptor. Only
//   tiles that cross the diagonal, the window's edge or Skv are masked.
//   bf16 at other D (flash_bf16): 4 warps, each owns 16 of 64 rows; S = Q K^T
//   and O += P V are mma.sync.m16n8k16 (bf16 in, f32 accumulate); P goes
//   from the S accumulators to the A operand in registers, rounded to bf16.
//   K and V tiles (64 keys) are loaded synchronously into shared memory, V
//   transposed so that its B fragments are 32-bit loads; row strides padded
//   by 8 elements keep the fragment loads free of bank conflicts.
//   f32 (flash_f32): no tensor cores (TF32 would lose the 2e-5 agreement).
//   256 threads over a 64-row tile, each owns 4 rows x 4 keys of S
//   (explicit fmaf from transposed Q and K tiles, float4 loads) and the same
//   4 rows x D/16 columns of O; P goes through shared memory.
// In flash_bf16 and flash_f32 D is a runtime value, a multiple of 16 in
// [16, 256]; the register arrays are sized by the next of 64, 128, 192, 256.
//
// Bound on the H100: operations. 4 D flops per unmasked (q, k) pair (two
// products) against 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32);
// q, k, v and out are read or written once. In the wgmma kernel each
// warpgroup runs S, softmax and P V in turn; the softmax overlaps only the
// other warpgroup's products, and blocks do not stay resident across q
// tiles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;    // q rows a block
constexpr int kBK = 64;    // keys a kv tile

struct Attn {
  int B, Hq, Hkv, S, Skv, D, causal, window;
  float scale;
};

// The kv tiles [lo, hi] of `bk` keys that the `bq`-row q tile starting at
// q0 must visit. A tile holding a row with no valid key skips none.
__device__ __forceinline__ void kv_range(const Attn& a, int q0, int* lo,
                                         int* hi, int bq = kBQ,
                                         int bk = kBK) {
  const int q_last = min(q0 + bq, a.S) - 1;
  *lo = 0;
  *hi = (a.Skv + bk - 1) / bk - 1;
  if (a.window > 0 && q_last >= a.Skv + a.window - 1) return;  // a dead row
  if (a.causal) *hi = min(*hi, q_last / bk);
  if (a.window > 0) *lo = max(0, q0 - a.window + 1) / bk;
}

__device__ __forceinline__ float masked(const Attn& a, float s, int q, int k) {
  if (k >= a.Skv) return -INFINITY;
  if (a.causal && k > q) return kNeg;
  if (a.window > 0 && q - k >= a.window) return kNeg;
  return s * a.scale;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DCAP>
__global__ void __launch_bounds__(128)
    flash_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
               Attn a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D;
  const int ld = D + 8;         // row stride of Qs and Ks (elements)
  const int ldv = kBK + 8;      // row stride of Vt
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);  // [kBQ][ld]
  uint16_t* Ks = Qs + kBQ * ld;                      // [kBK][ld]
  uint16_t* Vt = Ks + kBK * ld;                      // [D][ldv]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const uint16_t* qb = q + (size_t)(b * a.Hq + h) * a.S * D;
  const uint16_t* kb = k + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  const uint16_t* vb = v + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  uint16_t* ob = o + (size_t)(b * a.Hq + h) * a.S * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int vec = D / 8;        // 16-byte vectors a row
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < kBQ * vec; e += blockDim.x) {
    const int r = e / vec, c = e - r * vec;
    uint4 val = zero;
    if (q0 + r < a.S) {
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * ld + c * 8) = val;
  }
  float acc[DCAP / 8][4];
#pragma unroll
  for (int j = 0; j < DCAP / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int lo, hi;
  kv_range(a, q0, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();            // the previous tile's readers are done
    for (int e = tid; e < kBK * vec; e += blockDim.x) {
      const int r = e / vec, c = e - r * vec;
      uint4 val = zero;
      if (k0 + r < a.Skv) {
        val = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D +
                                              c * 8);
      }
      *reinterpret_cast<uint4*>(Ks + r * ld + c * 8) = val;
    }
    for (int e = tid; e < kBK * vec; e += blockDim.x) {
      const int r = e % kBK, c = e / kBK;   // neighbouring threads: keys
      uint4 val = zero;
      if (k0 + r < a.Skv) {
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D +
                                              c * 8);
      }
      const uint16_t* x = reinterpret_cast<const uint16_t*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c * 8 + i) * ldv + r] = x[i];
    }
    __syncthreads();
    // ---- S = Q K^T for this warp's 16 rows x 64 keys ----------------------
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint16_t* qa = Qs + (warp * 16 + g) * ld + kk * 16 + 2 * t;
      const uint32_t af[4] = {ld32(qa), ld32(qa + 8 * ld), ld32(qa + 8),
                              ld32(qa + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint16_t* kp = Ks + (j * 8 + g) * ld + kk * 16 + 2 * t;
        mma_bf16(s[j], af, ld32(kp), ld32(kp + 8));
      }
    }
    // ---- mask, online softmax --------------------------------------------
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = masked(a, s[j][e], row0 + 8 * r, k0 + j * 8 + 2 * t + (e & 1));
        tmax[r] = fmaxf(tmax[r], s[j][e]);
      }
    }
    float corr[2], tsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m_r[r], tmax[r]);
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        tsum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
      l_r[r] = l_r[r] * corr[r] + tsum[r];
    }
#pragma unroll
    for (int j = 0; j < DCAP / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // ---- O += P V: P from the S accumulators, rounded to bf16 -------------
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DCAP / 8; ++j) {
        if (j < D / 8) {
          const uint16_t* vp = Vt + (j * 8 + g) * ldv + kk * 16 + 2 * t;
          mma_bf16(acc[j], pf, ld32(vp), ld32(vp + 8));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
    const float den = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DCAP / 8; ++j) {
      if (j < D / 8) {
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + j * 8 + 2 * t) =
            pack_bf16(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
      }
    }
  }
}

template <int DCAP>
__global__ void __launch_bounds__(256)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Attn a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = DCAP / 16;   // O columns a thread
  const int D = a.D;
  float* QsT = reinterpret_cast<float*>(smem);   // [D][kBQ]
  float* KsT = QsT + D * kBQ;                     // [D][kBK]
  float* Vs = KsT + D * kBK;                      // [kBK][D]
  float* PsT = Vs + kBK * D;                      // [kBK][kBQ]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const float* qb = q + (size_t)(b * a.Hq + h) * a.S * D;
  const float* kb = k + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  const float* vb = v + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  float* ob = o + (size_t)(b * a.Hq + h) * a.S * D;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;      // rows 4 rg .. 4 rg + 3
  const int cg = tid & 15;      // keys 4 cg .. 4 cg + 3; O columns cg + 16 j
  const int vec = D / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = tid; e < kBQ * vec; e += blockDim.x) {
    const int r = e % kBQ, c = e / kBQ;   // neighbouring threads: rows
    float4 val = zero;
    if (q0 + r < a.S) {
      val = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * D + 4 * c);
    }
    QsT[(4 * c + 0) * kBQ + r] = val.x;
    QsT[(4 * c + 1) * kBQ + r] = val.y;
    QsT[(4 * c + 2) * kBQ + r] = val.z;
    QsT[(4 * c + 3) * kBQ + r] = val.w;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNeg;
    l_r[i] = 0.0f;
  }
  int lo, hi;
  kv_range(a, q0, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    for (int e = tid; e < kBK * vec; e += blockDim.x) {
      const int r = e % kBK, c = e / kBK;
      float4 val = zero;
      if (k0 + r < a.Skv) {
        val = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + r) * D +
                                               4 * c);
      }
      KsT[(4 * c + 0) * kBK + r] = val.x;
      KsT[(4 * c + 1) * kBK + r] = val.y;
      KsT[(4 * c + 2) * kBK + r] = val.z;
      KsT[(4 * c + 3) * kBK + r] = val.w;
    }
    for (int e = tid; e < kBK * vec; e += blockDim.x) {
      const int r = e / vec, c = e - r * vec;
      float4 val = zero;
      if (k0 + r < a.Skv) {
        val = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + r) * D +
                                               4 * c);
      }
      *reinterpret_cast<float4*>(Vs + r * D + 4 * c) = val;
    }
    __syncthreads();
    // ---- S = Q K^T: 4 rows x 4 keys a thread -------------------------------
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(QsT + d * kBQ + 4 * rg);
      const float4 kv = *reinterpret_cast<const float4*>(KsT + d * kBK + 4 * cg);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }
    // ---- mask, online softmax (a row's 64 keys lie on 16 lanes) -----------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(a, s[i][j], q0 + 4 * rg + i, k0 + 4 * cg + j);
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      }
      const float m_new = fmaxf(m_r[i], tmax);
      const float corr = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      float tsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        tsum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      }
      l_r[i] = l_r[i] * corr + tsum;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(PsT + (4 * cg + j) * kBQ + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();
    // ---- O += P V ----------------------------------------------------------
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(PsT + kk * kBQ + 4 * rg);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = cg + 16 * j;
        if (col < D) {
          const float x = Vs[kk * D + col];
          acc[0][j] = fmaf(pv.x, x, acc[0][j]);
          acc[1][j] = fmaf(pv.y, x, acc[1][j]);
          acc[2][j] = fmaf(pv.z, x, acc[2][j]);
          acc[3][j] = fmaf(pv.w, x, acc[3][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= a.S) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = cg + 16 * j;
      if (col < D) ob[(size_t)row * D + col] = acc[i][j] / den;
    }
  }
}

// ---- bf16 on wgmma + TMA (D = 64, 128, 256) ------------------------------
// One block: one (batch, q head, 128-row q tile); warpgroups 0 and 1
// consume (64 q rows each), warpgroup 2 produces (one thread issues TMA).
// Shared memory holds every tile as 64-column boxes of 128-byte rows in
// the 128-byte swizzle: Q [D/64][128][64], and per stage K and V
// [D/64][BK][64].
constexpr int kWgBQ = 128;
constexpr int kWgStages = 2;
constexpr int kWgThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BK>
struct WgTile {
  static constexpr int kQBytes = kWgBQ * D * 2;
  static constexpr int kKVBytes = BK * D * 2;       // one K or V tile
  static constexpr int kBarriers = 1 + 4 * kWgStages;
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kWgStages * kKVBytes +
                                  8 * kBarriers;
};

// raw (unscaled) score; -inf past Skv, NEG where masked
__device__ __forceinline__ float masked_raw(const Attn& a, float s, int q,
                                            int k) {
  if (k >= a.Skv) return -INFINITY;
  if (a.causal && k > q) return kNeg;
  if (a.window > 0 && q - k >= a.window) return kNeg;
  return s;
}

template <int N>
__device__ __forceinline__ void wgmma_s(float* d, uint64_t a, uint64_t b,
                                        int acc) {
  if constexpr (N == 64) hopper::wgmma_ss_n64(d, a, b, acc);
  else hopper::wgmma_ss_n128(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 64) hopper::wgmma_rs_n64(d, a, b, 1);
  else if constexpr (N == 128) hopper::wgmma_rs_n128(d, a, b, 1);
  else hopper::wgmma_rs_n256(d, a, b, 1);
}

// S = Q K^T (raw scores), 64 x BK in registers, from the warpgroup's 64 q
// rows at q_base and the K tile at k_base; committed, not awaited.
template <int D, int BK>
__device__ __forceinline__ void issue_s(float* sacc, uint32_t q_base,
                                        uint32_t k_base) {
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) hopper::reg_fence(sacc[j]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qa = q_base + (kk / 4) * kWgBQ * 128 + (kk % 4) * 32;
    const uint32_t kb = k_base + (kk / 4) * BK * 128 + (kk % 4) * 32;
    wgmma_s<BK>(sacc, hopper::sw128_desc(qa, 16, 1024),
                hopper::sw128_desc(kb, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// 2^x by one MUFU.EX2 (subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one tile's raw scores in place: updates the rows' max
// m and sum l, leaves p in sacc and the accumulator's correction in corr.
// EDGE: the tile may hold masked keys (masks them, and gives a row with
// every key so far masked the plain softmax's 1 each); otherwise every key
// of the tile is valid for every row.
template <int BK, bool EDGE>
__device__ __forceinline__ void online_softmax(float* sacc, float* m_r,
                                               float* l_r, float* corr,
                                               const Attn& a, float c,
                                               int row0, int k0, int tq4) {
  if (EDGE) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[4 * j + e] = masked_raw(a, sacc[4 * j + e], row0 + 8 * (e >> 1),
                                     k0 + 8 * j + 2 * tq4 + (e & 1));
      }
    }
  }
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tmax[e >> 1] = fmaxf(tmax[e >> 1], sacc[4 * j + e]);
    }
  }
  float mc[2], tsum[2] = {0.0f, 0.0f};
  bool dead[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m_r[r], tmax[r]);
    corr[r] = fast_exp2((m_r[r] - m_new) * c);
    mc[r] = m_new * c;
    // every key so far masked: the plain softmax of NEG scores, 1 each
    // (fmaf would leave the rounding error of NEG c)
    dead[r] = EDGE && m_new == kNeg;
    m_r[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float& x = sacc[4 * j + e];
      const float p = fast_exp2(fmaf(x, c, -mc[r]));
      x = EDGE && dead[r] ? (x == kNeg ? 1.0f : 0.0f) : p;
      tsum[r] += x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
    tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
    l_r[r] = l_r[r] * corr[r] + tsum[r];
  }
}

template <int D>
__device__ __forceinline__ void rescale(float* oacc, const float* corr) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    oacc[4 * j + 0] *= corr[0];
    oacc[4 * j + 1] *= corr[0];
    oacc[4 * j + 2] *= corr[1];
    oacc[4 * j + 3] *= corr[1];
  }
}

// P rounded to bf16 in the layout of wgmma's register A operand (that of
// the S accumulators: rows g and g + 8, keys 2 t, 2 t + 1 and + 8)
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (*pf)[4], const float* sacc) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
    pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// O += P V from the V tile at v_base ([key][D] is MN-major for B: 64-column
// boxes BK * 128 bytes apart, 8 keys 1,024 bytes apart); committed, not
// awaited.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float* oacc, uint32_t (*pf)[4],
                                         uint32_t v_base) {
#pragma unroll
  for (int j = 0; j < D / 2; ++j) hopper::reg_fence(oacc[j]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_pv<D>(oacc, pf[kk],
                hopper::sw128_desc(v_base + kk * 16 * 128, BK * 128, 1024));
  }
  hopper::wgmma_commit();
}

template <int D, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     uint16_t* __restrict__ o, Attn a) {
  using T = WgTile<D, BK>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Ks = Qs + kWgBQ * D;                 // [stage][BK * D]
  uint16_t* Vs = Ks + kWgStages * BK * D;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kWgStages * BK * D);
  uint64_t* k_full = q_full + 1;             // [stage], one ring per operand
  uint64_t* v_full = k_full + kWgStages;
  uint64_t* k_empty = v_full + kWgStages;
  uint64_t* v_empty = k_empty + kWgStages;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  int lo, hi;
  kv_range(a, q0, &lo, &hi, kWgBQ, BK);
  const int n_tiles = hi - lo + 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2 * 128);
      hopper::mbar_init(&v_empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: Q once, then K and V through their rings -----------
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < kHalves; ++c) {
        hopper::tma_load_3d(Qs + c * kWgBQ * 64, &tq, q_full, c * 64, q0,
                            b * a.Hq + h);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWgStages;
        const uint32_t free_par = ((i / kWgStages) & 1) ^ 1;
        const int row = (lo + i) * BK, plane = b * a.Hkv + kvh;
        hopper::mbar_wait(&k_empty[s], free_par);
        hopper::mbar_expect_tx(&k_full[s], T::kKVBytes);
        for (int c = 0; c < kHalves; ++c) {
          hopper::tma_load_3d(Ks + s * BK * D + c * BK * 64, &tk, &k_full[s],
                              c * 64, row, plane);
        }
        hopper::mbar_wait(&v_empty[s], free_par);
        hopper::mbar_expect_tx(&v_full[s], T::kKVBytes);
        for (int c = 0; c < kHalves; ++c) {
          hopper::tma_load_3d(Vs + s * BK * D + c * BK * 64, &tv, &v_full[s],
                              c * 64, row, plane);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ------------------------------------
    hopper::setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tq4 = lane & 3;
    const int rq0 = q0 + wg * 64;              // this warpgroup's first row
    const int row0 = rq0 + w * 16 + g;         // rows row0 and row0 + 8
    const float c = a.scale * kLog2e;
    float oacc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) oacc[j] = 0.0f;
    float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};
    const uint32_t q_base = hopper::smem_u32(Qs) + wg * 64 * 128;
    float sacc[BK / 2];
    hopper::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kWgStages;
      const uint32_t par = (i / kWgStages) & 1;
      hopper::mbar_wait(&k_full[s], par);
      issue_s<D, BK>(sacc, q_base, hopper::smem_u32(Ks + s * BK * D));
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) hopper::reg_fence(sacc[j]);
      hopper::mbar_arrive(&k_empty[s]);
      float corr[2];
      const int k0 = (lo + i) * BK;
      // only tiles that cross the diagonal, the window's edge or Skv mask
      const bool edge = k0 + BK > a.Skv ||
                        (a.causal && k0 + BK - 1 > rq0) ||
                        (a.window > 0 && rq0 + 63 - k0 >= a.window);
      if (edge) {
        online_softmax<BK, true>(sacc, m_r, l_r, corr, a, c, row0, k0, tq4);
      } else {
        online_softmax<BK, false>(sacc, m_r, l_r, corr, a, c, row0, k0, tq4);
      }
      rescale<D>(oacc, corr);
      uint32_t pf[BK / 16][4];
      pack_p<BK>(pf, sacc);
      hopper::mbar_wait(&v_full[s], par);
      issue_pv<D, BK>(oacc, pf, hopper::smem_u32(Vs + s * BK * D));
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < D / 2; ++j) hopper::reg_fence(oacc[j]);
      hopper::mbar_arrive(&v_empty[s]);
    }
    uint16_t* ob = o + (size_t)(b * a.Hq + h) * a.S * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.S) continue;
      const float den = fmaxf(l_r[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + j * 8 + 2 * tq4) =
            pack_bf16(oacc[4 * j + 2 * r] / den,
                      oacc[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

// Launches of each kernel (0 wgmma bf16, 1 mma.sync bf16, 2 FFMA f32),
// counted beside each launch.
int g_launches[3] = {0, 0, 0};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime's entry
// point query: no -lcuda in the link line.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (d, rows, planes) bf16 tensor as boxes of 64 columns x box_rows rows,
// swizzled by 128 bytes; rows past the end read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int d, int rows,
                int planes, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Attn& a, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, D, a.S, a.B * a.Hq, kWgBQ) ||
      !tensor_map(&tk, k, D, a.Skv, a.B * a.Hkv, BK) ||
      !tensor_map(&tv, v, D, a.Skv, a.B * a.Hkv, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = WgTile<D, BK>::kSmem;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_wgmma<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((a.S + kWgBQ - 1) / kWgBQ, a.Hq, a.B);
  flash_bf16_wgmma<D, BK><<<grid, kWgThreads, smem, s>>>(tq, tk, tv,
                                                        (uint16_t*)o, a);
  ++g_launches[0];
  return (int)cudaGetLastError();
}

template <int DCAP>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           const Attn& a, cudaStream_t s) {
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.Hq, a.B);
  if (bf16) {
    const size_t smem = ((size_t)(kBQ + kBK) * (a.D + 8) +
                         (size_t)a.D * (kBK + 8)) * sizeof(uint16_t);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16<DCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16<DCAP><<<grid, 128, smem, s>>>(
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
        (uint16_t*)o, a);
    ++g_launches[1];
  } else {
    const size_t smem = ((size_t)a.D * (kBQ + kBK) + (size_t)kBK * a.D +
                         (size_t)kBK * kBQ) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32<DCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32<DCAP><<<grid, 256, smem, s>>>((const float*)q, (const float*)k,
                                            (const float*)v, (float*)o, a);
    ++g_launches[2];
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hkv, Skv, D), contiguous, all f32 or all bf16
// (bf16 != 0) -> o like q. Hq a multiple of Hkv; D a multiple of 16 in
// [16, 256]; window 0 for none (the wrapper passes 0 for a window >= S).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int S, int Skv, int D,
                                     int causal, int window, float scale,
                                     int bf16, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      Skv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  const Attn a{B, Hq, Hkv, S, Skv, D, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64) return launch<64>(bf16 != 0, q, k, v, o, a, s);
  if (D <= 128) return launch<128>(bf16 != 0, q, k, v, o, a, s);
  if (D <= 192) return launch<192>(bf16 != 0, q, k, v, o, a, s);
  return launch<256>(bf16 != 0, q, k, v, o, a, s);
}

// The bf16 kernel on wgmma and TMA, for D = 64, 128 or 256 (the wrapper
// takes it for those); arguments as repro_flash_attention.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Hq, int Hkv, int S, int Skv,
                                           int D, int causal, int window,
                                           float scale, void* stream) {
  if ((D != 64 && D != 128 && D != 256) || Hkv <= 0 || Hq % Hkv != 0 ||
      Skv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  const Attn a{B, Hq, Hkv, S, Skv, D, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_wgmma<64, 128>(q, k, v, o, a, s);
  if (D == 128) return launch_wgmma<128, 128>(q, k, v, o, a, s);
  return launch_wgmma<256, 64>(q, k, v, o, a, s);
}

// Launches of kernel `kernel` (0 wgmma bf16, 1 mma.sync bf16, 2 FFMA f32)
// since the last reset; reset != 0 sets that count to 0 after reading it.
extern "C" int repro_flash_attention_device_launches(int kernel, int reset) {
  if (kernel < 0 || kernel > 2) return -1;
  const int n = g_launches[kernel];
  if (reset) g_launches[kernel] = 0;
  return n;
}
