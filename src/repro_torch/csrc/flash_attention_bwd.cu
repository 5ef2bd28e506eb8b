// K9's backward: dQ, dK and dV of the attention of flash_attention.cu.
//
// Replaces no TPU kernel: the JAX package differentiates its plain jnp
// attention (models/attention.py) and its Pallas flash kernel has no
// custom_vjp. The port's training step runs its attention forward on K9, so
// K9 needs this gradient. It is the gradient of
// repro_torch/kernels/flash_attention.py::flash_attention_plain for every
// mask the forward takes (causal, window, neither; Sq != Skv), GQA (the
// G = Hq / Hkv query heads of a group summed into one dK, dV) and `scale`;
// the plain version is autograd through it (flash_attention_plain_bwd).
//
// With s = scale q.k, the forward's row logsumexp lse (flash_attention.cu
// writes it when asked) and dO the output's gradient:
//   P = exp(s - lse) on the valid pairs, 0 elsewhere;  dP = dO V^T;
//   Dr = rowsum(P o dP);  dS = P o (dP - Dr);
//   dV = P^T dO;  dK = scale dS^T Q;  dQ = scale dS K.
// Dr is summed here from P and dP, not from the forward's rounded output
// (rowsum(dO o O)): a bf16 O would put its rounding into every dS of the
// row. Two kernels, no atomics, so a second run is bitwise equal:
//   dq_*: one block a (batch, q head, q tile); it loops over the kv tiles
//     the tile sees twice, first summing Dr (written out for the second
//     kernel), then dQ;
//   dkdv_*: one block a (batch, kv head, kv tile); it loops over the G
//     heads of the group and the q tiles that see the tile, accumulating dK
//     and dV in registers in a fixed order.
// bf16 (dq_bf16, dkdv_bf16): mma.sync m16n8k16, bf16 in, f32 accumulate,
//   fragments as K9's mma.sync kernel lays them out; P and dS go from the
//   accumulators to the A operand in registers as a pair of bf16 values
//   (hi = rn(x), lo = rn(x - hi)), two products each, so their rounding
//   (2^-9 relative with one bf16) drops to about 2^-17 and the result's
//   error is its final rounding to bf16. Each warp owns 16 rows (q rows in
//   dq, keys in dkdv). Tiles are loaded synchronously into shared memory,
//   rows padded by 8 elements; K (in dq) and Q, dO (in dkdv) also
//   transposed, for the B operands of dS K, dS^T Q and P^T dO. At D > 128
//   dK and dV do not fit one thread's registers together: dkdv runs twice,
//   once for each.
// f32 (dq_f32, dkdv_f32): FFMA, for f32 at D other than 64 and 128 (at D
//   = 256 the TF32 design's hi and lo tiles do not fit shared memory); at
//   D = 64 and 128 f32 runs on csrc/flash_attention_tf32.cu, TF32 wgmma
//   with three products to the product, bounded by those products at 495
//   TFLOP/s. 256 threads over 32 x 32 tiles, two rows x two columns of
//   each score tile a thread, rows of shared memory padded by one float; P
//   and dS go through shared memory.
// Rows with no valid key (a window with q_pos >= Skv + window - 1) are
// refused by the wrapper: the forward gives them the mean of V, which no
// logsumexp of the valid keys describes.
//
// Bound on the H100: operations. Five matrix products of 2 D flops a valid
// (q, k) pair and head (Q K^T, dO V^T, P^T dO, dS K, dS^T Q) against 989
// TFLOP/s (bf16) or 67 TFLOP/s (FFMA f32; f32-accurate products on the
// tensor cores, three TF32 ones each at 495 TFLOP/s, bound f32 attention
// below that, and flash_attention_tf32.cu takes them). These kernels do
// more: Q K^T and dO V^T twice (once in each kernel) and once more for Dr,
// and the split products twice, 12 products in all; mma.sync and
// synchronous loads reach a fraction of the wgmma rate (bf16 at D = 64, 128
// and 256 runs on flash_attention_bwd_wgmma.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Bwd {
  int B, Hq, Hkv, S, Skv, D, causal, window;
  float scale;
};

__device__ __forceinline__ bool valid(const Bwd& a, int q, int k) {
  return q < a.S && k < a.Skv && !(a.causal && k > q) &&
         !(a.window > 0 && q - k >= a.window);
}

// P of one pair from its raw score and its row's logsumexp
__device__ __forceinline__ float prob(const Bwd& a, float s, float lse, int q,
                                      int k) {
  return valid(a, q, k) ? expf(s * a.scale - lse) : 0.0f;
}

// The kv tiles [lo, hi] of `bk` keys that the `bq`-row q tile at q0 sees.
__device__ __forceinline__ void kv_tiles(const Bwd& a, int q0, int bq, int bk,
                                         int* lo, int* hi) {
  const int q_last = min(q0 + bq, a.S) - 1;
  *lo = 0;
  *hi = (a.Skv + bk - 1) / bk - 1;
  if (a.causal) *hi = min(*hi, q_last / bk);
  if (a.window > 0) *lo = max(0, q0 - a.window + 1) / bk;
}

// The q tiles [lo, hi] of `bq` rows that see the `bk`-key tile at k0.
__device__ __forceinline__ void q_tiles(const Bwd& a, int k0, int bk, int bq,
                                        int* lo, int* hi) {
  const int k_last = min(k0 + bk, a.Skv) - 1;
  *lo = a.causal ? k0 / bq : 0;
  *hi = (a.S - 1) / bq;
  if (a.window > 0) *hi = min(*hi, (k_last + a.window - 1) / bq);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x0, x1) as hi + lo, each a pair of bf16 packed as an A fragment register
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [r0, r0 + n) of a (rows, D) bf16 matrix into shared memory, row
// stride ld, zeros past `rows`
__device__ __forceinline__ void load_rows(uint16_t* dst, int ld,
                                          const uint16_t* src, int r0, int n,
                                          int rows, int D) {
  const int vec = D / 8;
  for (int e = threadIdx.x; e < n * vec; e += blockDim.x) {
    const int r = e / vec, c = e - r * vec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// the same rows transposed: dst[d][r], row stride ldt
__device__ __forceinline__ void load_cols(uint16_t* dst, int ldt,
                                          const uint16_t* src, int r0, int n,
                                          int rows, int D) {
  const int vec = D / 8;
  for (int e = threadIdx.x; e < n * vec; e += blockDim.x) {
    const int r = e % n, c = e / n;   // neighbouring threads: rows
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c * 8);
    }
    const uint16_t* x = reinterpret_cast<const uint16_t*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c * 8 + i) * ldt + r] = x[i];
  }
}

// acc[16 x 8 n] = A (16 rows at a, row stride ld) . B^T (N rows at b) over
// D: the warp's 16 rows against N rows, both [row][d] in shared memory
template <int N>
__device__ __forceinline__ void rows_dot(float (*acc)[4], const uint16_t* a,
                                         const uint16_t* b, int ld, int D,
                                         int g, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint16_t* pa = a + g * ld + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(pa), ld32(pa + 8 * ld), ld32(pa + 8),
                            ld32(pa + 8 * ld + 8)};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint16_t* pb = b + (j * 8 + g) * ld + kk * 16 + 2 * t;
      mma_bf16(acc[j], af, ld32(pb), ld32(pb + 8));
    }
  }
}

// out[16 x D] += X (16 x N, the accumulators of rows_dot, split into bf16
// hi + lo) . Bt^T, Bt [D][N] in shared memory (row stride ldt)
template <int DCAP, int N>
__device__ __forceinline__ void acc_split(float (*out)[4], float (*x)[4],
                                          const uint16_t* bt, int ldt, int D,
                                          int g, int t) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], &hi[0], &lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], &hi[1], &lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], &hi[2], &lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], &hi[3], &lo[3]);
#pragma unroll
    for (int j = 0; j < DCAP / 8; ++j) {
      if (j < D / 8) {
        const uint16_t* pb = bt + (j * 8 + g) * ldt + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(pb), b1 = ld32(pb + 8);
        mma_bf16(out[j], hi, b0, b1);
        mma_bf16(out[j], lo, b0, b1);
      }
    }
  }
}

constexpr int kRows = 64;   // rows a bf16 block (4 warps x 16)
constexpr int kBQ = 32;     // q rows a tile in dkdv_bf16

template <int DCAP, int BK>
__global__ void __launch_bounds__(128)
    dq_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
            const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ dsum,
            uint16_t* __restrict__ dq, Bwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ld = D + 8, ldt = BK + 8;
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);  // [kRows][ld]
  uint16_t* dOs = Qs + kRows * ld;                   // [kRows][ld]
  uint16_t* Ks = dOs + kRows * ld;                   // [BK][ld]
  uint16_t* Vs = Ks + BK * ld;                       // [BK][ld]
  uint16_t* Kt = Vs + BK * ld;                       // [D][ldt]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const size_t qrow = (size_t)(b * a.Hq + h) * a.S;
  const uint16_t* kb = k + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  const uint16_t* vb = v + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  load_rows(Qs, ld, q + qrow * D, q0, kRows, a.S, D);
  load_rows(dOs, ld, dout + qrow * D, q0, kRows, a.S, D);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float lse_r[2], d_r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < a.S ? lse[qrow + row] : 0.0f;
  }
  int lo, hi;
  kv_tiles(a, q0, kRows, BK, &lo, &hi);
  const uint16_t* qw = Qs + warp * 16 * ld;
  const uint16_t* dow = dOs + warp * 16 * ld;
  float s[BK / 8][4], dp[BK / 8][4];
  // ---- pass 1: Dr = rowsum(P o dP) ---------------------------------------
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows(Ks, ld, kb, k0, BK, a.Skv, D);
    load_rows(Vs, ld, vb, k0, BK, a.Skv, D);
    __syncthreads();
    rows_dot<BK>(s, qw, Ks, ld, D, g, t);
    rows_dot<BK>(dp, dow, Vs, ld, D, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = prob(a, s[j][e], lse_r[r], row0 + 8 * r,
                             k0 + j * 8 + 2 * t + (e & 1));
        d_r[r] += p * dp[j][e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_r[r] += __shfl_xor_sync(0xffffffffu, d_r[r], 1);
    d_r[r] += __shfl_xor_sync(0xffffffffu, d_r[r], 2);
    const int row = row0 + 8 * r;
    if (t == 0 && row < a.S) dsum[qrow + row] = d_r[r];
  }
  // ---- pass 2: dQ = scale dS K -------------------------------------------
  float acc[DCAP / 8][4];
#pragma unroll
  for (int j = 0; j < DCAP / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows(Ks, ld, kb, k0, BK, a.Skv, D);
    load_rows(Vs, ld, vb, k0, BK, a.Skv, D);
    load_cols(Kt, ldt, kb, k0, BK, a.Skv, D);
    __syncthreads();
    rows_dot<BK>(s, qw, Ks, ld, D, g, t);
    rows_dot<BK>(dp, dow, Vs, ld, D, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = prob(a, s[j][e], lse_r[r], row0 + 8 * r,
                             k0 + j * 8 + 2 * t + (e & 1));
        s[j][e] = p * (dp[j][e] - d_r[r]);   // dS
      }
    }
    acc_split<DCAP, BK>(acc, s, Kt, ldt, D, g, t);
  }
  uint16_t* dqb = dq + qrow * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < DCAP / 8; ++j) {
      if (j < D / 8) {
        *reinterpret_cast<uint32_t*>(dqb + (size_t)row * D + j * 8 + 2 * t) =
            pack_bf16(acc[j][2 * r] * a.scale, acc[j][2 * r + 1] * a.scale);
      }
    }
  }
}

// MODE: 1 dV, 2 dK, 3 both
template <int DCAP, int MODE>
__global__ void __launch_bounds__(128)
    dkdv_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v,
              const uint16_t* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, Bwd a) {
  constexpr bool kDV = MODE & 1, kDK = MODE & 2;
  constexpr int NA = kDK ? DCAP / 8 : 1, NV = kDV ? DCAP / 8 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ld = D + 8, ldt = kBQ + 8;
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);  // [kRows][ld]
  uint16_t* Vs = Ks + kRows * ld;                    // [kRows][ld]
  uint16_t* Qs = Vs + kRows * ld;                    // [kBQ][ld]
  uint16_t* dOs = Qs + kBQ * ld;                     // [kBQ][ld]
  uint16_t* Qt = dOs + kBQ * ld;                     // [D][ldt]
  uint16_t* dOt = Qt + D * ldt;                      // [D][ldt]
  float* lse_s = reinterpret_cast<float*>(dOt + D * ldt);  // [kBQ]
  float* dsum_s = lse_s + kBQ;                             // [kBQ]
  const int k0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const size_t krow = (size_t)(b * a.Hkv + kvh) * a.Skv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  load_rows(Ks, ld, k + krow * D, k0, kRows, a.Skv, D);
  load_rows(Vs, ld, v + krow * D, k0, kRows, a.Skv, D);
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const uint16_t* kw = Ks + warp * 16 * ld;
  const uint16_t* vw = Vs + warp * 16 * ld;
  float dka[NA][4], dva[NV][4];
#pragma unroll
  for (int j = 0; j < NA; ++j) dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.0f;
  int lo, hi;
  q_tiles(a, k0, kRows, kBQ, &lo, &hi);
  float st[kBQ / 8][4], dpt[kBQ / 8][4];
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const size_t qrow = (size_t)(b * a.Hq + h) * a.S;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();
      load_rows(Qs, ld, q + qrow * D, q0, kBQ, a.S, D);
      if constexpr (kDK) {
        load_rows(dOs, ld, dout + qrow * D, q0, kBQ, a.S, D);
        load_cols(Qt, ldt, q + qrow * D, q0, kBQ, a.S, D);
      }
      if constexpr (kDV) load_cols(dOt, ldt, dout + qrow * D, q0, kBQ, a.S, D);
      for (int i = threadIdx.x; i < kBQ; i += blockDim.x) {
        const bool in = q0 + i < a.S;
        lse_s[i] = in ? lse[qrow + q0 + i] : 0.0f;
        dsum_s[i] = in && kDK ? dsum[qrow + q0 + i] : 0.0f;
      }
      __syncthreads();
      rows_dot<kBQ>(st, kw, Qs, ld, D, g, t);   // S^T: 16 keys x kBQ rows
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          st[j][e] = prob(a, st[j][e], lse_s[c], q0 + c, key0 + 8 * (e >> 1));
        }
      }
      if constexpr (kDV) acc_split<DCAP, kBQ>(dva, st, dOt, ldt, D, g, t);
      if constexpr (kDK) {
        rows_dot<kBQ>(dpt, vw, dOs, ld, D, g, t);   // dP^T
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + 2 * t + (e & 1);
            dpt[j][e] = st[j][e] * (dpt[j][e] - dsum_s[c]);   // dS^T
          }
        }
        acc_split<DCAP, kBQ>(dka, dpt, Qt, ldt, D, g, t);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < DCAP / 8; ++j) {
      if (j < D / 8) {
        const size_t at = (krow + key) * D + j * 8 + 2 * t;
        if constexpr (kDK) {
          *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(
              dka[j][2 * r] * a.scale, dka[j][2 * r + 1] * a.scale);
        }
        if constexpr (kDV) {
          *reinterpret_cast<uint32_t*>(dv + at) =
              pack_bf16(dva[j][2 * r], dva[j][2 * r + 1]);
        }
      }
    }
  }
}

// ---- f32: FFMA over 32 x 32 tiles ---------------------------------------
constexpr int kFT = 32;   // rows and columns of an f32 tile

// rows [r0, r0 + kFT) of a (rows, D) f32 matrix, row stride D + 1, zeros
// past `rows`
__device__ __forceinline__ void load_f32(float* dst, const float* src, int r0,
                                         int rows, int D) {
  for (int e = threadIdx.x; e < kFT * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    dst[r * (D + 1) + c] = r0 + r < rows ? src[(size_t)(r0 + r) * D + c] : 0.0f;
  }
}

// s[i][j] = sum_d A[ra + i][d] B[rb + j][d], i, j < 2 (row stride D + 1)
__device__ __forceinline__ void dot2x2(float (*s)[2], const float* A, int ra,
                                       const float* B, int rb, int D) {
  s[0][0] = s[0][1] = s[1][0] = s[1][1] = 0.0f;
  const float* a0 = A + ra * (D + 1);
  const float* b0 = B + rb * (D + 1);
  for (int d = 0; d < D; ++d) {
    const float x0 = a0[d], x1 = a0[D + 1 + d];
    const float y0 = b0[d], y1 = b0[D + 1 + d];
    s[0][0] = fmaf(x0, y0, s[0][0]);
    s[0][1] = fmaf(x0, y1, s[0][1]);
    s[1][0] = fmaf(x1, y0, s[1][0]);
    s[1][1] = fmaf(x1, y1, s[1][1]);
  }
}

// acc[i][j] += sum_c T[r + i][c] M[c][col_j], col_j = cg + 16 j; T is a
// kFT x kFT tile (row stride kFT + 1), M kFT rows of D (row stride D + 1).
// The tile's sum is taken apart and then added: a chain of kFT products a
// tile instead of one of every product (the plain version's f32 products
// are blocked too; one long chain left the kernel 3x its error at G = 7).
template <int NC>
__device__ __forceinline__ void acc2(float (*acc)[NC], const float* T, int r,
                                     const float* M, int cg, int D) {
  float part[2][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) part[0][j] = part[1][j] = 0.0f;
  for (int c = 0; c < kFT; ++c) {
    const float t0 = T[r * (kFT + 1) + c], t1 = T[(r + 1) * (kFT + 1) + c];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = cg + 16 * j;
      if (col < D) {
        const float m = M[c * (D + 1) + col];
        part[0][j] = fmaf(t0, m, part[0][j]);
        part[1][j] = fmaf(t1, m, part[1][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    acc[0][j] += part[0][j];
    acc[1][j] += part[1][j];
  }
}

template <int DCAP>
__global__ void __launch_bounds__(256)
    dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, float* __restrict__ dsum,
           float* __restrict__ dq, Bwd a) {
  constexpr int NC = DCAP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ldf = D + 1;
  float* Qs = reinterpret_cast<float*>(smem);   // [kFT][ldf]
  float* dOs = Qs + kFT * ldf;
  float* Ks = dOs + kFT * ldf;
  float* Vs = Ks + kFT * ldf;
  float* dSs = Vs + kFT * ldf;                  // [kFT][kFT + 1]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const size_t qrow = (size_t)(b * a.Hq + h) * a.S;
  const float* kb = k + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  const float* vb = v + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int r = 2 * rg, c = 2 * cg;   // this thread's rows and keys of a tile
  load_f32(Qs, q + qrow * D, q0, a.S, D);
  load_f32(dOs, dout + qrow * D, q0, a.S, D);
  float lse_r[2], d_r[2] = {0.0f, 0.0f};
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = q0 + r + i < a.S ? lse[qrow + q0 + r + i] : 0.0f;
  }
  int lo, hi;
  kv_tiles(a, q0, kFT, kFT, &lo, &hi);
  float s[2][2], dp[2][2];
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kFT;
    __syncthreads();
    load_f32(Ks, kb, k0, a.Skv, D);
    load_f32(Vs, vb, k0, a.Skv, D);
    __syncthreads();
    dot2x2(s, Qs, r, Ks, c, D);
    dot2x2(dp, dOs, r, Vs, c, D);
    for (int i = 0; i < 2; ++i) {
      for (int j = 0; j < 2; ++j) {
        d_r[i] += prob(a, s[i][j], lse_r[i], q0 + r + i, k0 + c + j) *
                  dp[i][j];
      }
    }
  }
  for (int i = 0; i < 2; ++i) {
    for (int off = 1; off < 16; off <<= 1) {
      d_r[i] += __shfl_xor_sync(0xffffffffu, d_r[i], off);
    }
    if (cg == 0 && q0 + r + i < a.S) dsum[qrow + q0 + r + i] = d_r[i];
  }
  float acc[2][NC];
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kFT;
    __syncthreads();
    load_f32(Ks, kb, k0, a.Skv, D);
    load_f32(Vs, vb, k0, a.Skv, D);
    __syncthreads();
    dot2x2(s, Qs, r, Ks, c, D);
    dot2x2(dp, dOs, r, Vs, c, D);
    for (int i = 0; i < 2; ++i) {
      for (int j = 0; j < 2; ++j) {
        const float p = prob(a, s[i][j], lse_r[i], q0 + r + i, k0 + c + j);
        dSs[(r + i) * (kFT + 1) + c + j] = p * (dp[i][j] - d_r[i]);
      }
    }
    __syncthreads();
    acc2<NC>(acc, dSs, r, Ks, cg, D);
  }
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r + i;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = cg + 16 * j;
      if (col < D) dq[(qrow + row) * D + col] = acc[i][j] * a.scale;
    }
  }
}

template <int DCAP>
__global__ void __launch_bounds__(256)
    dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             float* __restrict__ dk, float* __restrict__ dv, Bwd a) {
  constexpr int NC = DCAP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ldf = D + 1;
  float* Ks = reinterpret_cast<float*>(smem);   // [kFT][ldf]
  float* Vs = Ks + kFT * ldf;
  float* Qs = Vs + kFT * ldf;
  float* dOs = Qs + kFT * ldf;
  float* Pt = dOs + kFT * ldf;                  // [kFT keys][kFT + 1]
  float* dSt = Pt + kFT * (kFT + 1);
  float* lse_s = dSt + kFT * (kFT + 1);         // [kFT]
  float* dsum_s = lse_s + kFT;
  const int k0 = blockIdx.x * kFT;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const size_t krow = (size_t)(b * a.Hkv + kvh) * a.Skv;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int r = 2 * rg, c = 2 * cg;   // this thread's keys and q rows
  load_f32(Ks, k + krow * D, k0, a.Skv, D);
  load_f32(Vs, v + krow * D, k0, a.Skv, D);
  float dka[2][NC], dva[2][NC];
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[i][j] = dva[i][j] = 0.0f;
  }
  int lo, hi;
  q_tiles(a, k0, kFT, kFT, &lo, &hi);
  float st[2][2], dpt[2][2];
  for (int hh = 0; hh < G; ++hh) {
    const size_t qrow = (size_t)(b * a.Hq + kvh * G + hh) * a.S;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * kFT;
      __syncthreads();
      load_f32(Qs, q + qrow * D, q0, a.S, D);
      load_f32(dOs, dout + qrow * D, q0, a.S, D);
      for (int i = threadIdx.x; i < kFT; i += blockDim.x) {
        const bool in = q0 + i < a.S;
        lse_s[i] = in ? lse[qrow + q0 + i] : 0.0f;
        dsum_s[i] = in ? dsum[qrow + q0 + i] : 0.0f;
      }
      __syncthreads();
      dot2x2(st, Ks, r, Qs, c, D);
      dot2x2(dpt, Vs, r, dOs, c, D);
      for (int i = 0; i < 2; ++i) {
        for (int j = 0; j < 2; ++j) {
          const float p = prob(a, st[i][j], lse_s[c + j], q0 + c + j,
                               k0 + r + i);
          Pt[(r + i) * (kFT + 1) + c + j] = p;
          dSt[(r + i) * (kFT + 1) + c + j] = p * (dpt[i][j] - dsum_s[c + j]);
        }
      }
      __syncthreads();
      acc2<NC>(dva, Pt, r, dOs, cg, D);
      acc2<NC>(dka, dSt, r, Qs, cg, D);
    }
  }
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r + i;
    if (key >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = cg + 16 * j;
      if (col < D) {
        dk[(krow + key) * D + col] = dka[i][j] * a.scale;
        dv[(krow + key) * D + col] = dva[i][j];
      }
    }
  }
}

// Launches of each kernel (0 dq bf16, 1 dkdv bf16, 2 dq f32, 3 dkdv f32),
// counted beside each launch.
int g_launches[4] = {0, 0, 0, 0};

template <typename K>
cudaError_t size_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DCAP>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, float* dsum, void* dq, void* dk, void* dv,
                const Bwd& a, cudaStream_t s) {
  constexpr int BK = DCAP > 128 ? 32 : 64;
  const size_t ld = a.D + 8;
  const uint16_t *q_ = (const uint16_t*)q, *k_ = (const uint16_t*)k,
                 *v_ = (const uint16_t*)v, *o_ = (const uint16_t*)dout;
  const size_t smem_q = ((2 * kRows + 2 * BK) * ld + (size_t)a.D * (BK + 8)) *
                        sizeof(uint16_t);
  cudaError_t err = size_smem(dq_bf16<DCAP, BK>, smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_bf16<DCAP, BK><<<dim3((a.S + kRows - 1) / kRows, a.Hq, a.B), 128, smem_q,
                      s>>>(q_, k_, v_, o_, lse, dsum, (uint16_t*)dq, a);
  ++g_launches[0];
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_kv = ((2 * kRows + 2 * kBQ) * ld +
                          2 * (size_t)a.D * (kBQ + 8)) * sizeof(uint16_t) +
                         2 * kBQ * sizeof(float);
  const dim3 grid((a.Skv + kRows - 1) / kRows, a.Hkv, a.B);
  if (DCAP <= 128) {
    err = size_smem(dkdv_bf16<DCAP, 3>, smem_kv);
    if (err != cudaSuccess) return (int)err;
    dkdv_bf16<DCAP, 3><<<grid, 128, smem_kv, s>>>(
        q_, k_, v_, o_, lse, dsum, (uint16_t*)dk, (uint16_t*)dv, a);
    ++g_launches[1];
    return (int)cudaGetLastError();
  }
  err = size_smem(dkdv_bf16<DCAP, 1>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_bf16<DCAP, 1><<<grid, 128, smem_kv, s>>>(
      q_, k_, v_, o_, lse, dsum, (uint16_t*)dk, (uint16_t*)dv, a);
  ++g_launches[1];
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = size_smem(dkdv_bf16<DCAP, 2>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_bf16<DCAP, 2><<<grid, 128, smem_kv, s>>>(
      q_, k_, v_, o_, lse, dsum, (uint16_t*)dk, (uint16_t*)dv, a);
  ++g_launches[1];
  return (int)cudaGetLastError();
}

template <int DCAP>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, float* dsum, void* dq, void* dk, void* dv,
               const Bwd& a, cudaStream_t s) {
  const size_t tile = (size_t)kFT * (a.D + 1);
  const size_t smem_q = (4 * tile + kFT * (kFT + 1)) * sizeof(float);
  cudaError_t err = size_smem(dq_f32<DCAP>, smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_f32<DCAP><<<dim3((a.S + kFT - 1) / kFT, a.Hq, a.B), 256, smem_q, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, dsum, (float*)dq, a);
  ++g_launches[2];
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_kv =
      (4 * tile + 2 * kFT * (kFT + 1) + 2 * kFT) * sizeof(float);
  err = size_smem(dkdv_f32<DCAP>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_f32<DCAP><<<dim3((a.Skv + kFT - 1) / kFT, a.Hkv, a.B), 256, smem_kv,
                   s>>>((const float*)q, (const float*)k, (const float*)v,
                        (const float*)dout, lse, dsum, (float*)dk, (float*)dv,
                        a);
  ++g_launches[3];
  return (int)cudaGetLastError();
}

template <int DCAP>
int launch(bool bf16, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, const Bwd& a, cudaStream_t s) {
  return bf16 ? launch_bf16<DCAP>(q, k, v, dout, lse, dsum, dq, dk, dv, a, s)
              : launch_f32<DCAP>(q, k, v, dout, lse, dsum, dq, dk, dv, a, s);
}

}  // namespace

// q, dout (B, Hq, S, D); k, v (B, Hkv, Skv, D); lse (B, Hq, S) f32 from the
// forward; dsum (B, Hq, S) f32 scratch (written, then read); dq like q, dk
// and dv like k. Contiguous, all f32 or all bf16 (bf16 != 0); D a multiple
// of 16 in [16, 256]; window 0 for none (as the forward takes it), and no
// row without a valid key. Two launches (three for bf16 at D > 128).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dsum, void* dq, void* dk, void* dv, int B, int Hq,
    int Hkv, int S, int Skv, int D, int causal, int window, float scale,
    int bf16, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      Skv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  const Bwd a{B, Hq, Hkv, S, Skv, D, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* ds = (float*)dsum;
  const bool h = bf16 != 0;
  if (D <= 64) return launch<64>(h, q, k, v, dout, l, ds, dq, dk, dv, a, s);
  if (D <= 128) return launch<128>(h, q, k, v, dout, l, ds, dq, dk, dv, a, s);
  if (D <= 192) return launch<192>(h, q, k, v, dout, l, ds, dq, dk, dv, a, s);
  return launch<256>(h, q, k, v, dout, l, ds, dq, dk, dv, a, s);
}

// Launches of kernel `kernel` (0 dq bf16, 1 dkdv bf16, 2 dq f32, 3 dkdv
// f32) since the last reset; reset != 0 sets that count to 0 after reading.
extern "C" int repro_flash_attention_bwd_device_launches(int kernel,
                                                         int reset) {
  if (kernel < 0 || kernel > 3) return -1;
  const int n = g_launches[kernel];
  if (reset) g_launches[kernel] = 0;
  return n;
}
