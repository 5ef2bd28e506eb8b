// K9's backward in bf16 on Hopper's wgmma and TMA, for D = 64, 128 and 256
// (the forward's wgmma head dimensions): dQ, dK and dV of the attention of
// flash_attention.cu.
//
// Replaces no TPU kernel, as flash_attention_bwd.cu does not: the JAX
// package differentiates its plain jnp attention (models/attention.py) and
// its Pallas flash kernel has no custom_vjp. It computes what
// flash_attention_bwd.cu's bf16 kernels compute, the gradient of
// repro_torch/kernels/flash_attention.py::flash_attention_plain for every
// mask the forward takes (causal, window, neither; Sq != Skv), GQA and
// `scale`, from the forward's row logsumexp lse:
//   P = exp(s - lse) on the valid pairs, 0 elsewhere;  dP = dO V^T;
//   Dr = rowsum(P o dP);  dS = P o (dP - Dr);
//   dV = P^T dO;  dK = scale dS^T Q;  dQ = scale dS K.
// The numerical contract is that of flash_attention_bwd.cu: P and dS enter
// their products as two bf16 values each (hi = rn(x), lo = rn(x - hi)); Dr
// is summed from P and dP, not from the forward's output; no atomics, every
// sum in a fixed order, so a second call is bitwise equal.
//
// Three kernels:
//   dq_wgmma: one block a (q head, 128-row q tile, batch), the tiles with
//     the most keys launched first. Warpgroups 0 and 1 own 64 q rows each;
//     warpgroup 2 gives its registers back (setmaxnreg) and one of its
//     threads issues the TMA loads: Q and dO once, then K and V tiles (64
//     keys; 32 at D = 256) through a two-stage ring with a "full" and an
//     "empty" mbarrier per operand and stage, twice over the tiles the q
//     tile sees. Pass 1: S = Q K^T and dP = dO V^T (wgmma, both operands
//     K-major in shared memory), Dr = rowsum(P o dP) (quad shuffles),
//     written out for dkdv. Pass 2: S and dP again, dS split hi + lo into
//     register A fragments, dQ += dS K with the K tile of the ring read
//     MN-major: no transposed copy.
//   dkdv_wgmma: one block a (q head, key tile, batch), key tile 0 (the
//     most q tiles under the causal mask) first. K and V arrive once by
//     TMA; Q, dO and the rows' lse and Dr go through a two-stage ring over
//     the 64-row q tiles that see the key tile (warp 0 of warpgroup 2: one
//     lane issues Q and dO, all 32 copy lse and Dr, and arrive). S^T = K
//     Q^T and dP^T = V dO^T are wgmma with both operands in shared memory;
//     P^T and dS^T are split hi + lo in registers; dV += P^T dO and dK +=
//     dS^T Q read dO and Q MN-major. At D <= 128 a block holds 128 keys,
//     warpgroup w the 64 keys from 64 w, each with its dK and dV (128 f32
//     registers a thread at D = 128). At D = 256, dK and dV of 64 keys do
//     not fit one thread's registers together (256 f32): a block holds 64
//     keys, warpgroup 0 computes their dV (S^T, then P^T dO) and warpgroup
//     1 their dK (S^T, dP^T, then dS^T Q), on the same tiles of the ring,
//     in one launch. With G = Hq / Hkv > 1 each block writes its q head's
//     dK and dV in f32 to a scratch of (2, B, Hq, Skv, D); at G = 1 it
//     writes bf16 directly.
//   group_sum: at G > 1, each group's G partials summed in head order, dK
//     scaled, each rounded once to bf16.
// A block per q head and key tile, instead of a kv head looping over its
// group, gives Hq x Skv / 128 blocks (896 at qwen2-7b's S = 4,096, 28 / 4
// heads, against 128), enough to even out the causal triangle; the scratch
// is written and read once (117 MB there, ~0.07 ms at 3.35 TB/s).
// Only tiles that cross the diagonal, the window's edge or Sq / Skv are
// masked; a warpgroup whose 64 rows (or keys) see none of a tile skips its
// products but keeps the ring's barriers. TMA zero-fills rows past Sq and
// Skv (3-D tensor maps (D, rows, B x heads), boxes of 64 columns in the
// 128-byte swizzle, as the forward's).
//
// Bound on the H100: operations. Five matrix products of 2 D flops a valid
// (q, k) pair and head (Q K^T, dO V^T, P^T dO, dS K, dS^T Q) against 989
// TFLOP/s: 0.3041 ms at qwen2-7b's training shape (B = 1, S = 4,096, 28 q
// heads of 128, causal). This design does 12 (S and dP twice in dq and
// once more in dkdv, and the three split products twice): 0.73 ms at the
// same rate, before the masked halves of the diagonal tiles. What it does
// about the mma.sync kernels' limits: wgmma in place of mma.sync m16n8k16;
// TMA loads into rings that overlap the products, in place of synchronous
// loads by every thread between __syncthreads; B operands read MN-major in
// place of transposed copies; a block per q head to fill the card; one
// launch at D = 256. The 12 products remain (Dr needs S and dP before dS).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using hopper::fast_exp2;
using hopper::pack_bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int kRowsQ = 128;     // q rows a dq block
constexpr int kBQ = 64;         // q rows a tile of dkdv's ring

struct Bwd {
  int B, Hq, Hkv, S, Skv, D, causal, window;
  float scale;
};

__device__ __forceinline__ bool valid(const Bwd& a, int q, int k) {
  return q < a.S && k < a.Skv && !(a.causal && k > q) &&
         !(a.window > 0 && q - k >= a.window);
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

// No pair of q rows [q0, q0 + nq) and keys [k0, k0 + nk) is valid
__device__ __forceinline__ bool none_valid(const Bwd& a, int q0, int nq,
                                           int k0, int nk) {
  return q0 >= a.S || k0 >= a.Skv || (a.causal && k0 > q0 + nq - 1) ||
         (a.window > 0 && q0 - (k0 + nk - 1) >= a.window);
}

// Some pair of them is not
__device__ __forceinline__ bool some_invalid(const Bwd& a, int q0, int nq,
                                             int k0, int nk) {
  return q0 + nq > a.S || k0 + nk > a.Skv ||
         (a.causal && k0 + nk - 1 > q0) ||
         (a.window > 0 && q0 + nq - 1 - k0 >= a.window);
}

// x (a 64 x N accumulator) as hi + lo bf16 register A fragments
template <int N>
__device__ __forceinline__ void split_frags(uint32_t (*hi)[4],
                                            uint32_t (*lo)[4],
                                            const float* x) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int j = 0; j < N; ++j) hopper::reg_fence(acc[j]);
}

// acc (64 x N) = A B^T over D: A the warpgroup's 64 rows at a_base of a
// tile of AROWS rows a box, B the N rows of the tile at b_base, both
// K-major; committed, not awaited.
template <int D, int N, int AROWS>
__device__ __forceinline__ void issue_ss(float* acc, uint32_t a_base,
                                         uint32_t b_base) {
  fence_acc<N / 2>(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::wgmma_ss<N>(acc, hopper::kmajor_desc<AROWS>(a_base, kk),
                        hopper::kmajor_desc<N>(b_base, kk), kk > 0);
  }
  hopper::wgmma_commit();
}

// acc (64 x D) += (hi + lo) B: the A fragments of a 64 x K matrix, B the
// K x D tile at b_base (K rows a box, MN-major); not committed.
template <int D, int K>
__device__ __forceinline__ void issue_rs2(float* acc, uint32_t (*hi)[4],
                                          uint32_t (*lo)[4], uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t desc = hopper::mnmajor_desc<K>(b_base, kk);
    hopper::wgmma_rs<D>(acc, hi[kk], desc);
    hopper::wgmma_rs<D>(acc, lo[kk], desc);
  }
}

// P in place of the raw scores of a 64 x N accumulator whose rows are q
// rows (row0, row0 + 8: this thread's) and columns keys from k0; lse2 the
// rows' lse log2(e). EDGE: some pair of the tile may be invalid.
template <int N, bool EDGE>
__device__ __forceinline__ void probs_rows(float* s, const Bwd& a, float c2,
                                           const float* lse2, int row0,
                                           int k0, int tq4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(s[4 * j + e], c2, -lse2[e >> 1]));
      if (EDGE && !valid(a, row0 + 8 * (e >> 1), k0 + 8 * j + 2 * tq4 +
                                                     (e & 1))) {
        p = 0.0f;
      }
      s[4 * j + e] = p;
    }
  }
}

// The same for an accumulator whose rows are keys (key0, key0 + 8) and
// columns q rows from q0, lse2 in shared memory by column.
template <int N, bool EDGE>
__device__ __forceinline__ void probs_cols(float* s, const Bwd& a, float c2,
                                           const float* lse2, int key0,
                                           int q0, int tq4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * tq4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(s[4 * j + e], c2, -((e & 1) ? l.y : l.x)));
      if (EDGE && !valid(a, q0 + 8 * j + 2 * tq4 + (e & 1),
                         key0 + 8 * (e >> 1))) {
        p = 0.0f;
      }
      s[4 * j + e] = p;
    }
  }
}

// ---- dq ---------------------------------------------------------------
template <int D, int BK>
struct DqTile {
  static constexpr int kStages = 2;                // of the K and V ring
  static constexpr int kQBytes = kRowsQ * D * 2;   // Q or dO
  static constexpr int kKVBytes = BK * D * 2;      // a K or V tile
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  2 * kStages * kKVBytes +
                                  8 * (1 + 4 * kStages);
};

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse, float* __restrict__ dsum,
             uint16_t* __restrict__ dq, Bwd a) {
  using T = DqTile<D, BK>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);   // [D/64][128][64]
  uint16_t* dOs = Qs + kRowsQ * D;
  uint16_t* Ks = dOs + kRowsQ * D;                     // [stage][D/64][BK][64]
  uint16_t* Vs = Ks + T::kStages * BK * D;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(Vs + T::kStages * BK * D);
  uint64_t* k_full = qd_full + 1;
  uint64_t* v_full = k_full + T::kStages;
  uint64_t* k_empty = v_full + T::kStages;
  uint64_t* v_empty = k_empty + T::kStages;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsQ;
  const int kvh = h / (a.Hq / a.Hkv);
  int lo, hi;
  kv_tiles(a, q0, kRowsQ, BK, &lo, &hi);
  const int n = hi - lo + 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
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
    // ---- producer: Q and dO once, then K and V twice over the tiles ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(qd_full, 2 * T::kQBytes);
      for (int c = 0; c < kHalves; ++c) {
        hopper::tma_load_3d(Qs + c * kRowsQ * 64, &tq, qd_full, c * 64, q0,
                            b * a.Hq + h);
        hopper::tma_load_3d(dOs + c * kRowsQ * 64, &tdo, qd_full, c * 64, q0,
                            b * a.Hq + h);
      }
      const int plane = b * a.Hkv + kvh;
      for (int i = 0; i < 2 * n; ++i) {
        const int s = i % T::kStages;
        const uint32_t free_par = ((i / T::kStages) & 1) ^ 1;
        const int row = (lo + i % n) * BK;
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
    // ---- consumers: 64 q rows each --------------------------------------
    hopper::setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tq4 = lane & 3;
    const int rq0 = q0 + wg * 64;              // this warpgroup's first row
    const int row0 = rq0 + w * 16 + g;         // rows row0 and row0 + 8
    const size_t qrow = (size_t)(b * a.Hq + h) * a.S;
    const float c2 = a.scale * kLog2e;
    float lse2[2], dr[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < a.S ? lse[qrow + row] * kLog2e : 0.0f;
    }
    const uint32_t q_base = hopper::smem_u32(Qs) + wg * 64 * 128;
    const uint32_t do_base = hopper::smem_u32(dOs) + wg * 64 * 128;
    float dqa[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dqa[j] = 0.0f;
    float sacc[BK / 2], dpacc[BK / 2];
    hopper::mbar_wait(qd_full, 0);
    for (int pass = 0; pass < 2; ++pass) {
      for (int jt = 0; jt < n; ++jt) {
        const int i = pass * n + jt;
        const int s = i % T::kStages;
        const uint32_t par = (i / T::kStages) & 1;
        const int k0 = (lo + jt) * BK;
        if (none_valid(a, rq0, 64, k0, BK)) {
          hopper::mbar_wait(&k_full[s], par);
          hopper::mbar_wait(&v_full[s], par);
          hopper::mbar_arrive(&k_empty[s]);
          hopper::mbar_arrive(&v_empty[s]);
          continue;
        }
        const uint32_t kb = hopper::smem_u32(Ks + s * BK * D);
        const uint32_t vb = hopper::smem_u32(Vs + s * BK * D);
        hopper::mbar_wait(&k_full[s], par);
        issue_ss<D, BK, kRowsQ>(sacc, q_base, kb);
        hopper::mbar_wait(&v_full[s], par);
        issue_ss<D, BK, kRowsQ>(dpacc, do_base, vb);
        hopper::wgmma_wait<0>();
        fence_acc<BK / 2>(sacc);
        fence_acc<BK / 2>(dpacc);
        hopper::mbar_arrive(&v_empty[s]);
        if (some_invalid(a, rq0, 64, k0, BK)) {
          probs_rows<BK, true>(sacc, a, c2, lse2, row0, k0, tq4);
        } else {
          probs_rows<BK, false>(sacc, a, c2, lse2, row0, k0, tq4);
        }
        if (pass == 0) {
          hopper::mbar_arrive(&k_empty[s]);
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) {
            dr[(j & 3) >> 1] += sacc[j] * dpacc[j];
          }
          continue;
        }
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          sacc[j] *= dpacc[j] - dr[(j & 3) >> 1];   // dS
        }
        uint32_t hi_f[BK / 16][4], lo_f[BK / 16][4];
        split_frags<BK>(hi_f, lo_f, sacc);
        fence_acc<D / 2>(dqa);
        hopper::wgmma_fence();
        issue_rs2<D, BK>(dqa, hi_f, lo_f, kb);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_acc<D / 2>(dqa);
        hopper::mbar_arrive(&k_empty[s]);
      }
      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 1);
          dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 2);
          const int row = row0 + 8 * r;
          if (tq4 == 0 && row < a.S) dsum[qrow + row] = dr[r];
        }
      }
    }
    uint16_t* dqb = dq + qrow * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.S) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dqb + (size_t)row * D + j * 8 +
                                     2 * tq4) =
            pack_bf16(dqa[4 * j + 2 * r] * a.scale,
                      dqa[4 * j + 2 * r + 1] * a.scale);
      }
    }
  }
}

// ---- dk, dv -------------------------------------------------------------
template <int D>
struct DkvTile {
  static constexpr int kStages = 2;                   // of the Q, dO ring
  static constexpr int kKeys = D <= 128 ? 128 : 64;   // keys a block
  static constexpr int kKVBytes = kKeys * D * 2;      // K or V
  static constexpr int kQBytes = kBQ * D * 2;         // a Q or dO tile
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes +
                                  2 * kStages * kQBytes +
                                  2 * kStages * kBQ * 4 +
                                  8 * (1 + 2 * kStages);
};

struct DkvSmem {
  const uint16_t* Qs;   // [stage][D/64][64][64]
  const uint16_t* dOs;
  const float* lse2;    // [stage][64], lse log2(e) by q row
  const float* drs;     // [stage][64]
  uint64_t* kv_full;
  uint64_t* full;       // [stage]
  uint64_t* empty;      // [stage]
};

// One consumer warpgroup's 64 keys from k0w, at row k_row of the block's
// K and V tiles (k_base, v_base). MODE: 1 dV, 2 dK, 3 both.
template <int D, int MODE>
__device__ __forceinline__ void dkdv_consume(
    const DkvSmem& sm, uint32_t k_base, uint32_t v_base, const Bwd& a, int b,
    int h, int k0w, int lo, int n, uint16_t* __restrict__ dk,
    uint16_t* __restrict__ dv, float* __restrict__ part) {
  constexpr bool kDV = MODE & 1, kDK = MODE & 2;
  constexpr int kKeys = DkvTile<D>::kKeys;
  constexpr int kStages = DkvTile<D>::kStages;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane >> 2, tq4 = lane & 3;
  const int key0 = k0w + w * 16 + g;          // keys key0 and key0 + 8
  const float c2 = a.scale * kLog2e;
  float dka[kDK ? D / 2 : 1], dva[kDV ? D / 2 : 1];
#pragma unroll
  for (int j = 0; j < (kDK ? D / 2 : 1); ++j) dka[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < (kDV ? D / 2 : 1); ++j) dva[j] = 0.0f;
  float st[kBQ / 2], dpt[kBQ / 2];
  hopper::mbar_wait(sm.kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const uint32_t par = (i / kStages) & 1;
    const int q0 = (lo + i) * kBQ;
    hopper::mbar_wait(&sm.full[s], par);
    if (!none_valid(a, q0, kBQ, k0w, 64)) {
      const uint32_t qb = hopper::smem_u32(sm.Qs + s * kBQ * D);
      const uint32_t dob = hopper::smem_u32(sm.dOs + s * kBQ * D);
      issue_ss<D, kBQ, kKeys>(st, k_base, qb);
      if constexpr (kDK) issue_ss<D, kBQ, kKeys>(dpt, v_base, dob);
      hopper::wgmma_wait<0>();
      fence_acc<kBQ / 2>(st);
      if constexpr (kDK) fence_acc<kBQ / 2>(dpt);
      const float* lse2 = sm.lse2 + s * kBQ;
      if (some_invalid(a, q0, kBQ, k0w, 64)) {
        probs_cols<kBQ, true>(st, a, c2, lse2, key0, q0, tq4);
      } else {
        probs_cols<kBQ, false>(st, a, c2, lse2, key0, q0, tq4);
      }
      uint32_t p_hi[kDV ? kBQ / 16 : 1][4], p_lo[kDV ? kBQ / 16 : 1][4];
      uint32_t ds_hi[kDK ? kBQ / 16 : 1][4], ds_lo[kDK ? kBQ / 16 : 1][4];
      if constexpr (kDK) {
        const float* drs = sm.drs + s * kBQ;
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(drs + 8 * j +
                                                            2 * tq4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dpt[4 * j + e] = st[4 * j + e] *
                             (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
          }
        }
      }
      if constexpr (kDV) split_frags<kBQ>(p_hi, p_lo, st);
      if constexpr (kDK) split_frags<kBQ>(ds_hi, ds_lo, dpt);
      if constexpr (kDV) fence_acc<D / 2>(dva);
      if constexpr (kDK) fence_acc<D / 2>(dka);
      hopper::wgmma_fence();
      if constexpr (kDV) issue_rs2<D, kBQ>(dva, p_hi, p_lo, dob);
      if constexpr (kDK) issue_rs2<D, kBQ>(dka, ds_hi, ds_lo, qb);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if constexpr (kDV) fence_acc<D / 2>(dva);
      if constexpr (kDK) fence_acc<D / 2>(dka);
    }
    hopper::mbar_arrive(&sm.empty[s]);
  }
  const int G = a.Hq / a.Hkv;
  const size_t plane = (size_t)a.Skv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * tq4;
      if (part != nullptr) {   // this q head's partial, f32
        const size_t at = (size_t)(b * a.Hq + h) * plane +
                          (size_t)key * D + col;
        if constexpr (kDK) {
          *reinterpret_cast<float2*>(part + at) =
              make_float2(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        }
        if constexpr (kDV) {
          *reinterpret_cast<float2*>(part + (size_t)a.B * a.Hq * plane +
                                     at) =
              make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      } else {                 // G = 1: the kv head's gradient
        const size_t at = (size_t)(b * a.Hkv + h / G) * plane +
                          (size_t)key * D + col;
        if constexpr (kDK) {
          *reinterpret_cast<uint32_t*>(dk + at) =
              pack_bf16(dka[4 * j + 2 * r] * a.scale,
                        dka[4 * j + 2 * r + 1] * a.scale);
        }
        if constexpr (kDV) {
          *reinterpret_cast<uint32_t*>(dv + at) =
              pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
               float* __restrict__ part, Bwd a) {
  using T = DkvTile<D>;
  constexpr int kKeys = T::kKeys, kStages = T::kStages;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);   // [D/64][kKeys][64]
  uint16_t* Vs = Ks + kKeys * D;
  uint16_t* Qs = Vs + kKeys * D;                       // [stage][D/64][64][64]
  uint16_t* dOs = Qs + kStages * kBQ * D;
  float* lse2_s = reinterpret_cast<float*>(dOs + kStages * kBQ * D);
  float* dr_s = lse2_s + kStages * kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dr_s + kStages * kBQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kKeys;
  const int kvh = h / (a.Hq / a.Hkv);
  int lo, hi;
  q_tiles(a, k0, kKeys, kBQ, &lo, &hi);
  const int n = max(0, hi - lo + 1);
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: K and V once; Q, dO, lse, Dr through the ring --------
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      const size_t qrow = (size_t)(b * a.Hq + h) * a.S;
      if (lane == 0) {
        hopper::mbar_expect_tx(kv_full, 2 * T::kKVBytes);
        for (int c = 0; c < kHalves; ++c) {
          hopper::tma_load_3d(Ks + c * kKeys * 64, &tk, kv_full, c * 64, k0,
                              b * a.Hkv + kvh);
          hopper::tma_load_3d(Vs + c * kKeys * 64, &tv, kv_full, c * 64, k0,
                              b * a.Hkv + kvh);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const uint32_t free_par = ((i / kStages) & 1) ^ 1;
        const int q0 = (lo + i) * kBQ;
        hopper::mbar_wait(&empty[s], free_par);
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], 2 * T::kQBytes);
          for (int c = 0; c < kHalves; ++c) {
            hopper::tma_load_3d(Qs + s * kBQ * D + c * kBQ * 64, &tq,
                                &full[s], c * 64, q0, b * a.Hq + h);
            hopper::tma_load_3d(dOs + s * kBQ * D + c * kBQ * 64, &tdo,
                                &full[s], c * 64, q0, b * a.Hq + h);
          }
        }
        for (int r = lane; r < kBQ; r += 32) {
          const bool in = q0 + r < a.S;
          lse2_s[s * kBQ + r] = in ? lse[qrow + q0 + r] * kLog2e : 0.0f;
          dr_s[s * kBQ + r] = in ? dsum[qrow + q0 + r] : 0.0f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const DkvSmem sm{Qs, dOs, lse2_s, dr_s, kv_full, full, empty};
    const uint32_t k_base = hopper::smem_u32(Ks);
    const uint32_t v_base = hopper::smem_u32(Vs);
    if constexpr (D <= 128) {   // 64 keys each, dK and dV
      dkdv_consume<D, 3>(sm, k_base + wg * 64 * 128, v_base + wg * 64 * 128,
                         a, b, h, k0 + wg * 64, lo, n, dk, dv, part);
    } else if (wg == 0) {       // the same 64 keys: dV here, dK in 1
      dkdv_consume<D, 1>(sm, k_base, v_base, a, b, h, k0, lo, n, dk, dv,
                         part);
    } else {
      dkdv_consume<D, 2>(sm, k_base, v_base, a, b, h, k0, lo, n, dk, dv,
                         part);
    }
  }
}

// dK and dV of each kv head from the G partials of its group (part (2, B,
// Hq, Skv, D) f32, dK's first), summed in head order; dK scaled; rounded
// once to bf16. blockIdx.y: 0 dK, 1 dV.
__global__ void __launch_bounds__(256)
    group_sum(const float* __restrict__ part, uint16_t* __restrict__ dk,
              uint16_t* __restrict__ dv, int B, int Hq, int Hkv, int plane,
              float scale) {
  const int G = Hq / Hkv;
  const float* src = part + blockIdx.y * (size_t)B * Hq * plane;
  uint16_t* dst = blockIdx.y ? dv : dk;
  const float mul = blockIdx.y ? 1.0f : scale;
  const size_t n4 = (size_t)B * Hkv * plane / 4;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t idx = e * 4;
    const size_t pl = idx / plane, off = idx - pl * plane;
    const size_t bb = pl / Hkv, kvh = pl - bb * Hkv;
    const float* p = src + (bb * Hq + kvh * G) * plane + off;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int hh = 1; hh < G; ++hh) {
      const float4 x = *reinterpret_cast<const float4*>(p + hh * (size_t)plane);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<uint2*>(dst + idx) =
        make_uint2(pack_bf16(acc.x * mul, acc.y * mul),
                   pack_bf16(acc.z * mul, acc.w * mul));
  }
}

// Launches of each kernel (0 dq_wgmma, 1 dkdv_wgmma, 2 group_sum), counted
// beside each launch.
int g_launches[3] = {0, 0, 0};

template <typename K>
cudaError_t size_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv,
           float* part, const Bwd& a, cudaStream_t s) {
  constexpr int BK = D == 256 ? 32 : 64;
  constexpr int kKeys = DkvTile<D>::kKeys;
  CUtensorMap tq_dq, tdo_dq, tk_dq, tv_dq, tq_kv, tdo_kv, tk_kv, tv_kv;
  const int pq = a.B * a.Hq, pk = a.B * a.Hkv;
  if (!hopper::tensor_map(&tq_dq, q, D, a.S, pq, kRowsQ) ||
      !hopper::tensor_map(&tdo_dq, dout, D, a.S, pq, kRowsQ) ||
      !hopper::tensor_map(&tk_dq, k, D, a.Skv, pk, BK) ||
      !hopper::tensor_map(&tv_dq, v, D, a.Skv, pk, BK) ||
      !hopper::tensor_map(&tq_kv, q, D, a.S, pq, kBQ) ||
      !hopper::tensor_map(&tdo_kv, dout, D, a.S, pq, kBQ) ||
      !hopper::tensor_map(&tk_kv, k, D, a.Skv, pk, kKeys) ||
      !hopper::tensor_map(&tv_kv, v, D, a.Skv, pk, kKeys)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem_q = DqTile<D, BK>::kSmem;
  constexpr size_t smem_kv = DkvTile<D>::kSmem;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = size_smem(dq_wgmma<D, BK>, smem_q);
    if (err == cudaSuccess) err = size_smem(dkdv_wgmma<D>, smem_kv);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int G = a.Hq / a.Hkv;
  dq_wgmma<D, BK><<<dim3(a.Hq, (a.S + kRowsQ - 1) / kRowsQ, a.B), kThreads,
                    smem_q, s>>>(tq_dq, tdo_dq, tk_dq, tv_dq, lse, dsum,
                                 (uint16_t*)dq, a);
  ++g_launches[0];
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_wgmma<D><<<dim3(a.Hq, (a.Skv + kKeys - 1) / kKeys, a.B), kThreads,
                  smem_kv, s>>>(tq_kv, tdo_kv, tk_kv, tv_kv, lse, dsum,
                                (uint16_t*)dk, (uint16_t*)dv,
                                G > 1 ? part : nullptr, a);
  ++g_launches[1];
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return (int)err;
  const int plane = a.Skv * D;
  const size_t n4 = (size_t)a.B * a.Hkv * plane / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
  group_sum<<<dim3(blocks, 2), 256, 0, s>>>(part, (uint16_t*)dk,
                                            (uint16_t*)dv, a.B, a.Hq, a.Hkv,
                                            plane, a.scale);
  ++g_launches[2];
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout (B, Hq, S, D) bf16; k, v (B, Hkv, Skv, D) bf16; lse (B, Hq, S)
// f32 from the forward; dsum (B, Hq, S) f32 scratch (written by the dq
// kernel, read by dkdv); dq like q, dk and dv like k; part: (2, B, Hq, Skv,
// D) f32 scratch when Hq > Hkv, else unused (may be null). Contiguous, each
// base 16-byte aligned (TMA); D 64, 128 or 256; window 0 for none, and no
// row without a valid key (as repro_flash_attention_bwd). Two launches, a
// third (the group sum) when Hq > Hkv.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dsum, void* dq, void* dk, void* dv, void* part,
    int B, int Hq, int Hkv, int S, int Skv, int D, int causal, int window,
    float scale, void* stream) {
  if ((D != 64 && D != 128 && D != 256) || Hkv <= 0 || Hq % Hkv != 0 ||
      Skv <= 0 || (Hq > Hkv && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  const Bwd a{B, Hq, Hkv, S, Skv, D, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* ds = (float*)dsum;
  float* p = (float*)part;
  if (D == 64) return launch<64>(q, k, v, dout, l, ds, dq, dk, dv, p, a, s);
  if (D == 128) return launch<128>(q, k, v, dout, l, ds, dq, dk, dv, p, a, s);
  return launch<256>(q, k, v, dout, l, ds, dq, dk, dv, p, a, s);
}

// Launches of kernel `kernel` (0 dq_wgmma, 1 dkdv_wgmma, 2 group_sum) since
// the last reset; reset != 0 sets that count to 0 after reading it.
extern "C" int repro_flash_attention_bwd_wgmma_device_launches(int kernel,
                                                               int reset) {
  if (kernel < 0 || kernel > 2) return -1;
  const int n = g_launches[kernel];
  if (reset) g_launches[kernel] = 0;
  return n;
}
