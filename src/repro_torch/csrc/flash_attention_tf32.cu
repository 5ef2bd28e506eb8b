// K9 in f32 on Hopper's tensor cores: the forward of flash_attention.cu and
// the backward of flash_attention_bwd.cu for f32 q, k, v at D = 64 and 128,
// each f32 matrix product taken as three TF32 wgmma products ("3xTF32").
//
// Replaces, for those D, the FFMA kernels flash_attention.cu::flash_f32
// (the port of the JAX package's Pallas kernel kernels/flash_attention.py::
// flash_attention_fwd, pallas_call at :94) and flash_attention_bwd.cu::
// dq_f32 / dkdv_f32 (K9's backward, which no TPU kernel stands behind: the
// JAX package differentiates its plain jnp attention). What they compute is
// unchanged, and so is their arithmetic around the products:
//   forward: scores scaled by `scale`, masked ones NEG = -1e30 and keys past
//   Skv -inf; per kv tile m' = max(m, max s), c = exp(m - m'),
//   p = exp(s - m') (expf), l = l c + sum p, acc = acc c + p . v;
//   out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
//   backward: P = exp(s scale - lse) (expf) on the valid pairs, 0 elsewhere;
//   dP = dO V^T; Dr = rowsum(P o dP) (summed here from P and dP, not from
//   the forward's output); dS = P o (dP - Dr); dV = P^T dO;
//   dK = scale dS^T Q; dQ = scale dS K. No atomics, every sum in a fixed
//   order: a second call is bitwise equal.
//
// The arithmetic of a product. One TF32 product keeps 11 significant bits
// of each operand: about 2^-11 relative, some 1,000 times the f32 error, far
// outside the forward's 2e-5 agreement and the backward's bwd_tolerance.
// Each f32 operand x is split as hi = rna_tf32(x), lo = rna_tf32(x - hi)
// (cvt.rna.tf32.f32, explicit: the tensor core is not relied on to drop the
// low 13 bits), and A B as A_lo B_hi + A_hi B_lo + A_hi B_hi into one f32
// accumulator, the two small products first (the order of CUTLASS's
// OpMultiplyAddFastF32); A_lo B_lo (2^-22 relative) is dropped. P and dS
// are split in registers before they become register A operands.
//
// Where the trouble lies, and what the design does about it (times: device
// ms on an NVIDIA H100 80GB HBM3 at 700 W, tools/k9_tf32_probe.py):
//   Operand layout. TF32 wgmma reads both shared-memory operands K-major
//   only (the transposed-B descriptor the bf16 kernels use for V, K, Q and
//   dO is for 16-bit types). So a pre-pass, split_tf32 (one launch a call),
//   writes the hi and lo halves of the operands: K (and in the backward Q,
//   V, dO) as they are, (2, planes, rows, D), and the operands that enter a
//   product along their sequence dimension transposed, (2, planes, D, rows
//   padded to 8): V^T for O += P V, K^T for dQ += dS K, dO^T for dV +=
//   P^T dO, Q^T for dK += dS^T Q. In a transposed copy each group of 8
//   positions holds its rows in the order 0, 2, 4, 6, 1, 3, 5, 7: the tf32
//   A fragment holds columns t and t + 4 of a k8 slice where the f32
//   accumulator holds 2 t and 2 t + 1, so the accumulator's registers
//   become the A fragment as they are, with no shuffle. The forward takes
//   Q as it is: each consumer thread rounds its rows' hi halves from device
//   memory into register A fragments, and its warpgroup turns its 64 rows
//   of the TMA-loaded tile into the lo halves in place. The pre-pass then
//   splits only K and V (0.016 ms at qwen2-7b's S = 4,096, not 0.078), and
//   a score slice reads 5 KB of shared memory, not 9: with both, the
//   forward went from 1.54 to 1.44 ms.
//   Shared memory. An f32 tile with its lo half takes four times a bf16
//   tile's bytes. The forward keeps 128 q rows (Q's lo, 64 KB at D = 128)
//   and two-stage rings of 32-key K and V^T tiles (64 keys at D = 64); the
//   backward's blocks hold one consumer warpgroup (64 q rows or 64 keys)
//   and rings of 32-row tiles (64 at D = 64), one stage where the block
//   holds more than one resident operand pair. Each stays under the 227 KB
//   a block can have.
//   Registers. A tf32 A fragment is four 32-bit registers for 64 x 8, and
//   the lo halves double them. The forward's producer is a whole
//   warpgroup that gives its registers back (setmaxnreg): with one
//   producer warp, three of nine warps share an SM quarter and the
//   consumers were held to 168 registers, spilling (2.52 ms). With one
//   consumer warpgroup a block, the backward's dkdv launch splits dK and dV
//   across blocks (a block per key tile and gradient) instead of across
//   warpgroups, and its products of N = 128 columns run as two of 64 (a
//   64 x 64 fresh accumulator is 32 registers).
//   Accumulation. The tensor cores' own f32 sums lose more than FFMA's
//   round-to-nearest chains (see add_acc): the scores and every backward
//   product sum each k8 slice in a fresh accumulator and add the slices
//   with FADD.
//   Ragged and odd S. TMA zero-fills rows past S and Skv; the transposed
//   copies are padded with zeros to a multiple of 8 (a 16-byte row stride);
//   the lse and Dr rows a dkdv tile reads are copied into shared memory by
//   the producer warp, 0 past S.
//   D = 256 (recurrentgemma) does not fit: a 64-row Q tile is 128 KB as hi
//   + lo, a K and a V^T tile of 32 keys 64 KB each, and a thread's share of
//   Q's hi fragments 128 registers. It stays on FFMA (flash_f32, dq_f32,
//   dkdv_f32), as do D other than 64 and 128.
//
// Kernels:
//   split_tf32: the pre-pass, one launch for every operand of a call.
//   flash_tf32x3 (wgmma_tf32x3): one block a (128-row q tile, q head, batch)
//     with the most keys first; warpgroups 0 and 1 own 64 q rows each,
//     warpgroup 2 gives its registers back and one of its threads issues
//     TMA loads (Q once, then K and V^T tiles through their rings). S = Q
//     K^T (Q's hi from registers, its lo and K from shared memory; N = 32
//     keys at D = 128, 64 at D = 64), the online softmax on the
//     accumulators, P split in registers, O += P V with N = D.
//   dq_tf32x3: one block a (q head, 64-row q tile, batch), the most keys
//     first; Q and dO resident, K, V and K^T tiles through a ring, twice
//     over the tiles the rows see: pass 1 sums Dr (written out for dkdv),
//     pass 2 forms dS and dQ += dS K.
//   dkdv_tf32x3: one block a (q head, 64-key tile and gradient, batch): a
//     dK block holds K and V and rings Q, dO and Q^T (S^T, dP^T, dS^T,
//     dK += dS^T Q); a dV block holds K and rings Q and dO^T (S^T, P^T,
//     dV += P^T dO). With G = Hq / Hkv > 1 each block writes its q head's
//     partial to a (2, B, Hq, Skv, D) scratch, and
//   group_sum_f32 sums each group's G partials in head order, dK scaled.
//
// Bound on the H100: operations, now at the TF32 rate. Three TF32 products
// an f32 product at 495 TFLOP/s (dense) is 165 TFLOP/s of f32 products,
// against FFMA's 67: the forward's two products (4 D flops a valid pair)
// and the backward's five (10 D) are three times that work at 495. The
// designs do more: the backward's S and dP three times (twice in dq, once
// more in dkdv's dK blocks) and S once more in its dV blocks, 11 products
// in all; a warpgroup's softmax and its FADDs run between its own products
// and overlap only the other warpgroup's (the forward) or none (the
// backward's one warpgroup a block). Tried and dropped: two k8 slices a
// fresh accumulator for the scores (no time saved; some gradients' share
// of their tolerance 0.35 -> 0.65), a warpgroup's O += P V left running
// under its next tile's scores (1.44 -> 1.84 ms: the scores' slice waits
// queue behind it), and skipping tiles that add nothing to a warpgroup's
// rows (1.45 -> 1.55 ms, in turns).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNeg = -1e30f;

struct Attn {
  int B, Hq, Hkv, S, Skv, D, causal, window;
  float scale;
};

__device__ __forceinline__ bool valid(const Attn& a, int q, int k) {
  return q < a.S && k < a.Skv && !(a.causal && k > q) &&
         !(a.window > 0 && q - k >= a.window);
}

// The forward's kv tiles [lo, hi] of `bk` keys for the `bq`-row q tile at
// q0. A tile holding a row with no valid key skips none (that row gets the
// full softmax's answer, the mean of V).
__device__ __forceinline__ void kv_range(const Attn& a, int q0, int bq,
                                         int bk, int* lo, int* hi) {
  const int q_last = min(q0 + bq, a.S) - 1;
  *lo = 0;
  *hi = (a.Skv + bk - 1) / bk - 1;
  if (a.window > 0 && q_last >= a.Skv + a.window - 1) return;  // a dead row
  if (a.causal) *hi = min(*hi, q_last / bk);
  if (a.window > 0) *lo = max(0, q0 - a.window + 1) / bk;
}

// The backward's kv tiles [lo, hi] of `bk` keys that the `bq`-row q tile at
// q0 sees (no row without a valid key: the wrapper refuses those).
__device__ __forceinline__ void kv_tiles(const Attn& a, int q0, int bq,
                                         int bk, int* lo, int* hi) {
  const int q_last = min(q0 + bq, a.S) - 1;
  *lo = 0;
  *hi = (a.Skv + bk - 1) / bk - 1;
  if (a.causal) *hi = min(*hi, q_last / bk);
  if (a.window > 0) *lo = max(0, q0 - a.window + 1) / bk;
}

// The q tiles [lo, hi] of `bq` rows that see the `bk`-key tile at k0.
__device__ __forceinline__ void q_tiles(const Attn& a, int k0, int bk, int bq,
                                        int* lo, int* hi) {
  const int k_last = min(k0 + bk, a.Skv) - 1;
  *lo = a.causal ? k0 / bq : 0;
  *hi = (a.S - 1) / bq;
  if (a.window > 0) *hi = min(*hi, (k_last + a.window - 1) / bq);
}

// No pair of q rows [q0, q0 + nq) and keys [k0, k0 + nk) is valid
__device__ __forceinline__ bool none_valid(const Attn& a, int q0, int nq,
                                           int k0, int nk) {
  return q0 >= a.S || k0 >= a.Skv || (a.causal && k0 > q0 + nq - 1) ||
         (a.window > 0 && q0 - (k0 + nk - 1) >= a.window);
}

// Some pair of them is not
__device__ __forceinline__ bool some_invalid(const Attn& a, int q0, int nq,
                                             int k0, int nk) {
  return q0 + nq > a.S || k0 + nk > a.Skv ||
         (a.causal && k0 + nk - 1 > q0) ||
         (a.window > 0 && q0 + nq - 1 - k0 >= a.window);
}

// x as tf32 hi + lo
__device__ __forceinline__ void split(float x, uint32_t* hi, uint32_t* lo) {
  *hi = hopper::tf32_rna(x);
  *lo = hopper::tf32_rna(x - __uint_as_float(*hi));
}

// A 64 x N accumulator (rows g and g + 8, columns 8 j + 2 t and + 1, as
// wgmma leaves it) as hi and lo tf32 register A fragments, one a k8 slice:
// slice j holds its columns in the order 0, 2, 4, 6, 1, 3, 5, 7, the order
// of the transposed copies' K dimension
template <int N>
__device__ __forceinline__ void split_frags(uint32_t (*hi)[4],
                                            uint32_t (*lo)[4],
                                            const float* x) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split(x[4 * j + 0], &hi[j][0], &lo[j][0]);
    split(x[4 * j + 2], &hi[j][1], &lo[j][1]);
    split(x[4 * j + 1], &hi[j][2], &lo[j][2]);
    split(x[4 * j + 3], &hi[j][3], &lo[j][3]);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int j = 0; j < N; ++j) hopper::reg_fence(acc[j]);
}

// acc (64 x N) += A B over K in 3xTF32: A's hi and lo fragments (K/8
// slices), B a transposed tile [K/32][N][32] (hi at b_hi, lo at b_lo);
// not committed.
template <int K, int N>
__device__ __forceinline__ void issue_rs3(float* acc, uint32_t (*hi)[4],
                                          uint32_t (*lo)[4], uint32_t b_hi,
                                          uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint64_t bh = hopper::kmajor_desc<N>(b_hi, kk);
    const uint64_t bl = hopper::kmajor_desc<N>(b_lo, kk);
    hopper::wgmma_rs_tf32<N>(acc, lo[kk], bh, 1);
    hopper::wgmma_rs_tf32<N>(acc, hi[kk], bl, 1);
    hopper::wgmma_rs_tf32<N>(acc, hi[kk], bh, 1);
  }
}

// The scores and the backward's products keep the tensor cores' own f32
// sums short: each k8 slice's three products go into a fresh accumulator,
// and the slices are added in order with FADD (round to nearest). Summed on
// the tensor cores over a whole row of K, the gradients lay 1.2 to 2.6
// times outside bwd_tolerance on the card, and the forward's logsumexp so
// far from the float64 one that a backward fed it lay 3.3 times outside
// (0.4 fed the float64 logsumexp); two slices a fresh accumulator moved
// some shares from 0.35 to 0.65 and the forward's time not at all. O's sum
// over the keys stays on the tensor cores: the forward's output lies within
// a quarter of its 2e-5 tolerance of the plain version's.
template <int N>
__device__ __forceinline__ void add_acc(float* acc, float* t, bool first) {
  fence_acc<N>(t);
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = first ? t[j] : acc[j] + t[j];
}

// acc (64 x N) = the sum of kSlices slices, each issued by issue(t, i) into
// a fresh 64 x N accumulator t, NT in flight, added in order with FADD;
// issued and awaited (no other wgmma group may be pending).
template <int N, int kSlices, typename Issue>
__device__ __forceinline__ void sum_slices(float* acc, Issue issue) {
  constexpr int NT = N <= 32 ? 4 : 2;
  float tmp[NT][N / 2];
#pragma unroll
  for (int i = 0; i < kSlices; ++i) {
    float* t = tmp[i % NT];
    fence_acc<N / 2>(t);
    hopper::wgmma_fence();
    issue(t, i);
    hopper::wgmma_commit();
    if (i >= NT - 1) {
      hopper::wgmma_wait<NT - 1>();
      const int done = i - (NT - 1);
      add_acc<N / 2>(acc, tmp[done % NT], done == 0);
    }
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int done = kSlices - (NT - 1); done < kSlices; ++done) {
    if (done >= 0) add_acc<N / 2>(acc, tmp[done % NT], done == 0);
  }
}

// acc (64 x N) = A B^T over K in 3xTF32, a fresh accumulator a k8 slice
// (sum_slices): A the warpgroup's 64 rows of a tile of AROWS rows a box (hi
// at a_hi, lo at a_lo), B the N rows of a tile (hi at b_hi, lo at b_lo),
// all K-major [K/32][rows][32]; the two small products first (the order of
// CUTLASS's OpMultiplyAddFastF32).
template <int K, int N, int AROWS>
__device__ __forceinline__ void gemm_ss3(float* acc, uint32_t a_hi,
                                         uint32_t a_lo, uint32_t b_hi,
                                         uint32_t b_lo) {
  sum_slices<N, K / 8>(acc, [&](float* t, int i) {
    const uint64_t ah = hopper::kmajor_desc<AROWS>(a_hi, i);
    const uint64_t al = hopper::kmajor_desc<AROWS>(a_lo, i);
    const uint64_t bh = hopper::kmajor_desc<N>(b_hi, i);
    const uint64_t bl = hopper::kmajor_desc<N>(b_lo, i);
    hopper::wgmma_ss_tf32<N>(t, al, bh, 0);
    hopper::wgmma_ss_tf32<N>(t, ah, bl, 1);
    hopper::wgmma_ss_tf32<N>(t, ah, bh, 1);
  });
}

// The same with A's hi halves as register fragments (a_hi[i]: slice i):
// the slice reads 5 KB of shared memory at N = 32 instead of 9.
template <int K, int N, int AROWS>
__device__ __forceinline__ void gemm_rs_ss3(float* acc,
                                            const uint32_t (*a_hi)[4],
                                            uint32_t a_lo, uint32_t b_hi,
                                            uint32_t b_lo) {
  sum_slices<N, K / 8>(acc, [&](float* t, int i) {
    const uint64_t al = hopper::kmajor_desc<AROWS>(a_lo, i);
    const uint64_t bh = hopper::kmajor_desc<N>(b_hi, i);
    const uint64_t bl = hopper::kmajor_desc<N>(b_lo, i);
    hopper::wgmma_ss_tf32<N>(t, al, bh, 0);
    hopper::wgmma_rs_tf32<N>(t, a_hi[i], bl, 1);
    hopper::wgmma_rs_tf32<N>(t, a_hi[i], bh, 1);
  });
}

// acc (64 x N) += A B over K in 3xTF32 (operands as issue_rs3): N in
// halves of 64 columns, a fresh 64 x 64 accumulator a half and k8 slice,
// two in flight, each added to acc with FADD; issued and awaited (no other
// wgmma group may be pending).
template <int K, int N>
__device__ __forceinline__ void gemm_rs3_add(float* acc, uint32_t (*hi)[4],
                                             uint32_t (*lo)[4], uint32_t b_hi,
                                             uint32_t b_lo) {
  constexpr int kSlices = K / 8, kGroups = N / 64 * kSlices;
  float tmp[2][32];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int half = i / kSlices, kk = i % kSlices;
    float* t = tmp[i % 2];
    fence_acc<32>(t);
    hopper::wgmma_fence();
    // the half's 64 rows of B: 64 x 128 bytes into each box
    const uint64_t bh = hopper::kmajor_desc<N>(b_hi + half * 64 * 128, kk);
    const uint64_t bl = hopper::kmajor_desc<N>(b_lo + half * 64 * 128, kk);
    hopper::wgmma_rs_tf32<64>(t, lo[kk], bh, 0);
    hopper::wgmma_rs_tf32<64>(t, hi[kk], bl, 1);
    hopper::wgmma_rs_tf32<64>(t, hi[kk], bh, 1);
    hopper::wgmma_commit();
    if (i >= 1) {
      hopper::wgmma_wait<1>();
      add_acc<32>(acc + 32 * ((i - 1) / kSlices), tmp[(i - 1) % 2], false);
    }
  }
  hopper::wgmma_wait<0>();
  add_acc<32>(acc + 32 * ((kGroups - 1) / kSlices), tmp[(kGroups - 1) % 2],
              false);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- the pre-pass ---------------------------------------------------------
// One operand: src (planes, rows, D) f32 -> dst (2, planes, rows, D) (hi,
// then lo) when rows_pad is 0, else (2, planes, D, rows_pad), each group of
// 8 positions holding rows 0, 2, 4, 6, 1, 3, 5, 7 of its group, zeros past
// rows.
struct SplitJob {
  const float* src;
  float* dst;
  int planes, rows, D, rows_pad;
};

constexpr int kMaxJobs = 7;

struct SplitJobs {
  SplitJob job[kMaxJobs];
};

__global__ void __launch_bounds__(256) split_tf32(SplitJobs jobs) {
  const SplitJob j = jobs.job[blockIdx.y];
  if (j.rows_pad == 0) {
    const size_t n4 = (size_t)j.planes * j.rows * j.D / 4;
    const float4* src = reinterpret_cast<const float4*>(j.src);
    float4* hi = reinterpret_cast<float4*>(j.dst);
    float4* lo = hi + n4;
    for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < n4;
         e += (size_t)gridDim.x * 256) {
      const float4 x = src[e];
      uint32_t h[4], l[4];
      split(x.x, &h[0], &l[0]);
      split(x.y, &h[1], &l[1]);
      split(x.z, &h[2], &l[2]);
      split(x.w, &h[3], &l[3]);
      hi[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                          __uint_as_float(h[2]), __uint_as_float(h[3]));
      lo[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                          __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
    return;
  }
  // transposed: 32 x 32 tiles through shared memory
  __shared__ float tile[32][33];
  const int lane = threadIdx.x % 32, row8 = threadIdx.x / 32;
  const int rt = j.rows_pad / 32 + (j.rows_pad % 32 != 0), ct = j.D / 32;
  const size_t tiles = (size_t)j.planes * rt * ct;
  const size_t plane_out = (size_t)j.D * j.rows_pad;
  float* lo_base = j.dst + (size_t)j.planes * plane_out;
  // the row that position `lane` of a 32-position tile holds
  const int within = lane & 7;
  const int src_row = (lane & ~7) + (within < 4 ? 2 * within
                                                : 2 * (within - 4) + 1);
  for (size_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p = (int)(t / (rt * ct));
    const int rem = (int)(t % (rt * ct));
    const int r0 = rem / ct * 32, c0 = rem % ct * 32;
    for (int rr = row8; rr < 32; rr += 8) {
      const int r = r0 + rr;
      tile[rr][lane] = r < j.rows
          ? j.src[((size_t)p * j.rows + r) * j.D + c0 + lane] : 0.0f;
    }
    __syncthreads();
    const int pos = r0 + lane;
    if (pos < j.rows_pad) {
      for (int cc = row8; cc < 32; cc += 8) {
        uint32_t h, l;
        split(tile[src_row][cc], &h, &l);
        const size_t o = (size_t)p * plane_out +
                         (size_t)(c0 + cc) * j.rows_pad + pos;
        j.dst[o] = __uint_as_float(h);
        lo_base[o] = __uint_as_float(l);
      }
    }
    __syncthreads();
  }
}

// ---- forward ----------------------------------------------------------------
constexpr int kFwdRows = 128;     // q rows a block: two consumer warpgroups
constexpr int kFwdThreads = 384;  // and one producer warpgroup

template <int D, int BK, int KST, int VST>
struct FwdTile {
  static constexpr int kQ = kFwdRows * D;   // floats of Q's lo
  static constexpr int kT = BK * D;         // of a K or V^T tile's hi or lo
  static constexpr size_t kSmem =
      2048 + 4 * ((size_t)kQ + 2 * (size_t)(KST + VST) * kT);
};

// One tile's raw scores in place: scaled (and, EDGE, masked: -inf past
// Skv, NEG where the mask says so), the rows' max m and sum l updated, p
// left in s and the accumulator's correction in corr.
template <int BK, bool EDGE>
__device__ __forceinline__ void softmax_tile(float* s, float* m_r,
                                             float* l_r, float* corr,
                                             const Attn& a, int row0, int k0,
                                             int tq4) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float& x = s[4 * j + e];
      if (EDGE) {
        const int q = row0 + 8 * r, k = k0 + 8 * j + 2 * tq4 + (e & 1);
        if (k >= a.Skv) {
          x = -INFINITY;
        } else if ((a.causal && k > q) ||
                   (a.window > 0 && q - k >= a.window)) {
          x = kNeg;
        } else {
          x = x * a.scale;
        }
      } else {
        x = x * a.scale;
      }
      tmax[r] = fmaxf(tmax[r], x);
    }
  }
  float tsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m_r[r], tmax[r]);
    corr[r] = expf(m_r[r] - m_new);
    m_r[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      x = expf(x - m_r[e >> 1]);
      tsum[e >> 1] += x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
    tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
    l_r[r] = l_r[r] * corr[r] + tsum[r];
  }
}

// tq: Q as it is, (D, S, B Hq), 128-row boxes; tk: K's hi and lo, (D, Skv,
// 2 B Hkv), BK-row boxes; tv: V^T's, (Skv padded, D, 2 B Hkv), boxes of 32
// keys x D.
template <int D, int BK, int KST, int VST>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_tf32x3(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ q, float* __restrict__ o,
                 float* __restrict__ lse, Attn a) {
  using T = FwdTile<D, BK, KST, VST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* k_full = q_full + 1;              // [KST]
  uint64_t* k_empty = k_full + KST;
  uint64_t* v_full = k_empty + KST;           // [VST]
  uint64_t* v_empty = v_full + VST;
  float* Qs = reinterpret_cast<float*>(smem + 1024);  // lo [D/32][128][32]
  float* Ks = Qs + T::kQ;                     // [KST][hi, lo][D/32][BK][32]
  float* Vs = Ks + 2 * KST * T::kT;           // [VST][hi, lo][BK/32][D][32]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int pk = a.B * a.Hkv;   // K's and V^T's lo planes follow the hi
  int lo, hi;
  kv_range(a, q0, kFwdRows, BK, &lo, &hi);
  const int n = hi - lo + 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < KST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], 256);
    }
    for (int s = 0; s < VST; ++s) {
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    // ---- producer: Q once, then K and V^T through their rings. A whole
    // warpgroup, which gives its registers back (setmaxnreg): with one
    // producer warp, three warps of nine share an SM quarter's registers
    // and the consumers were held to 168 a thread ----------------------
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const int qp = b * a.Hq + h, kp = b * a.Hkv + kvh;
      hopper::mbar_expect_tx(q_full, 4 * T::kQ);
      for (int c = 0; c < D / 32; ++c) {
        hopper::tma_load_3d(Qs + c * kFwdRows * 32, &tq, q_full, c * 32, q0,
                            qp);
      }
      for (int i = 0; i < n; ++i) {
        const int k0 = (lo + i) * BK;
        const int ks = i % KST, vs = i % VST;
        float* kd = Ks + 2 * ks * T::kT;
        hopper::mbar_wait(&k_empty[ks], ((i / KST) & 1) ^ 1);
        hopper::mbar_expect_tx(&k_full[ks], 8 * T::kT);
        for (int c = 0; c < D / 32; ++c) {
          hopper::tma_load_3d(kd + c * BK * 32, &tk, &k_full[ks], c * 32, k0,
                              kp);
          hopper::tma_load_3d(kd + T::kT + c * BK * 32, &tk, &k_full[ks],
                              c * 32, k0, pk + kp);
        }
        float* vd = Vs + 2 * vs * T::kT;
        hopper::mbar_wait(&v_empty[vs], ((i / VST) & 1) ^ 1);
        hopper::mbar_expect_tx(&v_full[vs], 8 * T::kT);
        for (int c = 0; c < BK / 32; ++c) {
          hopper::tma_load_3d(vd + c * D * 32, &tv, &v_full[vs],
                              k0 + c * 32, 0, kp);
          hopper::tma_load_3d(vd + T::kT + c * D * 32, &tv, &v_full[vs],
                              k0 + c * 32, 0, pk + kp);
        }
      }
    }
    return;
  }
  // ---- consumers: 64 q rows each ----------------------------------------
  hopper::setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int w = t / 32, lane = t % 32, g = lane >> 2, tq4 = lane & 3;
  const int rq0 = q0 + wg * 64;              // this warpgroup's first row
  const int row0 = rq0 + w * 16 + g;         // rows row0 and row0 + 8
  const uint32_t q_lo = hopper::smem_u32(Qs) + wg * 64 * 128;
  float oacc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) oacc[j] = 0.0f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};
  float sacc[BK / 2];
  // Q's hi halves of this thread's rows as register A fragments, one a k8
  // slice (rows row0 and row0 + 8, columns t and t + 4 of the slice)
  uint32_t q_frag[D / 8][4];
  {
    const float* qb = q + (size_t)(b * a.Hq + h) * a.S * D;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e & 1);
        q_frag[kk][e] = row < a.S ? hopper::tf32_rna(
            qb[(size_t)row * D + 8 * kk + tq4 + 4 * (e >> 1)]) : 0u;
      }
    }
  }
  hopper::mbar_wait(q_full, 0);
  // this warpgroup's 64 rows of Q, as loaded, hold the lo halves after this
  // (an element's place in the swizzled box does not depend on its value)
  for (int e = t; e < 64 * D / 4; e += 128) {
    const int c = e / (64 * 8), r = e % (64 * 8);   // box, float4 in it
    float4* x = reinterpret_cast<float4*>(Qs + c * kFwdRows * 32 +
                                          wg * 64 * 32) + r;
    const float4 v = *x;
    uint32_t h[4], l[4];
    split(v.x, &h[0], &l[0]);
    split(v.y, &h[1], &l[1]);
    split(v.z, &h[2], &l[2]);
    split(v.w, &h[3], &l[3]);
    *x = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                     __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
  // the generic proxy's writes made visible to wgmma's reads, then the
  // warpgroup's 128 threads meet
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  for (int i = 0; i < n; ++i) {
    const int ks = i % KST, vs = i % VST;
    const int k0 = (lo + i) * BK;
    const uint32_t kb = hopper::smem_u32(Ks + 2 * ks * T::kT);
    hopper::mbar_wait(&k_full[ks], (i / KST) & 1);
    gemm_rs_ss3<D, BK, kFwdRows>(sacc, q_frag, q_lo, kb, kb + 4 * T::kT);
    hopper::mbar_arrive(&k_empty[ks]);
    // only tiles that cross the diagonal, the window's edge or Skv mask
    const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > rq0) ||
                      (a.window > 0 && rq0 + 63 - k0 >= a.window);
    float corr[2];
    if (edge) {
      softmax_tile<BK, true>(sacc, m_r, l_r, corr, a, row0, k0, tq4);
    } else {
      softmax_tile<BK, false>(sacc, m_r, l_r, corr, a, row0, k0, tq4);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[4 * j + 0] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
    split_frags<BK>(p_hi, p_lo, sacc);
    const uint32_t vb = hopper::smem_u32(Vs + 2 * vs * T::kT);
    hopper::mbar_wait(&v_full[vs], (i / VST) & 1);
    fence_acc<D / 2>(oacc);
    hopper::wgmma_fence();
    issue_rs3<BK, D>(oacc, p_hi, p_lo, vb, vb + 4 * T::kT);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_acc<D / 2>(oacc);
    hopper::mbar_arrive(&v_empty[vs]);
  }
  float* ob = o + (size_t)(b * a.Hq + h) * a.S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
    const float den = fmaxf(l_r[r], 1e-30f);
    if (lse != nullptr && tq4 == 0) {
      lse[(size_t)(b * a.Hq + h) * a.S + row] = m_r[r] + logf(den);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(ob + (size_t)row * D + j * 8 + 2 * tq4) =
          make_float2(oacc[4 * j + 2 * r] / den,
                      oacc[4 * j + 2 * r + 1] / den);
    }
  }
}

// ---- backward: dq -----------------------------------------------------------
constexpr int kBwdThreads = 160;  // one consumer warpgroup, one producer warp
constexpr int kBwdRows = 64;      // q rows a dq block, keys a dkdv block

template <int D, int BK, int ST>
struct DqTile {
  static constexpr int kQ = kBwdRows * D;   // floats of Q's or dO's hi or lo
  static constexpr int kT = BK * D;         // of a K, V or K^T tile's
  static constexpr size_t kSmem =
      2048 + 4 * (4 * (size_t)kQ + 6 * (size_t)ST * kT);
};

// P in place of the raw scores of a 64 x N accumulator whose rows are q rows
// (row0, row0 + 8) and columns keys from k0. EDGE: some pair may be invalid.
template <int N, bool EDGE>
__device__ __forceinline__ void probs_rows(float* s, const Attn& a,
                                           const float* lse_r, int row0,
                                           int k0, int tq4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = expf(s[4 * j + e] * a.scale - lse_r[e >> 1]);
      if (EDGE && !valid(a, row0 + 8 * (e >> 1), k0 + 8 * j + 2 * tq4 +
                                                    (e & 1))) {
        p = 0.0f;
      }
      s[4 * j + e] = p;
    }
  }
}

// tq, tdo: Q's and dO's hi and lo (D, S, 2 B Hq), 64-row boxes; tk, tv:
// K's and V's (D, Skv, 2 B Hkv), BK-row boxes; tkt: K^T's (Skv padded, D,
// 2 B Hkv), boxes of 32 keys x D.
template <int D, int BK, int ST>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dq_tf32x3(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tkt,
              const float* __restrict__ lse, float* __restrict__ dsum,
              float* __restrict__ dq, Attn a) {
  using T = DqTile<D, BK, ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* k_full = qd_full + 1;            // [ST] each
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  uint64_t* t_full = v_empty + ST;
  uint64_t* t_empty = t_full + ST;
  float* Qs = reinterpret_cast<float*>(smem + 1024);  // hi, lo [D/32][64][32]
  float* dOs = Qs + 2 * T::kQ;
  float* Ks = dOs + 2 * T::kQ;               // [ST][hi, lo][D/32][BK][32]
  float* Vs = Ks + 2 * ST * T::kT;
  float* Kts = Vs + 2 * ST * T::kT;          // [ST][hi, lo][BK/32][D][32]
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;
  const int kvh = h / (a.Hq / a.Hkv);
  const int pq = a.B * a.Hq, pk = a.B * a.Hkv;
  int lo, hi;
  kv_tiles(a, q0, kBwdRows, BK, &lo, &hi);
  const int n = hi - lo + 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], 128);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], 128);
      hopper::mbar_init(&t_full[s], 1);
      hopper::mbar_init(&t_empty[s], 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    // ---- producer: Q and dO once; K and V twice over the tiles, K^T on
    // the second pass ------------------------------------------------------
    if (threadIdx.x == 128) {
      const int qp = b * a.Hq + h, kp = b * a.Hkv + kvh;
      hopper::mbar_expect_tx(qd_full, 16 * T::kQ);
      for (int c = 0; c < D / 32; ++c) {
        const int off = c * kBwdRows * 32;
        hopper::tma_load_3d(Qs + off, &tq, qd_full, c * 32, q0, qp);
        hopper::tma_load_3d(Qs + T::kQ + off, &tq, qd_full, c * 32, q0,
                            pq + qp);
        hopper::tma_load_3d(dOs + off, &tdo, qd_full, c * 32, q0, qp);
        hopper::tma_load_3d(dOs + T::kQ + off, &tdo, qd_full, c * 32, q0,
                            pq + qp);
      }
      for (int pass = 0; pass < 2; ++pass) {
        for (int jt = 0; jt < n; ++jt) {
          const int i = pass * n + jt, s = i % ST;
          const uint32_t free_par = ((i / ST) & 1) ^ 1;
          const int k0 = (lo + jt) * BK;
          float* kd = Ks + 2 * s * T::kT;
          float* vd = Vs + 2 * s * T::kT;
          hopper::mbar_wait(&k_empty[s], free_par);
          hopper::mbar_expect_tx(&k_full[s], 8 * T::kT);
          for (int c = 0; c < D / 32; ++c) {
            hopper::tma_load_3d(kd + c * BK * 32, &tk, &k_full[s], c * 32,
                                k0, kp);
            hopper::tma_load_3d(kd + T::kT + c * BK * 32, &tk, &k_full[s],
                                c * 32, k0, pk + kp);
          }
          hopper::mbar_wait(&v_empty[s], free_par);
          hopper::mbar_expect_tx(&v_full[s], 8 * T::kT);
          for (int c = 0; c < D / 32; ++c) {
            hopper::tma_load_3d(vd + c * BK * 32, &tv, &v_full[s], c * 32,
                                k0, kp);
            hopper::tma_load_3d(vd + T::kT + c * BK * 32, &tv, &v_full[s],
                                c * 32, k0, pk + kp);
          }
          if (pass == 1) {
            const int ts = jt % ST;
            float* td = Kts + 2 * ts * T::kT;
            hopper::mbar_wait(&t_empty[ts], ((jt / ST) & 1) ^ 1);
            hopper::mbar_expect_tx(&t_full[ts], 8 * T::kT);
            for (int c = 0; c < BK / 32; ++c) {
              hopper::tma_load_3d(td + c * D * 32, &tkt, &t_full[ts],
                                  k0 + c * 32, 0, kp);
              hopper::tma_load_3d(td + T::kT + c * D * 32, &tkt, &t_full[ts],
                                  k0 + c * 32, 0, pk + kp);
            }
          }
        }
      }
    }
    return;
  }
  // ---- consumer: 64 q rows ------------------------------------------------
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int g = lane >> 2, tq4 = lane & 3;
  const int row0 = q0 + w * 16 + g;          // rows row0 and row0 + 8
  const size_t qrow = (size_t)(b * a.Hq + h) * a.S;
  float lse_r[2], dr[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < a.S ? lse[qrow + row] : 0.0f;
  }
  const uint32_t q_hi = hopper::smem_u32(Qs), q_lo = q_hi + 4 * T::kQ;
  const uint32_t do_hi = hopper::smem_u32(dOs), do_lo = do_hi + 4 * T::kQ;
  float dqa[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dqa[j] = 0.0f;
  float sacc[BK / 2], dpacc[BK / 2];
  hopper::mbar_wait(qd_full, 0);
  for (int pass = 0; pass < 2; ++pass) {
    for (int jt = 0; jt < n; ++jt) {
      const int i = pass * n + jt, s = i % ST, ts = jt % ST;
      const uint32_t par = (i / ST) & 1, tpar = (jt / ST) & 1;
      const int k0 = (lo + jt) * BK;
      if (none_valid(a, q0, kBwdRows, k0, BK)) {
        hopper::mbar_wait(&k_full[s], par);
        hopper::mbar_wait(&v_full[s], par);
        hopper::mbar_arrive(&k_empty[s]);
        hopper::mbar_arrive(&v_empty[s]);
        if (pass == 1) {
          hopper::mbar_wait(&t_full[ts], tpar);
          hopper::mbar_arrive(&t_empty[ts]);
        }
        continue;
      }
      const uint32_t kb = hopper::smem_u32(Ks + 2 * s * T::kT);
      const uint32_t vb = hopper::smem_u32(Vs + 2 * s * T::kT);
      hopper::mbar_wait(&k_full[s], par);
      gemm_ss3<D, BK, kBwdRows>(sacc, q_hi, q_lo, kb, kb + 4 * T::kT);
      hopper::mbar_arrive(&k_empty[s]);
      hopper::mbar_wait(&v_full[s], par);
      gemm_ss3<D, BK, kBwdRows>(dpacc, do_hi, do_lo, vb, vb + 4 * T::kT);
      hopper::mbar_arrive(&v_empty[s]);
      if (some_invalid(a, q0, kBwdRows, k0, BK)) {
        probs_rows<BK, true>(sacc, a, lse_r, row0, k0, tq4);
      } else {
        probs_rows<BK, false>(sacc, a, lse_r, row0, k0, tq4);
      }
      if (pass == 0) {
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
      uint32_t hi_f[BK / 8][4], lo_f[BK / 8][4];
      split_frags<BK>(hi_f, lo_f, sacc);
      const uint32_t tb = hopper::smem_u32(Kts + 2 * ts * T::kT);
      hopper::mbar_wait(&t_full[ts], tpar);
      gemm_rs3_add<BK, D>(dqa, hi_f, lo_f, tb, tb + 4 * T::kT);
      hopper::mbar_arrive(&t_empty[ts]);
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
  float* dqb = dq + qrow * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dqb + (size_t)row * D + j * 8 + 2 * tq4) =
          make_float2(dqa[4 * j + 2 * r] * a.scale,
                      dqa[4 * j + 2 * r + 1] * a.scale);
    }
  }
}

// ---- backward: dk, dv -------------------------------------------------------
template <int D, int BQ>
struct DkvTile {
  static constexpr int kKV = kBwdRows * D;  // floats of K's or V's hi or lo
  static constexpr int kT = BQ * D;         // of a q-side tile's hi or lo
  static constexpr int kStK = 1, kStV = 2;  // ring stages of dK and dV blocks
  static constexpr size_t kBytesK =
      4 * (4 * (size_t)kKV + kStK * (6 * (size_t)kT + 2 * BQ));
  static constexpr size_t kBytesV =
      4 * (2 * (size_t)kKV + kStV * (4 * (size_t)kT + BQ));
  static constexpr size_t kSmem = 2048 + (kBytesK > kBytesV ? kBytesK
                                                            : kBytesV);
};

struct DkvArgs {
  const float* lse;
  const float* dsum;
  float* dk;
  float* dv;
  float* part;
};

// One block's 64 keys from k0, for dK (DK) or dV: the resident K (and V)
// hi and lo, the ring of q tiles that see the keys, the gradient written
// out (f32: the q head's partial when part is given, else the kv head's).
template <int D, int BQ, bool DK>
__device__ __forceinline__ void dkdv_block(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tqt, const CUtensorMap* tdot,
    const DkvArgs& g_args, const Attn& a, unsigned char* smem, int h, int b,
    int k0) {
  using T = DkvTile<D, BQ>;
  constexpr int ST = DK ? T::kStK : T::kStV;
  constexpr int kPer = DK ? 6 : 4;           // hi / lo tiles a stage
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = kv_full + 1;              // [ST]
  uint64_t* empty = full + ST;
  float* Ks = reinterpret_cast<float*>(smem + 1024);  // hi, lo [D/32][64][32]
  float* Vs = Ks + 2 * T::kKV;                        // (dK blocks)
  float* ring = Ks + (DK ? 4 : 2) * T::kKV;
  // stage s: Q hi, lo [D/32][BQ][32]; dK: dO hi, lo, then Q^T hi, lo
  // [BQ/32][D][32]; dV: dO^T hi, lo
  float* lse_s = ring + ST * kPer * T::kT;   // [ST][BQ]
  float* dr_s = lse_s + ST * BQ;             // [ST][BQ] (dK blocks)
  const int kvh = h / (a.Hq / a.Hkv);
  const int pq = a.B * a.Hq, pk = a.B * a.Hkv;
  const int qp = b * a.Hq + h, kp = b * a.Hkv + kvh;
  int lo, hi;
  q_tiles(a, k0, kBwdRows, BQ, &lo, &hi);
  const int n = max(0, hi - lo + 1);
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    // ---- producer warp: K (and V) once; the q tiles through the ring ----
    const int lane = threadIdx.x - 128;
    const size_t qrow = (size_t)qp * a.S;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, (DK ? 16 : 8) * T::kKV);
      for (int c = 0; c < D / 32; ++c) {
        const int off = c * kBwdRows * 32;
        hopper::tma_load_3d(Ks + off, tk, kv_full, c * 32, k0, kp);
        hopper::tma_load_3d(Ks + T::kKV + off, tk, kv_full, c * 32, k0,
                            pk + kp);
        if (DK) {
          hopper::tma_load_3d(Vs + off, tv, kv_full, c * 32, k0, kp);
          hopper::tma_load_3d(Vs + T::kKV + off, tv, kv_full, c * 32, k0,
                              pk + kp);
        }
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % ST;
      const int q0 = (lo + i) * BQ;
      float* st = ring + s * kPer * T::kT;
      hopper::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 4 * kPer * T::kT);
        for (int c = 0; c < D / 32; ++c) {
          const int off = c * BQ * 32;
          hopper::tma_load_3d(st + off, tq, &full[s], c * 32, q0, qp);
          hopper::tma_load_3d(st + T::kT + off, tq, &full[s], c * 32, q0,
                              pq + qp);
          if (DK) {
            hopper::tma_load_3d(st + 2 * T::kT + off, tdo, &full[s], c * 32,
                                q0, qp);
            hopper::tma_load_3d(st + 3 * T::kT + off, tdo, &full[s], c * 32,
                                q0, pq + qp);
          }
        }
        const CUtensorMap* tt = DK ? tqt : tdot;
        float* td = st + (DK ? 4 : 2) * T::kT;
        for (int c = 0; c < BQ / 32; ++c) {
          hopper::tma_load_3d(td + c * D * 32, tt, &full[s], q0 + c * 32, 0,
                              qp);
          hopper::tma_load_3d(td + T::kT + c * D * 32, tt, &full[s],
                              q0 + c * 32, 0, pq + qp);
        }
      }
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < a.S;
        lse_s[s * BQ + r] = in ? g_args.lse[qrow + q0 + r] : 0.0f;
        if (DK) dr_s[s * BQ + r] = in ? g_args.dsum[qrow + q0 + r] : 0.0f;
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }
  // ---- consumer: 64 keys ------------------------------------------------
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int g = lane >> 2, tq4 = lane & 3;
  const int key0 = k0 + w * 16 + g;          // keys key0 and key0 + 8
  const uint32_t k_hi = hopper::smem_u32(Ks), k_lo = k_hi + 4 * T::kKV;
  const uint32_t v_hi = hopper::smem_u32(Vs), v_lo = v_hi + 4 * T::kKV;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
  float st[BQ / 2], dpt[DK ? BQ / 2 : 1];
  hopper::mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    const int q0 = (lo + i) * BQ;
    hopper::mbar_wait(&full[s], (i / ST) & 1);
    if (!none_valid(a, q0, BQ, k0, kBwdRows)) {
      const uint32_t sb = hopper::smem_u32(ring + s * kPer * T::kT);
      const uint32_t q_hi = sb, q_lo = sb + 4 * T::kT;
      gemm_ss3<D, BQ, kBwdRows>(st, k_hi, k_lo, q_hi, q_lo);
      if constexpr (DK) {
        gemm_ss3<D, BQ, kBwdRows>(dpt, v_hi, v_lo, sb + 8 * T::kT,
                                  sb + 12 * T::kT);
      }
      // P^T: rows keys, columns q rows from q0
      const bool edge = some_invalid(a, q0, BQ, k0, kBwdRows);
      const float* lse_t = lse_s + s * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j +
                                                          2 * tq4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(st[4 * j + e] * a.scale - ((e & 1) ? l.y : l.x));
          if (edge && !valid(a, q0 + 8 * j + 2 * tq4 + (e & 1),
                             key0 + 8 * (e >> 1))) {
            p = 0.0f;
          }
          st[4 * j + e] = p;
        }
      }
      if constexpr (DK) {
        const float* dr_t = dr_s + s * BQ;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(dr_t + 8 * j +
                                                            2 * tq4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dpt[4 * j + e] = st[4 * j + e] *
                             (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
          }
        }
      }
      uint32_t hi_f[BQ / 8][4], lo_f[BQ / 8][4];
      if constexpr (DK) {
        split_frags<BQ>(hi_f, lo_f, dpt);
      } else {
        split_frags<BQ>(hi_f, lo_f, st);
      }
      const uint32_t tb = sb + 4 * (DK ? 4 : 2) * T::kT;
      gemm_rs3_add<BQ, D>(acc, hi_f, lo_f, tb, tb + 4 * T::kT);
    }
    hopper::mbar_arrive(&empty[s]);
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
      float2 x = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      float* dst;
      if (g_args.part != nullptr) {   // this q head's partial
        dst = g_args.part + (DK ? 0 : (size_t)a.B * a.Hq * plane) +
              (size_t)qp * plane;
      } else {                        // G = 1: the kv head's gradient
        dst = (DK ? g_args.dk : g_args.dv) + (size_t)(b * a.Hkv + h / G) *
                                                 plane;
        if (DK) x = make_float2(x.x * a.scale, x.y * a.scale);
      }
      *reinterpret_cast<float2*>(dst + (size_t)key * D + col) = x;
    }
  }
}

// blockIdx.y: key tile (y / 2), gradient (y % 2: 0 dK, 1 dV). tq, tdo: Q's
// and dO's hi and lo (D, S, 2 B Hq), BQ-row boxes; tk, tv: K's and V's
// (D, Skv, 2 B Hkv), 64-row boxes; tqt, tdot: Q^T's and dO^T's (S padded,
// D, 2 B Hq), boxes of 32 rows x D.
template <int D, int BQ>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dkdv_tf32x3(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tqt,
                const __grid_constant__ CUtensorMap tdot, DkvArgs args,
                Attn a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = (blockIdx.y >> 1) * kBwdRows;
  if ((blockIdx.y & 1) == 0) {
    dkdv_block<D, BQ, true>(&tq, &tdo, &tk, &tv, &tqt, &tdot, args, a, smem,
                            h, b, k0);
  } else {
    dkdv_block<D, BQ, false>(&tq, &tdo, &tk, &tv, &tqt, &tdot, args, a, smem,
                             h, b, k0);
  }
}

// dK and dV of each kv head from the G partials of its group (part (2, B,
// Hq, Skv, D), dK's first), summed in head order; dK scaled. blockIdx.y:
// 0 dK, 1 dV.
__global__ void __launch_bounds__(256)
    group_sum_f32(const float* __restrict__ part, float* __restrict__ dk,
                  float* __restrict__ dv, int B, int Hq, int Hkv, int plane,
                  float scale) {
  const int G = Hq / Hkv;
  const float* src = part + blockIdx.y * (size_t)B * Hq * plane;
  float* dst = blockIdx.y ? dv : dk;
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
    *reinterpret_cast<float4*>(dst + idx) =
        make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul);
  }
}

// Launches of each kernel (0 split_tf32 for the forward, 1 flash_tf32x3,
// 2 split_tf32 for the backward, 3 dq_tf32x3, 4 dkdv_tf32x3,
// 5 group_sum_f32), counted beside each launch.
int g_launches[6] = {0, 0, 0, 0, 0, 0};

int pad8(int n) { return (n + 7) / 8 * 8; }

template <typename K>
cudaError_t size_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int launch_split(const SplitJobs& jobs, int n_jobs, cudaStream_t s,
                 int counter) {
  size_t most = 1;
  for (int i = 0; i < n_jobs; ++i) {
    const SplitJob& j = jobs.job[i];
    const size_t blocks = j.rows_pad == 0
        ? ((size_t)j.planes * j.rows * j.D / 4 + 255) / 256
        : (size_t)j.planes * ((j.rows_pad + 31) / 32) * (j.D / 32);
    most = blocks > most ? blocks : most;
  }
  const int grid_x = (int)(most < 1056 ? most : 1056);
  split_tf32<<<dim3(grid_x, n_jobs), 256, 0, s>>>(jobs);
  ++g_launches[counter];
  return (int)cudaGetLastError();
}

template <int D, int BK, int KST, int VST>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, float* ks, float* vt, const Attn& a,
               cudaStream_t s) {
  const int pq = a.B * a.Hq, pk = a.B * a.Hkv, skv_pad = pad8(a.Skv);
  SplitJobs jobs{};
  jobs.job[0] = {k, ks, pk, a.Skv, D, 0};
  jobs.job[1] = {v, vt, pk, a.Skv, D, skv_pad};
  CUtensorMap tq, tk, tv;
  if (!hopper::tensor_map_f32(&tq, q, D, a.S, pq, kFwdRows) ||
      !hopper::tensor_map_f32(&tk, ks, D, a.Skv, 2 * pk, BK) ||
      !hopper::tensor_map_f32(&tv, vt, skv_pad, D, 2 * pk, D)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = FwdTile<D, BK, KST, VST>::kSmem;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = size_smem(flash_tf32x3<D, BK, KST, VST>, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  int err = launch_split(jobs, 2, s, 0);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kFwdRows - 1) / kFwdRows, a.Hq, a.B);
  flash_tf32x3<D, BK, KST, VST><<<grid, kFwdThreads, smem, s>>>(
      tq, tk, tv, q, o, lse, a);
  ++g_launches[1];
  return (int)cudaGetLastError();
}

struct BwdPtrs {
  const float *q, *k, *v, *dout, *lse;
  float *dsum, *dq, *dk, *dv, *part;
  float *qs, *dos, *ks, *vs, *kt, *qt, *dot;
};

template <int D, int BK, int ST, int BQ>
int launch_bwd(const BwdPtrs& p, const Attn& a, cudaStream_t s) {
  const int pq = a.B * a.Hq, pk = a.B * a.Hkv;
  const int s_pad = pad8(a.S), skv_pad = pad8(a.Skv);
  SplitJobs jobs{};
  jobs.job[0] = {p.q, p.qs, pq, a.S, D, 0};
  jobs.job[1] = {p.dout, p.dos, pq, a.S, D, 0};
  jobs.job[2] = {p.k, p.ks, pk, a.Skv, D, 0};
  jobs.job[3] = {p.v, p.vs, pk, a.Skv, D, 0};
  jobs.job[4] = {p.k, p.kt, pk, a.Skv, D, skv_pad};
  jobs.job[5] = {p.q, p.qt, pq, a.S, D, s_pad};
  jobs.job[6] = {p.dout, p.dot, pq, a.S, D, s_pad};
  CUtensorMap tq_dq, tdo_dq, tk_dq, tv_dq, tkt, tq_kv, tdo_kv, tk_kv, tv_kv,
      tqt, tdot;
  if (!hopper::tensor_map_f32(&tq_dq, p.qs, D, a.S, 2 * pq, kBwdRows) ||
      !hopper::tensor_map_f32(&tdo_dq, p.dos, D, a.S, 2 * pq, kBwdRows) ||
      !hopper::tensor_map_f32(&tk_dq, p.ks, D, a.Skv, 2 * pk, BK) ||
      !hopper::tensor_map_f32(&tv_dq, p.vs, D, a.Skv, 2 * pk, BK) ||
      !hopper::tensor_map_f32(&tkt, p.kt, skv_pad, D, 2 * pk, D) ||
      !hopper::tensor_map_f32(&tq_kv, p.qs, D, a.S, 2 * pq, BQ) ||
      !hopper::tensor_map_f32(&tdo_kv, p.dos, D, a.S, 2 * pq, BQ) ||
      !hopper::tensor_map_f32(&tk_kv, p.ks, D, a.Skv, 2 * pk, kBwdRows) ||
      !hopper::tensor_map_f32(&tv_kv, p.vs, D, a.Skv, 2 * pk, kBwdRows) ||
      !hopper::tensor_map_f32(&tqt, p.qt, s_pad, D, 2 * pq, D) ||
      !hopper::tensor_map_f32(&tdot, p.dot, s_pad, D, 2 * pq, D)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem_q = DqTile<D, BK, ST>::kSmem;
  constexpr size_t smem_kv = DkvTile<D, BQ>::kSmem;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = size_smem(dq_tf32x3<D, BK, ST>, smem_q);
    if (err == cudaSuccess) err = size_smem(dkdv_tf32x3<D, BQ>, smem_kv);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  int err = launch_split(jobs, 7, s, 2);
  if (err != cudaSuccess) return err;
  dq_tf32x3<D, BK, ST><<<dim3(a.Hq, (a.S + kBwdRows - 1) / kBwdRows, a.B),
                         kBwdThreads, smem_q, s>>>(
      tq_dq, tdo_dq, tk_dq, tv_dq, tkt, p.lse, p.dsum, p.dq, a);
  ++g_launches[3];
  err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  const DkvArgs args{p.lse, p.dsum, p.dk, p.dv, G > 1 ? p.part : nullptr};
  const int key_tiles = (a.Skv + kBwdRows - 1) / kBwdRows;
  dkdv_tf32x3<D, BQ><<<dim3(a.Hq, 2 * key_tiles, a.B), kBwdThreads, smem_kv,
                       s>>>(tq_kv, tdo_kv, tk_kv, tv_kv, tqt, tdot, args, a);
  ++g_launches[4];
  err = (int)cudaGetLastError();
  if (err != cudaSuccess || G == 1) return err;
  const int plane = a.Skv * D;
  const size_t n4 = (size_t)a.B * a.Hkv * plane / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
  group_sum_f32<<<dim3(blocks, 2), 256, 0, s>>>(p.part, p.dk, p.dv, a.B,
                                                a.Hq, a.Hkv, plane, a.scale);
  ++g_launches[5];
  return (int)cudaGetLastError();
}

bool bad_shape(int D, int Hq, int Hkv, int Skv) {
  return (D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0;
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hkv, Skv, D), f32, contiguous, each base
// 16-byte aligned; D 64 or 128; window 0 for none -> o like q; lse: null,
// or (B, Hq, S) f32 for the rows' logsumexp. Scratch for the pre-pass's
// halves (f32, 16-byte aligned): ks (2, B, Hkv, Skv, D), vt (2, B, Hkv, D,
// Skv rounded up to 8). Two launches: split_tf32, then flash_tf32x3.
extern "C" int repro_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* ks, void* vt, int B, int Hq, int Hkv, int S, int Skv, int D,
    int causal, int window, float scale, void* stream) {
  if (bad_shape(D, Hq, Hkv, Skv)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  const Attn a{B, Hq, Hkv, S, Skv, D, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const float *q_ = (const float*)q, *k_ = (const float*)k,
              *v_ = (const float*)v;
  float *o_ = (float*)o, *l = (float*)lse;
  if (D == 64) {
    return launch_fwd<64, 64, 2, 2>(q_, k_, v_, o_, l, (float*)ks,
                                    (float*)vt, a, s);
  }
  return launch_fwd<128, 32, 2, 2>(q_, k_, v_, o_, l, (float*)ks, (float*)vt,
                                   a, s);
}

// q, dout (B, Hq, S, D); k, v (B, Hkv, Skv, D); lse (B, Hq, S) from the
// forward; dsum (B, Hq, S) scratch (written by dq, read by dkdv); dq like
// q, dk and dv like k; part (2, B, Hq, Skv, D) scratch when Hq > Hkv, else
// unused (may be null). Scratch for the pre-pass's halves: qs, dos (2, B,
// Hq, S, D), ks, vs (2, B, Hkv, Skv, D), kt (2, B, Hkv, D, Skv rounded up
// to 8), qt, dot (2, B, Hq, D, S rounded up to 8). All f32, contiguous,
// each base 16-byte aligned; D 64 or 128; window 0 for none, and no row
// without a valid key. Three launches (split_tf32, dq_tf32x3, dkdv_tf32x3),
// a fourth (group_sum_f32) when Hq > Hkv.
extern "C" int repro_flash_attention_bwd_tf32x3(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dsum, void* dq, void* dk, void* dv, void* part,
    void* qs, void* dos, void* ks, void* vs, void* kt, void* qt, void* dot,
    int B, int Hq, int Hkv, int S, int Skv, int D, int causal, int window,
    float scale, void* stream) {
  if (bad_shape(D, Hq, Hkv, Skv) || (Hq > Hkv && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  const Attn a{B, Hq, Hkv, S, Skv, D, causal, window, scale};
  const BwdPtrs p{(const float*)q,   (const float*)k,  (const float*)v,
                  (const float*)dout, (const float*)lse, (float*)dsum,
                  (float*)dq,        (float*)dk,       (float*)dv,
                  (float*)part,      (float*)qs,       (float*)dos,
                  (float*)ks,        (float*)vs,       (float*)kt,
                  (float*)qt,        (float*)dot};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_bwd<64, 64, 1, 64>(p, a, s);
  return launch_bwd<128, 32, 1, 32>(p, a, s);
}

// Launches of kernel `kernel` (0 split_tf32 of the forward, 1 flash_tf32x3,
// 2 split_tf32 of the backward, 3 dq_tf32x3, 4 dkdv_tf32x3, 5 group_sum_f32)
// since the last reset; reset != 0 sets that count to 0 after reading it.
extern "C" int repro_flash_attention_tf32x3_device_launches(int kernel,
                                                            int reset) {
  if (kernel < 0 || kernel > 5) return -1;
  const int n = g_launches[kernel];
  if (reset) g_launches[kernel] = 0;
  return n;
}
