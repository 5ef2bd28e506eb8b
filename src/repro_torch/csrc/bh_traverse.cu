// K2: phase-B Barnes-Hut traversal — frontier expansion, Gumbel-max node
// sampling with restarts, and leaf member selection, for Q queries against one
// rank's subtree.
//
// Replaces the JAX package's Pallas kernel kernels/bh_traverse.py::bh_traverse
// (pallas_call at :77; math connectome/traverse.py::phase_b_core).
// repro_torch/connectome/traverse.py::phase_b_core is the plain version; this
// file repeats its arithmetic op for op (built with --fmad=false): the
// acceptance criterion size/sqrt(max(d2, 1e-12)) < theta, the distance
// |x|^2 + |y|^2 - 2<x,y> in FP32 (the zero lanes of the reference's 8-lane
// padding add nothing), the Gaussian weight, the Gumbel draws keyed by
// (seed, BH_DOMAIN, bh_ctr(chunk, round, draw), source gid), and argmax ties
// going to the first index as in jnp.argmax.
//
// Design. One warp per query. The frontier (at most F <= 128 entries of cell,
// level and valid flag) lives in shared memory, double-buffered per warp; each
// lane owns entries lane, lane+32, ... . One expansion sub-round computes every
// entry's node statistics, the two exclusive cumsums of the reference
// (traverse.py::expand_and_sample) become warp scans, and each entry writes
// itself (or its 8 children) at its offset in the other buffer. The Gumbel-max
// pick is a warp argmax. A finished query leaves the restart loop at once (the
// reference computes and discards further rounds). The tree (L*C cells of
// count + centroid, 320 KB at L=5, C=4096) is larger than a block's shared
// memory, so it stays in global memory behind read-only loads; it fits in L2.
//
// Bound on the H100: operations. Per executed restart round a query evaluates
// up to F node statistics for each of n_levels expansion sub-rounds (a
// division, a sqrt, an exp each) plus F Gumbel draws (a Threefry hash and two
// logs each); the bytes moved (tree, membership table, neuron data, queries)
// are a few MB. Gumbels of invalid entries are skipped: their value is
// NEG + g == NEG exactly, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int kWarps = 4;          // queries (warps) per block
constexpr int kMaxFrontier = 128;  // F <= BH_DRAWS
constexpr int kMaxPerLane = kMaxFrontier / 32;
constexpr float kNeg = -1e30f;

struct Tree {
  const float* counts;   // (L, C)
  const float* cents;    // (L, C, 3)
  const float* sizes;    // (L,)
  int C;
};

struct Query {
  float x0, x1, x2, xx;
};

// count, probability weight and size/distance of node (lvl, cell)
__device__ __forceinline__ void node_stats(const Tree& t, const Query& q,
                                           int lvl, int cell, float sigma2,
                                           float* cnt, float* prob,
                                           float* crit) {
  const int idx = lvl * t.C + cell;
  const float c = __ldg(t.counts + idx);
  const float den = c > 1e-9f ? c : 1e-9f;
  const float y0 = __ldg(t.cents + 3 * idx + 0) / den;
  const float y1 = __ldg(t.cents + 3 * idx + 1) / den;
  const float y2 = __ldg(t.cents + 3 * idx + 2) / den;
  const float yy = y0 * y0 + y1 * y1 + y2 * y2;
  const float xy = q.x0 * y0 + q.x1 * y1 + q.x2 * y2;
  float d2 = q.xx + yy - 2.0f * xy;
  d2 = d2 > 0.0f ? d2 : 0.0f;
  *cnt = c;
  *crit = __ldg(t.sizes + lvl) / sqrtf(d2 > 1e-12f ? d2 : 1e-12f);
  *prob = c * expf(-d2 / sigma2);
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// warp argmax over (val, idx): larger val wins, ties go to the lower index
__device__ __forceinline__ void warp_argmax(float* val, int* idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, *val, o);
    const int oi = __shfl_xor_sync(0xffffffffu, *idx, o);
    if (ov > *val || (ov == *val && oi < *idx)) {
      *val = ov;
      *idx = oi;
    }
  }
}

struct Frontier {
  int cell[2][kMaxFrontier];
  int lvl[2][kMaxFrontier];
  unsigned char valid[2][kMaxFrontier];
};

struct Params {
  int F, n_levels, chunk;
  uint32_t seed;
  float theta, sigma2;
};

// One paper round (traverse.py::expand_and_sample) for one query, by one
// warp. Returns the sampled (cell, level), whether any entry was valid, and
// whether an expansion overflowed the frontier.
__device__ void expand_and_sample(const Tree& t, const Query& q,
                                  Frontier& fr, int root_cell, int root_rel,
                                  uint32_t src, int rnd, const Params& p,
                                  int* out_cell, int* out_lvl,
                                  bool* out_valid, bool* out_ovf) {
  const int lane = threadIdx.x & 31;
  const int F = p.F;
  const int last = p.n_levels - 1;
  const int per_lane = (F + 31) / 32;
  // init: the 8 children of the root (or the root itself at the deepest
  // level); the rest of the frontier is (0, 0, invalid)
  const bool at_leaf = root_rel >= last;
  int cur = 0;
  for (int k = 0; k < per_lane; ++k) {
    const int e = k * 32 + lane;
    if (e >= F) break;
    if (e < 8) {
      fr.cell[cur][e] = at_leaf ? root_cell : root_cell * 8 + e;
      fr.lvl[cur][e] = at_leaf ? root_rel : root_rel + 1;
      fr.valid[cur][e] = at_leaf ? (e == 0) : 1;
    } else {
      fr.cell[cur][e] = 0;
      fr.lvl[cur][e] = 0;
      fr.valid[cur][e] = 0;
    }
  }
  __syncwarp();
  bool overflow = false;
  for (int r = 0; r < p.n_levels; ++r) {
    int need[kMaxPerLane], need2[kMaxPerLane], off2[kMaxPerLane];
    bool expand[kMaxPerLane], keep[kMaxPerLane];
    // node statistics and the first-pass need (8 expand / 1 keep / 0 drop)
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      need[k] = 0;
      expand[k] = false;
      keep[k] = false;
      const int e = k * 32 + lane;
      if (k < per_lane && e < F && fr.valid[cur][e]) {
        const int lvl = fr.lvl[cur][e];
        float cnt, prob, crit;
        node_stats(t, q, lvl, fr.cell[cur][e], p.sigma2, &cnt, &prob, &crit);
        const bool nonempty = cnt > 1e-9f;
        const bool accepted = (crit < p.theta) || (lvl >= last);
        expand[k] = nonempty && !accepted;
        keep[k] = !expand[k] && nonempty;
        need[k] = expand[k] ? 8 : (keep[k] ? 1 : 0);
      }
    }
    // first exclusive cumsum -> fits; second pass keeps overflowing
    // expanders as single coarse candidates
    int carry = 0;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      if (k >= per_lane) break;
      const int inc = warp_inclusive_scan(need[k]);
      const int off = carry + inc - need[k];
      carry += __shfl_sync(0xffffffffu, inc, 31);
      const bool fits = off + need[k] <= F;
      need2[k] = (expand[k] && fits) ? 8
                 : ((keep[k] || (expand[k] && !fits)) ? 1 : 0);
    }
    carry = 0;
    bool ovf_lane = false;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      if (k >= per_lane) break;
      const int inc = warp_inclusive_scan(need2[k]);
      off2[k] = carry + inc - need2[k];
      carry += __shfl_sync(0xffffffffu, inc, 31);
      const bool fits2 = off2[k] + need2[k] <= F;
      if (!fits2) need2[k] = 0;           // dropped (scatter mode="drop")
      ovf_lane = ovf_lane || (expand[k] && !fits2);
    }
    const int nxt = cur ^ 1;
    for (int k = 0; k < per_lane; ++k) {
      const int e = k * 32 + lane;
      if (e >= F) break;
      fr.cell[nxt][e] = 0;
      fr.lvl[nxt][e] = 0;
      fr.valid[nxt][e] = 0;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      if (k >= per_lane) break;
      const int e = k * 32 + lane;
      if (need2[k] == 1) {
        fr.cell[nxt][off2[k]] = fr.cell[cur][e];
        fr.lvl[nxt][off2[k]] = fr.lvl[cur][e];
        fr.valid[nxt][off2[k]] = 1;
      } else if (need2[k] == 8) {
        const int c8 = fr.cell[cur][e] * 8;
        const int l1 = fr.lvl[cur][e] + 1;
        for (int j = 0; j < 8; ++j) {
          fr.cell[nxt][off2[k] + j] = c8 + j;
          fr.lvl[nxt][off2[k] + j] = l1;
          fr.valid[nxt][off2[k] + j] = 1;
        }
      }
    }
    overflow = overflow || __any_sync(0xffffffffu, ovf_lane);
    __syncwarp();
    cur = nxt;
  }
  // Gumbel-max sample over the settled frontier
  float best = kNeg;
  int best_idx = 0x7fffffff;
  bool any_valid = false;
  for (int k = 0; k < per_lane; ++k) {
    const int e = k * 32 + lane;
    if (e >= F) break;
    float val = kNeg;   // NEG + g rounds to NEG: invalid entries skip the draw
    if (fr.valid[cur][e]) {
      float cnt, prob, crit;
      node_stats(t, q, fr.lvl[cur][e], fr.cell[cur][e], p.sigma2, &cnt, &prob,
                 &crit);
      if (cnt > 1e-9f) {
        const float logit = logf(prob > 1e-30f ? prob : 1e-30f);
        any_valid = any_valid || (logit > kNeg / 2);
        val = logit + repro::hash_gumbel(p.seed, repro::BH_DOMAIN,
                                         repro::bh_ctr(p.chunk, rnd, e), src);
      }
    }
    if (val > best || (val == best && e < best_idx)) {
      best = val;
      best_idx = e;
    }
  }
  warp_argmax(&best, &best_idx);
  *out_cell = fr.cell[cur][best_idx];
  *out_lvl = fr.lvl[cur][best_idx];
  *out_valid = __any_sync(0xffffffffu, any_valid);
  *out_ovf = overflow;
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32) bh_traverse_kernel(
    Tree t, const int* __restrict__ members, const float* __restrict__ npos,
    const float* __restrict__ vac, const float* __restrict__ xq,
    const int* __restrict__ start, const int* __restrict__ gid,
    const unsigned char* __restrict__ valid_in, int* __restrict__ out_tgt,
    unsigned char* __restrict__ out_ok, int* __restrict__ out_depth, int Q,
    int M, int n_leaf, int gid_base, int round_base, int member_round,
    Params p) {
  __shared__ Frontier frontiers[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= Q) return;                   // whole warp leaves together
  Frontier& fr = frontiers[warp];
  Query q;
  q.x0 = xq[3 * qi + 0];
  q.x1 = xq[3 * qi + 1];
  q.x2 = xq[3 * qi + 2];
  q.xx = q.x0 * q.x0 + q.x1 * q.x1 + q.x2 * q.x2;
  const int src_gid = gid[qi];
  const uint32_t src = (uint32_t)src_gid;
  const int last = p.n_levels - 1;
  // ---- restart loop (traverse.py::bh_search) ----------------------------
  int cell = start[qi], rel = 0, depth = 0;
  bool valid = true;
  for (int i = 0; i < p.n_levels; ++i) {
    int ncell, nrel;
    bool nvalid, novf;
    expand_and_sample(t, q, fr, cell, rel, src, round_base + i, p, &ncell,
                      &nrel, &nvalid, &novf);
    cell = ncell;
    rel = nrel;
    valid = nvalid;
    depth += 1;
    if (rel >= last || !valid) break;    // done: later rounds are discarded
  }
  valid = valid && rel >= last && valid_in[qi] != 0;
  // ---- member selection (traverse.py::select_member) --------------------
  float val = kNeg;
  int msafe = 0;
  bool mlogit_valid = false;
  if (lane < M) {
    // the reference gathers with clamped indices
    const int leaf = cell < 0 ? 0 : (cell < n_leaf ? cell : n_leaf - 1);
    const int mem = members[leaf * M + lane];
    bool mvalid = mem >= 0;
    msafe = mvalid ? mem : 0;
    mvalid = mvalid && (gid_base + msafe != src_gid);   // no self-connection
    const float y0 = npos[3 * msafe + 0];
    const float y1 = npos[3 * msafe + 1];
    const float y2 = npos[3 * msafe + 2];
    const float yy = y0 * y0 + y1 * y1 + y2 * y2;
    const float xy = q.x0 * y0 + q.x1 * y1 + q.x2 * y2;
    float d2 = q.xx + yy - 2.0f * xy;
    d2 = d2 > 0.0f ? d2 : 0.0f;
    const float w = (mvalid ? vac[msafe] : 0.0f) * expf(-d2 / p.sigma2);
    if (mvalid && w > 1e-12f) {
      const float logit = logf(w > 1e-30f ? w : 1e-30f);
      mlogit_valid = logit > kNeg / 2;
      val = logit + repro::hash_gumbel(p.seed, repro::BH_DOMAIN,
                                       repro::bh_ctr(p.chunk, member_round,
                                                     lane), src);
    }
  }
  int pick = lane < M ? lane : 0x7fffffff;
  warp_argmax(&val, &pick);
  const int tgt_local = __shfl_sync(0xffffffffu, msafe, pick);
  const bool pvalid = __any_sync(0xffffffffu, mlogit_valid);
  if (lane == 0) {
    const bool ok = valid && pvalid;
    out_tgt[qi] = ok ? gid_base + tgt_local : -1;
    out_ok[qi] = ok;
    out_depth[qi] = depth;
  }
}

}  // namespace

extern "C" int repro_bh_traverse(
    const void* counts, const void* cents, const void* members,
    const void* npos, const void* vac, const void* x, const void* start,
    const void* gid, const void* valid, const void* sizes, void* out_tgt,
    void* out_ok, void* out_depth, int Q, int L, int C, int M, int F,
    int n_levels, int chunk, int gid_base, unsigned int seed, float theta,
    float sigma2, int round_base, int n_leaf, void* stream) {
  (void)L;
  if (F > kMaxFrontier || M > 32 || F < 8) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  Tree t;
  t.counts = (const float*)counts;
  t.cents = (const float*)cents;
  t.sizes = (const float*)sizes;
  t.C = C;
  Params p;
  p.F = F;
  p.n_levels = n_levels;
  p.chunk = chunk;
  p.seed = seed;
  p.theta = theta;
  p.sigma2 = sigma2;
  const int blocks = (Q + kWarps - 1) / kWarps;
  bh_traverse_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      t, (const int*)members, (const float*)npos, (const float*)vac,
      (const float*)x, (const int*)start, (const int*)gid,
      (const unsigned char*)valid, (int*)out_tgt, (unsigned char*)out_ok,
      (int*)out_depth, Q, M, n_leaf, gid_base, round_base,
      repro::BH_ROUNDS - 1, p);
  return (int)cudaGetLastError();
}
