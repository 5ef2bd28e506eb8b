// K2: phase-B Barnes-Hut traversal — frontier expansion, Gumbel-max node
// sampling with restarts, and leaf member selection, for Q queries against one
// rank's subtree.
//
// Replaces the JAX package's Pallas kernel kernels/bh_traverse.py::bh_traverse
// (pallas_call at :77; math connectome/traverse.py::phase_b_core).
// repro_torch/connectome/traverse.py::phase_b_core is the plain version; this
// file repeats its arithmetic op for op (built with --fmad=false): the node
// centre cent / max(count, 1e-9), the acceptance criterion
// size/sqrt(max(d2, 1e-12)) < theta, the distance |x|^2 + |y|^2 - 2<x,y> in
// FP32 (the zero lanes of the reference's 8-lane padding add nothing), the
// Gaussian weight, the Gumbel draws keyed by (seed, BH_DOMAIN, bh_ctr(chunk,
// round, draw), source gid), and argmax ties going to the first index as in
// jnp.argmax. Every output (target, ok, depth) is bit-equal on every row,
// valid or not: invalid queries run the search too, since the plain version
// returns their depth.
//
// Design.
// - A prologue (pack_nodes_kernel, in the same stream order) packs each real
//   node once a call as a float4 (count, y0, y1, y2), y = cent / max(count,
//   1e-9): the divisions depend on the node only, and IEEE division is
//   deterministic, so computing them once changes no bit. Level k holds the
//   first widths[k] cells of the stacked (L, C) arrays (the caller passes the
//   tree's real widths; by default all C), levels one after another.
// - A persistent grid (SMs x resident blocks, sized from device_facts.cuh)
//   of kWarps warps a block; each block stages the packed levels that fit in
//   its shared memory (at CONFIG all 4,681 nodes, 75 KB) with room left for
//   two blocks an SM; nodes beyond are read through __ldg as float4. Each
//   warp runs one query at a time, queries strided over the grid's warps.
// - The frontier (at most F <= 128 entries) lives in shared memory,
//   double-buffered per warp, as a count of valid entries (it is always
//   compact: entries land at exclusive-cumsum offsets, and drops are a
//   suffix) and, for each entry, its cell, level, squared distance to the
//   query and flags (statistics known, nonempty, wants expansion). A node's
//   statistics are computed when it enters the frontier and kept while it
//   stays; only what a decision reads is computed: an empty node's count
//   alone, the acceptance criterion above the deepest level only, and the
//   probability weight (the exp) only for the settled entries the Gumbel
//   pass draws for. Skipped values would be discarded, so no bit changes.
// - Fixed point. A sub-round in which every valid entry keeps one slot (no
//   entry takes 8 children, no valid entry is dropped; an expander that does
//   not fit stays as a coarse candidate in its slot) writes the frontier it
//   read, at the same offsets. A sub-round is a pure function of its
//   frontier, so every later sub-round repeats it exactly: the loop stops
//   there, with the same frontier, so the same result bit for bit. When
//   every entry needs one slot the offsets are known without a scan.
// - The two exclusive cumsums of the reference (traverse.py::
//   expand_and_sample) are prefix counts of two ballots (a need is 0, 1 or
//   8) over the valid entries only, the second taken only when the first
//   overflows F; the Gumbel-max pick is a warp argmax; a finished query
//   leaves the restart loop at once (the reference computes and discards
//   further rounds).
//
// Bound on the H100: operations. The search needs each frontier entry's
// statistics once (a distance, and a sqrt and a division above the deepest
// level), the weight (a division and an exp) and a Gumbel draw (a Threefry
// and two logs) for each valid nonempty entry of a settled frontier, and a
// draw for each valid leaf member; the bytes moved (tree, membership table,
// neuron data, queries) are a few MB. Gumbels of invalid entries are
// skipped: their value is NEG + g == NEG exactly, as in the reference.
// What holds it above that bound (PERF.md, tools/k2_breakdown.py): a warp
// runs one query's dependent chains (shared loads, IEEE division, sqrt, exp,
// the hash), with few entries a lane after the first round.
//
// -DREPRO_K2_BREAKDOWN (tools/k2_breakdown.py; never in the library build)
// adds per-call counters (queries, rounds, sub-rounds, frontier fill, node
// evaluations, draws) and clock64() cycle sums per part of a query, read
// through repro_k2_breakdown.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"
#include "hash.cuh"

namespace {

constexpr int kWarps = 16;         // warps (queries in flight) per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFrontier = 128;  // F <= BH_DRAWS
constexpr int kMaxPerLane = kMaxFrontier / 32;
constexpr int kMaxLevels = 16;
constexpr float kNeg = -1e30f;

// frontier entry flags
constexpr unsigned char kKnown = 1;     // statistics computed
constexpr unsigned char kNonempty = 2;  // count > 1e-9
constexpr unsigned char kExpand = 4;    // nonempty and not accepted

struct Params {
  int F, n_levels, chunk;
  uint32_t seed;
  float theta, sigma2;
  int staged;                       // packed nodes held in shared memory
  int level_off[kMaxLevels + 1];    // first packed node of each level
  float sizes[kMaxLevels];          // cell edge length of each level
};

#ifdef REPRO_K2_BREAKDOWN
// counters: 0 queries, 1 valid queries, 2 rounds, 3-5 queries that ran 1, 2,
// 3+ rounds, 6 node evaluations, 7 frontier draws, 8 member draws,
// 9-11 sub-rounds run in round 0, 1, 2+, 12-14 valid entries entering those
// sub-rounds, 15-17 sub-rounds that ended at the fixed point in round 0,
// 1, 2+, 18 cycles in node statistics, 19 cycles in scans and frontier
// writes, 20 cycles in the Gumbel pass, 21 cycles in member selection,
// 22 cycles a query in all
// Each warp of the grid adds into its own row (no atomics, so the counting
// perturbs the timing little); repro_k2_breakdown sums the rows.
constexpr int kCounters = 24;
constexpr int kCounterRows = 16384;   // warps of the grid counted
__device__ unsigned long long g_k2_counts[kCounterRows][kCounters];
// v is evaluated by every lane (it may be a warp collective), added by lane 0
#define K2_COUNT(i, v)                                                    \
  do {                                                                    \
    const unsigned long long k2v = (unsigned long long)(v);               \
    const unsigned k2w = blockIdx.x * kWarps + (threadIdx.x >> 5);        \
    if ((threadIdx.x & 31) == 0 && k2w < kCounterRows) {                  \
      g_k2_counts[k2w][i] += k2v;                                         \
    }                                                                     \
  } while (0)
#define K2_CLOCK(name) const long long name = clock64()
#else
#define K2_COUNT(i, v) \
  do {                 \
  } while (0)
#define K2_CLOCK(name) \
  do {                 \
  } while (0)
#endif

struct Query {
  float x0, x1, x2, xx;
};

// The packed tree as a warp reads it; level offsets and sizes are copied to
// shared memory (lanes index them by different levels).
struct Tree {
  const float4* smem;    // the staged nodes [0, staged)
  const float4* nodes;   // every packed node, in global memory
  const int* off;        // [kMaxLevels + 1] first packed node of each level
  const float* size;     // [kMaxLevels] cell edge length of each level
};

// shared bytes of the level table (offsets, sizes) after the staged nodes
constexpr int kLevelTableBytes =
    ((kMaxLevels + 1) * 4 + kMaxLevels * 4 + 15) / 16 * 16;

__device__ __forceinline__ float4 load_node(const Tree& t, const Params& p,
                                            int cell, int lvl) {
  const int node = t.off[lvl] + cell;
  return node < p.staged ? t.smem[node] : __ldg(t.nodes + node);
}

// The decision statistics of the node at (lvl, cell): its flags, and its
// squared distance d2 to the query (kept for the probability weight, which
// only a settled entry needs). An empty node needs neither, and a
// deepest-level node no acceptance criterion: their results would be
// discarded.
__device__ __forceinline__ unsigned char node_flags(const Tree& t,
                                                    const Params& p,
                                                    const Query& q, int cell,
                                                    int lvl, float* d2_out) {
  const float4 nd = load_node(t, p, cell, lvl);
  if (!(nd.x > 1e-9f)) return kKnown;
  const float yy = nd.y * nd.y + nd.z * nd.z + nd.w * nd.w;
  const float xy = q.x0 * nd.y + q.x1 * nd.z + q.x2 * nd.w;
  float d2 = q.xx + yy - 2.0f * xy;
  d2 = d2 > 0.0f ? d2 : 0.0f;
  *d2_out = d2;
  bool accepted = lvl >= p.n_levels - 1;
  if (!accepted) {
    const float crit = t.size[lvl] / sqrtf(d2 > 1e-12f ? d2 : 1e-12f);
    accepted = crit < p.theta;
  }
  return kKnown | kNonempty | (accepted ? 0 : kExpand);
}

// The probability weight count * exp(-d2 / sigma^2) of a nonempty node.
__device__ __forceinline__ float node_prob(const Tree& t, const Params& p,
                                           int cell, int lvl, float d2) {
  return load_node(t, p, cell, lvl).x * expf(-d2 / p.sigma2);
}

// Exclusive prefix sum over the warp of a need in {0, 1, 8}, from two
// ballots; *total is the warp's sum.
__device__ __forceinline__ int warp_need_prefix(int need, int* total) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  const unsigned b1 = __ballot_sync(0xffffffffu, need == 1);
  const unsigned b8 = __ballot_sync(0xffffffffu, need == 8);
  *total = __popc(b1) + 8 * __popc(b8);
  return __popc(b1 & lt) + 8 * __popc(b8 & lt);
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

// One warp's frontier: two buffers of F entries each, in shared memory.
struct Frontier {
  int* cell;            // [2][F]
  float* d2;            // [2][F] squared distance to the query
  unsigned char* lvl;   // [2][F]
  unsigned char* flag;  // [2][F]
};

__host__ __device__ __forceinline__ int frontier_bytes(int F) {
  return ((2 * F * (4 + 4 + 1 + 1)) + 15) / 16 * 16;
}

__device__ __forceinline__ Frontier frontier_at(unsigned char* base, int F) {
  Frontier fr;
  fr.cell = (int*)base;
  fr.d2 = (float*)(base + 2 * F * 4);
  fr.lvl = base + 2 * F * 8;
  fr.flag = base + 2 * F * 9;
  return fr;
}

// One paper round (traverse.py::expand_and_sample) for one query, by one
// warp. Returns the sampled (cell, level) and whether any entry was valid.
// ridx: the round's index in the restart loop (read by the counters only).
__device__ __forceinline__ void expand_and_sample(
    const Tree& t, const Params& p, const Query& q, const Frontier& fr,
    int root_cell, int root_rel, uint32_t src, int rnd, int ridx,
    int* out_cell, int* out_lvl, bool* out_valid) {
  (void)ridx;
  const int lane = threadIdx.x & 31;
  const int F = p.F;
  const int last = p.n_levels - 1;
  // init: the 8 children of the root (or the root itself at the deepest
  // level); entries past nv are invalid
  const bool at_leaf = root_rel >= last;
  int nv = at_leaf ? 1 : 8;
  int cur = 0;
  if (lane < nv) {
    fr.cell[lane] = at_leaf ? root_cell : root_cell * 8 + lane;
    fr.lvl[lane] = (unsigned char)(at_leaf ? root_rel : root_rel + 1);
    fr.flag[lane] = 0;
  }
  __syncwarp();
  for (int r = 0; r < p.n_levels; ++r) {
    K2_COUNT(9 + (ridx > 2 ? 2 : ridx), 1);
    K2_COUNT(12 + (ridx > 2 ? 2 : ridx), nv);
    K2_CLOCK(c0);
    const int nk = (nv + 31) >> 5;
    int* cell = fr.cell + cur * F;
    float* d2 = fr.d2 + cur * F;
    unsigned char* lvl = fr.lvl + cur * F;
    unsigned char* flag = fr.flag + cur * F;
    unsigned char fl[kMaxPerLane];
    int evals = 0;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      fl[k] = 0;
      const int e = k * 32 + lane;
      if (k < nk && e < nv) {
        fl[k] = flag[e];
        if (!(fl[k] & kKnown)) {
          fl[k] = node_flags(t, p, q, cell[e], lvl[e], &d2[e]);
          flag[e] = fl[k];
          ++evals;
        }
      }
    }
    (void)evals;
    K2_COUNT(6, __reduce_add_sync(0xffffffffu, evals));
    K2_CLOCK(c1);
    // need: 8 expand / 1 keep / 0 drop (empty); entries past nv need 0.
    // When every entry needs 1, every offset is the entry's own index and
    // nothing moves: no scan is needed.
    int need[kMaxPerLane], need2[kMaxPerLane], off2[kMaxPerLane];
    bool moves = false;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      need[k] = (fl[k] & kExpand) ? 8 : ((fl[k] & kNonempty) ? 1 : 0);
      need2[k] = need[k];
      off2[k] = k * 32 + lane;
      moves = moves || (k < nk && k * 32 + lane < nv && need[k] != 1);
    }
    if (__any_sync(0xffffffffu, moves)) {
      // first exclusive cumsum -> fits; the second pass (overflowing
      // expanders kept as single coarse candidates) only if it overflows
      int carry = 0;
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k) {
        if (k >= nk) break;
        int sum;
        off2[k] = carry + warp_need_prefix(need[k], &sum);
        carry += sum;
      }
      if (carry > F) {
        carry = 0;
#pragma unroll
        for (int k = 0; k < kMaxPerLane; ++k) {
          if (k >= nk) break;
          if (need[k] == 8 && off2[k] + 8 > F) need2[k] = 1;
          int sum;
          off2[k] = carry + warp_need_prefix(need2[k], &sum);
          carry += sum;
          if (off2[k] + need2[k] > F) need2[k] = 0;  // dropped (mode="drop")
        }
      }
    }
    // the fixed point: every valid entry keeps one slot, its own (this
    // includes expanders that do not fit, kept as coarse candidates)
    int written = 0;
    moves = false;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      if (k >= nk) break;
      written += need2[k];
      moves = moves || (k * 32 + lane < nv && need2[k] != 1);
    }
    if (!__any_sync(0xffffffffu, moves)) {
      K2_COUNT(15 + (ridx > 2 ? 2 : ridx), 1);
      K2_CLOCK(c2);
      K2_COUNT(18, c1 - c0);
      K2_COUNT(19, c2 - c1);
      break;
    }
    const int nxt = cur ^ 1;
    int* ncell = fr.cell + nxt * F;
    float* nd2 = fr.d2 + nxt * F;
    unsigned char* nlvl = fr.lvl + nxt * F;
    unsigned char* nflag = fr.flag + nxt * F;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      if (k >= nk) break;
      const int e = k * 32 + lane;
      if (need2[k] == 1) {
        ncell[off2[k]] = cell[e];
        nlvl[off2[k]] = lvl[e];
        nd2[off2[k]] = d2[e];
        nflag[off2[k]] = fl[k];
      } else if (need2[k] == 8) {
        const int c8 = cell[e] * 8;
        const unsigned char l1 = (unsigned char)(lvl[e] + 1);
        for (int j = 0; j < 8; ++j) {
          ncell[off2[k] + j] = c8 + j;
          nlvl[off2[k] + j] = l1;
          nflag[off2[k] + j] = 0;
        }
      }
    }
    nv = (int)__reduce_add_sync(0xffffffffu, (unsigned)written);
    __syncwarp();
    cur = nxt;
    K2_CLOCK(c2);
    K2_COUNT(18, c1 - c0);
    K2_COUNT(19, c2 - c1);
  }
  // Gumbel-max sample over the settled frontier
  K2_CLOCK(g0);
  const int* cell = fr.cell + cur * F;
  float* d2 = fr.d2 + cur * F;
  const unsigned char* lvl = fr.lvl + cur * F;
  const unsigned char* flag = fr.flag + cur * F;
  float best = kNeg;     // entries past nv and empty entries: NEG + g == NEG
  int best_idx = lane < F ? lane : 0x7fffffff;
  int evals = 0, draws = 0;
  bool any_valid = false;
  for (int e = lane; e < nv; e += 32) {
    unsigned char f = flag[e];
    if (!(f & kKnown)) {
      f = node_flags(t, p, q, cell[e], lvl[e], &d2[e]);
      ++evals;
    }
    if (f & kNonempty) {
      const float pr = node_prob(t, p, cell[e], lvl[e], d2[e]);
      const float logit = logf(pr > 1e-30f ? pr : 1e-30f);
      any_valid = any_valid || (logit > kNeg / 2);
      const float val = logit + repro::hash_gumbel(
                                    p.seed, repro::BH_DOMAIN,
                                    repro::bh_ctr(p.chunk, rnd, e), src);
      ++draws;
      if (val > best) {
        best = val;
        best_idx = e;
      }
    }
  }
  (void)evals;
  (void)draws;
  K2_COUNT(6, __reduce_add_sync(0xffffffffu, evals));
  K2_COUNT(7, __reduce_add_sync(0xffffffffu, draws));
  warp_argmax(&best, &best_idx);
  const bool in = best_idx < nv;
  *out_cell = in ? cell[best_idx] : 0;
  *out_lvl = in ? (int)lvl[best_idx] : 0;
  *out_valid = __any_sync(0xffffffffu, any_valid);
  __syncwarp();
  K2_CLOCK(g1);
  K2_COUNT(20, g1 - g0);
}

__global__ void pack_nodes_kernel(const float* __restrict__ counts,
                                  const float* __restrict__ cents,
                                  float4* __restrict__ nodes, int total,
                                  int L, int C, Params p) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int k = 0;
    while (k + 1 < L && i >= p.level_off[k + 1]) ++k;
    const long long idx = (long long)k * C + (i - p.level_off[k]);
    const float c = counts[idx];
    const float den = c > 1e-9f ? c : 1e-9f;
    nodes[i] = make_float4(c, cents[3 * idx + 0] / den,
                           cents[3 * idx + 1] / den, cents[3 * idx + 2] / den);
  }
}

__global__ void __launch_bounds__(kThreads) bh_traverse_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ members,
    const float* __restrict__ npos, const float* __restrict__ vac,
    const float* __restrict__ xq, const int* __restrict__ start,
    const int* __restrict__ gid, const unsigned char* __restrict__ valid_in,
    int* __restrict__ out_tgt, unsigned char* __restrict__ out_ok,
    int* __restrict__ out_depth, int Q, int M, int n_leaf, int gid_base,
    int round_base, int member_round, Params p) {
  // dynamic shared memory: the staged nodes, the level table, then each
  // warp's frontier
  extern __shared__ __align__(16) unsigned char smem[];
  float4* staged = (float4*)smem;
  int* off = (int*)(smem + (size_t)p.staged * 16);
  float* size = (float*)(off + kMaxLevels + 1);
  for (int i = threadIdx.x; i < p.staged; i += kThreads) {
    staged[i] = __ldg(nodes + i);
  }
  if (threadIdx.x <= kMaxLevels) off[threadIdx.x] = p.level_off[threadIdx.x];
  if (threadIdx.x < kMaxLevels) size[threadIdx.x] = p.sizes[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Tree t{staged, nodes, off, size};
  const Frontier fr = frontier_at(smem + (size_t)p.staged * 16 +
                                      kLevelTableBytes +
                                      (size_t)warp * frontier_bytes(p.F),
                                  p.F);
  const int last = p.n_levels - 1;
  for (int qi = blockIdx.x * kWarps + warp; qi < Q;
       qi += gridDim.x * kWarps) {
    K2_CLOCK(q0);
    Query q;
    q.x0 = xq[3 * qi + 0];
    q.x1 = xq[3 * qi + 1];
    q.x2 = xq[3 * qi + 2];
    q.xx = q.x0 * q.x0 + q.x1 * q.x1 + q.x2 * q.x2;
    const int src_gid = gid[qi];
    const uint32_t src = (uint32_t)src_gid;
    const bool vin = valid_in[qi] != 0;
    // ---- restart loop (traverse.py::bh_search) --------------------------
    int cell = start[qi], rel = 0, depth = 0;
    bool valid = true;
    for (int i = 0; i < p.n_levels; ++i) {
      int ncell, nrel;
      bool nvalid;
      expand_and_sample(t, p, q, fr, cell, rel, src, round_base + i, i,
                        &ncell, &nrel, &nvalid);
      cell = ncell;
      rel = nrel;
      valid = nvalid;
      depth += 1;
      if (rel >= last || !valid) break;  // done: later rounds are discarded
    }
    valid = valid && rel >= last && vin;
    K2_COUNT(0, 1);
    K2_COUNT(1, vin);
    K2_COUNT(2, depth);
    K2_COUNT(depth >= 3 ? 5 : 2 + depth, 1);
    // ---- member selection (traverse.py::select_member) ------------------
    K2_CLOCK(m0);
    float val = kNeg;
    int msafe = 0;
    bool mlogit_valid = false;
    if (lane < M) {
      // the reference gathers with clamped indices
      const int leaf = cell < 0 ? 0 : (cell < n_leaf ? cell : n_leaf - 1);
      const int mem = members[leaf * M + lane];
      bool mvalid = mem >= 0;
      msafe = mvalid ? mem : 0;
      mvalid = mvalid && (gid_base + msafe != src_gid);  // no self-connection
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
    K2_COUNT(8, __popc(__ballot_sync(0xffffffffu, val > kNeg)));
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
    K2_CLOCK(m1);
    K2_COUNT(21, m1 - m0);
    K2_COUNT(22, m1 - q0);
  }
}

}  // namespace

extern "C" int repro_bh_traverse(
    const void* counts, const void* cents, const void* members,
    const void* npos, const void* vac, const void* x, const void* start,
    const void* gid, const void* valid, const float* sizes,
    const int* widths, void* nodes, void* out_tgt, void* out_ok,
    void* out_depth, int Q, int L, int C, int M, int F, int n_levels,
    int chunk, int gid_base, unsigned int seed, float theta, float sigma2,
    int round_base, int n_leaf, void* stream) {
  if (F > kMaxFrontier || M > 32 || F < 8 || L != n_levels || L < 1 ||
      L > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.F = F;
  p.n_levels = n_levels;
  p.chunk = chunk;
  p.seed = seed;
  p.theta = theta;
  p.sigma2 = sigma2;
  p.level_off[0] = 0;
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k < L && (widths[k] < 0 || widths[k] > C)) {
      return (int)cudaErrorInvalidValue;
    }
    p.level_off[k + 1] = p.level_off[k] + (k < L ? widths[k] : 0);
    p.sizes[k] = k < L ? sizes[k] : 0.0f;
  }
  const int total = p.level_off[L];
  cudaStream_t st = (cudaStream_t)stream;
  if (total > 0) {
    const int threads = 256;
    int blocks = (total + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    pack_nodes_kernel<<<blocks, threads, 0, st>>>(
        (const float*)counts, (const float*)cents, (float4*)nodes, total, L,
        C, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Q <= 0) return (int)cudaGetLastError();
  int dev;
  repro::DeviceFacts dv;
  cudaError_t err;
  if ((err = repro::current_device(&dev, &dv)) != cudaSuccess) return (int)err;
  // stage what fits with two blocks resident on an SM
  const int fbytes = kLevelTableBytes + kWarps * frontier_bytes(F);
  long long room = (long long)dv.smem_sm / 2 - dv.smem_reserved - fbytes;
  if (room > (long long)dv.smem_optin - fbytes) room = dv.smem_optin - fbytes;
  int staged = room > 0 ? (int)(room / 16) : 0;
  if (staged > total) staged = total;
  p.staged = staged;
  const size_t smem = (size_t)staged * 16 + fbytes;
  int occ = 0;
  if ((err = repro::resident_blocks((const void*)bh_traverse_kernel, dev,
                                    kThreads, smem, dv.smem_optin, &occ)) !=
      cudaSuccess) {
    return (int)err;
  }
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)dv.sms * occ;
  const long long need = ((long long)Q + kWarps - 1) / kWarps;
  if (blocks > need) blocks = need;
  bh_traverse_kernel<<<(int)blocks, kThreads, smem, st>>>(
      (const float4*)nodes, (const int*)members, (const float*)npos,
      (const float*)vac, (const float*)x, (const int*)start, (const int*)gid,
      (const unsigned char*)valid, (int*)out_tgt, (unsigned char*)out_ok,
      (int*)out_depth, Q, M, n_leaf, gid_base, round_base,
      repro::BH_ROUNDS - 1, p);
  return (int)cudaGetLastError();
}

#ifdef REPRO_K2_BREAKDOWN
// Sums the warps' counters into host memory (kCounters words) and, if
// reset, sets them to 0. Synchronises with the device.
extern "C" int repro_k2_breakdown(unsigned long long* out, int reset) {
  static unsigned long long rows[kCounterRows][kCounters];
  cudaError_t err = cudaMemcpyFromSymbol(rows, g_k2_counts, sizeof(rows));
  for (int i = 0; i < kCounters; ++i) {
    out[i] = 0;
    for (int w = 0; w < kCounterRows; ++w) out[i] += rows[w][i];
  }
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[kCounterRows][kCounters] = {};
    err = cudaMemcpyToSymbol(g_k2_counts, zero, sizeof(zero));
  }
  return (int)err;
}

extern "C" int repro_k2_breakdown_counters() { return kCounters; }
#endif
