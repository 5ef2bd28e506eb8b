// The octree build's assembly on the card: from each neuron's leaf and its
// stable rank in the leaf, the rank's local tree below the top tree, all of
// it in ONE cooperative launch:
//   - per leaf cell, the sum of its neurons' vacancy weights and of their
//     weighted positions, each added in ascending neuron order from +0.0 in
//     f32, each product position x weight rounded on its own;
//   - the parent levels, a parent ((c0 + c1) + c2) + ... + c7 of its eight
//     children in order;
//   - the capped membership table, leaf_members[l, s] = the member of leaf l
//     at rank s for s < min(M, count), else -1.
//
// Not a TPU kernel: the JAX package computes all of this in jnp
// (repro/connectome/tree.py:68-89, `.at[rel].add`, which XLA adds in
// ascending neuron order, `reshape(-1, 8).sum(1)` and the `slot < m`
// scatter). The plain version is repro_torch/connectome/tree.py::
// assemble_plain (_leaf_sums, a dense (leaf, slot) table summed column by
// column, which reads its width on the host; _sum8; the table scatter).
//
// Design. The leaf of neuron i is rel[i] and its stable rank among the
// leaf's neurons slot[i] (K3, or the reference's positions_within), so the
// members of a leaf in ascending order are known without a sort. One
// cooperative launch, a block an SM, grid.sync() between the phases:
//   0. zero the leaf counts;
//   1. count: one integer atomic a warp and leaf (the lanes of one leaf
//      found by __match_any_sync; exact in any order), so a leaf that holds
//      every row takes n / 32 atomics, not n;
//   2. every block scans the counts itself into shared memory (tiles of
//      kTile leaves, a warp a contiguous segment read by coalesced loads,
//      all in flight, scanned by shuffles, then over the warps), so no
//      second barrier is needed for the offsets; block 0 lists the
//      crowded leaves (more than kCrowded members) in ascending order.
//      Then place: order[offset[rel[i]] + slot[i]] = i, the members of
//      each leaf side by side in ascending neuron order, and the
//      membership table (its -1 padding written where s >= count, so no
//      cell is written twice);
//   3. leaf sums. A crowded leaf is summed by one whole block: 15 producer
//      warps gather order[], the position and the weight, form the products
//      and fill a ring of kRing stages in shared memory (component-major,
//      so each chain reads 16 bytes a load), signalled by named barriers
//      (bar.arrive / bar.sync: FULL and EMPTY a stage); in the consumer
//      warp four lanes each run one chain (count, x, y, z), the next
//      kBatch float4 loaded while the current ones are added. The fixed
//      order allows no tree, so the floor is the add latency: m x 4
//      cycles. Every other leaf is summed by one warp the same way, a
//      stage of 128 members at a time (the next stage's gathers in flight
//      while four lanes add);
//   4. the parent levels, a thread a cell adding its eight children in
//      order: level L - 1 by the block whose eight warps summed the cell's
//      leaves (leaf l is warp l mod warps'), then after one barrier block
//      0 alone, from shared memory, every level above it (one barrier, not
//      one a level), and the cells of level L - 1 with a crowded leaf.
// Every step is exact or in the reference's order, so the result is bit-equal
// to the plain version for any layout, crowded or not: the trailing +0.0 of
// a stage's padding changes no sum (a sum from +0.0 is never -0.0), as the
// plain version's trailing +0.0 columns change none.
//
// Bound on the H100: bytes. The function reads the positions (12 B), the
// weight (4 B), rel and slot (8 B) of each neuron and writes 16 B a cell of
// every level and 4 B a table entry: 1.7 MB at n = 65,536 and n_leaf =
// 4,096, 0.5 us at 3.35 TB/s. The launch and its barriers cost more than
// that. A leaf that holds every neuron of the rank (rows clamped into one
// leaf, as a loaded connectome can give) costs its n dependent adds a
// component: 65,536 x 4 cycles of add latency, about 0.13 ms at 1.98 GHz.
//
// Breakdown build. Built with -DREPRO_K35_BREAKDOWN (tools/k35_breakdown.py,
// never the library), thread 0 of each block stamps the global timer at the
// phases' ends (TREE_MARK), read back through repro_tree_marks.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace cg = cooperative_groups;

namespace {

#ifdef REPRO_K35_BREAKDOWN
constexpr int kMarks = 8;
__device__ long long d_marks[256][kMarks];
#define TREE_MARK(k)                                                 \
  do {                                                               \
    if (threadIdx.x == 0) {                                          \
      long long t_;                                                  \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
      d_marks[blockIdx.x][k] = t_;                                   \
    }                                                                \
  } while (0)
#else
#define TREE_MARK(k) \
  do {               \
  } while (0)
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCrowded = 2048;         // members above which a block sums
constexpr int kWarpStage = 128;        // members a warp stages at a time
constexpr int kDepth = kWarpStage / 32;
constexpr int kProducers = kThreads - 32;          // warps 1-15
constexpr int kPerProducer = 2;
constexpr int kBlockStage = kProducers * kPerProducer;  // 960 members
constexpr int kRing = 3;
constexpr int kBatch = 8;              // float4 a chain lane has in flight
constexpr int kRun = 16;               // leaves a lane scans a tile
constexpr int kTile = kThreads * kRun;
constexpr int kRingFloats = kRing * 4 * kBlockStage;
constexpr int kWarpFloats = kWarps * 4 * kWarpStage;
constexpr int kWorkFloats = kRingFloats > kWarpFloats ? kRingFloats
                                                      : kWarpFloats;

struct AssembleArgs {
  const float* pos;    // (n, 3)
  const float* w;      // (n,)
  const int* rel;      // (n,) in [0, n_leaf)
  const int* slot;     // (n,) stable rank in the leaf
  float* counts;       // every level's cells, level 0 first
  float* cents;        // (cells, 3), level 0 first
  int* members;        // (n_leaf, m)
  int* cnt;            // n_leaf: members a leaf
  int* order;          // n: the members, leaf by leaf
  int* crowd;          // n_leaf: the crowded leaves, ascending
  int n, n_leaf, levels, m;
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// The first cell of level k (levels 0..L, level L the leaves) in the
// concatenated level arrays.
__device__ __forceinline__ long long level_base(const AssembleArgs& a,
                                                int k) {
  long long b = 0;
  for (int j = 0; j < k; ++j) b += a.n_leaf >> (3 * (a.levels - j));
  return b;
}

// A member's four values: its weight and the weighted position, each
// product rounded on its own (the library is built with --fmad=false);
// zeros past the leaf's end.
__device__ __forceinline__ float4 member(const AssembleArgs& a, int idx,
                                         int end) {
  if (idx >= end) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long long i = __ldcg(a.order + idx);
  const float wi = __ldg(a.w + i);
  return make_float4(wi, __ldg(a.pos + 3 * i) * wi,
                     __ldg(a.pos + 3 * i + 1) * wi,
                     __ldg(a.pos + 3 * i + 2) * wi);
}

__device__ __forceinline__ float add4(float acc, float4 t) {
  acc += t.x;
  acc += t.y;
  acc += t.z;
  return acc + t.w;
}

// Lane c < 4 adds component c of q staged members (component-major rows of
// `stride` floats, padded with +0.0 to a multiple of 4) to acc, in order.
// The loads of the next kBatch float4 are issued before the current ones
// are added, so the only serial cost is the chain of adds.
__device__ __forceinline__ float add_chain(const float* stage, int stride,
                                           int lane, int q, float acc) {
  const float4* v = reinterpret_cast<const float4*>(stage + lane * stride);
  const int q4 = (q + 3) >> 2;
  int j = 0;
  if (q4 >= kBatch) {
    float4 cur[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) cur[b] = v[b];
    for (j = kBatch; j + kBatch <= q4; j += kBatch) {
      float4 nxt[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) nxt[b] = v[j + b];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) acc = add4(acc, cur[b]);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) cur[b] = nxt[b];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) acc = add4(acc, cur[b]);
  }
  for (; j < q4; ++j) acc = add4(acc, v[j]);
  return acc;
}

__device__ __forceinline__ void write_leaf(const AssembleArgs& a, float* lc,
                                           float* lx, int l, int lane,
                                           float acc) {
  if (lane == 0) {
    lc[l] = acc;
  } else if (lane < 4) {
    lx[3 * (long long)l + lane - 1] = acc;
  }
}

// One leaf [begin, end) of order[] summed by one warp, a stage of
// kWarpStage members at a time: lane j gathers members 32 q + j of the
// stage, the stage is staged component-major in the warp's `st` (4 x
// kWarpStage floats), and lanes 0-3 add one component each. The next
// stage's values and the ids of the one after are in flight meanwhile.
__device__ void sum_leaf_warp(const AssembleArgs& a, float* lc, float* lx,
                              int l, int begin, int end, float* st,
                              int lane) {
  float acc = 0.0f;
  float4 cur[kDepth];
  int ids[kDepth];
#pragma unroll
  for (int q = 0; q < kDepth; ++q) {
    const int i = begin + 32 * q + lane;
    cur[q] = member(a, i, end);
    const int i2 = i + kWarpStage;
    ids[q] = i2 < end ? __ldcg(a.order + i2) : -1;
  }
  for (int k = begin; k < end; k += kWarpStage) {
    float4 next[kDepth];
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      const int id = ids[q];
      if (id >= 0) {
        const float wi = __ldg(a.w + id);
        next[q] = make_float4(wi, __ldg(a.pos + 3LL * id) * wi,
                              __ldg(a.pos + 3LL * id + 1) * wi,
                              __ldg(a.pos + 3LL * id + 2) * wi);
      } else {
        next[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      const int i = k + 2 * kWarpStage + 32 * q + lane;
      ids[q] = i < end ? __ldcg(a.order + i) : -1;
      const int j = 32 * q + lane;
      st[j] = cur[q].x;
      st[kWarpStage + j] = cur[q].y;
      st[2 * kWarpStage + j] = cur[q].z;
      st[3 * kWarpStage + j] = cur[q].w;
    }
    __syncwarp();
    if (lane < 4) {
      acc = add_chain(st, kWarpStage, lane, min(kWarpStage, end - k), acc);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kDepth; ++q) cur[q] = next[q];
  }
  write_leaf(a, lc, lx, l, lane, acc);
}

// One crowded leaf [begin, end) of order[] summed by the whole block
// (every thread must call it). Producers (warps 1-15) fill stage k of the
// ring once the consumer has released it (EMPTY, from stage kRing on) and
// signal it (FULL); the consumer (warp 0) waits for FULL, adds the stage
// (lanes 0-3, one component each) and releases it, except the last kRing
// stages, which no producer waits for: every barrier's arrivals are
// matched.
__device__ void sum_leaf_block(const AssembleArgs& a, float* lc, float* lx,
                               int l, int begin, int end, float* ring) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = end - begin;
  const int stages = (m + kBlockStage - 1) / kBlockStage;
  if (warp == 0) {
    float acc = 0.0f;
    for (int k = 0; k < stages; ++k) {
      const int s = k % kRing;
      bar_sync(1 + s);
      if (lane < 4) {
        acc = add_chain(ring + s * 4 * kBlockStage, kBlockStage, lane,
                        min(kBlockStage, m - k * kBlockStage), acc);
      }
      __syncwarp();
      if (k + kRing < stages) bar_arrive(1 + kRing + s);
    }
    write_leaf(a, lc, lx, l, lane, acc);
  } else {
    const int p = threadIdx.x - 32;
    int ids[kPerProducer];
#pragma unroll
    for (int q = 0; q < kPerProducer; ++q) {
      const int idx = begin + q * kProducers + p;
      ids[q] = idx < end ? __ldcg(a.order + idx) : -1;
    }
    for (int k = 0; k < stages; ++k) {
      const int s = k % kRing;
      float4 v[kPerProducer];
#pragma unroll
      for (int q = 0; q < kPerProducer; ++q) {
        const int id = ids[q];
        if (id >= 0) {
          const float wi = __ldg(a.w + id);
          v[q] = make_float4(wi, __ldg(a.pos + 3LL * id) * wi,
                             __ldg(a.pos + 3LL * id + 1) * wi,
                             __ldg(a.pos + 3LL * id + 2) * wi);
        } else {
          v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        const int idx = begin + (k + 1) * kBlockStage + q * kProducers + p;
        ids[q] = idx < end ? __ldcg(a.order + idx) : -1;
      }
      if (k >= kRing) bar_sync(1 + kRing + s);
      float* st = ring + s * 4 * kBlockStage;
#pragma unroll
      for (int q = 0; q < kPerProducer; ++q) {
        const int j = q * kProducers + p;
        st[j] = v[q].x;
        st[kBlockStage + j] = v[q].y;
        st[2 * kBlockStage + j] = v[q].z;
        st[3 * kBlockStage + j] = v[q].w;
      }
      bar_arrive(1 + s);
    }
  }
  __syncthreads();   // the ring is reused by the next leaf
}

// ((v0 + v1) + v2) + ... + v7, component by component.
__device__ __forceinline__ float4 sum8(const float4 (&v)[8]) {
  float4 s = v[0];
#pragma unroll
  for (int g = 1; g < 8; ++g) {
    s.x += v[g].x;
    s.y += v[g].y;
    s.z += v[g].z;
    s.w += v[g].w;
  }
  return s;
}

__device__ __forceinline__ void store_cell(const AssembleArgs& a,
                                           long long e, float4 s) {
  a.counts[e] = s.x;
  a.cents[3 * e] = s.y;
  a.cents[3 * e + 1] = s.z;
  a.cents[3 * e + 2] = s.w;
}

// Whether a child of level L - 1 cell p holds more than kCrowded members.
__device__ __forceinline__ bool crowded_child(const int* off_s, int p) {
  bool c = false;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    c |= off_s[8 * p + g + 1] - off_s[8 * p + g] > kCrowded;
  }
  return c;
}

// Level L - 1 cell p from its eight leaves in global memory, all 32 loads
// in flight (plain loads through L1: a warp's loads of one child index
// fetch sectors that its other seven reuse).
__device__ __forceinline__ float4 from_leaves(const AssembleArgs& a,
                                              long long leaves, int p) {
  float4 v[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const long long e = leaves + 8LL * p + g;
    v[g] = make_float4(a.counts[e], a.cents[3 * e], a.cents[3 * e + 1],
                       a.cents[3 * e + 2]);
  }
  return sum8(v);
}

// The parent levels above level L - 1, by one block (every thread must call
// it) after level L - 1 is in global memory but for the cells with a
// crowded child, which it adds here from the leaves; then level by level, a
// thread a cell, from the level below in `lv`, shared memory of at least 16
// x (cells above the leaves) bytes that may alias off_s.
__device__ void parents(const AssembleArgs& a, const int* off_s,
                        float4* lv) {
  const int top = a.levels;
  const long long leaves = level_base(a, top);
  int cells = a.n_leaf >> 3;
  long long base = level_base(a, top - 1);
  for (int p = threadIdx.x; p < cells; p += kThreads) {
    if (crowded_child(off_s, p)) {
      store_cell(a, base + p, from_leaves(a, leaves, p));
    }
  }
  __syncthreads();                   // off_s is read no more
  for (int p = threadIdx.x; p < cells; p += kThreads) {
    const long long e = base + p;
    lv[p] = make_float4(a.counts[e], a.cents[3 * e], a.cents[3 * e + 1],
                        a.cents[3 * e + 2]);
  }
  __syncthreads();
  int src = 0;
  for (int k = top - 1; k >= 1; --k) {
    const int dst = src + cells;
    cells >>= 3;
    base = level_base(a, k - 1);
    for (int p = threadIdx.x; p < cells; p += kThreads) {
      float4 v[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) v[g] = lv[src + 8 * p + g];
      const float4 s = sum8(v);
      lv[dst + p] = s;
      store_cell(a, base + p, s);
    }
    src = dst;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) assemble_kernel(AssembleArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int n_leaf = a.n_leaf;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gtid = blockIdx.x * kThreads + tid;
  const int gsize = gridDim.x * kThreads;
  const int gw = gtid >> 5;
  const int nw = gsize >> 5;
  int* off_s = reinterpret_cast<int*>(smem);     // n_leaf + 1
  float* work = reinterpret_cast<float*>(
      smem + ((((size_t)n_leaf + 1) * sizeof(int) + 15) & ~(size_t)15));

  TREE_MARK(0);
  // ---- 0: zero the counts -----------------------------------------------
  for (int l = gtid; l < n_leaf; l += gsize) a.cnt[l] = 0;
  grid.sync();
  TREE_MARK(1);

  // ---- 1: count, one atomic a warp and leaf ------------------------------
  for (int i0 = gtid - lane; i0 < n; i0 += gsize) {       // warp-uniform
    const int i = i0 + lane;
    const int r = i < n ? __ldg(a.rel + i) : -1;
    const bool ok = r >= 0 && r < n_leaf;
    const unsigned same = __match_any_sync(kFull, ok ? r : -1);
    if (ok && lane == __ffs(same) - 1) atomicAdd(a.cnt + r, __popc(same));
  }
  grid.sync();
  TREE_MARK(2);

  // ---- 2: every block scans the counts; place; the membership table ------
  // tiles of kTile leaves, a warp a contiguous segment of 32 kRun, lane j
  // of it holding leaves j, j + 32, ... (coalesced loads, all in flight),
  // scanned in index order by warp shuffles, then over the warps
  __shared__ int wsum[kWarps], wcrowd[kWarps];
  int carry = 0, carry_crowded = 0;
  for (int t0 = 0; t0 < n_leaf; t0 += kTile) {
    const int seg = t0 + (tid >> 5) * 32 * kRun;
    int c[kRun], at[kRun], rank[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int l = seg + 32 * j + lane;
      c[j] = l < n_leaf ? __ldcg(a.cnt + l) : 0;
    }
    int run = 0, run_crowded = 0;
    if (seg < n_leaf) {                                  // warp-uniform
      const unsigned before_lane = (1u << lane) - 1u;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const unsigned crowd = __ballot_sync(kFull, c[j] > kCrowded);
        int x = c[j];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(kFull, x, o);
          if (lane >= o) x += u;
        }
        at[j] = run + x - c[j];
        rank[j] = run_crowded + __popc(crowd & before_lane);
        run += __shfl_sync(kFull, x, 31);
        run_crowded += __popc(crowd);
      }
    }
    if (lane == 0) {
      wsum[tid >> 5] = run;
      wcrowd[tid >> 5] = run_crowded;
    }
    __syncthreads();
    int before = 0, before_crowded = 0, total = 0, total_crowded = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w == (tid >> 5)) {
        before = total;
        before_crowded = total_crowded;
      }
      total += wsum[w];
      total_crowded += wcrowd[w];
    }
    __syncthreads();   // wsum is rewritten by the next tile
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int l = seg + 32 * j + lane;
      if (l < n_leaf) {
        off_s[l] = carry + before + at[j];
        if (blockIdx.x == 0 && c[j] > kCrowded) {
          a.crowd[carry_crowded + before_crowded + rank[j]] = l;
        }
      }
    }
    carry += total;
    carry_crowded += total_crowded;
  }
  const int n_crowded = carry_crowded;
  if (tid == 0) off_s[n_leaf] = carry;
  __syncthreads();
  TREE_MARK(3);
  for (int i = gtid; i < n; i += gsize) {
    const int r = __ldg(a.rel + i);
    const int s = __ldg(a.slot + i);
    if (r < 0 || r >= n_leaf || s < 0 || s >= off_s[r + 1] - off_s[r]) {
      continue;
    }
    a.order[off_s[r] + s] = i;
    if (s < a.m) a.members[(long long)r * a.m + s] = i;
  }
  const long long table = (long long)n_leaf * a.m;
  for (long long k = gtid; k < table; k += gsize) {
    const int l = (int)(k / a.m);
    const int s = (int)(k - (long long)l * a.m);
    if (s >= off_s[l + 1] - off_s[l]) a.members[k] = -1;
  }
  grid.sync();
  TREE_MARK(4);

  // ---- 3: the leaf sums ---------------------------------------------------
  const long long leaf0 = level_base(a, a.levels);
  float* lc = a.counts + leaf0;
  float* lx = a.cents + 3 * leaf0;
  for (int r = blockIdx.x; r < n_crowded; r += gridDim.x) {
    const int l = __ldcg(a.crowd + r);
    sum_leaf_block(a, lc, lx, l, off_s[l], off_s[l + 1], work);
  }
  float* st = work + (tid >> 5) * 4 * kWarpStage;
  for (int l = gw; l < n_leaf; l += nw) {        // warp-uniform
    const int begin = off_s[l], end = off_s[l + 1];
    if (end - begin > kCrowded) continue;
    sum_leaf_warp(a, lc, lx, l, begin, end, st, lane);
  }
  TREE_MARK(5);

  // ---- 4: the parent levels ----------------------------------------------
  // leaf l is warp l mod nw's, so a cell of level L - 1 has its eight
  // leaves summed by eight warps of one block, which adds the cell here
  // (but for a cell with a crowded leaf, summed by another block)
  if (a.levels == 0) return;
  __syncthreads();
  const long long base = level_base(a, a.levels - 1);
  for (int i = tid;; i += kThreads) {
    const long long l0 = (long long)(i >> 1) * nw + kWarps * blockIdx.x +
                         8 * (i & 1);
    if (l0 >= n_leaf) break;
    const int p = (int)(l0 >> 3);
    if (!crowded_child(off_s, p)) {
      store_cell(a, base + p, from_leaves(a, leaf0, p));
    }
  }
  grid.sync();
  if (blockIdx.x == 0) parents(a, off_s, reinterpret_cast<float4*>(smem));
  TREE_MARK(6);
}

// Kernel launches, counted beside the launch.
int g_launches = 0;

size_t smem_bytes(int n_leaf) {
  return ((((size_t)n_leaf + 1) * sizeof(int) + 15) & ~(size_t)15) +
         (size_t)kWorkFloats * sizeof(float);
}

}  // namespace

#ifdef REPRO_K35_BREAKDOWN
// The breakdown build's stamps of the last call, copied to host (256, 8)
// int64 (ns; 0 where a block stamped nothing), then cleared.
extern "C" int repro_tree_marks(long long* host) {
  void* dev = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev, d_marks);
  if (err == cudaSuccess) {
    err = cudaMemcpy(host, dev, sizeof(d_marks), cudaMemcpyDeviceToHost);
  }
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(d_marks));
  return (int)err;
}
#endif

// The assembly's device launches since the last reset; reset != 0 sets the
// count to 0 after reading it.
extern "C" int repro_tree_assemble_device_launches(int reset) {
  const int k = g_launches;
  if (reset) g_launches = 0;
  return k;
}

// positions (n, 3) f32, weights (n,) f32, rel and slot (n,) int32 with rel
// in [0, n_leaf) and slot the stable rank within the leaf; n_leaf a
// multiple of 8^levels. Writes counts (cells,) and centroids (cells, 3)
// f32 of levels 0..levels concatenated, level 0 first (level k holds
// n_leaf / 8^(levels - k) cells), and members (n_leaf, m) int32. work:
// 2 n_leaf + n int32 words (the counts, the members in leaf order, the
// crowded leaves), written before they are read.
// One cooperative launch.
extern "C" int repro_tree_assemble(const void* positions, const void* weights,
                                   const void* rel, const void* slot,
                                   void* counts, void* centroids,
                                   void* members, void* work, int n,
                                   int n_leaf, int levels, int m,
                                   void* stream) {
  if (n < 0 || n_leaf < 1 || levels < 0 || levels > 10 || m < 0 ||
      n_leaf % (1 << (3 * levels)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int dev;
  repro::DeviceFacts dv;
  cudaError_t err;
  if ((err = repro::current_device(&dev, &dv)) != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(n_leaf);
  if (smem > (size_t)dv.smem_optin - 1024) return (int)cudaErrorInvalidValue;
  int occ = 0;
  if ((err = repro::resident_blocks((const void*)assemble_kernel, dev,
                                    kThreads, smem, dv.smem_optin, &occ)) !=
      cudaSuccess) {
    return (int)err;
  }
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  AssembleArgs a;
  int* w = (int*)work;
  a.pos = (const float*)positions;
  a.w = (const float*)weights;
  a.rel = (const int*)rel;
  a.slot = (const int*)slot;
  a.counts = (float*)counts;
  a.cents = (float*)centroids;
  a.members = (int*)members;
  a.cnt = w;
  a.order = w + n_leaf;
  a.crowd = a.order + n;   // n_leaf words
  a.n = n;
  a.n_leaf = n_leaf;
  a.levels = levels;
  a.m = m;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)assemble_kernel,
                                    dim3((unsigned)dv.sms), dim3(kThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  ++g_launches;
  return (int)cudaGetLastError();
}
