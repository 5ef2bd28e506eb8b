// K4: the synapse-table apply, and K5: the deletion-routing buffer build.
//
// K4 replaces the JAX package's Pallas kernel
// kernels/synapse_apply.py::synapse_apply (pallas_call at :63, body
// _apply_kernel): each valid deletion message (row, gid) removes the earliest
// slot of the row holding gid, the row is compacted (occupied slots to the
// front, in order), then the valid formation requests of the row are accepted
// in ascending (priority, request index) order, up to min(floor(vacant[row]),
// free slots) in f32, and written after the occupied slots. The plain version
// is repro_torch/kernels/synapse_apply.py::synapse_apply_plain
// (remove_edges_by_messages -> compact -> accept_core).
//
// K5 replaces kernels/synapse_apply.py::route_build (pallas_call at :95, body
// _route_kernel): the stable partition of the flattened (partner gid, my gid)
// pairs into per-destination (R, cap, 2) buffers, slot = #{earlier valid
// entries with the same destination rank}, entries with slot >= cap dropped
// and counted. The plain version is routing.route_build_core.
//
// Both are integer-exact (the priorities are computed outside, by the same
// torch expression for kernel and plain version), so kernel and plain version
// agree bit for bit.
//
// K4 design. The JAX form lexsorts the q + n*S message and slot items; here
// the work is per row. Messages and requests are grouped by row, and the
// placement order inside a row is arbitrary: nothing downstream depends on
// it, because
//   - a slot j holding gid g dies iff #{k < j : edge[k] == g} is below the
//     number of valid messages (row, g) — a count, not an order;
//   - the accepted requests are the cap smallest by the total order
//     (priority, request index), found by cap rounds of a warp argmin over
//     the row's requests, each round above the previous pick.
// The grouping and the rows are ONE cooperative launch (every block
// resident, cudaLaunchCooperativeKernel), in five phases with a grid.sync()
// between them, so nothing has to be zero beforehand and no phase is a
// single block:
//   0. zero the 2n per-row counts and write the accept mask in full (0);
//   1. count: each valid message or request takes its rank inside its row
//      from the atomicAdd that counts it (grid-stride, coalesced);
//   2. scan: block b owns a contiguous range of rows and scans the two count
//      arrays over it in coalesced tiles of 256 (a block scan with a carry),
//      writing row offsets local to the range and the range's totals;
//   3. every block scans the ranges' totals into shared memory (a thread a
//      run of them, one block scan), so a row's offset is its local offset
//      plus its range's prefix; the items are placed at offset + rank;
//   4. rows: one warp per row (S <= 32: one lane per slot) kills, compacts by
//      ballot and popc, and writes the accepted sources at base + rank. A
//      row's cost is O(S * (S + messages / 32) + cap * requests / 32): a row
//      swamped with requests costs cap passes over them, not a sort.
//
// K5 design. ONE cooperative launch a call (every block resident), four
// blocks of 256 threads an SM, block b owning a contiguous range of the
// entries (a multiple of 4) and warp w a contiguous chunk of it:
//   1. count: each warp reads its chunk once into shared memory (int4 loads,
//      4 in flight a lane) and counts it per destination with warp ballots
//      (one per bit of the destination: a lane counts the destinations lane
//      and lane + 32), so no atomics and no order; the block writes its row
//      of R counts;
//   2. grid.sync(); every block sums the rows of the blocks before it (its
//      exclusive start per destination) and all rows (the totals), all its
//      warps reading; block 0 writes the drop count, and the grid fills the
//      unused tail of each destination's buffer with -1;
//   3. place: a scan over the warps' counts gives each warp its starts, and
//      the warp walks its chunk in index order, 8 rounds of 32 at a time: an
//      entry's slot is its destination's running count (a shuffle from the
//      lane that holds it) plus the lanes before it with the same
//      destination (the ballots). A slot below the cap gets the partner gid
//      from shared memory and the own gid from flat_mine, read only for the
//      entries that land (the round's loads issued as soon as the slots are
//      known). A block (or warp) whose every start is at or past the cap
//      skips the step, so at a lesion's counts only the first blocks place
//      anything; small blocks, four an SM, spread those over more SMs.
// A range larger than the block's shared memory runs in stages (flat_other
// read again in step 3). The destination is a 64-bit multiply-high by a
// reciprocal of n computed on the host, exact for gids below 2^31.
//
// Bound on the H100: both move bytes with a few integer operations each. K4
// reads the (n, S) table and writes it back (16.8 MB at n = 65,536, S = 32)
// plus the messages and requests, and about 24 bytes a row and 16 an item of
// its own scratch, with four grid barriers. K5's function reads 2 * n * S
// int32 (16.8 MB) and writes R * cap * 8 bytes; the kernel reads flat_other
// once (8.4 MB) and flat_mine only where an entry lands. On an H100 80GB
// HBM3 at 700 W at the lesion's shape (tools/k35_breakdown.py) the launch
// and one barrier of an empty cooperative kernel of the same grid take 4.3
// us, the read of flat_other 2.2 (3.1 in the slowest block; 2.5 at 3.35
// TB/s), the starts and totals after the barrier 1.5, and the placing in the
// 17 blocks that place 3.4-5.5: sixteen rounds a warp of ballots, shuffles
// and the own gids' loads, on the critical path.
//
// Breakdown build. Built with -DREPRO_K35_BREAKDOWN (tools/k35_breakdown.py,
// never the library), thread 0 of each block of K5 stamps the global timer
// at the steps' ends (K5_MARK), read back through repro_k5_marks.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

// Exclusive prefix sum of x over the block (blockDim.x a multiple of 32, at
// most 1024). Returns the block total in *total. Every thread must call it.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_sums[33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    warp_sums[lane] = wi - w;            // exclusive prefix of warp totals
    if (lane == 31) warp_sums[32] = wi;  // the block total
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - x;
  if (total) *total = warp_sums[32];
  __syncthreads();                       // warp_sums is reused by the next call
  return out;
}

// ------------------------------------------------------------------ K4
constexpr int kApplyThreads = 256;
constexpr int kApplyMaxGrid = 2048;

struct ApplyArgs {
  const int* edges;
  int* out;
  const int* msg_lid;
  const int* msg_gid;
  const unsigned char* msg_valid;
  const int* req_lid;
  const int* req_src;
  const unsigned char* req_valid;
  const float* req_prio;
  const float* vacant;
  unsigned char* accept;
  int* cnt;        // 2n: messages, then requests, per row
  int* off;        // 2n: offsets local to the block's range of rows
  int* rank;       // qm + qr: an item's rank inside its row
  int* items;      // qm + qr: item ids grouped by row
  int* agg;        // 2 x grid: each range's totals
  int n, s_max, qm, qr;
  int rows;        // rows a block owns in the scan
};

// One row: remove, compact, accept (m0/mc: the row's messages in
// a.items[m0, m0 + mc); r0/rc: its requests in a.items[qm + r0, ...)).
__device__ void apply_row(const ApplyArgs& a, int row, int lane, int m0,
                          int mc, int r0, int rc) {
  const int s_max = a.s_max;
  const int* msg_items = a.items;
  const int* req_items = a.items + a.qm;
  const int e = lane < s_max ? a.edges[(size_t)row * s_max + lane] : -1;

  // ---- remove: valid messages (row, e) against earlier equal slots -----
  int matches = 0;
  for (int base = 0; base < mc; base += 32) {
    const int g = base + lane < mc ? a.msg_gid[msg_items[m0 + base + lane]]
                                   : -1;
    const int lim = min(32, mc - base);
    for (int k = 0; k < lim; ++k) matches += __shfl_sync(kFull, g, k) == e;
  }
  int earlier = 0;
  for (int k = 0; k < 32; ++k) {
    earlier += (k < lane) & (__shfl_sync(kFull, e, k) == e);
  }
  const bool keep = e >= 0 && earlier >= matches;

  // ---- compact ----------------------------------------------------------
  const unsigned kept = __ballot_sync(kFull, keep);
  const int base = __popc(kept);
  int* orow = a.out + (size_t)row * s_max;
  if (keep) orow[__popc(kept & ((1u << lane) - 1u))] = e;

  // ---- accept: the cap smallest (priority, index) of the row -----------
  int accepted = 0;
  if (rc > 0) {
    const float fl = floorf(a.vacant[row]);
    const float freef = (float)(s_max - base);
    const float cap = (fl < freef || isnan(fl)) ? fl : freef;
    float pp = 0.0f;
    int pi = -1;                               // previous pick; -1 = none
    while (accepted < rc && (float)accepted < cap) {
      float bp = 0.0f;
      int bi = kNone;
      for (int k = lane; k < rc; k += 32) {
        const int idx = req_items[r0 + k];
        const float p = a.req_prio[idx];
        const bool above = pi < 0 || p > pp || (p == pp && idx > pi);
        const bool below = bi == kNone || p < bp || (p == bp && idx < bi);
        if (above && below) {
          bp = p;
          bi = idx;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float op = __shfl_xor_sync(kFull, bp, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (oi != kNone &&
            (bi == kNone || op < bp || (op == bp && oi < bi))) {
          bp = op;
          bi = oi;
        }
      }
      if (lane == 0) {
        orow[base + accepted] = a.req_src[bi];
        a.accept[bi] = 1;
      }
      pp = bp;
      pi = bi;
      ++accepted;
    }
  }
  if (lane < s_max && lane >= base + accepted) orow[lane] = -1;
}

__global__ void __launch_bounds__(kApplyThreads)
    synapse_apply_kernel(ApplyArgs a) {
  extern __shared__ int pre_s[];                 // 2 x gridDim.x
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * kApplyThreads + tid;
  const int gsize = gridDim.x * kApplyThreads;
  const int grid_n = gridDim.x;

  // ---- 0: zero the counts, the accept mask in full ----------------------
  for (int k = gtid; k < 2 * n; k += gsize) a.cnt[k] = 0;
  for (int k = gtid; k < a.qr; k += gsize) a.accept[k] = 0;
  grid.sync();

  // ---- 1: count, and each item's rank inside its row ---------------------
  for (int k = gtid; k < a.qm; k += gsize) {
    const int r = a.msg_lid[k];
    if (a.msg_valid[k] && r >= 0 && r < n) a.rank[k] = atomicAdd(a.cnt + r, 1);
  }
  for (int k = gtid; k < a.qr; k += gsize) {
    const int r = a.req_lid[k];
    if (a.req_valid[k] && r >= 0 && r < n) {
      a.rank[a.qm + k] = atomicAdd(a.cnt + n + r, 1);
    }
  }
  grid.sync();

  // ---- 2: each block scans its range of rows, coalesced tiles -----------
  const int lo = (int)min((long long)blockIdx.x * a.rows, (long long)n);
  const int hi = min(lo + a.rows, n);
  for (int arr = 0; arr < 2; ++arr) {
    const int* cnt = a.cnt + (size_t)arr * n;
    int* off = a.off + (size_t)arr * n;
    int carry = 0;
    for (int base = lo; base < hi; base += kApplyThreads) {
      const int r = base + tid;
      const int x = r < hi ? cnt[r] : 0;
      int total;
      const int ex = block_exclusive_sum(x, &total);
      if (r < hi) off[r] = carry + ex;
      carry += total;
    }
    if (tid == 0) a.agg[arr * grid_n + blockIdx.x] = carry;
  }
  grid.sync();

  // ---- 3: the ranges' prefixes (every block), then place ----------------
  // thread t sums a contiguous run of `per` totals (independent loads), one
  // block scan gives each run's start, and the thread writes its run's
  // prefixes
  const int per = (grid_n + kApplyThreads - 1) / kApplyThreads;
  for (int arr = 0; arr < 2; ++arr) {
    const int* agg = a.agg + arr * grid_n;
    const int b0 = min(tid * per, grid_n);
    const int b1 = min(b0 + per, grid_n);
    int run = 0;
    for (int b = b0; b < b1; ++b) run += agg[b];
    run = block_exclusive_sum(run, nullptr);
    for (int b = b0; b < b1; ++b) {
      pre_s[arr * grid_n + b] = run;
      run += agg[b];
    }
  }
  __syncthreads();
  for (int k = gtid; k < a.qm; k += gsize) {
    const int r = a.msg_lid[k];
    if (a.msg_valid[k] && r >= 0 && r < n) {
      a.items[pre_s[r / a.rows] + a.off[r] + a.rank[k]] = k;
    }
  }
  for (int k = gtid; k < a.qr; k += gsize) {
    const int r = a.req_lid[k];
    if (a.req_valid[k] && r >= 0 && r < n) {
      a.items[a.qm + pre_s[grid_n + r / a.rows] + a.off[n + r] +
              a.rank[a.qm + k]] = k;
    }
  }
  grid.sync();

  // ---- 4: the rows, a warp each ------------------------------------------
  const int lane = tid & 31;
  for (int row = gtid >> 5; row < n; row += gsize >> 5) {   // warp-uniform
    const int b = row / a.rows;
    apply_row(a, row, lane, pre_s[b] + a.off[row], a.cnt[row],
              pre_s[grid_n + b] + a.off[n + row], a.cnt[n + row]);
  }
}

// ------------------------------------------------------------------ K5
#ifdef REPRO_K35_BREAKDOWN
constexpr int kMarks = 8;
__device__ long long d_marks[1024][kMarks];
#define K5_MARK(k)                                                   \
  do {                                                               \
    if (threadIdx.x == 0) {                                          \
      long long t_;                                                  \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
      d_marks[blockIdx.x][k] = t_;                                   \
    }                                                                \
  } while (0)
#else
#define K5_MARK(k) \
  do {             \
  } while (0)
#endif

constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kRouteBlocksPerSM = 4;     // the entries that land spread wide
constexpr int kRouteUnroll = 4;          // int4 loads in flight a thread
constexpr int kRouteBatch = 8;           // rounds a warp places at once
constexpr int kMaxRanks = 64;
// bytes of static shared memory the kernel may hold (the per-warp counts
// and four rows of R), kept out of the stage
constexpr int kRouteStatic = 4 * 1024;

struct RouteArgs {
  const int* other;
  const int* mine;
  int* buf;                    // (num_ranks, cap, 2)
  float* dropped;
  int* counts;                 // (grid, num_ranks): each block's counts
  unsigned long long magic;    // n >= 2: floor((2^64 - 1) / n) + 1; n == 1: 0
  unsigned unit;               // n == 1: ~0u (the gid is its rank); else 0
  int m, num_ranks, cap;
  int per_block;               // entries a block owns, a multiple of 4
  int stage;                   // entries shared memory holds, a multiple of 4
  int vec;                     // other is 16-byte aligned: int4 loads
};

// The destination rank of a partner gid, num_ranks for an empty entry
// (and for a gid at or past num_ranks * n, which the callers never pass).
// Branch-free, one code path for every n: the product is formed for an
// empty entry too, and at n = 1 (magic 0, unit ~0u) the gid itself is kept.
__device__ __forceinline__ int route_dest(int o, const RouteArgs& a) {
  const unsigned u = (unsigned)o;
  const unsigned q =
      (unsigned)__umul64hi((unsigned long long)u, a.magic) | (u & a.unit);
  return o < 0 || q >= (unsigned)a.num_ranks ? a.num_ranks : (int)q;
}

// One ballot per bit of the destinations in [0, 2^kBits) of a warp's lanes.
template <int kBits>
struct DestBallots {
  unsigned b[kBits];
  __device__ __forceinline__ explicit DestBallots(int d) {
#pragma unroll
    for (int k = 0; k < kBits; ++k) b[k] = __ballot_sync(kFull, (d >> k) & 1);
  }
  // the lanes whose destination is x (only x's low kBits bits are read)
  __device__ __forceinline__ unsigned lanes(int x) const {
    unsigned m = kFull;
#pragma unroll
    for (int k = 0; k < kBits; ++k) m &= ((x >> k) & 1) ? b[k] : ~b[k];
    return m;
  }
};

// Adds a warp's destinations to the lane's counts of destinations lane and
// lane + 32. Every lane of the warp must call it.
template <int kBits>
__device__ __forceinline__ void count_dests(int d, int lane, int& c0,
                                            int& c1) {
  const DestBallots<kBits> db(d);
  c0 += __popc(db.lanes(lane));
  if (kBits > 5) c1 += __popc(db.lanes(lane + 32));
}

// The warp's chunk [cs, ce) of a stage of len entries: contiguous, in warp
// order, each a multiple of 4 long but the last.
__device__ __forceinline__ void warp_chunk(int len, int warp, int* cs,
                                           int* ce) {
  const int chunk = ((len + kRouteWarps - 1) / kRouteWarps + 3) & ~3;
  *cs = min(warp * chunk, len);
  *ce = min(*cs + chunk, len);
}

// Reads the warp's chunk of flat_other[g0, g0 + len) (g0 a multiple of 4)
// into s when s is given, and adds its destinations to the lane's counts.
// Every lane of the warp must call it.
template <int kBits>
__device__ void route_load(const RouteArgs& a, long long g0, int len, int* s,
                           int& c0, int& c1) {
  const int lane = threadIdx.x & 31;
  int cs, ce;
  warp_chunk(len, threadIdx.x >> 5, &cs, &ce);
  int done = cs;
  if (a.vec) {
    const int v0 = cs >> 2;
    const int v1 = ce >> 2;
    const int4* src = reinterpret_cast<const int4*>(a.other + g0);
    for (int base = v0; base < v1; base += 32 * kRouteUnroll) {
      int4 x[kRouteUnroll];
#pragma unroll
      for (int u = 0; u < kRouteUnroll; ++u) {
        const int v = base + 32 * u + lane;
        x[u] = v < v1 ? __ldg(src + v) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kRouteUnroll; ++u) {
        const int v = base + 32 * u + lane;
        if (s && v < v1) reinterpret_cast<int4*>(s)[v] = x[u];
        count_dests<kBits>(route_dest(x[u].x, a), lane, c0, c1);
        count_dests<kBits>(route_dest(x[u].y, a), lane, c0, c1);
        count_dests<kBits>(route_dest(x[u].z, a), lane, c0, c1);
        count_dests<kBits>(route_dest(x[u].w, a), lane, c0, c1);
      }
    }
    done = max(cs, v1 << 2);        // an empty chunk may start off a 4
  }
  for (int base = done; base < ce; base += 32) {
    const int j = base + lane;
    const int o = j < ce ? __ldg(a.other + g0 + j) : -1;
    if (s && j < ce) s[j] = o;
    count_dests<kBits>(route_dest(o, a), lane, c0, c1);
  }
}

template <int kBits>
__global__ void __launch_bounds__(kRouteThreads, kRouteBlocksPerSM)
    route_build_kernel(RouteArgs a) {
  extern __shared__ int4 route_smem[];
  int* s = reinterpret_cast<int*>(route_smem);     // a.stage entries
  __shared__ int wc[kRouteWarps][kMaxRanks];       // a warp's counts, starts
  __shared__ int s_pre[kMaxRanks], s_tot[kMaxRanks], s_own[kMaxRanks],
      s_run[kMaxRanks];
  __shared__ int s_live;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = a.num_ranks;
  const int cap = a.cap;
  const long long lo = (long long)blockIdx.x * a.per_block;
  const int len = (int)max(0LL, min((long long)a.per_block, a.m - lo));
  const bool one_stage = len <= a.stage;
  const unsigned lt = (1u << lane) - 1u;
  K5_MARK(0);

  // ---- 1: the block's count per destination, by warp chunks --------------
  int c0 = 0, c1 = 0;
  for (int s0 = 0; s0 < len; s0 += a.stage) {
    route_load<kBits>(a, lo + s0, min(a.stage, len - s0),
                      one_stage ? s : nullptr, c0, c1);
  }
  if (lane < R) wc[warp][lane] = c0;
  if (lane + 32 < R) wc[warp][lane + 32] = c1;
  __syncthreads();
  if (tid < R) {
    int t = 0;
    for (int w = 0; w < kRouteWarps; ++w) t += wc[w][tid];
    a.counts[(size_t)blockIdx.x * R + tid] = t;
    s_own[tid] = t;
    s_pre[tid] = 0;
    s_tot[tid] = 0;
  }
  K5_MARK(1);
  grid.sync();
  K5_MARK(2);

  // ---- 2: this block's starts and the totals; drop count; tails ----------
  // kRouteWarps / R warps a destination (one when R >= kRouteWarps), each
  // summing every wpd-th run of 32 blocks' counts
  const int wpd = R < kRouteWarps ? kRouteWarps / R : 1;
  for (int d = warp / wpd; d < R; d += kRouteWarps / wpd) {
    int pre = 0, tot = 0;
#pragma unroll 4
    for (int j = (warp % wpd) * 32 + lane; j < (int)gridDim.x;
         j += 32 * wpd) {
      const int v = __ldcg(a.counts + (size_t)j * R + d);
      tot += v;
      pre += j < (int)blockIdx.x ? v : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tot += __shfl_xor_sync(kFull, tot, o);
      pre += __shfl_xor_sync(kFull, pre, o);
    }
    if (lane == 0) {
      atomicAdd(s_pre + d, pre);
      atomicAdd(s_tot + d, tot);
    }
  }
  __syncthreads();
  if (tid < R) s_run[tid] = s_pre[tid];
  if (blockIdx.x == 0 && tid == 0) {
    long long drop = 0;
    for (int d = 0; d < R; ++d) drop += s_tot[d] > cap ? s_tot[d] - cap : 0;
    a.dropped[0] = (float)drop;
  }
  const int gt = blockIdx.x * kRouteThreads + tid;
  const int gs = gridDim.x * kRouteThreads;
  for (int d = 0; d < R; ++d) {
    int2* row = reinterpret_cast<int2*>(a.buf) + (size_t)d * cap;
    for (int p = min(s_tot[d], cap) + gt; p < cap; p += gs) {
      row[p] = make_int2(-1, -1);
    }
  }
  __syncthreads();
  K5_MARK(3);

  // ---- 3: place the block's entries that land below the cap --------------
  for (int s0 = 0; s0 < len; s0 += a.stage) {
    if (tid == 0) {
      int live = 0;   // a destination with room and entries left here
      for (int d = 0; d < R; ++d) {
        live |= s_run[d] < cap && s_pre[d] + s_own[d] > s_run[d];
      }
      s_live = live;
    }
    __syncthreads();
    if (!s_live) break;                                  // block-uniform
    const int sl = min(a.stage, len - s0);
    int w0 = c0, w1 = c1;        // the warp's counts of its chunk
    if (!one_stage) {
      w0 = w1 = 0;
      route_load<kBits>(a, lo + s0, sl, s, w0, w1);
      if (lane < R) wc[warp][lane] = w0;
      if (lane + 32 < R) wc[warp][lane + 32] = w1;
      __syncthreads();
    }
    if (tid < R) {                         // the warps' starts, in order
      int run = s_run[tid];
      for (int w = 0; w < kRouteWarps; ++w) {
        const int t = wc[w][tid];
        wc[w][tid] = run;
        run += t;
      }
      s_run[tid] = run;
    }
    __syncthreads();
    K5_MARK(4);
    int cs, ce;
    warp_chunk(sl, warp, &cs, &ce);
    // the lane's running slot of destinations lane and lane + 32
    int r0 = lane < R ? wc[warp][lane] : cap;
    int r1 = lane + 32 < R ? wc[warp][lane + 32] : cap;
    if (__any_sync(kFull, (w0 > 0 && r0 < cap) || (w1 > 0 && r1 < cap))) {
      const int* mine = a.mine + lo + s0;
      for (int j0 = cs; j0 < ce; j0 += 32 * kRouteBatch) {  // warp-uniform
        // kRouteBatch rounds at once: the destinations and ballots first
        // (independent), then the slots along the running counts
        int ov[kRouteBatch];
        unsigned pk[kRouteBatch];      // dest | lower << 8 | counts << 16
#pragma unroll
        for (int u = 0; u < kRouteBatch; ++u) {
          const int j = j0 + 32 * u + lane;
          ov[u] = j < ce ? s[j] : -1;
          const int d = route_dest(ov[u], a);
          const DestBallots<kBits> db(d);
          pk[u] = (unsigned)d | (unsigned)__popc(db.lanes(d) & lt) << 8 |
                  (unsigned)__popc(db.lanes(lane)) << 16;
          if (kBits > 5) pk[u] |= (unsigned)__popc(db.lanes(lane + 32)) << 24;
        }
        // each slot's partner gid is written as soon as it is known, and
        // its own gid's load issued, so the loads overlap the later rounds
        int at[kRouteBatch], mv[kRouteBatch];
#pragma unroll
        for (int u = 0; u < kRouteBatch; ++u) {
          const int d = (int)(pk[u] & 0xffu);
          const int x0 = __shfl_sync(kFull, r0, d & 31);
          const int x1 = kBits > 5 ? __shfl_sync(kFull, r1, d & 31) : 0;
          const int pos = (d < 32 ? x0 : x1) + (int)((pk[u] >> 8) & 0xffu);
          at[u] = d < R && pos < cap ? d * cap + pos : -1;
          mv[u] = at[u] >= 0 ? __ldg(mine + j0 + 32 * u + lane) : 0;
          if (at[u] >= 0) a.buf[(size_t)at[u] * 2] = ov[u];
          r0 += (int)((pk[u] >> 16) & 0xffu);
          if (kBits > 5) r1 += (int)(pk[u] >> 24);
        }
#pragma unroll
        for (int u = 0; u < kRouteBatch; ++u) {
          if (at[u] >= 0) a.buf[(size_t)at[u] * 2 + 1] = mv[u];
        }
      }
    }
    __syncthreads();             // the next stage reloads s and reuses wc
    K5_MARK(5);
  }
  K5_MARK(6);
}

const void* route_kernel(int bits) {
  switch (bits) {
    case 1: return (const void*)route_build_kernel<1>;
    case 2: return (const void*)route_build_kernel<2>;
    case 3: return (const void*)route_build_kernel<3>;
    case 4: return (const void*)route_build_kernel<4>;
    case 5: return (const void*)route_build_kernel<5>;
    case 6: return (const void*)route_build_kernel<6>;
    default: return (const void*)route_build_kernel<7>;
  }
}

struct RoutePlan {
  int grid, per_block, stage;
};

// The grid and ranges of a call of m entries on the device: kRouteBlocksPerSM
// blocks an SM, each staging its range in its share of the SM's memory.
RoutePlan route_plan(int m, const repro::DeviceFacts& dv) {
  RoutePlan p;
  const long long blocks = (long long)dv.sms * kRouteBlocksPerSM;
  long long per = ((long long)m + blocks - 1) / blocks;
  per = (per + 3) & ~3LL;
  if (per < 4) per = 4;
  p.per_block = (int)per;
  p.grid = (int)(((long long)m + per - 1) / per);
  if (p.grid < 1) p.grid = 1;
  const long long room = ((long long)dv.smem_sm / kRouteBlocksPerSM -
                          dv.smem_reserved - kRouteStatic) / 4 & ~3LL;
  p.stage = (int)(per < room ? per : room);
  return p;
}

// Kernel launches of K5, counted beside the launch.
int g_route_launches = 0;

// Kernel launches of K4, counted beside each launch.
int g_apply_launches = 0;

long long apply_words(int n, int qm, int qr) {
  return 4LL * n + 2LL * ((long long)qm + qr) + 2LL * kApplyMaxGrid;
}

}  // namespace

// K4's device launches since the last reset; reset != 0 sets the count to 0
// after reading it.
extern "C" int repro_synapse_apply_device_launches(int reset) {
  const int k = g_apply_launches;
  if (reset) g_apply_launches = 0;
  return k;
}

// int32 words of workspace a call of K4 needs.
extern "C" long long repro_synapse_apply_workspace(int n, int qm, int qr) {
  return apply_words(n, qm, qr);
}

// edges (n, s_max) -> out (n, s_max); msg_* (qm,), req_* (qr,); accept (qr,)
// bytes of 0 or 1, written in full. work: int32 workspace of `words` words
// (repro_synapse_apply_workspace), any contents. One cooperative launch.
extern "C" int repro_synapse_apply(
    const void* edges, void* out, const void* msg_lid, const void* msg_gid,
    const void* msg_valid, const void* req_lid, const void* req_src,
    const void* req_valid, const void* req_prio, const void* vacant,
    void* accept, void* work, long long words, int n, int s_max, int qm,
    int qr, void* stream) {
  if (n < 0 || s_max < 1 || s_max > 32 || words < apply_words(n, qm, qr)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev;
  repro::DeviceFacts dv;
  cudaError_t err;
  if ((err = repro::current_device(&dev, &dv)) != cudaSuccess) return (int)err;
  // the occupancy with the most shared memory any grid could ask for
  int occ = 0;
  if ((err = repro::resident_blocks((const void*)synapse_apply_kernel, dev,
                                    kApplyThreads,
                                    2 * kApplyMaxGrid * sizeof(int),
                                    dv.smem_optin, &occ)) != cudaSuccess) {
    return (int)err;
  }
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)dv.sms * occ;
  if (grid > kApplyMaxGrid) grid = kApplyMaxGrid;
  ApplyArgs a;
  a.rows = n > grid ? (int)((n + grid - 1) / grid) : 1;
  grid = n > 0 ? (n + a.rows - 1) / a.rows : 1;
  int* w = (int*)work;
  a.edges = (const int*)edges;
  a.out = (int*)out;
  a.msg_lid = (const int*)msg_lid;
  a.msg_gid = (const int*)msg_gid;
  a.msg_valid = (const unsigned char*)msg_valid;
  a.req_lid = (const int*)req_lid;
  a.req_src = (const int*)req_src;
  a.req_valid = (const unsigned char*)req_valid;
  a.req_prio = (const float*)req_prio;
  a.vacant = (const float*)vacant;
  a.accept = (unsigned char*)accept;
  a.cnt = w;
  a.off = w + 2LL * n;
  a.rank = w + 4LL * n;
  a.items = a.rank + (long long)qm + qr;
  a.agg = a.items + (long long)qm + qr;
  a.n = n;
  a.s_max = s_max;
  a.qm = qm;
  a.qr = qr;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)synapse_apply_kernel,
                                    dim3((unsigned)grid), dim3(kApplyThreads),
                                    args, 2 * grid * sizeof(int),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  ++g_apply_launches;
  return (int)cudaGetLastError();
}

#ifdef REPRO_K35_BREAKDOWN
// The breakdown build's stamps of K5's last call, copied to host (1024, 8)
// int64 (ns; 0 where a block stamped nothing), then cleared.
extern "C" int repro_k5_marks(long long* host) {
  void* dev = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev, d_marks);
  if (err == cudaSuccess) {
    err = cudaMemcpy(host, dev, sizeof(d_marks), cudaMemcpyDeviceToHost);
  }
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(d_marks));
  return (int)err;
}
#endif

// K5's device launches since the last reset; reset != 0 sets the count to
// 0 after reading it.
extern "C" int repro_route_build_device_launches(int reset) {
  const int k = g_route_launches;
  if (reset) g_route_launches = 0;
  return k;
}

// int32 words of scratch a call of K5 over m entries and num_ranks
// destinations takes on the current device (0 if there is none).
extern "C" long long repro_route_build_workspace(int m, int num_ranks) {
  int dev;
  repro::DeviceFacts dv;
  if (m < 0 || repro::current_device(&dev, &dv) != cudaSuccess) return 0;
  return (long long)route_plan(m, dv).grid * num_ranks;
}

// flat_other, flat_mine (m,) -> buf (num_ranks, cap, 2), dropped (1,) f32,
// both written in full. counts: int32 scratch of `words` words
// (repro_route_build_workspace), any contents. Partner gids below
// num_ranks * n; num_ranks * cap below 2^31. One cooperative launch.
extern "C" int repro_route_build(const void* other, const void* mine,
                                 void* buf, void* dropped, void* counts,
                                 long long words, int m, int n,
                                 int num_ranks, int cap, void* stream) {
  if (num_ranks < 1 || num_ranks > kMaxRanks || n < 1 || m < 0 || cap < 0 ||
      (long long)num_ranks * cap > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  int dev;
  repro::DeviceFacts dv;
  cudaError_t err;
  if ((err = repro::current_device(&dev, &dv)) != cudaSuccess) return (int)err;
  const RoutePlan p = route_plan(m, dv);
  if (words < (long long)p.grid * num_ranks) return (int)cudaErrorInvalidValue;
  const int bits = 32 - __builtin_clz((unsigned)num_ranks);
  const void* fn = route_kernel(bits);
  const size_t smem = (size_t)p.stage * sizeof(int);
  int occ = 0;
  if ((err = repro::resident_blocks(fn, dev, kRouteThreads, smem,
                                    dv.smem_optin, &occ)) != cudaSuccess) {
    return (int)err;
  }
  if ((long long)occ * dv.sms < p.grid) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  RouteArgs a;
  a.other = (const int*)other;
  a.mine = (const int*)mine;
  a.buf = (int*)buf;
  a.dropped = (float*)dropped;
  a.counts = (int*)counts;
  a.magic = n >= 2 ? ~0ULL / (unsigned long long)n + 1ULL : 0ULL;
  a.unit = n == 1 ? ~0u : 0u;
  a.m = m;
  a.num_ranks = num_ranks;
  a.cap = cap;
  a.per_block = p.per_block;
  a.stage = p.stage;
  a.vec = ((uintptr_t)other & 15u) == 0;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)p.grid),
                                    dim3(kRouteThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  ++g_route_launches;
  return (int)cudaGetLastError();
}
