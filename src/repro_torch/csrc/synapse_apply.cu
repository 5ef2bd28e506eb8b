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
// K5 design. A stable partition is three passes: per-tile bucket counts
// (tiles of 2,048 entries, shared-memory counters), one block that scans the
// counts down the tiles for each bucket (and computes the drop count), and a
// pass that re-reads each tile and ranks its entries with one block-wide
// exclusive scan per bucket, then writes slot < cap and fills the unused tail
// of each buffer with -1.
//
// Bound on the H100: both move bytes with a few integer operations each. K4
// reads the (n, S) table and writes it back (16.8 MB at n = 65,536, S = 32)
// plus the messages and requests, and about 24 bytes a row and 16 an item of
// its own scratch, with four grid barriers. K5 reads 2 * n * S int32 (16.8
// MB) and writes R * cap * 8 bytes in three launches; its one-block scan
// runs over tiles / 1024 items a thread (1,024 tiles at n = 65,536), cheap
// beside its passes.
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
constexpr int kRouteThreads = 256;
constexpr int kRouteItems = 8;
constexpr int kRouteTile = kRouteThreads * kRouteItems;
constexpr int kMaxRanks = 64;

__device__ __forceinline__ int route_dest(int other, int n, int num_ranks) {
  return other >= 0 ? other / n : num_ranks;   // num_ranks = invalid
}

__global__ void route_count(const int* __restrict__ other,
                            int* __restrict__ counts, int m, int n,
                            int num_ranks, int tiles) {
  __shared__ int c[kMaxRanks];
  for (int b = threadIdx.x; b < num_ranks; b += blockDim.x) c[b] = 0;
  __syncthreads();
  const int t0 = blockIdx.x * kRouteTile;
  for (int j = threadIdx.x; j < kRouteTile; j += blockDim.x) {
    const int i = t0 + j;
    if (i < m) {
      const int d = route_dest(other[i], n, num_ranks);
      if (d < num_ranks) atomicAdd(c + d, 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_ranks; b += blockDim.x) {
    counts[(size_t)b * tiles + blockIdx.x] = c[b];
  }
}

// One block: counts[b][0..tiles) -> exclusive offsets in place; totals[b];
// dropped = sum_b max(total_b - cap, 0).
__global__ void route_scan(int* __restrict__ counts, int* __restrict__ totals,
                           float* __restrict__ dropped, int num_ranks,
                           int tiles, int cap) {
  const int per = (tiles + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, tiles);
  const int hi = min(lo + per, tiles);
  int drop = 0;
  for (int b = 0; b < num_ranks; ++b) {
    int* row = counts + (size_t)b * tiles;
    int local = 0;
    for (int k = lo; k < hi; ++k) local += row[k];
    int total;
    int run = block_exclusive_sum(local, &total);
    for (int k = lo; k < hi; ++k) {
      const int c = row[k];
      row[k] = run;
      run += c;
    }
    if (threadIdx.x == 0) totals[b] = total;
    drop += total > cap ? total - cap : 0;
  }
  if (threadIdx.x == 0) dropped[0] = (float)drop;
}

__global__ void route_scatter(const int* __restrict__ other,
                              const int* __restrict__ mine,
                              const int* __restrict__ offsets,
                              const int* __restrict__ totals,
                              int* __restrict__ buf, int m, int n,
                              int num_ranks, int tiles, int cap) {
  const int t0 = blockIdx.x * kRouteTile + threadIdx.x * kRouteItems;
  int dest[kRouteItems];
#pragma unroll
  for (int j = 0; j < kRouteItems; ++j) {
    const int i = t0 + j;
    dest[j] = i < m ? route_dest(other[i], n, num_ranks) : num_ranks;
  }
  for (int b = 0; b < num_ranks; ++b) {
    int local = 0;
#pragma unroll
    for (int j = 0; j < kRouteItems; ++j) local += dest[j] == b;
    int run = block_exclusive_sum(local, nullptr) +
              offsets[(size_t)b * tiles + blockIdx.x];
#pragma unroll
    for (int j = 0; j < kRouteItems; ++j) {
      if (dest[j] == b) {
        if (run < cap) {
          int* slot = buf + ((size_t)b * cap + run) * 2;
          slot[0] = other[t0 + j];
          slot[1] = mine[t0 + j];
        }
        ++run;
      }
    }
  }
  // the unused tail of every destination's buffer
  const int stride = gridDim.x * blockDim.x;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < num_ranks * cap;
       k += stride) {
    const int b = k / cap;
    if (k - b * cap >= min(totals[b], cap)) {
      buf[(size_t)k * 2] = -1;
      buf[(size_t)k * 2 + 1] = -1;
    }
  }
}

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

// flat_other, flat_mine (m,) -> buf (num_ranks, cap, 2), dropped (1,) f32.
// scratch: counts (num_ranks, tiles) int32, totals (num_ranks,) int32,
// tiles = ceil(m / 2048).
extern "C" int repro_route_build(const void* other, const void* mine,
                                 void* buf, void* dropped, void* counts,
                                 void* totals, int m, int n, int num_ranks,
                                 int cap, int tiles, void* stream) {
  if (num_ranks < 1 || num_ranks > kMaxRanks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  route_count<<<tiles, kRouteThreads, 0, s>>>((const int*)other, (int*)counts,
                                              m, n, num_ranks, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  route_scan<<<1, 1024, 0, s>>>((int*)counts, (int*)totals, (float*)dropped,
                                num_ranks, tiles, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  route_scatter<<<tiles, kRouteThreads, 0, s>>>(
      (const int*)other, (const int*)mine, (const int*)counts,
      (const int*)totals, (int*)buf, m, n, num_ranks, tiles, cap);
  return (int)cudaGetLastError();
}
