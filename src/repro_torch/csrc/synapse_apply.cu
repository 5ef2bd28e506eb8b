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
// the work is per row. Messages and requests are grouped by row with atomic
// counters (count, one-block exclusive scan, place): the placement order
// inside a row is arbitrary, and nothing downstream depends on it, because
//   - a slot j holding gid g dies iff #{k < j : edge[k] == g} is below the
//     number of valid messages (row, g) — a count, not an order;
//   - the accepted requests are the cap smallest by the total order
//     (priority, request index), found by cap rounds of a warp argmin over
//     the row's requests, each round above the previous pick.
// One warp per row (S <= 32: one lane per slot) kills, compacts by ballot and
// popc, and writes the accepted sources at base + rank. A row's cost is
// O(S * (S + messages / 32) + cap * requests / 32): a row swamped with
// requests costs cap passes over them, not a sort.
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
// plus the messages and requests; K5 reads 2 * n * S int32 (16.8 MB) and
// writes R * cap * 8 bytes. Both are several launches (counts, scan, place,
// rows), and the one-block scans are serial over n / 1024 or tiles / 1024
// items per thread; those are what a later PR would fuse.
#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void apply_count(const int* __restrict__ msg_lid,
                            const unsigned char* __restrict__ msg_valid,
                            const int* __restrict__ req_lid,
                            const unsigned char* __restrict__ req_valid,
                            int* __restrict__ msg_cnt,
                            int* __restrict__ req_cnt, int qm, int qr, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < qm && msg_valid[k]) {
    const int r = msg_lid[k];
    if (r >= 0 && r < n) atomicAdd(msg_cnt + r, 1);
  }
  if (k < qr && req_valid[k]) {
    const int r = req_lid[k];
    if (r >= 0 && r < n) atomicAdd(req_cnt + r, 1);
  }
}

// One block: off[i] = sum(cnt[0..i)) for both arrays (len n each).
__global__ void apply_scan(const int* __restrict__ msg_cnt,
                           const int* __restrict__ req_cnt,
                           int* __restrict__ msg_off,
                           int* __restrict__ req_off, int n) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n);
  const int hi = min(lo + per, n);
  for (int a = 0; a < 2; ++a) {
    const int* cnt = a == 0 ? msg_cnt : req_cnt;
    int* off = a == 0 ? msg_off : req_off;
    int local = 0;
    for (int k = lo; k < hi; ++k) local += cnt[k];
    int run = block_exclusive_sum(local, nullptr);
    for (int k = lo; k < hi; ++k) {
      off[k] = run;
      run += cnt[k];
    }
  }
}

__global__ void apply_place(const int* __restrict__ msg_lid,
                            const unsigned char* __restrict__ msg_valid,
                            const int* __restrict__ req_lid,
                            const unsigned char* __restrict__ req_valid,
                            const int* __restrict__ msg_off,
                            const int* __restrict__ req_off,
                            int* __restrict__ msg_cur,
                            int* __restrict__ req_cur,
                            int* __restrict__ msg_items,
                            int* __restrict__ req_items, int qm, int qr,
                            int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < qm && msg_valid[k]) {
    const int r = msg_lid[k];
    if (r >= 0 && r < n) msg_items[msg_off[r] + atomicAdd(msg_cur + r, 1)] = k;
  }
  if (k < qr && req_valid[k]) {
    const int r = req_lid[k];
    if (r >= 0 && r < n) req_items[req_off[r] + atomicAdd(req_cur + r, 1)] = k;
  }
}

__global__ void apply_rows(const int* __restrict__ edges,
                           int* __restrict__ out,
                           const int* __restrict__ msg_gid,
                           const int* __restrict__ req_src,
                           const float* __restrict__ req_prio,
                           const float* __restrict__ vacant,
                           const int* __restrict__ msg_cnt,
                           const int* __restrict__ req_cnt,
                           const int* __restrict__ msg_off,
                           const int* __restrict__ req_off,
                           const int* __restrict__ msg_items,
                           const int* __restrict__ req_items,
                           unsigned char* __restrict__ accept, int n,
                           int s_max) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;                       // warp-uniform
  const int e = lane < s_max ? edges[(size_t)row * s_max + lane] : -1;

  // ---- remove: valid messages (row, e) against earlier equal slots -----
  const int m0 = msg_off[row], mc = msg_cnt[row];
  int matches = 0;
  for (int base = 0; base < mc; base += 32) {
    const int g = base + lane < mc ? msg_gid[msg_items[m0 + base + lane]] : -1;
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
  int* orow = out + (size_t)row * s_max;
  if (keep) orow[__popc(kept & ((1u << lane) - 1u))] = e;

  // ---- accept: the cap smallest (priority, index) of the row -----------
  const int r0 = req_off[row], rc = req_cnt[row];
  int accepted = 0;
  if (rc > 0) {
    const float fl = floorf(vacant[row]);
    const float freef = (float)(s_max - base);
    const float cap = (fl < freef || isnan(fl)) ? fl : freef;
    float pp = 0.0f;
    int pi = -1;                               // previous pick; -1 = none
    while (accepted < rc && (float)accepted < cap) {
      float bp = 0.0f;
      int bi = kNone;
      for (int k = lane; k < rc; k += 32) {
        const int idx = req_items[r0 + k];
        const float p = req_prio[idx];
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
        orow[base + accepted] = req_src[bi];
        accept[bi] = 1;
      }
      pp = bp;
      pi = bi;
      ++accepted;
    }
  }
  if (lane < s_max && lane >= base + accepted) orow[lane] = -1;
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

}  // namespace

// edges (n, s_max) -> out (n, s_max); msg_* (qm,), req_* (qr,); accept (qr,)
// uint8 zeroed by the caller; scratch: 4n int32 zeroed (msg_cnt, req_cnt,
// msg_cur, req_cur), 2n int32 (msg_off, req_off), qm + qr int32 (items).
extern "C" int repro_synapse_apply(
    const void* edges, void* out, const void* msg_lid, const void* msg_gid,
    const void* msg_valid, const void* req_lid, const void* req_src,
    const void* req_valid, const void* req_prio, const void* vacant,
    void* accept, void* zeroed, void* offsets, void* items, int n, int s_max,
    int qm, int qr, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* msg_cnt = (int*)zeroed;
  int* req_cnt = msg_cnt + n;
  int* msg_cur = req_cnt + n;
  int* req_cur = msg_cur + n;
  int* msg_off = (int*)offsets;
  int* req_off = msg_off + n;
  int* msg_items = (int*)items;
  int* req_items = msg_items + qm;
  const int q = qm > qr ? qm : qr;
  cudaError_t err;
  if (q > 0) {
    apply_count<<<(q + 255) / 256, 256, 0, s>>>(
        (const int*)msg_lid, (const unsigned char*)msg_valid,
        (const int*)req_lid, (const unsigned char*)req_valid, msg_cnt,
        req_cnt, qm, qr, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  apply_scan<<<1, 1024, 0, s>>>(msg_cnt, req_cnt, msg_off, req_off, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (q > 0) {
    apply_place<<<(q + 255) / 256, 256, 0, s>>>(
        (const int*)msg_lid, (const unsigned char*)msg_valid,
        (const int*)req_lid, (const unsigned char*)req_valid, msg_off,
        req_off, msg_cur, req_cur, msg_items, req_items, qm, qr, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int warps_per_block = 8;
  apply_rows<<<(n + warps_per_block - 1) / warps_per_block,
               warps_per_block * 32, 0, s>>>(
      (const int*)edges, (int*)out, (const int*)msg_gid, (const int*)req_src,
      (const float*)req_prio, (const float*)vacant, msg_cnt, req_cnt, msg_off,
      req_off, msg_items, req_items, (unsigned char*)accept, n, s_max);
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
