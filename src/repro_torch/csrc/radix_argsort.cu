// K6: the stable LSD radix argsort of the public kernel API, as a onesweep
// sort with decoupled look-back.
//
// Replaces the JAX package's Pallas kernel kernels/radix_sort.py::radix_argsort
// (pallas_call at :99, body _argsort_kernel, ranks radix_ranks): passes over
// 8-bit digits d = (k >> shift) & 255 of the int32 keys, shift = 0, 8, ...
// below max(key_bits, 1), each a stable partition of the (key, index) pairs
// by the digit. Returns the keys in sorted order and the order. Only the low
// 8 * passes bits count, and a negative key sorts by its two's-complement
// bytes, as on the TPU. The plain version is
// repro_torch/kernels/radix_sort.py::radix_argsort_plain; every quantity is an
// integer, so the two agree bit for bit.
//
// Design. The TPU kernel held the whole array in VMEM and ranked each digit
// with 256 masked cumsums. Here a call is 1 + passes launches:
//   1. digit_counts: kHistBlocks (at most) blocks read the keys once, 8
//      loads in flight a thread, and count every pass's digit with
//      shared-memory atomics into 8 sub-histograms (one per 2 warps, against
//      contention; a count does not depend on the atomics' order), writing
//      one row of passes x 256 counts per block; the same launch zeroes the
//      look-back status words and the per-pass tile counters. Nothing has
//      to be zero beforehand, so the workspace comes from torch.empty.
//   2. onesweep, once per pass, over tiles of kTile = 4,096 keys. A block
//      takes the next tile id from the pass's atomic counter (not blockIdx),
//      so every tile it waits on is already running: the look-back cannot
//      deadlock. The block ranks its keys by digit: warp w holds keys
//      [512 w, 512 w + 512) of the tile in 16 rounds of 32, finds the lanes
//      sharing its digit with eight ballots (one per bit) and adds the
//      popcount of the lower peers to the warp's running count of that digit
//      (stable: rounds run in index order); a scan over the 8 warps and over
//      the 256 digits gives each key its place in the tile. Thread d then
//      publishes the tile's count of digit d as a (flag, count) word, flag
//      1 "aggregate", and looks back over earlier tiles, 8 words a round
//      trip, adding aggregates until it meets a flag 2 "inclusive prefix";
//      it publishes its own inclusive prefix. Tile 0 has no predecessor: its
//      prefix starts at the digit's global start, the exclusive scan over
//      digits of the counts of step 1, which the first pass's tile 0 sums
//      from the count rows and every later pass reads from the previous
//      pass's last tile, off the critical path. The tile is staged in digit
//      order in shared memory and written out run by run, so neighbouring
//      threads write neighbouring addresses. Every prefix is an exact
//      integer sum: the result does not depend on which tile finishes
//      first, and a second call is bitwise equal.
// The keys and indices ping-pong between the outputs and a scratch pair,
// ending in the outputs; the first pass takes index = position.
//
// Bound on the H100: bytes. The function reads the n keys and writes n keys
// and n indices, 12 bytes a key (25 MB at n = 2,097,152, 7.5 us at
// 3.35 TB/s). A call moves 4 n bytes for the counts and about 16 n bytes a
// pass (the pairs read and written once); the status words are 1 KB a tile
// and pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDigits = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                      // keys a thread
constexpr int kWarpKeys = 32 * kRounds;          // 512
constexpr int kTile = kThreads * kRounds;        // 4,096 keys a tile
constexpr int kHistBlocks = 128;                 // at most, for step 1
constexpr int kHistThreads = 512;
constexpr int kHistKeys = 8;                     // keys a thread a round
constexpr int kHistSub = 8;                      // sub-histograms a block
constexpr int kLookback = 8;                     // status words a round trip
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kInclusive = 2u << 30;
constexpr unsigned kValue = (1u << 30) - 1u;

__device__ __forceinline__ int digit_of(int k, int shift) {
  return (int)(((unsigned)k >> shift) & 255u);
}

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// The lanes of the warp whose digit equals this lane's, among the lanes
// with `valid` set: eight ballots, one per bit of the digit.
__device__ __forceinline__ unsigned digit_peers(int d, bool valid) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool set = (d >> bit) & 1;
    const unsigned b = __ballot_sync(0xffffffffu, set);
    peers &= set ? b : ~b;
  }
  return peers;
}

// Exclusive prefix sum of one value per thread over kThreads threads, in
// thread order. Ends with a __syncthreads; `wsum` holds kWarps ints.
__device__ int block_exclusive_scan(int x, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  __syncthreads();
  return before + incl - x;
}

// Step 1: per block one row of passes x 256 digit counts; zero the status
// words and tile counters of the passes.
__global__ void __launch_bounds__(kHistThreads)
    digit_counts(const int* __restrict__ keys, int* __restrict__ rows,
                 unsigned* __restrict__ status, int status_words,
                 int* __restrict__ tile_ctr, int n, int passes) {
  __shared__ int cnt[kHistSub][4][kDigits];
  for (int j = threadIdx.x; j < kHistSub * 4 * kDigits; j += kHistThreads) {
    (&cnt[0][0][0])[j] = 0;
  }
  const int stride = gridDim.x * kHistThreads;
  for (int j = blockIdx.x * kHistThreads + threadIdx.x; j < status_words;
       j += stride) {
    status[j] = 0u;
  }
  if (blockIdx.x == 0 && threadIdx.x < passes) tile_ctr[threadIdx.x] = 0;
  __syncthreads();
  const int sub = (threadIdx.x >> 5) % kHistSub;
  // kHistKeys loads in flight a thread
  const int round = stride * kHistKeys;
  for (int e0 = blockIdx.x * kHistThreads + threadIdx.x; e0 - threadIdx.x < n;
       e0 += round) {
    int k[kHistKeys];
#pragma unroll
    for (int j = 0; j < kHistKeys; ++j) {
      const int e = e0 + j * stride;
      k[j] = e < n ? keys[e] : 0;
    }
#pragma unroll
    for (int j = 0; j < kHistKeys; ++j) {
      const bool valid = e0 + j * stride < n;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= passes) break;
        if (valid) atomicAdd(&cnt[sub][p][digit_of(k[j], 8 * p)], 1);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < passes * kDigits; j += kHistThreads) {
    int total = 0;
#pragma unroll
    for (int u = 0; u < kHistSub; ++u) total += (&cnt[u][0][0])[j];
    rows[(size_t)blockIdx.x * passes * kDigits + j] = total;
  }
}

// The start of each digit of pass `pass` (thread = digit): the exclusive
// scan over digits of the count rows' sums, with 16 loads in flight.
__device__ int digit_start(const int* __restrict__ rows, int hist_blocks,
                           int passes, int pass, int* wsum) {
  int total = 0;
#pragma unroll 16
  for (int g = 0; g < hist_blocks; ++g) {
    total += rows[((size_t)g * passes + pass) * kDigits + threadIdx.x];
  }
  return block_exclusive_scan(total, wsum);
}

// Step 2: one pass over the digit at `shift`.
__global__ void __launch_bounds__(kThreads)
    onesweep(const int* __restrict__ src_k, const int* __restrict__ src_i,
             int* __restrict__ dst_k, int* __restrict__ dst_i,
             const int* __restrict__ rows, int hist_blocks, int passes,
             int pass, int* __restrict__ starts,
             unsigned* __restrict__ status, int* __restrict__ tile_ctr, int n,
             int shift) {
  __shared__ int wcnt[kWarps][kDigits];  // per-warp counts, then offsets
  __shared__ int loc[kDigits];           // tile-local start of each digit
  __shared__ int gbase[kDigits];         // global position of that start
  __shared__ int s_k[kTile];
  __shared__ int s_i[kTile];
  __shared__ int wsum[kWarps];
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(&tile_ctr[pass], 1);
  for (int j = tid; j < kWarps * kDigits; j += kThreads) {
    (&wcnt[0][0])[j] = 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile + warp * kWarpKeys;
  int key[kRounds], idx[kRounds], dig[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int e = base + r * 32 + lane;
    const bool valid = e < n;
    key[r] = valid ? src_k[e] : 0;
    idx[r] = valid ? (src_i ? src_i[e] : e) : 0;
    dig[r] = valid ? digit_of(key[r], shift) : kDigits;  // sentinel
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool valid = dig[r] < kDigits;
    const unsigned peers = digit_peers(dig[r], valid);
    rank[r] = (valid ? wcnt[warp][dig[r]] : 0) + __popc(peers & lower);
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) wcnt[warp][dig[r]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread = digit: scan its counts over the warps (index order)
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = wcnt[w][tid];
    wcnt[w][tid] = count;
    count += c;
  }
  // publish the tile's count at once, so later tiles can look past it
  unsigned* my = status + ((size_t)pass * gridDim.x + tile) * kDigits + tid;
  if (tile > 0) store_status(my, kAggregate | (unsigned)count);
  const int local = block_exclusive_scan(count, wsum);
  loc[tid] = local;
  int before = 0;
  if (tile == 0) {
    // every later tile waits on this: the first pass sums the count rows,
    // a later one reads what the previous pass's last tile left
    before = pass == 0 ? digit_start(rows, hist_blocks, passes, 0, wsum)
                       : starts[pass * kDigits + tid];
  } else {
    // kLookback predecessors a round trip, nearest first; stop at the first
    // inclusive prefix, and read again from the first word still 0
    int t = tile - 1;
    bool done = false;
    while (!done) {
      unsigned st[kLookback];
#pragma unroll
      for (int j = 0; j < kLookback; ++j) {
        st[j] = t - j >= 0 ? load_status(my - (size_t)(tile - t + j) *
                                                 kDigits)
                           : 0u;
      }
      int used = 0;
#pragma unroll
      for (int j = 0; j < kLookback; ++j) {
        if (done || used < j || st[j] == 0u) continue;
        before += (int)(st[j] & kValue);
        done = (st[j] & kInclusive) != 0u;
        used = j + 1;
      }
      t -= used;
    }
  }
  store_status(my, kInclusive | (unsigned)(before + count));
  gbase[tid] = before;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (dig[r] < kDigits) {
      const int pos = loc[dig[r]] + wcnt[warp][dig[r]] + rank[r];
      s_k[pos] = key[r];
      s_i[pos] = idx[r];
    }
  }
  __syncthreads();
  const int m = min(kTile, n - tile * kTile);
  for (int j = tid; j < m; j += kThreads) {
    const int k = s_k[j];
    const int d = digit_of(k, shift);
    const int dst = gbase[d] + (j - loc[d]);
    dst_k[dst] = k;
    dst_i[dst] = s_i[j];
  }
  // off the critical path: the last tile leaves the next pass's starts
  if (tile == gridDim.x - 1 && pass + 1 < passes) {
    starts[(pass + 1) * kDigits + tid] =
        digit_start(rows, hist_blocks, passes, pass + 1, wsum);
  }
}

// Kernel launches, counted beside each launch.
int g_launches = 0;

struct Layout {
  int tiles, hist_blocks;
  size_t tmp_k, tmp_i, rows, starts, status, ctr, total;   // int offsets
};

Layout layout(int n, int passes) {
  Layout l;
  l.tiles = (n + kTile - 1) / kTile;
  l.hist_blocks = l.tiles < kHistBlocks ? l.tiles : kHistBlocks;
  const size_t pair = passes > 1 ? (size_t)n : 0;
  l.tmp_k = 0;
  l.tmp_i = pair;
  l.rows = 2 * pair;
  l.starts = l.rows + (size_t)l.hist_blocks * passes * kDigits;
  l.status = l.starts + (size_t)passes * kDigits;
  l.ctr = l.status + (size_t)passes * l.tiles * kDigits;
  l.total = l.ctr + passes;
  return l;
}

}  // namespace

// Kernel launches since the last reset, counted beside each launch; reset
// != 0 sets the count to 0 after reading it.
extern "C" int repro_radix_argsort_device_launches(int reset) {
  const int n = g_launches;
  if (reset) g_launches = 0;
  return n;
}

// int32 words of workspace a call of n keys and `passes` passes needs.
extern "C" long long repro_radix_argsort_workspace(int n, int passes) {
  return n > 0 && passes >= 1 ? (long long)layout(n, passes).total : 0;
}

// keys (n,) int32 -> sorted keys, order (n,) int32. work: int32 workspace
// of `words` words (repro_radix_argsort_workspace), any contents: the
// scratch pair, the count rows, the status words and the tile counters, at
// offsets computed here. passes = number of 8-bit digits, in [1, 4];
// n < 2**30 (a prefix must fit the status word's 30 bits).
extern "C" int repro_radix_argsort(const void* keys, void* out_k, void* out_i,
                                   void* work, long long words, int n,
                                   int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (passes < 1 || passes > 4 || n >= (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  const Layout l = layout(n, passes);
  if (words < (long long)l.total) return (int)cudaErrorInvalidValue;
  int* w = (int*)work;
  unsigned* status = (unsigned*)(w + l.status);
  const int status_words = passes * l.tiles * kDigits;
  digit_counts<<<l.hist_blocks, kHistThreads, 0, s>>>(
      (const int*)keys, w + l.rows, status, status_words, w + l.ctr, n,
      passes);
  ++g_launches;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* src_k = (const int*)keys;
  const int* src_i = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = (passes - 1 - p) % 2 == 0;
    int* dk = to_out ? (int*)out_k : w + l.tmp_k;
    int* di = to_out ? (int*)out_i : w + l.tmp_i;
    onesweep<<<l.tiles, kThreads, 0, s>>>(
        src_k, src_i, dk, di, w + l.rows, l.hist_blocks, passes, p,
        w + l.starts, status, w + l.ctr, n, 8 * p);
    ++g_launches;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src_k = dk;
    src_i = di;
  }
  return (int)cudaGetLastError();
}
