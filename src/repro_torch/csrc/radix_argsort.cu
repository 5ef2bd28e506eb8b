// K6: the stable LSD radix argsort of the public kernel API.
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
// with 256 masked cumsums. Here a pass is three launches over tiles of 1,024
// keys, and the rank is built without atomics-ordered counters (the order in
// which atomics land changes from run to run):
//   1. digit_hist: per tile, the count of each digit (shared-memory atomics:
//      a count does not depend on their order) -> hist[digit][tile].
//   2. scan_digits: one warp per digit turns hist[digit][0..tiles) into an
//      exclusive prefix over the tiles (warp shuffles) and writes the digit's
//      total.
//   3. scatter: per tile, the stable rank of each key among the tile's keys
//      of its digit. A warp finds the lanes that share its digit with
//      __match_any_sync (rank = popc of the lower peers); the 32 "virtual
//      warps" of the tile (4 rounds x 8 warps, in index order) have their
//      per-digit counts scanned in shared memory. The tile is then placed in
//      digit order in shared memory and written out run by run, so that
//      neighbouring threads write neighbouring addresses: the destination is
//      start(digit) + hist[digit][tile] + rank within the tile.
// The keys and indices ping-pong between the output buffers and a scratch
// pair, ending in the outputs; the first pass takes index = position.
//
// Bound on the H100: bytes. The function reads the n keys and writes n keys
// and n indices, 12 bytes a key (25 MB at n = 2,097,152, 7.5 us at
// 3.35 TB/s). Each pass moves about 20 bytes a key (keys read twice, pairs
// read and written once) and the hist scratch (256 x tiles ints, 2 MB at
// 2,048 tiles) twice, and four passes of three launches each make the
// latency floor of a call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;       // 1,024 keys a block
constexpr int kWarps = kThreads / 32;
constexpr int kVirtualWarps = kRounds * kWarps;  // 32
constexpr int kDigits = 256;

__device__ __forceinline__ int digit_of(int k, int shift) {
  return (int)(((unsigned)k >> shift) & 255u);
}

__global__ void digit_hist(const int* __restrict__ keys,
                           int* __restrict__ hist, int n, int tiles,
                           int shift) {
  __shared__ int cnt[kDigits];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int e = base + r * kThreads + threadIdx.x;
    if (e < n) atomicAdd(&cnt[digit_of(keys[e], shift)], 1);
  }
  __syncthreads();
  hist[(size_t)threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
}

__global__ void scan_digits(int* __restrict__ hist, int* __restrict__ totals,
                            int tiles) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= kDigits) return;
  int* row = hist + (size_t)warp * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += 32) {
    const int t = base + lane;
    const int x = t < tiles ? row[t] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (t < tiles) row[t] = carry + incl - x;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) totals[warp] = carry;
}

// Exclusive prefix sum of one value per thread over the 256 threads, in
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

__global__ void scatter(const int* __restrict__ src_k,
                        const int* __restrict__ src_i,
                        int* __restrict__ dst_k, int* __restrict__ dst_i,
                        const int* __restrict__ hist,
                        const int* __restrict__ totals, int n, int tiles,
                        int shift) {
  __shared__ int cnt[kVirtualWarps][kDigits];
  __shared__ int loc[kDigits];    // tile-local start of each digit
  __shared__ int gbase[kDigits];  // global destination of that start
  __shared__ int s_k[kTile];
  __shared__ int s_i[kTile];
  __shared__ int wsum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = blockIdx.x * kTile;
  for (int j = tid; j < kVirtualWarps * kDigits; j += kThreads) {
    (&cnt[0][0])[j] = 0;
  }
  __syncthreads();
  int dig[kRounds], key[kRounds], idx[kRounds], rank[kRounds];
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int e = base + r * kThreads + tid;
    const bool valid = e < n;
    key[r] = valid ? src_k[e] : 0;
    idx[r] = valid ? (src_i ? src_i[e] : e) : 0;
    dig[r] = valid ? digit_of(key[r], shift) : kDigits;   // sentinel
    const unsigned peers = __match_any_sync(0xffffffffu, dig[r]);
    rank[r] = __popc(peers & lower);
    if (valid && rank[r] == 0) cnt[r * kWarps + warp][dig[r]] = __popc(peers);
  }
  __syncthreads();
  // thread = digit: scan its counts down the virtual warps (index order)
  int running = 0;
  for (int w = 0; w < kVirtualWarps; ++w) {
    const int c = cnt[w][tid];
    cnt[w][tid] = running;
    running += c;
  }
  const int local_start = block_exclusive_scan(running, wsum);
  const int digit_start = block_exclusive_scan(totals[tid], wsum);
  loc[tid] = local_start;
  gbase[tid] = digit_start + hist[(size_t)tid * tiles + blockIdx.x];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (dig[r] < kDigits) {
      const int pos = loc[dig[r]] + cnt[r * kWarps + warp][dig[r]] + rank[r];
      s_k[pos] = key[r];
      s_i[pos] = idx[r];
    }
  }
  __syncthreads();
  const int m = min(kTile, n - base);
  for (int j = tid; j < m; j += kThreads) {
    const int k = s_k[j];
    const int d = digit_of(k, shift);
    const int dst = gbase[d] + (j - loc[d]);
    dst_k[dst] = k;
    dst_i[dst] = s_i[j];
  }
}

}  // namespace

// keys (n,) int32 -> sorted keys, order (n,) int32. tmp_k, tmp_i: (n,) int32
// scratch; hist: (256, tiles) int32 scratch, tiles = ceil(n / 1024); totals:
// (256,) int32 scratch. passes = number of 8-bit digits, >= 1.
extern "C" int repro_radix_argsort(const void* keys, void* out_k, void* out_i,
                                   void* tmp_k, void* tmp_i, void* hist,
                                   void* totals, int n, int tiles, int passes,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int* src_k = (const int*)keys;
  const int* src_i = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = (passes - 1 - p) % 2 == 0;
    int* dk = (int*)(to_out ? out_k : tmp_k);
    int* di = (int*)(to_out ? out_i : tmp_i);
    const int shift = 8 * p;
    digit_hist<<<tiles, kThreads, 0, s>>>(src_k, (int*)hist, n, tiles, shift);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_digits<<<kDigits / kWarps, kThreads, 0, s>>>((int*)hist,
                                                      (int*)totals, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scatter<<<tiles, kThreads, 0, s>>>(src_k, src_i, dk, di,
                                       (const int*)hist, (const int*)totals,
                                       n, tiles, shift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src_k = dk;
    src_i = di;
  }
  return (int)cudaGetLastError();
}
