// K3: the Morton sort that feeds the octree build.
//
// Replaces the JAX package's Pallas kernel kernels/radix_sort.py::morton_sort
// (pallas_call at :135, body _morton_sort_kernel): Morton-encode each
// position at the leaf level, rebase to the rank's block and clamp to
// [0, n_leaf), then the stable rank of each neuron within its leaf cell,
// slot[i] = #{j < i : rel[j] == rel[i]}. The plain version is
// repro_torch/kernels/radix_sort.py::morton_sort_plain; every quantity is an
// integer, so kernel and plain version agree bit for bit.
//
// Design. The TPU kernel ran an LSD radix sort with the whole array resident
// in VMEM. Here a call is ONE cooperative launch (every block resident,
// cudaLaunchCooperativeKernel), one block an SM, block b owning the
// contiguous range [b * per_block, (b + 1) * per_block) of neurons:
//   0. encode: each neuron's cell goes to rel and, packed with its place in
//      its warp (the lanes of its 32-neuron step sharing its cell, from
//      __match_any_sync: how many come before it and how many there are),
//      to a key in shared memory;
//   1. count: the block counts its neurons per cell in a shared histogram
//      (one shared atomic per group of equal cells in a step: a count does
//      not depend on the atomics' order) and writes that row whole to the
//      scratch (grid x cells ints), so nothing has to be zero beforehand;
//   2. grid.sync(); scan: tiles of 32 cells, a block a tile; each warp sums
//      a contiguous run of the rows, the warps' sums are scanned in shared
//      memory, and each warp writes its rows' exclusive prefixes over the
//      blocks in place;
//   3. grid.sync(); rank: the block loads its row of prefixes into the
//      shared histogram, and one warp walks the block's steps in index
//      order: a neuron's slot is its cell's running count plus the lanes
//      before it in its group, and the group's last lane advances the count.
// The histogram holds a window of at most kMaxWindow cells; a larger n_leaf
// runs steps 1-3 once a window (two grid syncs each; the scratch then holds
// two windows' rows, alternating, so a window's rows are written while no
// block reads them). The cost does not depend on how the neurons fall in
// the cells: n atomics at most, grid x cells ints scanned.
//
// Bound on the H100: the function moves n*12 bytes of positions in and
// n*8 bytes of (rel, slot) out, 1.3 MB at n = 65,536, 0.39 us at 3.35 TB/s,
// below a launch's own latency. What bounds this kernel is the launch, its
// two grid barriers and the dependent round trips between them: the
// positions' load, the scratch through L2 (grid x n_leaf ints written, read
// and written by the scan, read: 2.2 MB each way at 132 x 4,096), then the
// one warp's walk over a block's ceil(per_block / 32) steps (16 at n =
// 65,536). On an H100 80GB HBM3 at 700 W (tools/k35_breakdown.py) an empty
// cooperative kernel of the same grid with two barriers takes 4.5 us, about
// half of this kernel's device time at CONFIG; of the rest, the scan is the
// longest step (1.5 us).
//
// Breakdown build. Built with -DREPRO_K35_BREAKDOWN (tools/k35_breakdown.py,
// never the library), thread 0 of each block stamps the global timer at the
// steps' ends (K3_MARK), read back through repro_k3_marks.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace cg = cooperative_groups;

namespace {

#ifdef REPRO_K35_BREAKDOWN
constexpr int kMarks = 8;
__device__ long long d_marks[256][kMarks];
#define K3_MARK(k)                                                   \
  do {                                                               \
    if (threadIdx.x == 0) {                                          \
      long long t_;                                                  \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
      d_marks[blockIdx.x][k] = t_;                                   \
    }                                                                \
  } while (0)
#else
#define K3_MARK(k) \
  do {             \
  } while (0)
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 256;            // grid: one block an SM, at most
constexpr int kRowsPerWarp = kMaxBlocks / kWarps;   // step 2, in registers
constexpr int kMaxWindow = 32768;          // cells the histogram holds
constexpr int kLoads = 8;                  // a row's loads in flight a thread
constexpr int kCellBits = 22;              // a key: cell | lower | group - 1
constexpr unsigned kCellMask = (1u << kCellBits) - 1u;
constexpr int kTooLarge = -3;              // the block's keys do not fit

__device__ __forceinline__ uint32_t part1by2(uint32_t x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// core/morton.py::morton_encode: one f32 multiply by 2^level, truncation to
// int32, a clamp to [0, 2^level - 1], then the bit interleave.
__device__ __forceinline__ int encode(const float* p, int level) {
  const int g = 1 << level;
  const float gf = (float)g;
  uint32_t ijk[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    int q = __float2int_rz(p[d] * gf);
    q = q < 0 ? 0 : (q > g - 1 ? g - 1 : q);
    ijk[d] = (uint32_t)q;
  }
  return (int)(part1by2(ijk[0]) | (part1by2(ijk[1]) << 1) |
               (part1by2(ijk[2]) << 2));
}

struct MortonArgs {
  const float* pos;
  int* rel;
  int* slot;
  int* rows;        // windows > 1 ? 2 : 1 buffers of grid x window ints
                    // (a multiple of 4, the last window's rows padded)
  int n, per_block, leaf_base, level, n_leaf, window;
};

__global__ void __launch_bounds__(kThreads, 1)
    morton_sort_kernel(MortonArgs a) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  int* hist = smem;                                  // a.window ints
  unsigned* key = (unsigned*)(smem + a.window);      // a.per_block keys
  __shared__ int part[kWarps][32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int grid_n = gridDim.x;
  const int lo = b * a.per_block;
  const int len = max(0, min(a.per_block, a.n - lo));
  const unsigned lt = (1u << lane) - 1u;
  K3_MARK(0);

  // ---- 0: encode, rel, and each neuron's place in its step's group -------
  for (int base = 0; base < len; base += kThreads) {        // block-uniform
    const int j = base + tid;
    int c = -1;
    if (j < len) {
      c = encode(a.pos + (size_t)(lo + j) * 3, a.level) - a.leaf_base;
      c = c < 0 ? 0 : (c > a.n_leaf - 1 ? a.n_leaf - 1 : c);
      a.rel[lo + j] = c;
    }
    const unsigned peers = __match_any_sync(kFull, c);
    if (j < len) {
      key[j] = (unsigned)c | ((unsigned)__popc(peers & lt) << kCellBits) |
               ((unsigned)(__popc(peers) - 1) << (kCellBits + 5));
    }
  }

  K3_MARK(1);
  const int rows_per_warp = (grid_n + kWarps - 1) / kWarps;
  const int r0 = min(warp * rows_per_warp, grid_n);
  const int r1 = min(r0 + rows_per_warp, grid_n);
  int4* hist4 = reinterpret_cast<int4*>(hist);
  for (int w0 = 0, p = 0; w0 < a.n_leaf; w0 += a.window, ++p) {
    const int width = min(a.window, a.n_leaf - w0);
    // rows of whole int4s: a row is padded to a multiple of 4 cells (the
    // pad stays 0), so every row of the 16-byte aligned scratch is too
    const int units = (width + 3) / 4;
    int* rows = a.rows + (size_t)(p & 1) * grid_n * a.window;
    int4* row4 = reinterpret_cast<int4*>(rows) + (size_t)b * units;

    // ---- 1: the block's count per cell of the window, its row whole -----
    for (int k = tid; k < units; k += kThreads) {
      hist4[k] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    for (int j = tid; j < len; j += kThreads) {
      const unsigned kv = key[j];
      const int c = (int)(kv & kCellMask) - w0;
      if (((kv >> kCellBits) & 31u) == 0 && c >= 0 && c < width) {
        atomicAdd(hist + c, (int)(kv >> (kCellBits + 5)) + 1);
      }
    }
    __syncthreads();
    for (int k = tid; k < units; k += kThreads) row4[k] = hist4[k];
    K3_MARK(2);
    grid.sync();
    K3_MARK(3);

    // ---- 2: exclusive prefix over the blocks, a tile of 32 cells a block -
    const int stride = units * 4;                      // a row's cells
    for (int t = b; t * 32 < stride; t += grid_n) {
      const int cell = t * 32 + lane;
      const bool in = cell < stride;
      int v[kRowsPerWarp];
      int sum = 0;
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = r0 + k;
        v[k] = in && r < r1 ? __ldcg(rows + (size_t)r * stride + cell) : 0;
        sum += v[k];
      }
      part[warp][lane] = sum;
      __syncthreads();
      int run = 0;
      for (int w = 0; w < warp; ++w) run += part[w][lane];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = r0 + k;
        if (in && r < r1) rows[(size_t)r * stride + cell] = run;
        run += v[k];
      }
      __syncthreads();                       // part is reused by the next tile
    }
    K3_MARK(4);
    grid.sync();
    K3_MARK(5);

    // ---- 3: the block's offsets, then its neurons in index order --------
    for (int k0 = tid; k0 < units; k0 += kThreads * kLoads) {
      int4 v[kLoads];                                   // loads in flight
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int k = k0 + u * kThreads;
        if (k < units) v[u] = __ldcg(row4 + k);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (k0 + u * kThreads < units) hist4[k0 + u * kThreads] = v[u];
      }
    }
    __syncthreads();
    K3_MARK(6);
    if (warp == 0) {
      unsigned next = lane < len ? key[lane] : 0u;
      for (int j0 = 0; j0 < len; j0 += 32) {              // warp-uniform
        const int j = j0 + lane;
        const unsigned kv = next;
        next = j + 32 < len ? key[j + 32] : 0u;
        const int c = (int)(kv & kCellMask) - w0;
        const bool mine = j < len && c >= 0 && c < width;
        const int lower = (int)((kv >> kCellBits) & 31u);
        const int group = (int)(kv >> (kCellBits + 5)) + 1;
        const int start = mine ? hist[c] : 0;
        __syncwarp();
        if (mine && lower == group - 1) hist[c] = start + group;
        __syncwarp();
        if (mine) a.slot[lo + j] = start + lower;
      }
    }
    __syncthreads();                 // the next window zeroes the histogram
    K3_MARK(7);
  }
}

struct Launch {
  int grid, per_block, window, windows;
  size_t smem;
};

// The grid, ranges and window of a call on the current device; kTooLarge
// when a block's keys and one 32-cell window exceed its shared memory.
int plan(int n, int n_leaf, int* dev, Launch* l) {
  repro::DeviceFacts dv;
  cudaError_t err;
  if ((err = repro::current_device(dev, &dv)) != cudaSuccess) return (int)err;
  const int blocks = dv.sms < kMaxBlocks ? dv.sms : kMaxBlocks;
  l->per_block = (n + blocks - 1) / blocks;
  if (l->per_block < 1) l->per_block = 1;
  l->grid = (n + l->per_block - 1) / l->per_block;
  if (l->grid < 1) l->grid = 1;
  // dynamic shared memory: the window, then the keys (static: part)
  const long long room = (long long)dv.smem_optin -
                         (long long)kWarps * 32 * (long long)sizeof(int) -
                         (long long)l->per_block * (long long)sizeof(int);
  // a window of cells, a multiple of 4 (the last row padded up to it): all
  // n_leaf cells if they fit, else the most multiple of 32 that fit
  long long fit = room / (long long)sizeof(int);
  if (fit > kMaxWindow) fit = kMaxWindow;
  const long long padded = ((long long)n_leaf + 3) & ~3LL;
  const long long window = padded <= fit ? padded : fit & ~31LL;
  if (window < 4) return kTooLarge;
  l->window = (int)window;
  l->windows = (n_leaf + l->window - 1) / l->window;
  l->smem = ((size_t)l->window + (size_t)l->per_block) * sizeof(int);
  return 0;
}

// Kernel launches, counted beside the launch.
int g_launches = 0;

}  // namespace

#ifdef REPRO_K35_BREAKDOWN
// The breakdown build's stamps of K3's last call, copied to host (256, 8)
// int64 (ns; 0 where a block stamped nothing), then cleared.
extern "C" int repro_k3_marks(long long* host) {
  void* dev = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev, d_marks);
  if (err == cudaSuccess) {
    err = cudaMemcpy(host, dev, sizeof(d_marks), cudaMemcpyDeviceToHost);
  }
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(d_marks));
  return (int)err;
}
#endif

// Device launches of K3 since the last reset; reset != 0 sets the count to
// 0 after reading it.
extern "C" int repro_morton_sort_device_launches(int reset) {
  const int k = g_launches;
  if (reset) g_launches = 0;
  return k;
}

// int32 words of scratch a call of n neurons into n_leaf cells takes on the
// current device (0 when it cannot run there: see repro_morton_sort).
extern "C" long long repro_morton_sort_workspace(int n, int n_leaf) {
  int dev;
  Launch l;
  if (n < 1 || n_leaf < 1 || plan(n, n_leaf, &dev, &l) != 0) return 0;
  return (long long)(l.windows > 1 ? 2 : 1) * l.grid * l.window;
}

// positions (n, 3) f32 -> rel, slot (n,) int32, n >= 1, 1 <= n_leaf <=
// 2^22. work: int32 scratch of `words` words (repro_morton_sort_workspace),
// any contents. One cooperative launch. Returns 0, a cudaError_t, or -3
// when a block's share of the neurons does not fit its shared memory.
extern "C" int repro_morton_sort(const void* positions, void* rel, void* slot,
                                 void* work, long long words, int n,
                                 int leaf_base, int level, int n_leaf,
                                 void* stream) {
  if (n < 1 || n_leaf < 1 || n_leaf > (1 << kCellBits) || level < 0 ||
      level > 10) {
    return (int)cudaErrorInvalidValue;
  }
  int dev;
  Launch l;
  int rc = plan(n, n_leaf, &dev, &l);
  if (rc != 0) return rc;
  if (words < (long long)(l.windows > 1 ? 2 : 1) * l.grid * l.window) {
    return (int)cudaErrorInvalidValue;
  }
  repro::DeviceFacts dv;
  cudaError_t err;
  if ((err = repro::current_device(&dev, &dv)) != cudaSuccess) return (int)err;
  int occ = 0;
  if ((err = repro::resident_blocks((const void*)morton_sort_kernel, dev,
                                    kThreads, l.smem, dv.smem_optin,
                                    &occ)) != cudaSuccess) {
    return (int)err;
  }
  if ((long long)occ * dv.sms < l.grid) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  MortonArgs a;
  a.pos = (const float*)positions;
  a.rel = (int*)rel;
  a.slot = (int*)slot;
  a.rows = (int*)work;
  a.n = n;
  a.per_block = l.per_block;
  a.leaf_base = leaf_base;
  a.level = level;
  a.n_leaf = n_leaf;
  a.window = l.window;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)morton_sort_kernel,
                                    dim3((unsigned)l.grid), dim3(kThreads),
                                    args, l.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  ++g_launches;
  return (int)cudaGetLastError();
}
