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
// in VMEM. A stable rank cannot come from atomic counters (they give the
// right counts in a run-dependent order), so the rank is built from tiles in
// three passes, each O(n) whatever the positions:
//   1. encode_tiles: one block per tile of 256 neurons encodes the tile into
//      shared memory and writes rel. Each thread counts the earlier and all
//      equal cells in its tile (256 compares in shared memory): the earlier
//      count is the within-tile rank (written to slot), and the first
//      occurrence of a cell in the tile writes the tile's count of that cell
//      to hist[cell][tile].
//   2. scan_cells: one warp per cell turns hist[cell][0..tiles) into an
//      exclusive prefix sum over the tiles (warp shuffles), in place.
//   3. add_offsets: slot[i] += hist[rel[i]][tile(i)].
// The cost does not depend on how many neurons share a cell: the tile
// compare is 256 x 256 per block and the scan n_leaf x tiles, so the worst
// case is O(n * 256 + n_leaf * n / 256) operations and n_leaf * n / 256 * 4
// bytes of scratch (4 MB at n = 65,536, n_leaf = 4,096).
//
// Bound on the H100: the function moves n*12 bytes of positions in and
// n*8 bytes of (rel, slot) out, 1.3 MB at n = 65,536, under a microsecond at
// 3.35 TB/s. The kernel is bound by its three launches and the per-tile
// compares; the hist round trip (4 MB, in L2) is the extra traffic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;

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

__global__ void encode_tiles(const float* __restrict__ pos,
                             int* __restrict__ rel, int* __restrict__ slot,
                             int* __restrict__ hist, int n, int tiles,
                             int leaf_base, int level, int n_leaf) {
  __shared__ int cell[kTile];
  const int tile = blockIdx.x;
  const int i = tile * kTile + threadIdx.x;
  const int m = min(kTile, n - tile * kTile);
  int c = -1;
  if (i < n) {
    c = encode(pos + (size_t)i * 3, level) - leaf_base;
    c = c < 0 ? 0 : (c > n_leaf - 1 ? n_leaf - 1 : c);
    rel[i] = c;
  }
  cell[threadIdx.x] = c;
  __syncthreads();
  if (i < n) {
    int earlier = 0, total = 0;
    for (int j = 0; j < m; ++j) {
      const int eq = cell[j] == c;
      total += eq;
      earlier += eq & (j < (int)threadIdx.x);
    }
    slot[i] = earlier;
    if (earlier == 0) hist[(size_t)c * tiles + tile] = total;
  }
}

__global__ void scan_cells(int* __restrict__ hist, int tiles, int n_leaf) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_leaf) return;
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
}

__global__ void add_offsets(const int* __restrict__ rel,
                            int* __restrict__ slot,
                            const int* __restrict__ hist, int n, int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) slot[i] += hist[(size_t)rel[i] * tiles + i / kTile];
}

}  // namespace

// positions (n, 3) f32 -> rel, slot (n,) int32. hist: (n_leaf, tiles) int32
// scratch, zeroed by the caller, tiles = ceil(n / 256).
extern "C" int repro_morton_sort(const void* positions, void* rel, void* slot,
                                 void* hist, int n, int tiles, int leaf_base,
                                 int level, int n_leaf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    encode_tiles<<<tiles, kTile, 0, s>>>((const float*)positions, (int*)rel,
                                         (int*)slot, (int*)hist, n, tiles,
                                         leaf_base, level, n_leaf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int warps_per_block = 8;
    scan_cells<<<(n_leaf + warps_per_block - 1) / warps_per_block,
                 warps_per_block * 32, 0, s>>>((int*)hist, tiles, n_leaf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    add_offsets<<<(n + 255) / 256, 256, 0, s>>>((const int*)rel, (int*)slot,
                                                (const int*)hist, n, tiles);
  }
  return (int)cudaGetLastError();
}
