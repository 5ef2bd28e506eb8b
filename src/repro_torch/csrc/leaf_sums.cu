// The octree build's leaf level on the card: per leaf cell, the sum of its
// neurons' vacancy weights and of their weighted positions, each added in
// ascending neuron order from +0.0 in f32.
//
// Not a TPU kernel: the JAX package sums the leaves in jnp
// (repro/connectome/tree.py:76-78, `.at[rel].add(weights)` and
// `.at[rel].add(positions * weights[:, None])`, which XLA adds in ascending
// neuron order). The plain version is repro_torch/connectome/tree.py::
// _leaf_sums, a dense (leaf, within-leaf slot) table summed column by
// column; it reads the table's width on the host and allocates
// n_leaf x width floats. This kernel does neither: nothing in it is sized by
// the fullest leaf, and no value goes back to the host.
//
// Design. The leaf of neuron i is rel[i] and its stable rank among the
// leaf's neurons slot[i] (K3, or the reference's positions_within), so the
// members of a leaf in ascending order are known without a sort:
//   1. zero the leaf counts (a memset);
//   2. count: one integer atomic a neuron (exact in any order);
//   3. scan: one block turns the counts into exclusive offsets (tiles of
//      1,024 leaves with a carry), offset[n_leaf] = n;
//   4. place: order[offset[rel[i]] + slot[i]] = i, the members of each leaf
//      side by side in ascending neuron order;
//   5. sum: one warp a leaf. The lanes load 128 members at a time and form
//      the products position x weight (each rounded to f32 on its own: the
//      library is built with --fmad=false, and a product meets its sum only
//      through shared memory), and lane 0 adds the staged values in member
//      order: the count and the three centroid components in one pass, one
//      serial chain each, with the next stage's loads in flight.
// Every step is exact or in the reference's order, so the result is bit-equal
// to the plain version for any layout: the plain version's trailing +0.0
// columns change no sum (a sum from +0.0 is never -0.0).
//
// Bound on the H100: bytes. The function reads the positions (12 B), the
// weight (4 B), rel and slot (8 B) of each neuron and writes 16 B a leaf:
// 1.7 MB at n = 65,536 and n_leaf = 8,192, 0.5 us at 3.35 TB/s. A memset
// and four dependent launches cost more than that. A leaf that holds every neuron of
// the rank (rows clamped into one leaf, as a loaded connectome can give) is
// summed by one warp: n dependent adds a component (the fixed order allows
// no tree), 65,536 x 4 cycles of add latency, about 0.13 ms at 1.98 GHz.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kDepth = 4;              // members a lane loads a stage
constexpr int kStage = 32 * kDepth;    // members a warp adds a stage

__global__ void count_kernel(const int* __restrict__ rel,
                             int* __restrict__ cnt, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    atomicAdd(&cnt[rel[i]], 1);
  }
}

// One block: off[l] = sum of cnt[0..l), off[n_leaf] = the total.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    const int* __restrict__ cnt, int* __restrict__ off, int n_leaf) {
  __shared__ int wsum[kScanThreads / 32];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (int base = 0; base < n_leaf; base += kScanThreads) {
    const int l = base + threadIdx.x;
    const int x = l < n_leaf ? cnt[l] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = wsum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      wsum[lane] = w;   // inclusive over the warps
    }
    __syncthreads();
    const int carry = carry_s;
    const int before = (warp > 0 ? wsum[warp - 1] : 0) + incl - x;
    if (l < n_leaf) off[l] = carry + before;
    __syncthreads();
    if (threadIdx.x == 0) carry_s = carry + wsum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) off[n_leaf] = carry_s;
}

__global__ void place_kernel(const int* __restrict__ rel,
                             const int* __restrict__ slot,
                             const int* __restrict__ off,
                             int* __restrict__ order, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    order[off[rel[i]] + slot[i]] = i;
  }
}

__device__ __forceinline__ float4 member(const float* __restrict__ pos,
                                         const float* __restrict__ w, int i) {
  if (i < 0) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float wi = w[i];
  return make_float4(wi, pos[3 * (long long)i] * wi,
                     pos[3 * (long long)i + 1] * wi,
                     pos[3 * (long long)i + 2] * wi);
}

// One warp a leaf, a stage of kStage members at a time. Lane j loads
// members k + 32 q + j (q < kDepth) of the stage at k and forms their
// products, the warp stages them in shared memory in member order, and lane
// 0 adds the stage's values in that order (one 16-byte shared load a member,
// four independent add chains). The ids of the stage after next and the
// values of the next stage are in flight while a stage is added: a stage is
// long enough (kStage members, about 5 cycles each) to cover a gather's
// latency.
__global__ void __launch_bounds__(kThreads) sum_kernel(
    const float* __restrict__ pos, const float* __restrict__ w,
    const int* __restrict__ off, const int* __restrict__ order,
    float* __restrict__ counts, float* __restrict__ cents, int n_leaf) {
  __shared__ float4 stage[kThreads / 32][kStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = gridDim.x * (kThreads / 32);
  for (int l = blockIdx.x * (kThreads / 32) + warp; l < n_leaf; l += warps) {
    const int begin = off[l];
    const int end = off[l + 1];
    float c = 0.0f, x = 0.0f, y = 0.0f, z = 0.0f;
    float4 cur[kDepth];
    int ids[kDepth];
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      const int i = begin + 32 * q + lane;
      cur[q] = member(pos, w, i < end ? order[i] : -1);
      const int i2 = i + kStage;
      ids[q] = i2 < end ? order[i2] : -1;
    }
    for (int k = begin; k < end; k += kStage) {
      float4 next[kDepth];
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        next[q] = member(pos, w, ids[q]);
        const int i = k + 2 * kStage + 32 * q + lane;
        ids[q] = i < end ? order[i] : -1;
        stage[warp][32 * q + lane] = cur[q];
      }
      __syncwarp();
      if (lane == 0) {
        const int m = min(kStage, end - k);
#pragma unroll 8
        for (int j = 0; j < m; ++j) {
          const float4 v = stage[warp][j];
          c += v.x;
          x += v.y;
          y += v.z;
          z += v.w;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kDepth; ++q) cur[q] = next[q];
    }
    if (lane == 0) {
      counts[l] = c;
      cents[3 * (long long)l] = x;
      cents[3 * (long long)l + 1] = y;
      cents[3 * (long long)l + 2] = z;
    }
  }
}

int grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  return (int)blocks;
}

}  // namespace

// int32 words of scratch a call takes: the counts (n_leaf), the offsets
// (n_leaf + 1) and the members in leaf order (n).
extern "C" long long repro_leaf_sums_workspace(int n, int n_leaf) {
  return 2LL * n_leaf + 1 + (long long)n;
}

// positions (n, 3) f32, weights (n,) f32, rel and slot (n,) int32 with rel
// in [0, n_leaf) and slot the stable rank within the leaf; writes counts
// (n_leaf,) and centroids (n_leaf, 3) f32. work: repro_leaf_sums_workspace
// int32 words, written before they are read.
extern "C" int repro_leaf_sums(const void* positions, const void* weights,
                               const void* rel, const void* slot,
                               void* counts, void* centroids, void* work,
                               int n, int n_leaf, void* stream) {
  if (n < 0 || n_leaf < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* cnt = (int*)work;
  int* off = cnt + n_leaf;
  int* order = off + n_leaf + 1;
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)n_leaf, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    count_kernel<<<grid_for(n), kThreads, 0, s>>>((const int*)rel, cnt, n);
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(cnt, off, n_leaf);
  if (n > 0) {
    place_kernel<<<grid_for(n), kThreads, 0, s>>>(
        (const int*)rel, (const int*)slot, off, order, n);
  }
  sum_kernel<<<grid_for((long long)n_leaf * 32), kThreads, 0, s>>>(
      (const float*)positions, (const float*)weights, off, order,
      (float*)counts, (float*)centroids, n_leaf);
  return (int)cudaGetLastError();
}
