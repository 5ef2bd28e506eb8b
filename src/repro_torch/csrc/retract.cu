// Retraction on the card: the per-row choice of the synapses a neuron's lost
// elements break, and the keyed per-(a, b) priorities it and the acceptance
// rank by.
//
// Not a TPU kernel: the JAX package computes both in jnp
// (connectome/synapses.py:56 edge_priority, :89 request_priority, :117
// retract_synapses). repro_torch/connectome/synapses.py holds the plain
// versions (retract_synapses, edge_priority), which draw jax.random's
// priorities through the port's int64 Threefry; here jax's key derivation
// runs in registers from K0's device functions (hash.cuh: priority,
// pair_priority, shared with K4's keyed accept), so the two are bit-equal.
//
// On the simulation's paths the acceptance priorities are drawn inside K4
// (synapse_apply.cu, keyed mode); edge_priority stays as the kernel API's
// standalone draw, held against its plain version.
//
// Design. retract: one warp per row, one lane per slot (S <= 32). A lane's
// priority is drawn only where the rules need it: a row with n_delete <= 0
// kills nothing and a row with n_delete >= its occupied count kills every
// occupied slot (the lesion case), both without a draw; the scenario's rows
// hold about 0.25 synapses a neuron, so most rows hash nothing. Otherwise the
// row key is drawn once (lane 0, broadcast by shuffle) and each occupied
// slot draws its own priority; unoccupied slots rank as 2.0. The rank is the
// reference's (priority, slot) lexicographic count over the row, one shuffle
// a slot. edge_priority: one thread per pair, three Threefry each.
//
// Bound on the H100: bytes (the two tables of a chunk's retraction, 8 MB
// each at CONFIG, read and written, the kill mask written) or, on rows that
// draw, 2 Threefry a slot and 1 a row at 67 integer instructions each (as
// nvcc compiles hash.cuh, tools/k0_sass.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // warps (rows) per block of retract

__global__ void __launch_bounds__(kRowsPerBlock * 32) retract_kernel(
    const int* __restrict__ edges, const int* __restrict__ n_delete,
    const int* __restrict__ row_gids, int* __restrict__ out,
    unsigned char* __restrict__ kill, int n, int S, uint32_t k0,
    uint32_t k1) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kRowsPerBlock;
  for (int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5); row < n;
       row += warps) {
    const long long base = (long long)row * S;
    const int e = lane < S ? edges[base + lane] : -1;
    const bool occ = e >= 0;
    const unsigned occ_mask = __ballot_sync(0xffffffffu, occ);
    const int count = __popc(occ_mask);
    const int nd = n_delete[row];
    bool dead;
    if (nd <= 0) {
      dead = false;
    } else if (nd >= count) {
      dead = occ;
    } else {
      uint32_t rk0 = 0, rk1 = 0;
      if (lane == 0) {
        repro::threefry2x32(k0, k1, 0u, (uint32_t)row_gids[row], &rk0, &rk1);
      }
      rk0 = __shfl_sync(0xffffffffu, rk0, 0);
      rk1 = __shfl_sync(0xffffffffu, rk1, 0);
      const float p = occ ? repro::priority(rk0, rk1, (uint32_t)e) : 2.0f;
      int rank = 0;
      for (int i = 0; i < S; ++i) {
        const float pi = __shfl_sync(0xffffffffu, p, i);
        rank += (pi < p) || (pi == p && i < lane);
      }
      dead = occ && rank < nd;
    }
    if (lane < S) {
      out[base + lane] = dead ? -1 : e;
      kill[base + lane] = dead;
    }
  }
}

__global__ void edge_priority_kernel(const int* __restrict__ a,
                                     const int* __restrict__ b,
                                     const unsigned char* __restrict__ valid,
                                     float* __restrict__ out, int n,
                                     uint32_t k0, uint32_t k1) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const bool v = valid == nullptr || valid[i] != 0;
    out[i] = repro::pair_priority(k0, k1, v ? (uint32_t)a[i] : 0u,
                                  v ? (uint32_t)b[i] : 0u);
  }
}

}  // namespace

extern "C" int repro_retract(const void* edges, const void* n_delete,
                             const void* row_gids, void* out, void* kill,
                             int n, int S, unsigned int k0, unsigned int k1,
                             void* stream) {
  if (S < 1 || S > 32) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    long long blocks = ((long long)n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > (1 << 20)) blocks = 1 << 20;
    retract_kernel<<<(int)blocks, kRowsPerBlock * 32, 0,
                     (cudaStream_t)stream>>>(
        (const int*)edges, (const int*)n_delete, (const int*)row_gids,
        (int*)out, (unsigned char*)kill, n, S, k0, k1);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_edge_priority(const void* a, const void* b,
                                   const void* valid, void* out, int n,
                                   unsigned int k0, unsigned int k1,
                                   void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = ((long long)n + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;
    edge_priority_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, (const unsigned char*)valid,
        (float*)out, n, k0, k1);
  }
  return (int)cudaGetLastError();
}
