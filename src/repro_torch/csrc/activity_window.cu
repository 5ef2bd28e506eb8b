// K1: the activity window — Delta electrical steps of one rank.
//
// Replaces the JAX package's Pallas megakernel
// kernels/activity_fused.py::activity_window (pallas_call at :279, body
// _window_kernel, math step_core). For every step t and neuron i: the
// signed-weight synaptic sum over the neuron's in-edge row (true local spikes
// from step t-1, Bernoulli(rate) remote spikes reconstructed from the
// Threefry hash keyed by (seed, SPIKE_DOMAIN, gstep, dst_gid*S + slot)),
// Box-Muller background noise, two half-ms Izhikevich Euler steps and the
// reset, calcium, axonal/dendritic element growth, and the step's exact fired
// count. repro_torch/kernels/activity_fused.py::step_core is the plain
// version; this file repeats its arithmetic op for op (built with
// --fmad=false), and torch's CUDA ops call the same logf/log1pf/cosf/sqrtf,
// so on the card kernel and plain version agree bitwise (chip_smoke.py).
//
// Design. Step t reads EVERY neuron's step t-1 spike flag through the in-edge
// table, so steps need a grid-wide ordering. The TPU ran the steps as a
// sequential grid with the state resident in VMEM; here each step is its own
// launch on the caller's stream (Delta launches per window, from the host
// loop below), one thread per neuron looping over its S edges. The spike
// flags are DOUBLE-BUFFERED: a step reads `prev` and writes `next`, and the
// loop swaps them. Writing the flags in place would let a block read a flag
// another block already overwrote this step — a race the sequential TPU grid
// never had. The other state (v, u, ca, ax, de, spike_count) belongs to the
// thread's own neuron only and is updated in place. The fired count of a step
// is an exact integer: a block count (__syncthreads_count) and one atomicAdd
// on an int, converted to f32 by the caller. Edges that are local or empty
// skip the hash (their draw is masked by `remote & (u < rate)` anyway), and
// seed, rank and the rank count are runtime arguments.
//
// Bound on the H100: per step the in-edge table (n*S*4 bytes, 8 MB at
// n=65,536, S=32) is read again; it fits in the 50 MB L2, so after the first
// step the window is bound by the per-neuron integer and float work (the
// noise hash, ~120 integer operations, plus ~10 operations per edge) and by
// the launch latency of Delta small launches. A persistent cooperative launch
// or a CUDA graph over the Delta launches, and a warp-per-row edge layout for
// coalesced loads, are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

struct WindowArgs {
  float* v;
  float* u;
  float* ca;
  float* ax;
  float* de;
  float* spike_count;
  const int* in_edges;
  const float* w_table;
  const float* rates;
  const float* bg_mean;
  const float* bg_std;
  const float* izh_a;
  const float* izh_b;
  const float* izh_c;
  const float* izh_d;
  const float* izh_nu;
  const float* izh_eps;
  int n;
  int s_max;
  int num_ranks;
  int rank;
  uint32_t seed;
  float ca_decay;
  float ca_beta;
};

__global__ void activity_step_kernel(WindowArgs a,
                                     const unsigned char* __restrict__ prev,
                                     unsigned char* __restrict__ next,
                                     int gstep, int* __restrict__ fired_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int fired = 0;
  if (i < a.n) {
    const int n = a.n;
    const uint32_t dst_gid = (uint32_t)a.rank * (uint32_t)n + (uint32_t)i;
    // ---- (a) synaptic input from the in-edge row ----------------------
    float syn_in = 0.0f;
    const int* row = a.in_edges + (size_t)i * a.s_max;
    for (int s = 0; s < a.s_max; ++s) {
      const int src = row[s];
      if (src < 0) continue;                       // empty slot
      const int src_rank = src / n;
      const int src_lid = src - src_rank * n;
      bool hit;
      if (src_rank == a.rank) {
        hit = prev[src_lid] != 0;                  // true local spike
      } else {
        const uint32_t edge_id = dst_gid * (uint32_t)a.s_max + (uint32_t)s;
        const float u = repro::hash_uniform(a.seed, repro::SPIKE_DOMAIN,
                                            (uint32_t)gstep, edge_id);
        const int r = src_rank < a.num_ranks ? src_rank : a.num_ranks - 1;
        hit = u < a.rates[(size_t)r * n + src_lid];
      }
      if (hit) syn_in += a.w_table[src_lid];
    }
    // ---- (b) background noise -------------------------------------------
    const float z = repro::hash_normal(a.seed, repro::NOISE_DOMAIN,
                                       (uint32_t)gstep, dst_gid);
    const float noise = a.bg_mean[i] + a.bg_std[i] * z;
    // ---- (c) Izhikevich + calcium + element growth ----------------------
    float v = a.v[i];
    float u = a.u[i];
    const float i_t = syn_in + noise;
    for (int h = 0; h < 2; ++h) {
      v = v + 0.5f * (0.04f * v * v + 5.0f * v + 140.0f - u + i_t);
    }
    u = u + a.izh_a[i] * (a.izh_b[i] * v - u);
    fired = v >= 30.0f;
    if (fired) {
      v = a.izh_c[i];
      u = u + a.izh_d[i];
    }
    float ca = a.ca[i];
    ca = ca + (-ca * a.ca_decay + a.ca_beta * (fired ? 1.0f : 0.0f));
    const float drive = a.izh_nu[i] * (1.0f - ca / a.izh_eps[i]);
    a.v[i] = v;
    a.u[i] = u;
    a.ca[i] = ca;
    a.ax[i] = max0(a.ax[i] + drive);
    a.de[i] = max0(a.de[i] + drive);
    a.spike_count[i] = a.spike_count[i] + (fired ? 1.0f : 0.0f);
    next[i] = (unsigned char)fired;
  }
  const int block_fired = __syncthreads_count(fired);
  if (threadIdx.x == 0 && block_fired > 0) atomicAdd(fired_count, block_fired);
}

}  // namespace

// Runs num_steps launches on `stream`. spiked_a holds the input flags; after
// the window the flags are in spiked_a when num_steps is even, else in
// spiked_b. fired_counts (num_steps,) must be zeroed by the caller.
extern "C" int repro_activity_window(
    void* v, void* u, void* ca, void* ax, void* de, void* spike_count,
    void* spiked_a, void* spiked_b, const void* in_edges, const void* w_table,
    const void* rates, const void* bg_mean, const void* bg_std,
    const void* izh_a, const void* izh_b, const void* izh_c,
    const void* izh_d, const void* izh_nu, const void* izh_eps,
    void* fired_counts, int n, int s_max, int num_ranks, int rank,
    unsigned int seed, int gstep0, int num_steps, float ca_decay,
    float ca_beta, void* stream) {
  WindowArgs a;
  a.v = (float*)v;
  a.u = (float*)u;
  a.ca = (float*)ca;
  a.ax = (float*)ax;
  a.de = (float*)de;
  a.spike_count = (float*)spike_count;
  a.in_edges = (const int*)in_edges;
  a.w_table = (const float*)w_table;
  a.rates = (const float*)rates;
  a.bg_mean = (const float*)bg_mean;
  a.bg_std = (const float*)bg_std;
  a.izh_a = (const float*)izh_a;
  a.izh_b = (const float*)izh_b;
  a.izh_c = (const float*)izh_c;
  a.izh_d = (const float*)izh_d;
  a.izh_nu = (const float*)izh_nu;
  a.izh_eps = (const float*)izh_eps;
  a.n = n;
  a.s_max = s_max;
  a.num_ranks = num_ranks;
  a.rank = rank;
  a.seed = seed;
  a.ca_decay = ca_decay;
  a.ca_beta = ca_beta;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  unsigned char* bufs[2] = {(unsigned char*)spiked_a,
                            (unsigned char*)spiked_b};
  for (int t = 0; t < num_steps; ++t) {
    activity_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        a, bufs[t % 2], bufs[(t + 1) % 2], gstep0 + t,
        (int*)fired_counts + t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
