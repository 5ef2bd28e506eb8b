// K8: the fused per-neuron state update.
//
// Replaces the JAX package's Pallas kernel kernels/neuron_step.py::neuron_step
// (pallas_call at :90 homogeneous, :98 heterogeneous; math _integrate): two
// half-ms Izhikevich Euler halves, the spike reset, the calcium trace and the
// axonal/dendritic element growth, elementwise over n neurons, with no
// synaptic input beyond the given current. The plain version is
// repro_torch/kernels/neuron_step.py::neuron_step_plain; this file repeats its
// arithmetic op for op (the order of K1's csrc/activity_window.cu, built with
// --fmad=false, true division for ca / eps), so the two agree bit for bit on
// the card.
//
// Design. One thread per neuron, no shared memory, no padding: any n >= 1.
// Two variants as on the TPU: HETERO = false takes a, b, c, d, nu and eps as
// kernel arguments; HETERO = true reads six per-neuron (n,) arrays. The
// calcium decay and beta are always arguments.
//
// Bound on the H100: bytes. The function reads 6 (homogeneous) or 12
// (heterogeneous) f32 arrays and writes 5 f32 arrays and one byte array,
// 45 or 69 bytes a neuron (2.9 / 4.5 MB at n = 65,536, about 1 us at
// 3.35 TB/s); about 30 float operations a neuron. At the main path's n a
// launch is one wave of 256 blocks, so its time is the launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  float a, b, c, d, nu, eps, ca_decay, ca_beta;
};

__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

template <bool HETERO>
__global__ void neuron_step_kernel(
    const float* __restrict__ v_in, const float* __restrict__ u_in,
    const float* __restrict__ ca_in, const float* __restrict__ ax_in,
    const float* __restrict__ de_in, const float* __restrict__ inp,
    const float* __restrict__ pa, const float* __restrict__ pb,
    const float* __restrict__ pc, const float* __restrict__ pd,
    const float* __restrict__ pnu, const float* __restrict__ peps,
    float* __restrict__ v_out, float* __restrict__ u_out,
    float* __restrict__ ca_out, float* __restrict__ ax_out,
    float* __restrict__ de_out, unsigned char* __restrict__ spiked, int n,
    Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = HETERO ? pa[i] : p.a;
  const float b = HETERO ? pb[i] : p.b;
  const float c = HETERO ? pc[i] : p.c;
  const float d = HETERO ? pd[i] : p.d;
  const float nu = HETERO ? pnu[i] : p.nu;
  const float eps = HETERO ? peps[i] : p.eps;
  float v = v_in[i];
  float u = u_in[i];
  const float i_t = inp[i];
  for (int h = 0; h < 2; ++h) {
    v = v + 0.5f * (0.04f * v * v + 5.0f * v + 140.0f - u + i_t);
  }
  u = u + a * (b * v - u);
  const bool fired = v >= 30.0f;
  if (fired) {
    v = c;
    u = u + d;
  }
  float ca = ca_in[i];
  ca = ca + (-ca * p.ca_decay + p.ca_beta * (fired ? 1.0f : 0.0f));
  const float drive = nu * (1.0f - ca / eps);
  v_out[i] = v;
  u_out[i] = u;
  ca_out[i] = ca;
  ax_out[i] = max0(ax_in[i] + drive);
  de_out[i] = max0(de_in[i] + drive);
  spiked[i] = (unsigned char)fired;
}

}  // namespace

// v, u, ca, ax, de, inp: (n,) f32 in; a..eps: (n,) f32 each when hetero,
// else ignored (the scalars are used); outputs five (n,) f32 and (n,) bytes.
extern "C" int repro_neuron_step(
    const void* v, const void* u, const void* ca, const void* ax,
    const void* de, const void* inp, const void* pa, const void* pb,
    const void* pc, const void* pd, const void* pnu, const void* peps,
    void* v_out, void* u_out, void* ca_out, void* ax_out, void* de_out,
    void* spiked, int n, int hetero, float a, float b, float c, float d,
    float nu, float eps, float ca_decay, float ca_beta, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const Params p{a, b, c, d, nu, eps, ca_decay, ca_beta};
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_NEURON_ARGS                                                     \
  (const float*)v, (const float*)u, (const float*)ca, (const float*)ax,      \
      (const float*)de, (const float*)inp, (const float*)pa,                 \
      (const float*)pb, (const float*)pc, (const float*)pd,                  \
      (const float*)pnu, (const float*)peps, (float*)v_out, (float*)u_out,   \
      (float*)ca_out, (float*)ax_out, (float*)de_out,                        \
      (unsigned char*)spiked, n, p
  if (hetero) {
    neuron_step_kernel<true><<<blocks, threads, 0, s>>>(REPRO_NEURON_ARGS);
  } else {
    neuron_step_kernel<false><<<blocks, threads, 0, s>>>(REPRO_NEURON_ARGS);
  }
#undef REPRO_NEURON_ARGS
  return (int)cudaGetLastError();
}
