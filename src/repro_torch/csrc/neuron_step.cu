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
// Bound on the H100: bytes. The function reads 6 f32 arrays (and up to six
// more per-neuron parameters) and writes 5 f32 arrays and one byte array,
// 45 bytes a neuron homogeneous and 69 with six parameter arrays (2.9 / 4.5
// MB at n = 65,536, 0.9 / 1.4 us at 3.35 TB/s); about 30 float operations a
// neuron. At that n the launch itself is most of the time:
// repro_neuron_step_floor launches an empty kernel of the same grid and
// parameters, and chip_smoke.py times it beside the kernel.
//
// Design. A thread takes four neurons a step: 16-byte loads and stores
// (float4) of every array, `spiked` written four bytes at a time; the n % 4
// neurons left at the end go one a thread. Pointers that are not 16-byte
// aligned (views at an odd offset) take the one-a-thread loop for every
// neuron. The grid is sized to the SMs (a grid-stride loop past that), not
// to n. The six parameters a, b, c, d, nu and eps are each a value, one f32
// on the card (stride 0) or an (n,) array (stride 1), so a mix of scalars
// and arrays passes as it is and nothing is broadcast or copied. Everything
// goes in one packed struct, by value: one launch a call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace {

// The parameters of one call, packed as bytes by
// repro_torch/kernels/neuron_step.py (_ARGS): no padding, 208 bytes.
struct NeuronStepArgs {
  const float* in[6];      // v, u, ca, ax, de, inp: (n,)
  float* out[5];           // v, u, ca, ax, de: (n,)
  unsigned char* spiked;   // (n,)
  const float* param[6];   // a, b, c, d, nu, eps on the card, or nullptr
  int stride[6];           // 1: an (n,) array; 0: one value at param[k]
  float value[6];          // the parameter where param[k] is nullptr
  float ca_decay, ca_beta;
  int n;
  int vec;                 // every pointer aligned for the float4 loop
};

constexpr int kThreads = 128;     // 64 or 256 were no faster on the H100
constexpr int kBlocksPerSm = 16;  // 2,048 threads an SM

struct Neuron {
  float v, u, ca, ax, de;
  bool fired;
};

__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ Neuron integrate(float v, float u, float ca,
                                            float ax, float de, float i_t,
                                            float a, float b, float c,
                                            float d, float nu, float eps,
                                            float ca_decay, float ca_beta) {
  for (int h = 0; h < 2; ++h) {
    v = v + 0.5f * (0.04f * v * v + 5.0f * v + 140.0f - u + i_t);
  }
  u = u + a * (b * v - u);
  const bool fired = v >= 30.0f;
  if (fired) {
    v = c;
    u = u + d;
  }
  ca = ca + (-ca * ca_decay + ca_beta * (fired ? 1.0f : 0.0f));
  const float drive = nu * (1.0f - ca / eps);
  return Neuron{v, u, ca, max0(ax + drive), max0(de + drive), fired};
}

#ifdef REPRO_K8_BREAKDOWN
// tools/k8_breakdown.py builds this file alone with REPRO_K8_BREAKDOWN: the
// same loads and stores with one add between them instead of the model's
// arithmetic, which splits the kernel's time into its memory round trip and
// its arithmetic. The library build never defines it.
__device__ __forceinline__ Neuron copy_through(float v, float u, float ca,
                                               float ax, float de, float i_t,
                                               float a, float b, float c,
                                               float d, float nu, float eps,
                                               float, float) {
  return Neuron{v + a, u + b, ca + c, ax + d, de + nu + eps, i_t >= 30.0f};
}
#define REPRO_K8_STEP copy_through
#else
#define REPRO_K8_STEP integrate
#endif

__device__ __forceinline__ float param1(const NeuronStepArgs& a, int k,
                                        int i) {
  const float* p = a.param[k];
  return p == nullptr ? a.value[k] : __ldg(p + (long long)a.stride[k] * i);
}

__device__ __forceinline__ float4 param4(const NeuronStepArgs& a, int k,
                                         int g) {
  const float* p = a.param[k];
  if (p == nullptr) return make_float4(a.value[k], a.value[k], a.value[k],
                                       a.value[k]);
  if (a.stride[k] == 0) {
    const float x = __ldg(p);
    return make_float4(x, x, x, x);
  }
  return __ldg(reinterpret_cast<const float4*>(p) + g);
}

__device__ __forceinline__ float4 in4(const NeuronStepArgs& a, int k, int g) {
  return __ldg(reinterpret_cast<const float4*>(a.in[k]) + g);
}

__device__ __forceinline__ float lane(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

__global__ void __launch_bounds__(kThreads) neuron_step_kernel(
    const NeuronStepArgs a) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int threads = gridDim.x * kThreads;
  const int groups = a.vec ? a.n >> 2 : 0;
  for (int g = tid; g < groups; g += threads) {
    const float4 v = in4(a, 0, g), u = in4(a, 1, g), ca = in4(a, 2, g),
                 ax = in4(a, 3, g), de = in4(a, 4, g), it = in4(a, 5, g);
    const float4 pa = param4(a, 0, g), pb = param4(a, 1, g),
                 pc = param4(a, 2, g), pd = param4(a, 3, g),
                 pnu = param4(a, 4, g), peps = param4(a, 5, g);
    Neuron r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = REPRO_K8_STEP(lane(v, j), lane(u, j), lane(ca, j), lane(ax, j),
                           lane(de, j), lane(it, j), lane(pa, j), lane(pb, j),
                           lane(pc, j), lane(pd, j), lane(pnu, j),
                           lane(peps, j), a.ca_decay, a.ca_beta);
    }
    reinterpret_cast<float4*>(a.out[0])[g] =
        make_float4(r[0].v, r[1].v, r[2].v, r[3].v);
    reinterpret_cast<float4*>(a.out[1])[g] =
        make_float4(r[0].u, r[1].u, r[2].u, r[3].u);
    reinterpret_cast<float4*>(a.out[2])[g] =
        make_float4(r[0].ca, r[1].ca, r[2].ca, r[3].ca);
    reinterpret_cast<float4*>(a.out[3])[g] =
        make_float4(r[0].ax, r[1].ax, r[2].ax, r[3].ax);
    reinterpret_cast<float4*>(a.out[4])[g] =
        make_float4(r[0].de, r[1].de, r[2].de, r[3].de);
    reinterpret_cast<uchar4*>(a.spiked)[g] =
        make_uchar4(r[0].fired, r[1].fired, r[2].fired, r[3].fired);
  }
  for (int i = (groups << 2) + tid; i < a.n; i += threads) {
    const Neuron r = REPRO_K8_STEP(
        __ldg(a.in[0] + i), __ldg(a.in[1] + i), __ldg(a.in[2] + i),
        __ldg(a.in[3] + i), __ldg(a.in[4] + i), __ldg(a.in[5] + i),
        param1(a, 0, i), param1(a, 1, i), param1(a, 2, i), param1(a, 3, i),
        param1(a, 4, i), param1(a, 5, i), a.ca_decay, a.ca_beta);
    a.out[0][i] = r.v;
    a.out[1][i] = r.u;
    a.out[2][i] = r.ca;
    a.out[3][i] = r.ax;
    a.out[4][i] = r.de;
    a.spiked[i] = (unsigned char)r.fired;
  }
}

// The floor under the kernel: the same grid and the same parameter block,
// no work.
__global__ void __launch_bounds__(kThreads) neuron_step_empty_kernel(
    const NeuronStepArgs a) {}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

cudaError_t grid_for(NeuronStepArgs* a, int* blocks) {
  int dev;
  repro::DeviceFacts facts;
  const cudaError_t err = repro::current_device(&dev, &facts);
  if (err != cudaSuccess) return err;
  bool vec = aligned(a->spiked, 4);
  for (int k = 0; k < 6; ++k) vec = vec && aligned(a->in[k], 16);
  for (int k = 0; k < 5; ++k) vec = vec && aligned(a->out[k], 16);
  for (int k = 0; k < 6; ++k) {
    vec = vec && (a->param[k] == nullptr || a->stride[k] == 0 ||
                  aligned(a->param[k], 16));
  }
  a->vec = vec;
  const int per_thread = vec ? 4 : 1;
  const long long want =
      ((long long)a->n + (long long)per_thread * kThreads - 1) /
      ((long long)per_thread * kThreads);
  const long long most = (long long)facts.sms * kBlocksPerSm;
  *blocks = (int)(want < most ? want : most);
  return cudaSuccess;
}

}  // namespace

// One step of n neurons: `args` a NeuronStepArgs (its `vec` is set here).
extern "C" int repro_neuron_step(const void* args, void* stream) {
  NeuronStepArgs a = *(const NeuronStepArgs*)args;
  if (a.n <= 0) return (int)cudaGetLastError();
  int blocks;
  const cudaError_t err = grid_for(&a, &blocks);
  if (err != cudaSuccess) return (int)err;
  neuron_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The empty kernel of the grid repro_neuron_step would launch for `args`.
extern "C" int repro_neuron_step_floor(const void* args, void* stream) {
  NeuronStepArgs a = *(const NeuronStepArgs*)args;
  if (a.n <= 0) return (int)cudaGetLastError();
  int blocks;
  const cudaError_t err = grid_for(&a, &blocks);
  if (err != cudaSuccess) return (int)err;
  neuron_step_empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
