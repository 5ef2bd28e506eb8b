// Elementwise Threefry-2x32 over four u32 arrays: the check kernel that holds
// the K0 device functions (hash.cuh) bit-equal to the plain torch version
// (repro_torch/kernels/hash.py::threefry2x32) on the card. Not on the
// simulation path; K1 and K2 inline the same functions.
//
// Bound on the H100: integer operations (~120 per element); one thread per
// element, grid-stride.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

__global__ void threefry_words_kernel(const uint32_t* __restrict__ k0,
                                      const uint32_t* __restrict__ k1,
                                      const uint32_t* __restrict__ c0,
                                      const uint32_t* __restrict__ c1,
                                      uint32_t* __restrict__ o0,
                                      uint32_t* __restrict__ o1, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    repro::threefry2x32(k0[i], k1[i], c0[i], c1[i], &o0[i], &o1[i]);
  }
}

extern "C" int repro_threefry_words(const void* k0, const void* k1,
                                    const void* c0, const void* c1, void* o0,
                                    void* o1, int n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    int blocks = (n + threads - 1) / threads;
    if (blocks > 65535) blocks = 65535;
    threefry_words_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)k0, (const uint32_t*)k1, (const uint32_t*)c0,
        (const uint32_t*)c1, (uint32_t*)o0, (uint32_t*)o1, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
