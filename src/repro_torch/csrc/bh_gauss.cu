// K7: the pairwise Gaussian connection probabilities and their row sums.
//
// Replaces the JAX package's Pallas kernel kernels/bh_gauss.py::bh_gauss_probs
// (pallas_call at :78, body _kernel): for searchers x (N, 3), candidates
// y (M, 3) and weights w (M,),
//   P[i, j] = w[j] * exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / sigma^2)
// and rowsum[i] = sum_j P[i, j]. The plain version is
// repro_torch/kernels/bh_gauss.py::bh_gauss_plain. The distance keeps the TPU
// kernel's identity in full FP32 (no tensor cores: TF32 would lose the
// 1e-5 agreement, and the product has only 3 non-zero lanes), each sum of
// three lane products in order, built with --fmad=false, a true division by
// sigma^2 and expf: P equals the plain version's bit for bit on the card.
//
// Design. The TPU kernel ran (256 x 256) tiles with the MXU doing x.y over 8
// padded lanes and carried the row sums across the sequential m-grid in
// VMEM scratch. Here a block takes 32 searchers x 256 candidates: the
// candidate tile (y, |y|^2, w) is staged in shared memory, each lane then
// holds 8 of its columns in registers, and each warp walks 4 rows, writing
// 32 neighbouring floats of P per store (P is written once). Blocks run in
// no order, so the row sum is not carried: each warp reduces its row over
// the tile in a fixed order (8 columns a lane in order, then a butterfly of
// shuffles) into partial[i][tile], and a second launch sums a row's
// partials in tile order. No float atomics: the sums are the same run to
// run.
//
// Bound on the H100: bytes. P is 4 N M bytes written once (1 GiB at
// N = 65,536, M = 4,096: 0.32 ms at 3.35 TB/s); the work is about 30 float
// operations an entry (0.12 ms at 67 TFLOP/s), but expf and the IEEE
// division take several instructions each, so the issue rate may bound it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 256;            // candidates a block
constexpr int kRows = 32;              // searchers a block
constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = kTileM / 32;     // columns a lane

__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

__global__ void gauss_tile(const float* __restrict__ x,
                           const float* __restrict__ y,
                           const float* __restrict__ w, float* __restrict__ p,
                           float* __restrict__ partial, int n, int m,
                           int tiles, float s2) {
  __shared__ float sy0[kTileM], sy1[kTileM], sy2[kTileM], syy[kTileM],
      sw[kTileM];
  const int i0 = blockIdx.x * kRows;
  const int j0 = blockIdx.y * kTileM;
  for (int c = threadIdx.x; c < kTileM; c += kThreads) {
    const int j = j0 + c;
    float a = 0.0f, b = 0.0f, d = 0.0f, ww = 0.0f;
    if (j < m) {
      a = y[3 * (size_t)j];
      b = y[3 * (size_t)j + 1];
      d = y[3 * (size_t)j + 2];
      ww = w[j];
    }
    sy0[c] = a;
    sy1[c] = b;
    sy2[c] = d;
    syy[c] = a * a + b * b + d * d;
    sw[c] = ww;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float c0[kCols], c1[kCols], c2[kCols], cyy[kCols], cw[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int c = lane + 32 * k;
    c0[k] = sy0[c];
    c1[k] = sy1[c];
    c2[k] = sy2[c];
    cyy[k] = syy[c];
    cw[k] = sw[c];
  }
  for (int r = warp; r < kRows; r += kWarps) {
    const int i = i0 + r;
    if (i >= n) break;                   // uniform across the warp
    const float x0 = x[3 * (size_t)i];
    const float x1 = x[3 * (size_t)i + 1];
    const float x2 = x[3 * (size_t)i + 2];
    const float xx = x0 * x0 + x1 * x1 + x2 * x2;
    float* row = p + (size_t)i * m;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int j = j0 + lane + 32 * k;
      if (j < m) {
        const float xy = x0 * c0[k] + x1 * c1[k] + x2 * c2[k];
        const float d2 = max0(xx + cyy[k] - 2.0f * xy);
        const float v = cw[k] * expf(-d2 / s2);
        row[j] = v;
        acc += v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) partial[(size_t)i * tiles + blockIdx.y] = acc;
  }
}

__global__ void row_sums(const float* __restrict__ partial,
                         float* __restrict__ rowsum, int n, int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = partial + (size_t)i * tiles;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += row[t];
  rowsum[i] = s;
}

}  // namespace

// x (n, 3), y (m, 3), w (m,) f32 -> p (n, m), rowsum (n,) f32. partial:
// (n, tiles) f32 scratch, tiles = ceil(m / 256). s2 = sigma^2 as f32.
extern "C" int repro_bh_gauss(const void* x, const void* y, const void* w,
                              void* p, void* partial, void* rowsum, int n,
                              int m, int tiles, float s2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (tiles > 0) {
    const dim3 grid((n + kRows - 1) / kRows, tiles);
    gauss_tile<<<grid, kThreads, 0, s>>>((const float*)x, (const float*)y,
                                         (const float*)w, (float*)p,
                                         (float*)partial, n, m, tiles, s2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  row_sums<<<(n + 255) / 256, 256, 0, s>>>((const float*)partial,
                                           (float*)rowsum, n, tiles);
  return (int)cudaGetLastError();
}
