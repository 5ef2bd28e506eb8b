// K0's draws over tensors: one launch computes one whole repro_torch.prng
// call (fold_in, split, random_bits, uniform, randint), one
// kernels/hash.py::threefry_words call or one of its counter-hash draws
// (uniform, gumbel, normal on a CUDA tensor), and writes its final tensor.
//
// Replaces the JAX package's kernels/hash.py (threefry2x32 at :57, with the
// uniform / normal / gumbel / bh_ctr helpers of :75-112), which the TPU
// kernels inline and which jax.random's threefry derivations repeat; K1, K2
// and retract.cu inline the same device function (hash.cuh). The plain
// versions are repro_torch/prng.py's tensor code and
// kernels/hash.py::threefry2x32; the card holds each epilogue bit-equal to
// them.
//
// Design. A draw's four u32 operands (key k0, k1; counter c0, c1) are each a
// value or an int32 / int64 array read over the flat index i of the output
// through one stride (stride 0 broadcasts one element; an int64 element
// gives its low word) or two: element (i % inner) * stride + (i / inner) *
// outer, so that a (Q, 1) column and a (1, F) row broadcast over a (Q, F)
// grid are read where they lie (phase A's and phase B's Gumbel draws:
// source gids against counters). Or the counter is the flat index itself,
// (i >> 32, i & M32), as jax.random.bits numbers a shape's draws. So no
// operand is copied, cast, stacked or built (no arange) around the launch. The epilogue is chosen at
// compile time (the template's mode):
//   kWords    two int64 arrays of u32 words (threefry_words)
//   kKeys     (..., 2) int64 keys (fold_in, split)
//   kBits     int64 x0 ^ x1 (random_bits)
//   kUniform  f32: jax's mantissa fill ((bits >> 9) | 1.0f) - 1, then
//             f * span + lo as XLA contracts it (one fused multiply-add,
//             __fmaf_rn; the library is built with --fmad=false, so nothing
//             else is fused), then the larger of that and lo
//   kRandint  int32: the key's two split keys hashed in registers (once a
//             thread), the higher and lower bits drawn with them, folded
//             modulo the span in u32 as jax.random.randint does.
//   kUnit     f32 counter-hash uniform: the first word's top 24 bits x 2^-24
//             (kernels/hash.py::uniform)
//   kGumbel   f32 -log(-log(max(u, 1e-20))) of that uniform (hash.gumbel)
//   kNormal   f32 Box-Muller on both words, sqrt(-2 log1p(-u1)) cos(2 pi u2)
//             (hash.normal); both in the plain versions' order of ops, the
//             device functions of hash.cuh that K1 and K2 inline.
// One thread per output element, grid-stride over a grid sized to the SMs.
//
// Bound on the H100: integer operations. A draw reads no counter when the
// counter is the flat index and writes 4 bytes (f32, int32) or 8 / 16
// (int64 words, keys); one Threefry is HASH_OPS integer operations
// (chip_smoke.py, counted in the compiled code by tools/k0_sass.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"
#include "hash.cuh"

namespace {

enum Mode {
  kWords = 0, kKeys = 1, kBits = 2, kUniform = 3, kRandint = 4, kUnit = 5,
  kGumbel = 6, kNormal = 7
};

// One u32 operand: `value` where ptr is null, else an element of an int32
// (is64 = 0) or int64 (is64 = 1) array, its low 32 bits: element i * stride
// where inner is 0, else (i % inner) * stride + (i / inner) * outer (the
// caller keeps n below 2^32 then).
struct Word {
  const void* ptr;
  long long stride;
  long long inner;
  long long outer;
  int is64;
  uint32_t value;
};

struct DrawArgs {
  Word k0, k1, c0, c1;
  int flat_counter;      // the counter is (i >> 32, i & M32); c0, c1 unused
  int mode;
  long long n;           // output elements (keys: key pairs)
  void* out;             // kWords: 2 x n int64, first words then second
  float lo, span;        // kUniform: f32 bounds
  uint32_t span_u;       // kRandint: (maxval - minval) mod 2^32, or 1
  uint32_t multiplier;   // kRandint: 2^32 mod span_u (in u32)
  uint32_t minval;       // kRandint: minval's low 32 bits
};

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

int g_launches = 0;

__device__ __forceinline__ uint32_t load(const Word& w, long long i) {
  if (w.ptr == nullptr) return w.value;
  long long j = i * w.stride;
  if (w.inner != 0) {
    const uint32_t q = (uint32_t)i / (uint32_t)w.inner;
    j = (long long)((uint32_t)i - q * (uint32_t)w.inner) * w.stride +
        (long long)q * w.outer;
  }
  return w.is64 ? (uint32_t)__ldg((const unsigned long long*)w.ptr + j)
                : __ldg((const uint32_t*)w.ptr + j);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) draw_kernel(const DrawArgs a) {
  const long long step = (long long)gridDim.x * kThreads;
  // randint: split(key) -> (threefry(key, (0, 0)), threefry(key, (0, 1))),
  // its one key read at index 0
  uint32_t hk0 = 0, hk1 = 0, lk0 = 0, lk1 = 0;
  if (MODE == kRandint) {
    const uint32_t k0 = load(a.k0, 0), k1 = load(a.k1, 0);
    repro::threefry2x32(k0, k1, 0u, 0u, &hk0, &hk1);
    repro::threefry2x32(k0, k1, 0u, 1u, &lk0, &lk1);
  }
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += step) {
    uint32_t c0, c1;
    if (a.flat_counter) {
      c0 = (uint32_t)(i >> 32);
      c1 = (uint32_t)i;
    } else {
      c0 = load(a.c0, i);
      c1 = load(a.c1, i);
    }
    uint32_t x0, x1;
    if (MODE == kRandint) {
      uint32_t y0, y1;
      repro::threefry2x32(hk0, hk1, c0, c1, &x0, &x1);
      repro::threefry2x32(lk0, lk1, c0, c1, &y0, &y1);
      const uint32_t higher = x0 ^ x1, lower = y0 ^ y1;
      uint32_t off = (higher % a.span_u) * a.multiplier;
      off = (off + lower % a.span_u) % a.span_u;
      ((int*)a.out)[i] = (int)(a.minval + off);
      continue;
    }
    repro::threefry2x32(load(a.k0, i), load(a.k1, i), c0, c1, &x0, &x1);
    if (MODE == kWords) {
      ((long long*)a.out)[i] = (long long)x0;
      ((long long*)a.out)[a.n + i] = (long long)x1;
    } else if (MODE == kKeys) {
      ((longlong2*)a.out)[i] = make_longlong2((long long)x0, (long long)x1);
    } else if (MODE == kBits) {
      ((long long*)a.out)[i] = (long long)(x0 ^ x1);
    } else if (MODE == kUnit) {
      ((float*)a.out)[i] = repro::to_unit(x0);
    } else if (MODE == kGumbel) {
      ((float*)a.out)[i] = repro::gumbel_of(x0);
    } else if (MODE == kNormal) {
      ((float*)a.out)[i] = repro::normal_of(x0, x1);
    } else {  // kUniform
      const float f =
          __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
      ((float*)a.out)[i] = fmaxf(a.lo, __fmaf_rn(f, a.span, a.lo));
    }
  }
}

template <int MODE>
cudaError_t launch(const DrawArgs& a, int blocks, cudaStream_t s) {
  draw_kernel<MODE><<<blocks, kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return err;
}

}  // namespace

// One prng / threefry_words / counter-hash draw call: `args` a DrawArgs
// (mode and operands);
// nothing is launched for n = 0.
extern "C" int repro_threefry_draw(const void* args, void* stream) {
  const DrawArgs& a = *(const DrawArgs*)args;
  if (a.n <= 0) return (int)cudaGetLastError();
  int dev;
  repro::DeviceFacts facts;
  cudaError_t err = repro::current_device(&dev, &facts);
  if (err != cudaSuccess) return (int)err;
  long long want = (a.n + kThreads - 1) / kThreads;
  const long long most = (long long)facts.sms * kBlocksPerSm;
  const int blocks = (int)(want < most ? want : most);
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.mode) {
    case kWords: err = launch<kWords>(a, blocks, s); break;
    case kKeys: err = launch<kKeys>(a, blocks, s); break;
    case kBits: err = launch<kBits>(a, blocks, s); break;
    case kUniform: err = launch<kUniform>(a, blocks, s); break;
    case kRandint: err = launch<kRandint>(a, blocks, s); break;
    case kUnit: err = launch<kUnit>(a, blocks, s); break;
    case kGumbel: err = launch<kGumbel>(a, blocks, s); break;
    case kNormal: err = launch<kNormal>(a, blocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The draw kernel's launches since the last reset (counted in launch(),
// beside its <<<>>>).
extern "C" int repro_threefry_device_launches(int reset) {
  const int k = g_launches;
  if (reset) g_launches = 0;
  return k;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
