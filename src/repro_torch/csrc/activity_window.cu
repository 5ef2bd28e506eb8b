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
// version; this file repeats its per-neuron arithmetic op for op (built with
// --fmad=false), and torch's CUDA ops call the same logf/log1pf/cosf/sqrtf,
// so on the card kernel and plain version agree bitwise (chip_smoke.py).
//
// Design: one persistent cooperative launch per window. Step t reads EVERY
// neuron's step t-1 spike flag through the in-edge table, so steps need a
// grid-wide ordering; the TPU ran them as a sequential grid with the state
// resident in VMEM. Here the grid is sized so that every block is resident
// (SM count x cudaOccupancyMaxActiveBlocksPerMultiprocessor, launched with
// cudaLaunchCooperativeKernel, which refuses a grid that is not), and a
// grid.sync() separates the steps (about 1.05 us on an NVIDIA H100 80GB
// HBM3 at 700 W; no -rdc needed). Each block owns a contiguous range of
// neurons, a multiple of 32, so each 32-bit word of the spike bitmap has
// one writer. In a step a lane
// takes one neuron of the range:
//   (a) the synaptic sum over the row, slot by slot: the slot's code comes
//       from shared memory in slot-major order (lanes on neighbouring
//       neurons read neighbouring words, conflict-free), a local edge tests
//       one bit of the previous step's bitmap, a remote edge draws its
//       Threefry word, and only a hit reads the weight (about 1 % of local
//       slots at the model's rates);
//   (b) noise, stimulus, lesion, Izhikevich, calcium and elements on state
//       held in shared memory, the fired flags packed by a ballot into the
//       next bitmap word, and the fired count added to a block counter; one
//       atomicAdd per block and step into fired_counts[t] keeps the count an
//       exact integer.
// A warp per neuron with a lane per slot was built first and was slower:
// five dependent shuffles a neuron left the warps waiting, and a
// transpose-reduction of 32 neurons at once spilled its 32 partial sums to
// local memory. With a lane per neuron a step takes about 6.1 us at n =
// 65,536, S = 32, full rows: 3.5 us the slot loop (bound by the bank
// conflicts of the random bitmap lookups), 1.04 us the barrier, 0.7 us the
// bitmap copy, 0.4 us the noise (tools/k1_breakdown.py on an NVIDIA H100
// 80GB HBM3 at 700 W).
// The bitmaps are DOUBLE-BUFFERED in global memory (step t reads buffer t&1
// and writes the other): with one barrier a step, a block writing the flags
// in place could overwrite a word another block has not read yet. After the
// barrier each block copies the whole bitmap (n / 8 bytes, 8 KB at n =
// 65,536) into shared memory with L1-bypassing loads.
//
// Staging. At the start of the window a block decodes its rows into shared
// memory once: per slot a 32-bit code (empty; a local source id; or, for a
// remote edge, the threshold ceil(rate * 2^24) clamped to [0, 2^24]: a
// uniform u = (word >> 8) * 2^-24 is exact, so u < rate iff (word >> 8) <
// threshold) and the source's weight. The remote rate comes from the dense
// (R, n) table at the source's (rank, local id), or, under the sparse
// exchange (rate_slots given), from the compact (subs_cap,) buffer at the
// slot's entry of the (n, S) slot remap, where slot -1 (a local, empty or
// overflowed subscription) reads rate 0, as the reference's
// jnp.where(rate_slots >= 0, ...) does: one operand and one test in the
// decode, which runs once a window; and v, u, ca, ax, de, spike_count, the
// background and Izhikevich operands and a bit mask of the first 32 lesion
// windows of its neurons, and the length of its row up to the last used slot
// (the slot loop stops there). They stay there for the window and the state
// is written back once at the end. That costs 8 S + 64 bytes a neuron plus
// the bitmap: 170,000 bytes a block at n = 65,536, S = 32 on 132 SMs. When
// a block's range does not fit the opt-in shared memory (227 KB), the
// STREAMING mode takes the window instead: rows decoded from global memory
// (L2) every step, the state updated in place in the outputs, the bitmap
// read from global memory with L1-bypassing loads. The C entry picks the
// mode from the shape (the card tests run streaming at n = 150,000 and
// up). Stimulus masks are read from global memory every step (their
// amplitudes multiply a 0 when inactive, and
// the plain version adds that term too).
//
// Sum order. The plain version sums the row with torch.sum; here the hits
// are added in slot order. The weights in use are integers (+-15 by default
// in configs/msp_brain.py, +-30 in scenarios/library.py), and partial sums
// of at most 32 such terms are exact in f32, so the order does not matter and
// the two agree bitwise. With non-integer weights they can differ in the
// last bits (the card tests hold that case within 1e-5 relative, flips only
// at near-ties).
//
// Bound on the H100: at R = 1 the window moves ~14 MB once (the rows, the
// state in and out). Its integer work a step is the noise draw's Threefry (67
// instructions a neuron as nvcc compiles hash.cuh, tools/k0_sass.py) and 6
// operations a local slot (code load, local test, word index, word load, bit
// shift, bit test): 1.70e9 a window at n = 65,536, S = 32, full rows, 0.102
// ms at the INT32 rate (64 a SM a clock, 16.7e12/s); its floor in practice
// is the 100 grid barriers. At R = 4, rank 1, each of the 1.57M remote slots
// draws a Threefry a step instead of the bit test, and the bound is integer
// operations too. chip_smoke.py computes the counts from the run's rows
// (HASH_OPS, SLOT_OPS).
//
// Breakdown build. Built with -DREPRO_K1_BREAKDOWN (tools/k1_breakdown.py,
// never the library), the entry repro_k1_parts_off(mask) switches parts of
// a step off for timing: bit 1 the synaptic sums, bit 2 the noise draw, bit
// 4 the bitmap copy.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"
#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

#ifdef REPRO_K1_BREAKDOWN
__device__ int d_parts_off;
#define K1_PART_OFF(bit) ((d_parts_off & (bit)) != 0)
#else
#define K1_PART_OFF(bit) false
#endif

constexpr int kThreads = 512;                 // a block: 16 warps
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmpty = 0xffffffffu;      // slot code of an empty slot
constexpr uint32_t kRemote = 0x80000000u;     // | threshold of a remote slot
constexpr float kTwo24 = 16777216.0f;
constexpr int kStateArrays = 14;              // v u ca ax de count + 8 operands
constexpr int kNeuronWords = kStateArrays + 2;  // + lesion mask + row length

// C entry return code that is not a CUDA error
constexpr int kNoCooperativeLaunch = -2;

__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

struct WindowArgs {
  const float* v;
  const float* u;
  const float* ca;
  const float* ax;
  const float* de;
  const float* spike_count;
  const unsigned char* spiked;
  float* out_v;
  float* out_u;
  float* out_ca;
  float* out_ax;
  float* out_de;
  float* out_spike_count;
  unsigned char* out_spiked;
  uint32_t* bits;          // 2 x words: the double-buffered spike bitmap
  int* fired_counts;       // (num_steps,), zeroed here
  const int* in_edges;
  const float* w_table;
  const float* rates;      // (R, n), or (subs_cap,) with rate_slots
  const int* rate_slots;   // (n, S) slot remap of the sparse exchange, or null
  int subs_cap;
  const float* bg_mean;
  const float* bg_std;
  const float* izh_a;
  const float* izh_b;
  const float* izh_c;
  const float* izh_d;
  const float* izh_nu;
  const float* izh_eps;
  const float* stim_mask;
  const float* stim_amp;
  const int* stim_t;
  int num_stim;
  const unsigned char* lesion_mask;
  const int* lesion_t;
  int num_lesions;
  int n;
  int s_max;
  int num_ranks;
  int rank;
  uint32_t seed;
  int gstep0;
  int num_steps;
  int rows;                // neurons a block owns, a multiple of 32
  float ca_decay;
  float ca_beta;
};

// Slot `k` (flat index into the (n, S) table) of an in-edge row, holding
// source gid `e`, as (code, weight): see the file's note.
__device__ __forceinline__ void decode_edge(const WindowArgs& a, int e,
                                            size_t k, uint32_t* code,
                                            float* wt) {
  if (e < 0) {
    *code = kEmpty;
    *wt = 0.0f;
    return;
  }
  const int src_rank = e / a.n;
  const int lid = e - src_rank * a.n;
  *wt = a.w_table[lid];
  if (src_rank == a.rank) {
    *code = (uint32_t)lid;
    return;
  }
  float rate;
  if (a.rate_slots != nullptr) {
    const int slot = a.rate_slots[k];
    rate = slot < 0 ? 0.0f
                    : a.rates[slot < a.subs_cap ? slot : a.subs_cap - 1];
  } else {
    const int r = src_rank < a.num_ranks ? src_rank : a.num_ranks - 1;
    rate = a.rates[(size_t)r * a.n + lid];
  }
  const float x = ceilf(rate * kTwo24);
  const uint32_t thr = !(x > 0.0f) ? 0u
                       : (x >= kTwo24 ? (uint32_t)kTwo24 : (uint32_t)x);
  *code = kRemote | thr;
}

// Whether a slot of code `code` delivers a spike at `gstep`.
template <bool kStaged>
__device__ __forceinline__ bool slot_hit(const WindowArgs& a, uint32_t code,
                                         const uint32_t* prev, int gstep,
                                         uint32_t edge_id) {
  if (code == kEmpty) return false;
  bool hit;
  if (code & kRemote) {
    uint32_t x0, x1;
    repro::threefry2x32(a.seed, repro::SPIKE_DOMAIN, (uint32_t)gstep, edge_id,
                        &x0, &x1);
    hit = (x0 >> 8) < (code & ~kRemote);
  } else {
    const uint32_t word =
        kStaged ? prev[code >> 5] : __ldcg(prev + (code >> 5));
    hit = (word >> (code & 31u)) & 1u;
  }
  return hit;
}

__device__ __forceinline__ bool window_open(const int* t, int w, int gstep) {
  return gstep >= t[2 * w] && gstep < t[2 * w + 1];
}

// Dynamic shared memory of a block: the block's fired count, then (staged)
// the bitmap, the row codes and weights, the state and operands and the
// lesion masks.
__host__ __device__ inline size_t smem_bytes(bool staged, int rows, int s_max,
                                             int words) {
  size_t b = 16;
  if (staged) {
    b += (size_t)words * 4 + (size_t)rows * s_max * 8 +
         (size_t)rows * kNeuronWords * 4;
  }
  return b;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
    activity_window_kernel(WindowArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n;
  const int s_max = a.s_max;
  const int words = (n + 31) >> 5;
  const int lo = (int)min((long long)blockIdx.x * a.rows, (long long)n);
  const int cnt = min(a.rows, n - lo);      // neurons this block owns

  int* fired_s = (int*)smem;                         // 1 (+3 pad)
  uint32_t* code_s = (uint32_t*)(fired_s + 4);      // S x rows (staged)
  float* wt_s = (float*)(code_s + (size_t)a.rows * s_max);          // S x rows
  uint32_t* bits_s = (uint32_t*)(wt_s + (size_t)a.rows * s_max);   // words
  float* st_s = (float*)(bits_s + words);            // 14 x rows
  uint32_t* les_s = (uint32_t*)(st_s + (size_t)kStateArrays * a.rows);
  int* len_s = (int*)(les_s + a.rows);               // 1 + last used slot

  // the neuron state and operands: shared arrays indexed by the block's
  // neuron j (staged), or the outputs and operands at lo + j (streaming)
  float *V, *U, *CA, *AX, *DE, *SC;
  const float *BGM, *BGS, *IA, *IB, *IC, *ID, *INU, *IEPS;
  if (kStaged) {
    float* p[kStateArrays];
    for (int k = 0; k < kStateArrays; ++k) p[k] = st_s + (size_t)k * a.rows;
    V = p[0]; U = p[1]; CA = p[2]; AX = p[3]; DE = p[4]; SC = p[5];
    BGM = p[6]; BGS = p[7]; IA = p[8]; IB = p[9]; IC = p[10]; ID = p[11];
    INU = p[12]; IEPS = p[13];
  } else {
    V = a.out_v + lo; U = a.out_u + lo; CA = a.out_ca + lo;
    AX = a.out_ax + lo; DE = a.out_de + lo; SC = a.out_spike_count + lo;
    BGM = a.bg_mean + lo; BGS = a.bg_std + lo; IA = a.izh_a + lo;
    IB = a.izh_b + lo; IC = a.izh_c + lo; ID = a.izh_d + lo;
    INU = a.izh_nu + lo; IEPS = a.izh_eps + lo;
  }

  // ---- prologue: stage (or copy) the block's neurons, pack the flags -----
  if (tid == 0) *fired_s = 0;
  const int staged_windows = a.num_lesions < 32 ? a.num_lesions : 32;
  for (int j = tid; j < cnt; j += kThreads) {
    const int i = lo + j;
    if (kStaged) {
      const float* src[kStateArrays] = {
          a.v, a.u, a.ca, a.ax, a.de, a.spike_count, a.bg_mean, a.bg_std,
          a.izh_a, a.izh_b, a.izh_c, a.izh_d, a.izh_nu, a.izh_eps};
#pragma unroll
      for (int k = 0; k < kStateArrays; ++k) {
        st_s[(size_t)k * a.rows + j] = src[k][i];
      }
      uint32_t lw = 0;
      for (int w = 0; w < staged_windows; ++w) {
        lw |= (a.lesion_mask[(size_t)w * n + i] ? 1u : 0u) << w;
      }
      les_s[j] = lw;
    } else {
      a.out_v[i] = a.v[i];
      a.out_u[i] = a.u[i];
      a.out_ca[i] = a.ca[i];
      a.out_ax[i] = a.ax[i];
      a.out_de[i] = a.de[i];
      a.out_spike_count[i] = a.spike_count[i];
    }
    if (a.num_steps == 0) a.out_spiked[i] = a.spiked[i];
  }
  if (kStaged) {
    // slot-major: lanes on neighbouring neurons read neighbouring words
    const int slots = cnt * s_max;
    const int* rows = a.in_edges + (size_t)lo * s_max;
    for (int k = tid; k < slots; k += kThreads) {
      uint32_t code;
      float wt;
      decode_edge(a, rows[k], (size_t)lo * s_max + k, &code, &wt);
      const int j = k / s_max;
      code_s[(size_t)(k - j * s_max) * a.rows + j] = code;
      wt_s[(size_t)(k - j * s_max) * a.rows + j] = wt;
    }
    __syncthreads();
    // the sums stop after a row's last used slot (the model's rows are
    // compacted and mostly short)
    for (int j = tid; j < cnt; j += kThreads) {
      int len = s_max;
      while (len > 0 && code_s[(size_t)(len - 1) * a.rows + j] == kEmpty) {
        --len;
      }
      len_s[j] = len;
    }
  }
  for (int j0 = 0; j0 < cnt; j0 += kThreads) {
    const int j = j0 + tid;
    const unsigned b = __ballot_sync(kFull, j < cnt && a.spiked[lo + j] != 0);
    if (lane == 0 && j0 + warp * 32 < cnt) a.bits[((lo + j0) >> 5) + warp] = b;
  }
  if (blockIdx.x == 0) {
    for (int t = tid; t < a.num_steps; t += kThreads) a.fired_counts[t] = 0;
  }
  grid.sync();

  // ---- the steps -----------------------------------------------------------
  for (int t = 0; t < a.num_steps; ++t) {
    const int gstep = (int)((unsigned)a.gstep0 + (unsigned)t);  // int32 wrap
    const uint32_t* prev = a.bits + (size_t)(t & 1) * words;
    uint32_t* next = a.bits + (size_t)((t + 1) & 1) * words;
    if (kStaged) {
      if (!K1_PART_OFF(4)) {
        for (int w = tid; w < words; w += kThreads) {
          bits_s[w] = __ldcg(prev + w);
        }
      }
      __syncthreads();
    }
    const uint32_t* flags = kStaged ? bits_s : prev;
    uint32_t open_lo = 0;            // open lesion windows among the first 32
    bool open_hi = false;            // any open window past the 32nd
    for (int w = 0; w < a.num_lesions; ++w) {
      if (window_open(a.lesion_t, w, gstep)) {
        if (w < 32) open_lo |= 1u << w;
        else open_hi = true;
      }
    }
    for (int j0 = 0; j0 < cnt; j0 += kThreads) {
      // a lane per neuron: lane l of warp w takes neuron j0 + 32 w + l
      int fired = 0;
      const int j = j0 + tid;
      if (j < cnt) {
        const int i = lo + j;
        const uint32_t dst_gid = (uint32_t)a.rank * (uint32_t)n + (uint32_t)i;
        // (a) the synaptic sum, slot by slot
        float syn_in = 0.0f;
        const int len = K1_PART_OFF(1) ? 0 : (kStaged ? len_s[j] : s_max);
        for (int s = 0; s < len; ++s) {
          uint32_t code;
          float wt;
          if (kStaged) {
            code = code_s[(size_t)s * a.rows + j];
          } else {
            const size_t k = (size_t)i * s_max + s;
            decode_edge(a, a.in_edges[k], k, &code, &wt);
          }
          if (slot_hit<kStaged>(a, code, flags, gstep,
                                dst_gid * (uint32_t)s_max + (uint32_t)s)) {
            if (kStaged) wt = wt_s[(size_t)s * a.rows + j];
            syn_in += wt;
          }
        }
        // (b) noise, stimulus, lesion, the neuron
        const float z = K1_PART_OFF(2)
                            ? 0.0f
                            : repro::hash_normal(a.seed, repro::NOISE_DOMAIN,
                                                 (uint32_t)gstep, dst_gid);
        float noise = BGM[j] + BGS[j] * z;
        for (int e = 0; e < a.num_stim; ++e) {
          const float active = window_open(a.stim_t, e, gstep) ? 1.0f : 0.0f;
          noise = noise + a.stim_amp[e] * active *
                              a.stim_mask[(size_t)e * n + i];
        }
        bool alive = true;
        if (open_lo != 0u || open_hi) {
          uint32_t lw = 0;
          if (kStaged) {
            lw = les_s[j];
          } else {
            for (int w = 0; w < staged_windows; ++w) {
              if ((open_lo >> w) & 1u) {
                lw |= (a.lesion_mask[(size_t)w * n + i] ? 1u : 0u) << w;
              }
            }
          }
          alive = (lw & open_lo) == 0u;
          for (int w = 32; open_hi && w < a.num_lesions; ++w) {
            if (window_open(a.lesion_t, w, gstep) &&
                a.lesion_mask[(size_t)w * n + i]) {
              alive = false;
            }
          }
        }
        float v = V[j];
        float u = U[j];
        const float u_prev = u;
        const float i_t = syn_in + noise;
        for (int h = 0; h < 2; ++h) {
          v = v + 0.5f * (0.04f * v * v + 5.0f * v + 140.0f - u + i_t);
        }
        u = u + IA[j] * (IB[j] * v - u);
        fired = v >= 30.0f;
        if (fired) {
          v = IC[j];
          u = u + ID[j];
        }
        if (!alive) {
          fired = 0;
          v = IC[j];
          u = u_prev;
        }
        float ca = CA[j];
        ca = ca + (-ca * a.ca_decay + a.ca_beta * (fired ? 1.0f : 0.0f));
        const float drive = INU[j] * (1.0f - ca / IEPS[j]);
        V[j] = v;
        U[j] = u;
        CA[j] = ca;
        AX[j] = alive ? max0(AX[j] + drive) : 0.0f;
        DE[j] = alive ? max0(DE[j] + drive) : 0.0f;
        SC[j] = SC[j] + (fired ? 1.0f : 0.0f);
        if (t == a.num_steps - 1) a.out_spiked[i] = (unsigned char)fired;
      }
      const unsigned b = __ballot_sync(kFull, fired);
      if (lane == 0 && j0 + warp * 32 < cnt) {
        next[((lo + j0) >> 5) + warp] = b;
        if (b) atomicAdd(fired_s, __popc(b));
      }
    }
    __syncthreads();                 // every warp's count is in fired_s
    if (tid == 0) {
      const int c = *fired_s;
      if (c > 0) atomicAdd(a.fired_counts + t, c);
      *fired_s = 0;
    }
    if (t + 1 < a.num_steps) grid.sync();
  }

  // ---- epilogue: the staged state back to the outputs ----------------------
  if (kStaged) {
    __syncthreads();
    for (int j = tid; j < cnt; j += kThreads) {
      const int i = lo + j;
      a.out_v[i] = V[j];
      a.out_u[i] = U[j];
      a.out_ca[i] = CA[j];
      a.out_ax[i] = AX[j];
      a.out_de[i] = DE[j];
      a.out_spike_count[i] = SC[j];
    }
  }
}

// Kernel launches by mode (0 staged, 1 streaming), counted beside each
// launch.
int g_launches[2] = {0, 0};

int round32(long long x) { return (int)((x + 31) / 32 * 32); }

}  // namespace

#ifdef REPRO_K1_BREAKDOWN
// Parts of a step switched off (the breakdown build only; see the note).
extern "C" int repro_k1_parts_off(int mask) {
  return (int)cudaMemcpyToSymbol(d_parts_off, &mask, sizeof(int));
}
#endif

// Device launches of mode `mode` (0 staged, 1 streaming) since the last
// reset; reset != 0 sets that count to 0 after reading it.
extern "C" int repro_activity_window_device_launches(int mode, int reset) {
  if (mode < 0 || mode > 1) return -1;
  const int k = g_launches[mode];
  if (reset) g_launches[mode] = 0;
  return k;
}

// One cooperative launch for the whole window. rates: the dense (num_ranks,
// n) table with rate_slots null, or the sparse exchange's (subs_cap,)
// buffer with its (n, s_max) int32 rate_slots. Inputs are left unchanged;
// the outputs (out_*, (n,) each) are written in full. bits: 2 * ceil(n / 32)
// uint32 of scratch, any contents; fired_counts (num_steps,) int32, any
// contents (zeroed by the kernel). The staged mode takes the window when a
// block's rows fit shared memory, the streaming mode otherwise.
// Returns 0, a cudaError_t or -2 (no cooperative launch on this device).
extern "C" int repro_activity_window(
    const void* v, const void* u, const void* ca, const void* ax,
    const void* de, const void* spike_count, const void* spiked, void* out_v,
    void* out_u, void* out_ca, void* out_ax, void* out_de,
    void* out_spike_count, void* out_spiked, void* bits,
    const void* in_edges, const void* w_table, const void* rates,
    const void* rate_slots, int subs_cap, const void* bg_mean,
    const void* bg_std, const void* izh_a, const void* izh_b,
    const void* izh_c, const void* izh_d,
    const void* izh_nu, const void* izh_eps, const void* stim_mask,
    const void* stim_amp, const void* stim_t, int num_stim,
    const void* lesion_mask, const void* lesion_t, int num_lesions,
    void* fired_counts, int n, int s_max, int num_ranks, int rank,
    unsigned int seed, int gstep0, int num_steps, float ca_decay,
    float ca_beta, void* stream) {
  if (n <= 0 || s_max <= 0) return (int)cudaErrorInvalidValue;
  int dev;
  repro::DeviceFacts dv;
  cudaError_t err;
  if ((err = repro::current_device(&dev, &dv)) != cudaSuccess) return (int)err;
  if (!dv.cooperative) return kNoCooperativeLaunch;
  const int words = (n + 31) / 32;
  // one block an SM first: the most rows a block can be given
  int rows = round32(((long long)n + dv.sms - 1) / dv.sms);
  const bool staged =
      smem_bytes(true, rows, s_max, words) <= (size_t)dv.smem_optin;
  const void* fn = staged ? (const void*)activity_window_kernel<true>
                          : (const void*)activity_window_kernel<false>;
  size_t smem = smem_bytes(staged, rows, s_max, words);
  int occ = 0;
  if ((err = repro::resident_blocks(fn, dev, kThreads, smem, dv.smem_optin,
                                    &occ)) != cudaSuccess) {
    return (int)err;
  }
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // every resident block gets rows; fewer blocks when n is small
  rows = round32(((long long)n + (long long)dv.sms * occ - 1) /
                 ((long long)dv.sms * occ));
  const int grid = (int)(((long long)n + rows - 1) / rows);
  smem = smem_bytes(staged, rows, s_max, words);

  WindowArgs a;
  a.v = (const float*)v;
  a.u = (const float*)u;
  a.ca = (const float*)ca;
  a.ax = (const float*)ax;
  a.de = (const float*)de;
  a.spike_count = (const float*)spike_count;
  a.spiked = (const unsigned char*)spiked;
  a.out_v = (float*)out_v;
  a.out_u = (float*)out_u;
  a.out_ca = (float*)out_ca;
  a.out_ax = (float*)out_ax;
  a.out_de = (float*)out_de;
  a.out_spike_count = (float*)out_spike_count;
  a.out_spiked = (unsigned char*)out_spiked;
  a.bits = (uint32_t*)bits;
  a.fired_counts = (int*)fired_counts;
  a.in_edges = (const int*)in_edges;
  a.w_table = (const float*)w_table;
  a.rates = (const float*)rates;
  a.rate_slots = (const int*)rate_slots;
  a.subs_cap = subs_cap;
  a.bg_mean = (const float*)bg_mean;
  a.bg_std = (const float*)bg_std;
  a.izh_a = (const float*)izh_a;
  a.izh_b = (const float*)izh_b;
  a.izh_c = (const float*)izh_c;
  a.izh_d = (const float*)izh_d;
  a.izh_nu = (const float*)izh_nu;
  a.izh_eps = (const float*)izh_eps;
  a.stim_mask = (const float*)stim_mask;
  a.stim_amp = (const float*)stim_amp;
  a.stim_t = (const int*)stim_t;
  a.num_stim = num_stim;
  a.lesion_mask = (const unsigned char*)lesion_mask;
  a.lesion_t = (const int*)lesion_t;
  a.num_lesions = num_lesions;
  a.n = n;
  a.s_max = s_max;
  a.num_ranks = num_ranks;
  a.rank = rank;
  a.seed = seed;
  a.gstep0 = gstep0;
  a.num_steps = num_steps;
  a.rows = rows;
  a.ca_decay = ca_decay;
  a.ca_beta = ca_beta;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  ++g_launches[staged ? 0 : 1];
  return (int)cudaGetLastError();
}
