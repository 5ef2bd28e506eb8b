// Facts a cooperative launch needs about the current device, read from the
// CUDA runtime once per device (and once per kernel and shared-memory
// size), so that a C entry called every chunk does not query them again.
//
// Used by K1 (activity_window.cu), K2 (bh_traverse.cu) and K4
// (synapse_apply.cu), which size their grids to the resident blocks. The
// tables are guarded by a mutex: ctypes releases the GIL around a C entry,
// so two Python threads may call in at once.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace repro {

constexpr int kMaxDevices = 64;

struct DeviceFacts {
  int sms = 0;          // streaming multiprocessors
  int cooperative = 0;  // takes cudaLaunchCooperativeKernel
  int smem_optin = 0;   // bytes of dynamic shared memory a block may opt in to
  int smem_sm = 0;      // bytes of shared memory of one SM
  int smem_reserved = 0;  // bytes of an SM's shared memory held per block
};

// The current device's index and facts.
inline cudaError_t current_device(int* dev, DeviceFacts* facts) {
  static std::mutex mu;
  static DeviceFacts known[kMaxDevices];
  static bool have[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!have[*dev]) {
    DeviceFacts f;
    if ((err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount,
                                      *dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&f.cooperative,
                                      cudaDevAttrCooperativeLaunch, *dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &f.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &f.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, *dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&f.smem_reserved,
                                      cudaDevAttrReservedSharedMemoryPerBlock,
                                      *dev)) != cudaSuccess) {
      return err;
    }
    known[*dev] = f;
    have[*dev] = true;
  }
  *facts = known[*dev];
  return cudaSuccess;
}

// Blocks of `fn` resident on one SM of device `dev` at `threads` threads and
// `smem` bytes of dynamic shared memory (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), remembered per (kernel, device, threads, smem). At the
// first query of a kernel on a device its dynamic shared-memory limit is
// raised to the device's opt-in maximum `smem_optin` less the kernel's
// static shared memory, so any size up to that may be launched.
inline cudaError_t resident_blocks(const void* fn, int dev, int threads,
                                   size_t smem, int smem_optin, int* occ) {
  struct Entry {
    const void* fn;
    int dev;
    int threads;
    size_t smem;
    int occ;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry entries[kEntries];
  static int used = 0, next = 0;
  static const void* raised_fn[kEntries];
  static int raised_dev[kEntries];
  static int raised_used = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < used; ++k) {
    const Entry& e = entries[k];
    if (e.fn == fn && e.dev == dev && e.threads == threads && e.smem == smem) {
      *occ = e.occ;
      return cudaSuccess;
    }
  }
  bool raised = false;
  for (int k = 0; k < raised_used && !raised; ++k) {
    raised = raised_fn[k] == fn && raised_dev[k] == dev;
  }
  cudaError_t err;
  if (!raised) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem_optin - (int)attr.sharedSizeBytes)) != cudaSuccess) {
      return err;
    }
    if (raised_used < kEntries) {  // past that, raised again: harmless
      raised_fn[raised_used] = fn;
      raised_dev[raised_used] = dev;
      ++raised_used;
    }
  }
  int o = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, fn, threads,
                                                           smem)) !=
      cudaSuccess) {
    return err;
  }
  entries[next] = Entry{fn, dev, threads, smem, o};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  *occ = o;
  return cudaSuccess;
}

}  // namespace repro
