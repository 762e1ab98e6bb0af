// Host-side launch helpers shared by the kernel libraries (plain C
// interface for ctypes).
#pragma once

#include <cuda_runtime.h>

// Each entry launches on `stream` (PyTorch's current stream, a raw
// cudaStream_t) on device `device`, never synchronises, and returns
// cudaGetLastError() after the launch (0 = launched).  The calling
// thread's current device is restored before returning, so a launch on
// another card does not move PyTorch's notion of the current device.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}
