// What a launch path would otherwise ask the CUDA runtime on every call,
// asked once per device: the SM count, and the dynamic shared memory a
// kernel instance has been allowed (cudaFuncSetAttribute). Both are
// properties of the device and the kernel, not of the call, and the
// runtime calls cost the host microseconds a launch.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace rad_launch {

constexpr int kMaxDevices = 64;  // devices beyond this are asked every time

// The current device's SM count.
inline cudaError_t device_sms(int* sms) {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    *sms = cached[dev].load(std::memory_order_relaxed);
    if (*sms > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices)
    cached[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory on the current
// device. `granted` belongs to one kernel instance (a zero-initialised
// static) and holds the largest size already allowed on each device, so
// the runtime is asked again only for a larger size.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                               std::atomic<int> (&granted)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices &&
      granted[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) {
    int seen = granted[dev].load(std::memory_order_relaxed);
    while (seen < bytes && !granted[dev].compare_exchange_weak(seen, bytes)) {
    }
  }
  return err;
}

}  // namespace rad_launch
