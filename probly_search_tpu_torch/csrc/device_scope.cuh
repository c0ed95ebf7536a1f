// The calling thread's current CUDA device, kept across one entry point.
//
// This library links its own CUDA runtime, and a runtime's current device is
// the driver's current context of the calling thread, which every runtime in
// the process shares with PyTorch's.  An entry that set the device and left
// it would change torch.cuda.current_device() for the caller: every
// device-less call after it (a synchronize, a new stream, a graph's default
// capture stream) would then go to the kernel's card.  So each entry that
// names a device selects it for its own duration only, and only where it is
// not already current (the common case, and always inside a capture, which
// runs on the capture stream's device).

#pragma once

#include <cuda_runtime.h>

namespace probly {

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      set_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (set_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  // cudaSuccess, or the error that kept the device from being selected.
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool set_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace probly
