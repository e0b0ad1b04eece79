// Host-side launch helper shared by the launchers that need more than 48 KB
// of dynamic shared memory (level_lm.cu, level_sg.cu, match.cu, extract.cu,
// edt.cu's column phase above 480 rows).
#pragma once

#include <cuda_runtime.h>

namespace rgbd {

constexpr int kMaxDevices = 64;

// The dynamic shared memory one kernel has been opted in to, per device.
struct SharedOptIn {
  long long bytes[kMaxDevices] = {};
};

// Make `bytes` of dynamic shared memory available to `kernel` on `device`
// (the current device). cudaFuncSetAttribute is called only when a launch
// needs more than any earlier one on this device did: the attribute stays
// set, so a launcher pays for it once per size and not once per launch.
template <typename Kernel>
inline cudaError_t opt_in_shared(Kernel kernel, int device, long long bytes, SharedOptIn* seen) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= seen->bytes[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) seen->bytes[device] = bytes;
  return err;
}

}  // namespace rgbd
