// Host-side launch helpers shared by the launchers: the dynamic shared
// memory opt-in past 48 KB (level_lm.cu, level_sg.cu, match.cu, extract.cu,
// canny.cu, edt.cu) and the launch of a grid of thread-block clusters
// (extract.cu, canny.cu).
#pragma once

#include <cuda_runtime.h>

namespace rgbd {

constexpr int kMaxDevices = 64;
// the portable cluster size: 8 blocks of up to 227 KB each
constexpr int kMaxCluster = 8;

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

// What one kernel's cluster launches have settled, per device and cluster
// size (1, 2, 4, 8): the shared memory it is opted in to, and one more than
// the largest shared memory at which the card was found to hold a cluster.
struct ClusterLaunch {
  SharedOptIn opted;
  long long fits[kMaxDevices][4] = {};
};

// Launch `kernel(args...)` on `grid` (x a multiple of `cluster`) with
// `smem` bytes of dynamic shared memory, the blocks grouped along x in
// clusters of `cluster` in {1, 2, 4, 8} blocks (1: a plain launch). Past
// 48 KB the kernel is opted in first. Before the first launch of a
// (device, cluster, size) larger than any that fitted,
// cudaOccupancyMaxActiveClusters must find room for one cluster on the
// card: if it does not, the launch is not made and
// cudaErrorInvalidConfiguration is returned for the caller to raise.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int device, dim3 grid, dim3 block,
                                  long long smem, int cluster, cudaStream_t stream,
                                  ClusterLaunch* state, Args... args) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int slot = cluster == 1 ? 0 : cluster == 2 ? 1 : cluster == 4 ? 2 : cluster == 8 ? 3 : -1;
  if (slot < 0 || grid.x % cluster != 0) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_shared(kernel, device, smem, &state->opted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one block: a plain launch
  if (cluster > 1 && smem >= state->fits[device][slot]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    state->fits[device][slot] = smem + 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace rgbd
