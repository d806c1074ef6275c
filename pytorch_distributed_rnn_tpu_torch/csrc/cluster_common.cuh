// The thread-block cluster shared by the GRU and LSTM cluster kernels
// (gru_fwd.cu, gru_bwd.cu, lstm_fwd.cu, lstm_bwd.cu).
//
// Above the width where one block's shared memory holds W_hh^T, each of
// those kernels splits W_hh^T by hidden units over a cluster of
// kClusterCtas CTAs: CTA c owns the units [c U, (c + 1) U), U = ceil(H /
// 16), and keeps the columns of W_hh^T of its own units' gates (3U for the
// GRU, 4U for the LSTM), so that every dot product over H a CTA needs runs
// over its own columns; what crosses the cluster, through distributed
// shared memory, is h_t (the forwards) or partial contractions (the
// backwards).
#pragma once

#include <cuda_runtime.h>

namespace pdrnn {

// Mirrored by ops/fused_rnn.py:GRU_CLUSTER_CTAS.
constexpr int kClusterCtas = 16;     // a non-portable cluster size (> 8)
constexpr int kClusterThreads = 512;
constexpr int kClusterMaxHidden = 512;
// the dynamic shared memory one Hopper CTA may use; mirrored by
// ops/fused_rnn.py:_MAX_SMEM_BYTES
constexpr size_t kMaxSmemBytes = 232448;

// float4 helpers of the backwards' partial sums (a float4 holds R = 4
// batch rows)
// a += v * w, per component
__device__ __forceinline__ void fma4(float4& a, const float4& v, float w) {
  a.x = fmaf(v.x, w, a.x);
  a.y = fmaf(v.y, w, a.y);
  a.z = fmaf(v.z, w, a.z);
  a.w = fmaf(v.w, w, a.w);
}

__device__ __forceinline__ float4 shfl_xor4(const float4& v, int mask) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask),
                     __shfl_xor_sync(0xffffffffu, v.z, mask),
                     __shfl_xor_sync(0xffffffffu, v.w, mask));
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The two halves of cluster.sync(), so that work can run between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The launch configuration of a cluster kernel of kClusterCtas CTAs a
// cluster, threads threads and smem bytes a CTA, over tiles clusters: its
// attributes set, and the clusters that can be resident at once in
// *active; returns the CUDA error code, cudaErrorLaunchOutOfResources when
// not even one cluster fits.
template <typename Kernel>
int cluster_launch_config(Kernel kernel, size_t smem, int tiles, cudaStream_t stream,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int* active,
                          int threads = kClusterThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(tiles * kClusterCtas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  return *active < 1 ? (int)cudaErrorLaunchOutOfResources : 0;
}

}  // namespace pdrnn
