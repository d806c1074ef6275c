// Shared pieces of the fused LSTM kernels (lstm_fwd.cu, lstm_bwd.cu).
//
// Layouts are the JAX package's fused-scan layouts: time-major
// x_proj (T, B, 4H) with both biases folded in, h/c (T, B, H), the
// recurrent weight pre-transposed as w_hh_t (H, 4H), gate order i, f, g, o.
// Every tensor is contiguous and of one dtype (float32 or bfloat16); the
// recurrence itself always runs in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pdrnn {

// dtype codes passed from Python (ops/fused_rnn.py:_DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Each thread owns one hidden unit j of kRowsPerThread batch rows, so a
// block of block_b rows runs hidden * block_b / kRowsPerThread threads.
// Mirrored by ops/fused_rnn.py:_ROWS_PER_THREAD.
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// w_hh_t staged in shared memory as float32 with a row stride of 4H + 1:
// the forward reads a row across consecutive units j (stride 1) and the
// backward's d_gates @ W_hh reads a column across units m (stride 4H + 1,
// odd), so neither access pattern has bank conflicts.
__host__ __device__ inline int w_stride(int hidden) { return 4 * hidden + 1; }

template <typename T>
__device__ void stage_weights(const T* __restrict__ w_hh_t, float* w,
                              int hidden) {
  const int gate_dim = 4 * hidden;
  const int stride = w_stride(hidden);
  for (int i = threadIdx.x; i < hidden * gate_dim; i += blockDim.x) {
    const int m = i / gate_dim;
    w[m * stride + (i - m * gate_dim)] = to_f32(w_hh_t[i]);
  }
}

// One (block_b, H) tile of a (B, H) array into float32 shared memory;
// rows past the batch (the ragged last tile) read as zero.
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, float* dst, int row0,
                           int batch, int hidden, int block_b) {
  for (int i = threadIdx.x; i < block_b * hidden; i += blockDim.x) {
    const int b = row0 + i / hidden;
    dst[i] = b < batch ? to_f32(src[(size_t)b * hidden + i % hidden]) : 0.0f;
  }
}

}  // namespace pdrnn
