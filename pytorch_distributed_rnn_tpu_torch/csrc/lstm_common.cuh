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

#include "cluster_common.cuh"  // the cluster variants' kClusterCtas, barrier, launch

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

// Four and eight consecutive values of a W_hh^T slice held in its own dtype,
// as float32 (exact: a bf16 value is the high half of its float32).  The
// pointer is 8-byte (quad) or 16-byte (octet) aligned.
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ void load_octet(const float* p, float (&w)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load_octet(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(words[i] << 16);
    w[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
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

// One halving exchange of reduce_scatter: lanes with BIT set keep values
// HALF .. 2 HALF - 1, the others 0 .. HALF - 1, each adding its partner's.
template <int N, int HALF, int BIT>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool upper = lane & BIT;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = upper ? v[i + HALF] : v[i];
    const float give = upper ? v[i] : v[i + HALF];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, give, BIT);
  }
}

// Sums the N values a lane holds over the L lanes of its group (lane
// bits below L, a power of two), by halving exchanges: afterwards the
// lane's v[0 .. N/L) hold the sums of values lane * N/L .. (lane + 1) *
// N/L - 1.  Every index is a constant, so v stays in registers.
template <int N, int L, int HALF = N / 2>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  static_assert(N % L == 0, "N values over L lanes");
  if constexpr (L > 1) {
    halve<N, HALF, L / 2>(v, lane);
    reduce_scatter<N, L / 2, HALF / 2>(v, lane);
  }
}

}  // namespace pdrnn
