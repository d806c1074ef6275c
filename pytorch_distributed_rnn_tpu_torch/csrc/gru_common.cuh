// Shared pieces of the fused GRU kernels (gru_fwd.cu, gru_bwd.cu).
//
// Layouts are the JAX package's fused-scan layouts: time-major
// x_proj (T, B, 3H) with b_ih folded in, h (T, B, H), the recurrent weight
// pre-transposed as w_hh_t (H, 3H), b_hh (3H) kept apart (the n gate's
// hidden bias sits inside r * (...)), gate order r, z, n.  Every tensor is
// contiguous and of one dtype (float32 or bfloat16); the recurrence itself
// always runs in float32.
//
// Thread mapping of the two kernels' shared-memory variants (up to
// H = 126; the cluster variants have their own, in gru_fwd.cu and
// gru_bwd.cu): a block owns block_b batch rows for the whole sequence.  Its threads form
// block_b / kRowsPerThread row groups of unit_threads threads each; a
// thread computes all three gates of units j0, j0 + unit_threads, ... for
// kRowsPerThread rows, so the gate update needs no exchange between
// threads.  unit_threads = min(H, 512 / row_groups), so one thread owns one
// unit up to that width and several beyond it.
#pragma once

#include "cluster_common.cuh"  // kClusterCtas, the split cluster barrier, cluster_launch_config
#include "lstm_common.cuh"     // dtype codes, to_f32/from_f32, sigmoid, stage_rows

namespace pdrnn {

// Threads of a block, and the kernels' __launch_bounds__: 512 threads
// leave each up to 128 registers (a 1024-thread block would leave 64).
constexpr int kMaxThreads = 512;

__host__ __device__ inline int gru_row_groups(int block_b) {
  return block_b / kRowsPerThread;
}

__host__ __device__ inline int gru_unit_threads(int hidden, int block_b) {
  const int cap = kMaxThreads / gru_row_groups(block_b);
  return hidden < cap ? hidden : cap;
}

__host__ inline int gru_threads(int hidden, int block_b) {
  return gru_row_groups(block_b) * gru_unit_threads(hidden, block_b);
}

// w_hh_t staged in shared memory as float32 with a row stride of 3H + 1:
// the gate products read a row across consecutive units j (stride 1) and
// the backward's d_hgates @ W_hh reads a column across units m (stride
// 3H + 1, odd), so neither access pattern has bank conflicts.
__host__ __device__ inline int gru_w_stride(int hidden) { return 3 * hidden + 1; }

__host__ inline size_t gru_w_smem_floats(int hidden) {
  return (size_t)hidden * gru_w_stride(hidden);
}

template <typename T>
__device__ void stage_gru_weights(const T* __restrict__ w_hh_t, float* w,
                                  int hidden) {
  const int gate_dim = 3 * hidden;
  const int stride = gru_w_stride(hidden);
  for (int i = threadIdx.x; i < hidden * gate_dim; i += blockDim.x) {
    const int m = i / gate_dim;
    w[m * stride + (i - m * gate_dim)] = to_f32(w_hh_t[i]);
  }
}

// W_hh^T where a block holds all of it (up to H = 126): the float32 copy
// staged in shared memory.  Above that width both kernels split W_hh^T
// over a thread-block cluster instead (gru_fwd.cu, gru_bwd.cu).
struct GruWeights {
  const float* smem;  // (H, 3H + 1) float32
  int hidden;

  // W_hh^T[m][col], read with col = k * H + j across threads j
  __device__ __forceinline__ float gate(int m, int col) const {
    return smem[m * gru_w_stride(hidden) + col];
  }

  // W_hh^T[m][n], read with m across threads
  __device__ __forceinline__ float contract(int m, int n) const {
    return smem[m * gru_w_stride(hidden) + n];
  }
};

__device__ __forceinline__ void fma_gates(float (&acc)[kRowsPerThread][3],
                                          const float* h_prev, int r0,
                                          int hidden, int m, float w0,
                                          float w1, float w2) {
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const float hv = h_prev[(r0 + r) * hidden + m];
    acc[r][0] = fmaf(hv, w0, acc[r][0]);
    acc[r][1] = fmaf(hv, w1, acc[r][1]);
    acc[r][2] = fmaf(hv, w2, acc[r][2]);
  }
}

// acc[r][k] += sum_m h_prev[r0 + r][m] * W_hh^T[m][k * H + j]: the
// hidden-side products of unit j's three gates for the thread's rows.
__device__ __forceinline__ void gate_products(const GruWeights& w,
                                              const float* h_prev, int r0,
                                              int j,
                                              float (&acc)[kRowsPerThread][3]) {
  const int hidden = w.hidden;
#pragma unroll 4
  for (int m = 0; m < hidden; ++m) {
    fma_gates(acc, h_prev, r0, hidden, m, w.gate(m, j), w.gate(m, hidden + j),
              w.gate(m, 2 * hidden + j));
  }
}

// acc[r] += sum_n d_hg[r0 + r][n] * W_hh^T[m][n]: the backward's
// contraction of the gate cotangents into dh_{t-1} of unit m, from the
// shared copy of W.
__device__ __forceinline__ void contract_gates(
    const GruWeights& w, const float* d_hg, int r0, int m,
    float (&acc)[kRowsPerThread]) {
  const int gate_dim = 3 * w.hidden;
#pragma unroll 4
  for (int n = 0; n < gate_dim; ++n) {
    const float wv = w.contract(m, n);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      acc[r] = fmaf(d_hg[(r0 + r) * gate_dim + n], wv, acc[r]);
    }
  }
}

// Above H = 126 both kernels split W_hh^T over a thread-block cluster
// (cluster_common.cuh): CTA c owns the units [c U, (c + 1) U), U = ceil(H /
// 16), and keeps the 3U columns of W_hh^T of its units' r, z and n gates in
// shared memory (gru_fwd.cu:gru_fwd_cluster_kernel, gru_bwd.cu:
// gru_bwd_cluster_kernel).

}  // namespace pdrnn
