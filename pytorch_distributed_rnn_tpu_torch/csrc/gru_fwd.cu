// Fused GRU forward time loop for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:
// _gru_fwd_kernel (launched by _gru_fwd_pallas).  Per step t:
//   h_proj = h @ w_hh_t + b_hh;  r = sigmoid(x_r + h_r);  z = sigmoid(x_z + h_z)
//   n = tanh(x_n + r * h_n);  h = (1 - z) * n + z * h;  h_all[t] = h
// with h carried in float32 and stored in the input dtype.
//
// What bounds it.  At the motion shape (T=128, B=1440, H=32, f32): bytes.
// It reads x_proj (71 MB) and writes h_all (24 MB), about 28 us at
// 3.35 TB/s, against 1.1 GFLOP of f32 FMAs (17 us at 67 TFLOP/s).  At the
// char-LM shape (T=128, B=256, H=512, f32): operations.  51.5 GFLOP of
// f32 FMAs (0.77 ms at 67 TFLOP/s, no tensor cores) against 0.27 GB of
// bytes (80 us).  Both are a chain of T dependent steps.
//
// Design: as csrc/lstm_fwd.cu, T is a loop inside the block and one block
// owns one tile of block_b batch rows for the whole sequence, with h in a
// double-buffered shared tile (one barrier per step) and the ragged last
// tile masked, not padded.  W_hh^T where it fits (H <= 126: 12 KiB at
// H=32) is staged once into shared memory.  Where it does not (3 MiB at
// H=512 f32), the block reads it from device memory every step; after the
// first step it is served from the L2, so each step costs one pass over W
// from L2 per block: the kernel then runs 4-row tiles (64 blocks at
// B=256) so that many SMs pull from L2 at once.  No tensor cores, and no
// split of W's columns across blocks: those are later changes.
#include "gru_common.cuh"

namespace {

using namespace pdrnn;

size_t fwd_smem_bytes(int hidden, int block_b, bool smem_w) {
  return sizeof(float) *
         (gru_w_smem_floats(hidden, smem_w) + 2 * (size_t)block_b * hidden);
}

template <typename T, bool kSmemW>
__global__ void __launch_bounds__(kMaxThreads) gru_fwd_kernel(const T* __restrict__ x_proj,
                               const T* __restrict__ h0,
                               const T* __restrict__ w_hh_t,
                               const T* __restrict__ b_hh,
                               T* __restrict__ h_all, int seq_len, int batch,
                               int hidden, int block_b) {
  extern __shared__ float smem[];
  const int gate_dim = 3 * hidden;
  const int tile = block_b * hidden;
  float* w_s = smem;
  float* h_buf = smem + (kSmemW ? hidden * gru_w_stride(hidden) : 0);
  const int row0 = blockIdx.x * block_b;
  const int unit_threads = gru_unit_threads(hidden, block_b);
  const int j0 = threadIdx.x % unit_threads;
  const int r0 = (threadIdx.x / unit_threads) * kRowsPerThread;

  if constexpr (kSmemW) stage_gru_weights(w_hh_t, w_s, hidden);
  stage_rows(h0, h_buf, row0, batch, hidden, block_b);
  __syncthreads();
  const GruWeights<T, kSmemW> w{w_s, w_hh_t, hidden};

  for (int t = 0; t < seq_len; ++t) {
    const float* h_prev = h_buf + (t & 1) * tile;
    float* h_next = h_buf + ((t + 1) & 1) * tile;

    for (int j = j0; j < hidden; j += unit_threads) {
      float xg[kRowsPerThread][3];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int b = row0 + r0 + r;
        const T* xp = x_proj + ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xg[r][k] = b < batch ? to_f32(xp[k * hidden]) : 0.0f;
        }
      }
      // h_proj = b_hh + h @ w_hh_t for the unit's three gates
      float acc[kRowsPerThread][3];
      const float bias[3] = {to_f32(b_hh[j]), to_f32(b_hh[hidden + j]),
                             to_f32(b_hh[2 * hidden + j])};
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[r][k] = bias[k];
      }
      gate_products(w, h_prev, r0, j, acc);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float rg = sigmoid(xg[r][0] + acc[r][0]);
        const float zg = sigmoid(xg[r][1] + acc[r][1]);
        const float ng = tanhf(xg[r][2] + rg * acc[r][2]);
        const float h = (1.0f - zg) * ng + zg * h_prev[(r0 + r) * hidden + j];
        h_next[(r0 + r) * hidden + j] = h;
        const int b = row0 + r0 + r;
        if (b < batch) h_all[((size_t)t * batch + b) * hidden + j] = from_f32<T>(h);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kSmemW>
int launch(const void* x_proj, const void* h0, const void* w_hh_t,
           const void* b_hh, void* h_all, int seq_len, int batch, int hidden,
           int block_b, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(hidden, block_b, kSmemW);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<T, kSmemW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 threads(gru_threads(hidden, block_b));
  gru_fwd_kernel<T, kSmemW><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h0),
      static_cast<const T*>(w_hh_t), static_cast<const T*>(b_hh),
      static_cast<T*>(h_all), seq_len, batch, hidden, block_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* x_proj, const void* h0, const void* w_hh_t,
                 const void* b_hh, void* h_all, int seq_len, int batch,
                 int hidden, int block_b, int smem_w, cudaStream_t stream) {
  if (smem_w) {
    return launch<T, true>(x_proj, h0, w_hh_t, b_hh, h_all, seq_len, batch,
                           hidden, block_b, stream);
  }
  return launch<T, false>(x_proj, h0, w_hh_t, b_hh, h_all, seq_len, batch,
                          hidden, block_b, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  Shapes,
// dtypes, block_b and smem_w are checked and chosen by the Python wrapper
// (ops/fused_rnn.py:gru_fwd).
extern "C" int gru_fwd(const void* x_proj, const void* h0, const void* w_hh_t,
                       const void* b_hh, void* h_all, int seq_len, int batch,
                       int hidden, int block_b, int smem_w, int dtype,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dtype<float>(x_proj, h0, w_hh_t, b_hh, h_all, seq_len,
                               batch, hidden, block_b, smem_w, s);
  }
  if (dtype == kBFloat16) {
    return launch_dtype<__nv_bfloat16>(x_proj, h0, w_hh_t, b_hh, h_all,
                                       seq_len, batch, hidden, block_b,
                                       smem_w, s);
  }
  return (int)cudaErrorInvalidValue;
}
