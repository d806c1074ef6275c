// Fused LSTM forward time loop for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:
// _lstm_fwd_kernel (launched by _lstm_fwd_pallas).  Per step t:
//   gates = x_proj[t] + h @ w_hh_t;  i, f, g, o = sigmoid, sigmoid, tanh, sigmoid
//   c = f * c + i * g;  h = o * tanh(c);  h_all[t] = h;  c_all[t] = c
// with h and c carried in float32 and stored in the input dtype.
//
// What bounds it: bytes.  At the motion model's shape (T=128, B=1440,
// H=32, f32) it must read x_proj (94 MB) and write h_all + c_all (47 MB),
// about 42 us at 3.35 TB/s, against 1.5 GFLOP of f32 FMAs (23 us at
// 67 TFLOP/s); and it is a chain of T dependent steps.
//
// Design: the TPU grid (batch_tiles, T) runs in order on one core; here
// blocks run in parallel in no order, so T is a loop inside the block and
// one block owns one tile of block_b batch rows for the whole sequence.
// W_hh^T is staged once into shared memory (16 KiB at H=32 f32) and read
// from there every step; h lives in a double-buffered shared tile (one
// barrier per step), c in registers of the thread that owns the unit.
// Each thread computes all four gates of its unit for kRowsPerThread rows,
// so the cell update needs no exchange between threads.  The ragged last
// tile is masked, not padded.  No tensor cores: a (block_b, H) x (H, 4H)
// product per step is too small to feed them; that is a later change.
#include "lstm_common.cuh"

namespace {

using namespace pdrnn;

size_t fwd_smem_bytes(int hidden, int block_b) {
  return sizeof(float) *
         ((size_t)hidden * w_stride(hidden) + 2 * (size_t)block_b * hidden);
}

template <typename T>
__global__ void lstm_fwd_kernel(const T* __restrict__ x_proj,
                                const T* __restrict__ h0,
                                const T* __restrict__ c0,
                                const T* __restrict__ w_hh_t,
                                T* __restrict__ h_all, T* __restrict__ c_all,
                                int seq_len, int batch, int hidden,
                                int block_b) {
  extern __shared__ float smem[];
  const int gate_dim = 4 * hidden;
  const int stride = w_stride(hidden);
  const int tile = block_b * hidden;
  float* w = smem;
  float* h_buf = w + hidden * stride;
  const int row0 = blockIdx.x * block_b;

  stage_weights(w_hh_t, w, hidden);
  stage_rows(h0, h_buf, row0, batch, hidden, block_b);

  const int j = threadIdx.x % hidden;
  const int r0 = (threadIdx.x / hidden) * kRowsPerThread;
  float c[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = row0 + r0 + r;
    c[r] = b < batch ? to_f32(c0[(size_t)b * hidden + j]) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < seq_len; ++t) {
    const float* h_prev = h_buf + (t & 1) * tile;
    float* h_next = h_buf + ((t + 1) & 1) * tile;

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int b = row0 + r0 + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[r][k] =
            b < batch
                ? to_f32(x_proj[((size_t)t * batch + b) * gate_dim + k * hidden + j])
                : 0.0f;
      }
    }
    for (int m = 0; m < hidden; ++m) {
      const float* wm = w + m * stride + j;
      const float w0 = wm[0];
      const float w1 = wm[hidden];
      const float w2 = wm[2 * hidden];
      const float w3 = wm[3 * hidden];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float hv = h_prev[(r0 + r) * hidden + m];
        acc[r][0] = fmaf(hv, w0, acc[r][0]);
        acc[r][1] = fmaf(hv, w1, acc[r][1]);
        acc[r][2] = fmaf(hv, w2, acc[r][2]);
        acc[r][3] = fmaf(hv, w3, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float ig = sigmoid(acc[r][0]);
      const float fg = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]);
      const float og = sigmoid(acc[r][3]);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      h_next[(r0 + r) * hidden + j] = h;
      const int b = row0 + r0 + r;
      if (b < batch) {
        const size_t o = ((size_t)t * batch + b) * hidden + j;
        h_all[o] = from_f32<T>(h);
        c_all[o] = from_f32<T>(c[r]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x_proj, const void* h0, const void* c0,
           const void* w_hh_t, void* h_all, void* c_all, int seq_len,
           int batch, int hidden, int block_b, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(hidden, block_b);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 threads(hidden * (block_b / kRowsPerThread));
  lstm_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<const T*>(w_hh_t),
      static_cast<T*>(h_all), static_cast<T*>(c_all), seq_len, batch, hidden,
      block_b);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  Shapes and
// dtypes are checked by the Python wrapper (ops/fused_rnn.py:lstm_fwd).
extern "C" int lstm_fwd(const void* x_proj, const void* h0, const void* c0,
                        const void* w_hh_t, void* h_all, void* c_all,
                        int seq_len, int batch, int hidden, int block_b,
                        int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch<float>(x_proj, h0, c0, w_hh_t, h_all, c_all, seq_len,
                         batch, hidden, block_b, s);
  }
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x_proj, h0, c0, w_hh_t, h_all, c_all,
                                 seq_len, batch, hidden, block_b, s);
  }
  return (int)cudaErrorInvalidValue;
}
