// Fused LSTM backward time loop (reverse time) for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:
// _lstm_bwd_kernel (launched by _lstm_bwd_pallas).  Per step t, from T-1
// down to 0, with dh and dc carried in float32 (dh_T, dc_T at the start):
//   recompute gates from h_{t-1}, c_{t-1} (h0, c0 at t = 0)
//   dh += dh_all[t];  tc = tanh(c_all[t]);  do = dh * tc
//   dc += dh * o * (1 - tc^2);  di = dc * g;  df = dc * c_{t-1};  dg = dc * i
//   d_gates = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]  -> dx_proj[t]
//   dh = d_gates @ W_hh (w_hh_t read transposed);  dc = dc * f
// and dh0, dc0 after step 0.  dW_hh is NOT formed here: the caller takes
// it as one matrix product over (t, b) of dx_proj and h_{t-1}, as the JAX
// package leaves it to XLA (_fused_bwd).
//
// What bounds it: bytes.  At T=128, B=1440, H=32, f32 it reads x_proj
// (94 MB) and h_all, c_all, dh_all (71 MB) and writes dx_proj (94 MB):
// about 77 us at 3.35 TB/s, against 3.0 GFLOP of f32 FMAs (45 us); and it
// is a chain of T dependent steps with two barriers each.
//
// Design: as the forward, one block owns one tile of block_b rows for the
// whole reverse sweep.  The SAME shared-memory copy of W_hh^T serves the
// gate recompute (rows read across units) and dh_prev = d_gates @ W_hh
// (columns read across units; the odd row stride keeps both conflict-
// free).  Each step stages h_{t-1} in shared memory, recomputes the gates
// of the thread's unit, publishes d_gates to shared memory, and after a
// barrier each thread contracts it into dh for its own unit - the unit it
// needs next step - so dh and dc stay in registers.
#include "lstm_common.cuh"

namespace {

using namespace pdrnn;

size_t bwd_smem_bytes(int hidden, int block_b) {
  return sizeof(float) * ((size_t)hidden * w_stride(hidden) +
                          (size_t)block_b * hidden +
                          (size_t)block_b * 4 * hidden);
}

template <typename T>
__global__ void lstm_bwd_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h_all,
    const T* __restrict__ c_all, const T* __restrict__ h0,
    const T* __restrict__ c0, const T* __restrict__ w_hh_t,
    const T* __restrict__ dh_all, const T* __restrict__ dh_T,
    const T* __restrict__ dc_T, T* __restrict__ dx_proj, T* __restrict__ dh0,
    T* __restrict__ dc0, int seq_len, int batch, int hidden, int block_b) {
  extern __shared__ float smem[];
  const int gate_dim = 4 * hidden;
  const int stride = w_stride(hidden);
  float* w = smem;
  float* h_prev = w + hidden * stride;         // (block_b, H)
  float* d_gates = h_prev + block_b * hidden;  // (block_b, 4H)
  const int row0 = blockIdx.x * block_b;
  const size_t step = (size_t)batch * hidden;

  stage_weights(w_hh_t, w, hidden);

  const int j = threadIdx.x % hidden;
  const int r0 = (threadIdx.x / hidden) * kRowsPerThread;
  float dh[kRowsPerThread];
  float dc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = row0 + r0 + r;
    const bool valid = b < batch;
    dh[r] = valid ? to_f32(dh_T[(size_t)b * hidden + j]) : 0.0f;
    dc[r] = valid ? to_f32(dc_T[(size_t)b * hidden + j]) : 0.0f;
  }

  for (int t = seq_len - 1; t >= 0; --t) {
    // h_{t-1} (h0 at t == 0) for the gate recompute
    stage_rows(t > 0 ? h_all + (t - 1) * step : h0, h_prev, row0, batch,
               hidden, block_b);
    __syncthreads();

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
      const int b = row0 + r0 + r;
      const bool valid = b < batch;
      const size_t o = (size_t)b * hidden + j;
      const float ig = sigmoid(acc[r][0]);
      const float fg = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]);
      const float og = sigmoid(acc[r][3]);
      float c_prev = 0.0f, c_t = 0.0f, dh_t = 0.0f;
      if (valid) {
        c_prev = to_f32(t > 0 ? c_all[(t - 1) * step + o] : c0[o]);
        c_t = to_f32(c_all[t * step + o]);
        dh_t = to_f32(dh_all[t * step + o]);
      }
      const float dhv = dh[r] + dh_t;
      const float tc = tanhf(c_t);
      const float dcv = dc[r] + dhv * og * (1.0f - tc * tc);
      const float gi = dcv * gg * ig * (1.0f - ig);
      const float gf = dcv * c_prev * fg * (1.0f - fg);
      const float gc = dcv * ig * (1.0f - gg * gg);
      const float go = dhv * tc * og * (1.0f - og);
      float* dg_row = d_gates + (r0 + r) * gate_dim + j;
      dg_row[0] = gi;
      dg_row[hidden] = gf;
      dg_row[2 * hidden] = gc;
      dg_row[3 * hidden] = go;
      if (valid) {
        T* dx = dx_proj + ((size_t)t * batch + b) * gate_dim + j;
        dx[0] = from_f32<T>(gi);
        dx[hidden] = from_f32<T>(gf);
        dx[2 * hidden] = from_f32<T>(gc);
        dx[3 * hidden] = from_f32<T>(go);
      }
      dc[r] = dcv * fg;
    }
    __syncthreads();

    // dh_{t-1}[row, j] = sum_n d_gates[row, n] * w_hh_t[j, n]
    float acc_h[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc_h[r] = 0.0f;
    const float* wj = w + j * stride;
    for (int n = 0; n < gate_dim; ++n) {
      const float wv = wj[n];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc_h[r] = fmaf(d_gates[(r0 + r) * gate_dim + n], wv, acc_h[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) dh[r] = acc_h[r];
    // no barrier here: the next step first rewrites h_prev, which nobody
    // reads after the barrier above, and rewrites d_gates only after the
    // next step's first barrier, which every thread reaches after this loop
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = row0 + r0 + r;
    if (b < batch) {
      dh0[(size_t)b * hidden + j] = from_f32<T>(dh[r]);
      dc0[(size_t)b * hidden + j] = from_f32<T>(dc[r]);
    }
  }
}

template <typename T>
int launch(const void* x_proj, const void* h_all, const void* c_all,
           const void* h0, const void* c0, const void* w_hh_t,
           const void* dh_all, const void* dh_T, const void* dc_T,
           void* dx_proj, void* dh0, void* dc0, int seq_len, int batch,
           int hidden, int block_b, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(hidden, block_b);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 threads(hidden * (block_b / kRowsPerThread));
  lstm_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h_all),
      static_cast<const T*>(c_all), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<const T*>(w_hh_t),
      static_cast<const T*>(dh_all), static_cast<const T*>(dh_T),
      static_cast<const T*>(dc_T), static_cast<T*>(dx_proj),
      static_cast<T*>(dh0), static_cast<T*>(dc0), seq_len, batch, hidden,
      block_b);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  Shapes and
// dtypes are checked by the Python wrapper (ops/fused_rnn.py:lstm_bwd).
extern "C" int lstm_bwd(const void* x_proj, const void* h_all,
                        const void* c_all, const void* h0, const void* c0,
                        const void* w_hh_t, const void* dh_all,
                        const void* dh_T, const void* dc_T, void* dx_proj,
                        void* dh0, void* dc0, int seq_len, int batch,
                        int hidden, int block_b, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch<float>(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T,
                         dc_T, dx_proj, dh0, dc0, seq_len, batch, hidden,
                         block_b, s);
  }
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all,
                                 dh_T, dc_T, dx_proj, dh0, dc0, seq_len, batch,
                                 hidden, block_b, s);
  }
  return (int)cudaErrorInvalidValue;
}
