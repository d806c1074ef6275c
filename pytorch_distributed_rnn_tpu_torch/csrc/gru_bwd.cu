// Fused GRU backward time loop (reverse time) for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:
// _gru_bwd_kernel (launched by _gru_bwd_pallas).  Per step t, from T-1
// down to 0, with dh carried in float32 (dh_T at the start):
//   recompute r, z, n and h_n = (h_{t-1} @ w_hh_t + b_hh)_n from the STORED
//   h_{t-1} (h0 at t = 0);  dh += dh_all[t]
//   dz = dh (h_{t-1} - n);  dn = dh (1 - z) (1 - n^2);  dr = dn h_n r (1 - r)
//   dz *= z (1 - z);  dx_proj[t] = [dr, dz, dn];  dhgates[t] = [dr, dz, dn r]
//   dh = dh z + dhgates[t] @ W_hh
// and dh0 after step 0.  dW_hh and db_hh are NOT formed here: the caller
// takes them as one matrix product and one sum over (t, b) of dhgates, as
// the JAX package leaves them to XLA (_gru_bwd).
//
// What bounds it.  At the motion shape (T=128, B=1440, H=32, f32): bytes.
// It reads x_proj (71 MB), h_all and dh_all (47 MB) and writes dx_proj and
// dhgates (142 MB), about 78 us at 3.35 TB/s, against 2.3 GFLOP (34 us).
// At the char-LM shape (T=128, B=256, H=512, f32): operations, 103 GFLOP
// (1.54 ms at 67 TFLOP/s) against 0.74 GB (0.22 ms).
//
// Design: as csrc/lstm_bwd.cu, one block owns one tile of block_b rows for
// the whole reverse sweep, with two barriers a step.  Each step stages
// h_{t-1} in shared memory, recomputes the gates of the thread's units,
// publishes d_hgates (block_b x 3H floats: 24 KiB at H=512, 4 rows) to
// shared memory, and after the barrier each thread contracts it into dh
// for its own units - the units it needs next step - so the carried dh
// lives in a shared tile that only its owner touches.  W_hh^T where it fits
// is staged once into shared memory and serves both products (odd row
// stride, see gru_common.cuh).  Where it does not, the gate recompute reads
// W_hh^T and the contraction reads W_hh from device memory (L2), each in
// the orientation in which neighbouring threads read neighbouring words.
#include "gru_common.cuh"

namespace {

using namespace pdrnn;

size_t bwd_smem_bytes(int hidden, int block_b, bool smem_w) {
  // W (if staged), h_{t-1} (block_b, H), d_hgates (block_b, 3H), dh (block_b, H)
  return sizeof(float) *
         (gru_w_smem_floats(hidden, smem_w) + 5 * (size_t)block_b * hidden);
}

template <typename T, bool kSmemW>
__global__ void __launch_bounds__(kMaxThreads) gru_bwd_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h_all,
    const T* __restrict__ h0, const T* __restrict__ w_hh_t,
    const T* __restrict__ w_hh, const T* __restrict__ b_hh,
    const T* __restrict__ dh_all, const T* __restrict__ dh_T,
    T* __restrict__ dx_proj, T* __restrict__ dhgates, T* __restrict__ dh0,
    int seq_len, int batch, int hidden, int block_b) {
  extern __shared__ float smem[];
  const int gate_dim = 3 * hidden;
  float* w_s = smem;
  float* h_prev = smem + (kSmemW ? hidden * gru_w_stride(hidden) : 0);
  float* d_hg = h_prev + block_b * hidden;  // (block_b, 3H)
  float* dh_s = d_hg + block_b * gate_dim;  // (block_b, H), the carried dh
  const int row0 = blockIdx.x * block_b;
  const size_t step = (size_t)batch * hidden;
  const int unit_threads = gru_unit_threads(hidden, block_b);
  const int j0 = threadIdx.x % unit_threads;
  const int r0 = (threadIdx.x / unit_threads) * kRowsPerThread;

  if constexpr (kSmemW) stage_gru_weights(w_hh_t, w_s, hidden);
  // read first after the first barrier below
  stage_rows(dh_T, dh_s, row0, batch, hidden, block_b);
  const GruWeights<T, kSmemW> w{w_s, w_hh_t, w_hh, hidden};

  for (int t = seq_len - 1; t >= 0; --t) {
    // h_{t-1} (h0 at t == 0): the gate recompute and dz read it
    stage_rows(t > 0 ? h_all + (t - 1) * step : h0, h_prev, row0, batch,
               hidden, block_b);
    __syncthreads();

    for (int j = j0; j < hidden; j += unit_threads) {
      float xg[kRowsPerThread][3];
      float dh_t[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int b = row0 + r0 + r;
        const bool valid = b < batch;
        const T* xp = x_proj + ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
        for (int k = 0; k < 3; ++k) xg[r][k] = valid ? to_f32(xp[k * hidden]) : 0.0f;
        dh_t[r] = valid ? to_f32(dh_all[t * step + (size_t)b * hidden + j]) : 0.0f;
      }
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
        const int b = row0 + r0 + r;
        const int o = (r0 + r) * hidden + j;
        const float rg = sigmoid(xg[r][0] + acc[r][0]);
        const float zg = sigmoid(xg[r][1] + acc[r][1]);
        const float hn = acc[r][2];
        const float ng = tanhf(xg[r][2] + rg * hn);
        const float dh = dh_s[o] + dh_t[r];
        const float dn = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float dz = dh * (h_prev[o] - ng) * zg * (1.0f - zg);
        const float dr = dn * hn * rg * (1.0f - rg);
        float* dg_row = d_hg + (r0 + r) * gate_dim + j;
        dg_row[0] = dr;
        dg_row[hidden] = dz;
        dg_row[2 * hidden] = dn * rg;
        dh_s[o] = dh * zg;  // the contraction below adds d_hgates @ W_hh
        if (b < batch) {
          const size_t g = ((size_t)t * batch + b) * gate_dim + j;
          dx_proj[g] = from_f32<T>(dr);
          dx_proj[g + hidden] = from_f32<T>(dz);
          dx_proj[g + 2 * hidden] = from_f32<T>(dn);
          dhgates[g] = from_f32<T>(dr);
          dhgates[g + hidden] = from_f32<T>(dz);
          dhgates[g + 2 * hidden] = from_f32<T>(dn * rg);
        }
      }
    }
    __syncthreads();

    // dh_{t-1}[row, m] += sum_n d_hgates[row, n] * w_hh_t[m, n]
    for (int m = j0; m < hidden; m += unit_threads) {
      float acc_h[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc_h[r] = 0.0f;
      contract_gates(w, d_hg, r0, m, acc_h);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) dh_s[(r0 + r) * hidden + m] += acc_h[r];
    }
    // no barrier here: the next step first rewrites h_prev, which nobody
    // reads after the barrier above, and rewrites d_hgates only after the
    // next step's first barrier, which every thread reaches after this loop
  }

  for (int m = j0; m < hidden; m += unit_threads) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int b = row0 + r0 + r;
      if (b < batch) dh0[(size_t)b * hidden + m] = from_f32<T>(dh_s[(r0 + r) * hidden + m]);
    }
  }
}

template <typename T, bool kSmemW>
int launch(const void* x_proj, const void* h_all, const void* h0,
           const void* w_hh_t, const void* w_hh, const void* b_hh,
           const void* dh_all, const void* dh_T, void* dx_proj, void* dhgates,
           void* dh0, int seq_len, int batch, int hidden, int block_b,
           cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(hidden, block_b, kSmemW);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<T, kSmemW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 threads(gru_threads(hidden, block_b));
  gru_bwd_kernel<T, kSmemW><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h_all),
      static_cast<const T*>(h0), static_cast<const T*>(w_hh_t),
      static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
      static_cast<const T*>(dh_all), static_cast<const T*>(dh_T),
      static_cast<T*>(dx_proj), static_cast<T*>(dhgates),
      static_cast<T*>(dh0), seq_len, batch, hidden, block_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* x_proj, const void* h_all, const void* h0,
                 const void* w_hh_t, const void* w_hh, const void* b_hh,
                 const void* dh_all, const void* dh_T, void* dx_proj,
                 void* dhgates, void* dh0, int seq_len, int batch, int hidden,
                 int block_b, int smem_w, cudaStream_t stream) {
  if (smem_w) {
    return launch<T, true>(x_proj, h_all, h0, w_hh_t, w_hh, b_hh, dh_all,
                           dh_T, dx_proj, dhgates, dh0, seq_len, batch,
                           hidden, block_b, stream);
  }
  return launch<T, false>(x_proj, h_all, h0, w_hh_t, w_hh, b_hh, dh_all,
                          dh_T, dx_proj, dhgates, dh0, seq_len, batch, hidden,
                          block_b, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  Shapes,
// dtypes, block_b and smem_w are checked and chosen by the Python wrapper
// (ops/fused_rnn.py:gru_bwd); w_hh (3H, H) is read only when smem_w is 0.
extern "C" int gru_bwd(const void* x_proj, const void* h_all, const void* h0,
                       const void* w_hh_t, const void* w_hh, const void* b_hh,
                       const void* dh_all, const void* dh_T, void* dx_proj,
                       void* dhgates, void* dh0, int seq_len, int batch,
                       int hidden, int block_b, int smem_w, int dtype,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dtype<float>(x_proj, h_all, h0, w_hh_t, w_hh, b_hh, dh_all,
                               dh_T, dx_proj, dhgates, dh0, seq_len, batch,
                               hidden, block_b, smem_w, s);
  }
  if (dtype == kBFloat16) {
    return launch_dtype<__nv_bfloat16>(x_proj, h_all, h0, w_hh_t, w_hh, b_hh,
                                       dh_all, dh_T, dx_proj, dhgates, dh0,
                                       seq_len, batch, hidden, block_b,
                                       smem_w, s);
  }
  return (int)cudaErrorInvalidValue;
}
