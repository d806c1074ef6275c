// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_attention.py:
// _fwd_kernel (launched by _fwd_impl).  For each head and query row:
//   s = (q . k^T) * scale (scale = D^-0.5, applied after the f32 product),
//   masked to -inf off the ragged edge and above the causal diagonal;
//   o = softmax(s) . v and lse = logsumexp(s), by the online softmax: a
//   running max m, denominator l and numerator acc in float32 over the key
//   tiles, p cast to v's dtype before p . v.  A row with no visible key
//   gives o = 0 and lse = -inf (not NaN).
//
// What bounds it on an H100 SXM.  At the attention classifier's CLI shape
// (BH = 256 x 4 = 1024, T = 128, D = 32, f32): operations.  4 BH T^2 D =
// 2.15 GFLOP, 32 us at 67 TFLOP/s of float32, against 67.6 MB of q, k, v,
// o and lse (20 us at 3.35 TB/s).  At the long-context shape (BH = 64,
// T = 1024, D = 128, bf16): operations too, 34.4 GFLOP, 35 us at 989
// TFLOP/s on the tensor cores against 67.4 MB (20 us).  This kernel does
// its products on the CUDA cores in float32 (bf16 operands widened), so
// its own floor there is 34.4 GFLOP at 67 TFLOP/s = 0.51 ms.
//
// Design: one block per (head, 64-row query tile), grid (BH, ceil(Tq/64)),
// looping over 64-row key tiles (the TPU grid's sequential key axis becomes
// the loop).  The query tile stays in shared memory; K and then V of a key
// tile share one buffer (staged one after the other, which keeps the
// block at 83 KB at D = 128, two blocks an SM); m, l and acc live in
// registers, a row's 16 owner threads reducing by shuffles; p goes through
// shared memory for p . v.  The ragged T edge and the head-dim padding are
// masked in the kernel, not padded in device memory, and key tiles wholly
// above the causal diagonal are never visited.  No tensor cores, no
// cp.async or TMA double-buffering: those are a later change.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DP>
size_t fwd_smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBlockM + kBlockN) * HeadDim<DP>::kStride + kBlockM * kScoreStride);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t_q, int t_k, int d,
                     float scale, int causal, int q_off, int k_off) {
  using H = HeadDim<DP>;
  extern __shared__ float smem[];
  float* q_s = smem;                            // (kBlockM, DP + 1)
  float* kv_s = q_s + kBlockM * H::kStride;     // (kBlockN, DP + 1): K, then V
  float* p_s = kv_s + kBlockN * H::kStride;     // (kBlockM, kBlockN + 1)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const T* q_h = q + (size_t)bh * t_q * d;
  const T* k_h = k + (size_t)bh * t_k * d;
  const T* v_h = v + (size_t)bh * t_k * d;

  stage_tile<T, DP>(q_h, q0, t_q, d, q_s, kBlockM);

  float acc[kRows][H::kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = neg_inf();
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < H::kCols; ++c) acc[r][c] = 0.0f;
  }

  const int k_end = key_end(q0, t_q, t_k, causal, q_off, k_off);
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile's V and p are read
    stage_tile<T, DP>(k_h, k0, t_k, d, kv_s, kBlockN);
    __syncthreads();

    // s = q . k^T for the thread's 4 x 4 scores
    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[r][j] = 0.0f;
    }
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = q_s[(ty * kRows + r) * H::kStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = kv_s[(tx + kTx * j) * H::kStride + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
      }
    }

    // the online softmax update of the thread's rows
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty * kRows + r;
      const int qi = q0 + row;
      bool ok[kCols];
      float tile_max = neg_inf();
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ok[j] = visible(qi, k0 + tx + kTx * j, t_q, t_k, causal, q_off, k_off);
        s[r][j] = ok[j] ? s[r][j] * scale : neg_inf();
        tile_max = fmaxf(tile_max, s[r][j]);
      }
      const float m_new = fmaxf(m[r], row_max(tile_max));
      // m[r] = -inf: nothing seen yet (acc and l are 0); else m_new is finite
      const float corr = m[r] == neg_inf() ? 0.0f : expf(m[r] - m_new);
      float tile_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[r][j] - m_new) : 0.0f;
        tile_sum += p;
        p_s[row * kScoreStride + tx + kTx * j] = round_to<T>(p);
      }
      l[r] = l[r] * corr + row_sum(tile_sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < H::kCols; ++c) acc[r][c] *= corr;
    }

    __syncthreads();  // K is read and p is whole: V replaces K
    stage_tile<T, DP>(v_h, k0, t_k, d, kv_s, kBlockN);
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = p_s[(ty * kRows + r) * kScoreStride + j];
#pragma unroll
      for (int c = 0; c < H::kCols; ++c) {
        const float vv = kv_s[j * H::kStride + tx + kTx * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    if (qi >= t_q) continue;
    const bool any = l[r] > 0.0f;
    const float l_safe = any ? l[r] : 1.0f;
    T* o_row = o + ((size_t)bh * t_q + qi) * d;
#pragma unroll
    for (int c = 0; c < H::kCols; ++c) {
      const int col = tx + kTx * c;
      if (col < d) o_row[col] = from_f32<T>(acc[r][c] / l_safe);
    }
    if (tx == 0) lse[(size_t)bh * t_q + qi] = any ? m[r] + logf(l_safe) : neg_inf();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int t_q, int t_k, int d, float scale, int causal, int q_off,
           int k_off, cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_kernel(flash_fwd_kernel<T, DP>, grid, fwd_smem_bytes<DP>(), stream,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<T*>(o),
                         static_cast<float*>(lse), t_q, t_k, d, scale, causal,
                         q_off, k_off);
  });
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); shapes and
// dtypes are checked by the Python wrapper (ops/fused_attention.py:flash_fwd).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int t_q, int t_k, int d,
                         float scale, int causal, int q_off, int k_off,
                         int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch<float>(q, k, v, o, lse, bh, t_q, t_k, d, scale, causal, q_off, k_off, s);
  }
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(q, k, v, o, lse, bh, t_q, t_k, d, scale, causal, q_off,
                                 k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}
