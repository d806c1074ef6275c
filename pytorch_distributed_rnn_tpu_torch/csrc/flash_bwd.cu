// Flash-attention backward for Hopper (sm_90a): the dQ and the dK/dV kernel.
//
// Replace the TPU kernels pytorch_distributed_rnn_tpu/ops/pallas_attention.py:
// _dq_kernel and _dkv_kernel (both launched by _bwd_impl).  Both recompute
// the probabilities from the forward's row logsumexp instead of storing
// them:
//   p  = exp(q . k^T * scale - lse), 0 where masked or not finite
//   dp = dO . v^T,  ds = p * (dp - delta) * scale   (delta = rowsum(dO * o))
//   flash_dq:  dQ = ds . K            (ds cast to k's dtype first)
//   flash_dkv: dV = p^T . dO,  dK = ds^T . Q
//              (p cast to dO's dtype, ds to q's dtype first)
// JAX's split is kept: a dQ pass over key tiles per query tile, and a dK/dV
// pass over query tiles per key tile, so every output element is owned by
// one block: no atomics, and the results do not change from run to run.
//
// What bounds them on an H100 SXM: operations.  At the attention
// classifier's CLI shape (BH = 1024, T = 128, D = 32, f32): dQ does
// 6 BH T^2 D = 3.22 GFLOP (48 us at 67 TFLOP/s) against 84.9 MB (25 us at
// 3.35 TB/s); dK/dV 8 BH T^2 D = 4.29 GFLOP (64 us) against 102 MB (30 us).
// At the long-context shape (BH = 64, T = 1024, D = 128, bf16): 51.5 and
// 68.7 GFLOP, 52 and 69 us at 989 TFLOP/s on the tensor cores, against
// 84 and 101 MB (25 and 30 us).  These kernels do their products on the
// CUDA cores in float32, so their own floor there is 0.77 and 1.03 ms.
//
// Design, as csrc/flash_fwd.cu: 256 threads, 64 x 64 tiles staged in shared
// memory as float32 (row stride DP + 1), each thread owning a 4 x 4 score
// micro tile and 4 x DP/16 output columns; the score and dp products share
// one pass over the head dim; ds (and p) go through shared memory for the
// second product.  dQ holds Q, dO, K, V and ds (149 KB at D = 128); dK/dV
// holds K, V, Q, dO, p^T, ds^T and the tile's lse and delta (166 KB), with
// dK and dV accumulating in registers.  Tiles wholly above the causal
// diagonal are never visited; the ragged T edge is masked in the kernel.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DP>
size_t dq_smem_bytes() {
  return sizeof(float) *
         ((size_t)2 * (kBlockM + kBlockN) * HeadDim<DP>::kStride + kBlockM * kScoreStride);
}

template <int DP>
size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)2 * (kBlockM + kBlockN) * HeadDim<DP>::kStride +
                          2 * kBlockN * kScoreStride + 2 * kBlockM);
}

// a[r][j] = sum_c x[row r][c] * y[col j][c] and b[r][j] likewise for
// (x2, y2): the thread's rows ty * 4 + r of x and x2, its columns
// tx + 16 j of y and y2, in one pass over the head dim.
template <int DP>
__device__ __forceinline__ void two_products(const float* x, const float* y,
                                             const float* x2, const float* y2,
                                             int ty, int tx, float (&a)[kRows][kCols],
                                             float (&b)[kRows][kCols]) {
  using H = HeadDim<DP>;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) a[r][j] = b[r][j] = 0.0f;
  }
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float xv[kRows], yv[kCols], x2v[kRows], y2v[kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      xv[r] = x[(ty * kRows + r) * H::kStride + c];
      x2v[r] = x2[(ty * kRows + r) * H::kStride + c];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      yv[j] = y[(tx + kTx * j) * H::kStride + c];
      y2v[j] = y2[(tx + kTx * j) * H::kStride + c];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        a[r][j] = fmaf(xv[r], yv[j], a[r][j]);
        b[r][j] = fmaf(x2v[r], y2v[j], b[r][j]);
      }
    }
  }
}

template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[kRows][HeadDim<DP>::kCols],
                                           int row0, int n_rows, int d, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + ty * kRows + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < HeadDim<DP>::kCols; ++c) {
      const int col = tx + kTx * c;
      if (col < d) dst[(size_t)row * d + col] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_q, int t_k, int d, float scale,
                    int causal, int q_off, int k_off) {
  using H = HeadDim<DP>;
  extern __shared__ float smem[];
  float* q_s = smem;                          // (kBlockM, DP + 1)
  float* do_s = q_s + kBlockM * H::kStride;   // (kBlockM, DP + 1)
  float* k_s = do_s + kBlockM * H::kStride;   // (kBlockN, DP + 1)
  float* v_s = k_s + kBlockN * H::kStride;    // (kBlockN, DP + 1)
  float* ds_s = v_s + kBlockN * H::kStride;   // (kBlockM, kBlockN + 1)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const size_t q_base = (size_t)bh * t_q;
  const size_t k_base = (size_t)bh * t_k;

  stage_tile<T, DP>(q + q_base * d, q0, t_q, d, q_s, kBlockM);
  stage_tile<T, DP>(d_o + q_base * d, q0, t_q, d, do_s, kBlockM);
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    lse_r[r] = qi < t_q ? lse[q_base + qi] : 0.0f;
    delta_r[r] = qi < t_q ? delta[q_base + qi] : 0.0f;
  }
  float acc[kRows][H::kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < H::kCols; ++c) acc[r][c] = 0.0f;
  }

  const int k_end = key_end(q0, t_q, t_k, causal, q_off, k_off);
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile's K and ds are read
    stage_tile<T, DP>(k + k_base * d, k0, t_k, d, k_s, kBlockN);
    stage_tile<T, DP>(v + k_base * d, k0, t_k, d, v_s, kBlockN);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    two_products<DP>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty * kRows + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTx * j;
        const bool ok = visible(q0 + row, kj, t_q, t_k, causal, q_off, k_off);
        const float p = recompute_p(s[r][j] * scale, lse_r[r], ok);
        const float ds = p * (dp[r][j] - delta_r[r]) * scale;
        ds_s[row * kScoreStride + tx + kTx * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dQ += ds . K
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float dsv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dsv[r] = ds_s[(ty * kRows + r) * kScoreStride + j];
#pragma unroll
      for (int c = 0; c < H::kCols; ++c) {
        const float kv = k_s[j * H::kStride + tx + kTx * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(dsv[r], kv, acc[r][c]);
      }
    }
  }
  store_rows<T, DP>(dq + q_base * d, acc, q0, t_q, d, ty, tx);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ d_o,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_q, int t_k, int d,
                     float scale, int causal, int q_off, int k_off) {
  using H = HeadDim<DP>;
  extern __shared__ float smem[];
  float* k_s = smem;                          // (kBlockN, DP + 1)
  float* v_s = k_s + kBlockN * H::kStride;    // (kBlockN, DP + 1)
  float* q_s = v_s + kBlockN * H::kStride;    // (kBlockM, DP + 1)
  float* do_s = q_s + kBlockM * H::kStride;   // (kBlockM, DP + 1)
  float* pt_s = do_s + kBlockM * H::kStride;  // p^T  (kBlockN, kBlockM + 1)
  float* dst_s = pt_s + kBlockN * kScoreStride;  // ds^T (kBlockN, kBlockM + 1)
  float* lse_s = dst_s + kBlockN * kScoreStride;  // (kBlockM)
  float* delta_s = lse_s + kBlockM;               // (kBlockM)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockN;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const size_t q_base = (size_t)bh * t_q;
  const size_t k_base = (size_t)bh * t_k;

  stage_tile<T, DP>(k + k_base * d, k0, t_k, d, k_s, kBlockN);
  stage_tile<T, DP>(v + k_base * d, k0, t_k, d, v_s, kBlockN);
  float dk_acc[kRows][H::kCols], dv_acc[kRows][H::kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < H::kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;
  }

  // the first query tile with a query on or below the diagonal of this key
  // tile's first key; earlier tiles are wholly above it
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 + k_off - q_off) / kBlockM * kBlockM;
  for (int q0 = q_begin; q0 < t_q; q0 += kBlockM) {
    __syncthreads();  // the previous tile's Q, dO, p^T and ds^T are read
    stage_tile<T, DP>(q + q_base * d, q0, t_q, d, q_s, kBlockM);
    stage_tile<T, DP>(d_o + q_base * d, q0, t_q, d, do_s, kBlockM);
    for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
      const bool in = q0 + i < t_q;
      lse_s[i] = in ? lse[q_base + q0 + i] : 0.0f;
      delta_s[i] = in ? delta[q_base + q0 + i] : 0.0f;
    }
    __syncthreads();

    // transposed scores: rows are the thread's keys, columns its queries
    float st[kRows][kCols], dpt[kRows][kCols];
    two_products<DP>(k_s, q_s, v_s, do_s, ty, tx, st, dpt);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = ty * kRows + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kTx * j;
        const bool ok = visible(q0 + col, k0 + key, t_q, t_k, causal, q_off, k_off);
        const float p = recompute_p(st[r][j] * scale, lse_s[col], ok);
        const float ds = p * (dpt[r][j] - delta_s[col]) * scale;
        pt_s[key * kScoreStride + col] = round_to<T>(p);
        dst_s[key * kScoreStride + col] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dV += p^T . dO and dK += ds^T . Q
#pragma unroll 2
    for (int i = 0; i < kBlockM; ++i) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pv[r] = pt_s[(ty * kRows + r) * kScoreStride + i];
        dsv[r] = dst_s[(ty * kRows + r) * kScoreStride + i];
      }
#pragma unroll
      for (int c = 0; c < H::kCols; ++c) {
        const float dov = do_s[i * H::kStride + tx + kTx * c];
        const float qv = q_s[i * H::kStride + tx + kTx * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dv_acc[r][c] = fmaf(pv[r], dov, dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dsv[r], qv, dk_acc[r][c]);
        }
      }
    }
  }
  store_rows<T, DP>(dk + k_base * d, dk_acc, k0, t_k, d, ty, tx);
  store_rows<T, DP>(dv + k_base * d, dv_acc, k0, t_k, d, ty, tx);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* d_o,
              const void* lse, const void* delta, void* dq, int bh, int t_q,
              int t_k, int d, float scale, int causal, int q_off, int k_off,
              cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_kernel(flash_dq_kernel<T, DP>, grid, dq_smem_bytes<DP>(), stream,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(d_o),
                         static_cast<const float*>(lse), static_cast<const float*>(delta),
                         static_cast<T*>(dq), t_q, t_k, d, scale, causal, q_off, k_off);
  });
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int t_q, int t_k, int d, float scale, int causal, int q_off,
               int k_off, cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_k + kBlockN - 1) / kBlockN);
    return launch_kernel(flash_dkv_kernel<T, DP>, grid, dkv_smem_bytes<DP>(), stream,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(d_o),
                         static_cast<const float*>(lse), static_cast<const float*>(delta),
                         static_cast<T*>(dk), static_cast<T*>(dv), t_q, t_k, d, scale,
                         causal, q_off, k_off);
  });
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched); shapes
// and dtypes are checked by the Python wrappers (ops/fused_attention.py:
// flash_dq, flash_dkv).
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* d_o, const void* lse, const void* delta,
                        void* dq, int bh, int t_q, int t_k, int d, float scale,
                        int causal, int q_off, int k_off, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dq<float>(q, k, v, d_o, lse, delta, dq, bh, t_q, t_k, d, scale, causal,
                            q_off, k_off, s);
  }
  if (dtype == kBFloat16) {
    return launch_dq<__nv_bfloat16>(q, k, v, d_o, lse, delta, dq, bh, t_q, t_k, d, scale,
                                    causal, q_off, k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* d_o, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int t_q, int t_k, int d,
                         float scale, int causal, int q_off, int k_off, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dkv<float>(q, k, v, d_o, lse, delta, dk, dv, bh, t_q, t_k, d, scale,
                             causal, q_off, k_off, s);
  }
  if (dtype == kBFloat16) {
    return launch_dkv<__nv_bfloat16>(q, k, v, d_o, lse, delta, dk, dv, bh, t_q, t_k, d,
                                     scale, causal, q_off, k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}
