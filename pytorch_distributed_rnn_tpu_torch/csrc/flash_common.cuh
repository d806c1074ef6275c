// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q (BH, Tq, D), k and v (BH, Tk, D), o and the gradients alike, all
// contiguous and of one dtype (float32 or bfloat16); lse and delta are
// (BH, Tq) float32.  Every product accumulates in float32.  The float32
// kernels multiply on the CUDA cores (no TF32, which would miss the float32
// tolerance); where the TPU kernel casts an operand to the input dtype
// before a product (p before p.V, ds before ds.K, ...), they round it to
// that dtype (round_to) and multiply the rounded value.  The bfloat16
// kernels multiply on the tensor cores (flash_fwd.cu, flash_bwd.cu, with
// the building blocks of flash_mma.cuh), where that cast is the rounding of
// the bf16 operand itself.
//
// Tiles: kBlockM query rows by kBlockN key rows (also the tensor-core
// kernels' tiles).  The CUDA-core kernels stage them in shared memory as
// float32 with a row stride of DP + 1, where DP is the head dim padded to
// 16, 32, 64 or 128 (columns past D read as zero, so D = 1..128).  A block
// has 256 threads as a 16 x 16 grid (ty, tx): in a score tile thread
// (ty, tx) owns rows ty * 4 + r (r < 4) and columns tx + 16 * c (c < 4); in
// an output tile the same rows and the head-dim columns tx + 16 * c
// (c < DP / 16).  A row's 16 owners are one half-warp, so row reductions
// are four xor-shuffles.  The odd row stride keeps the column-wise reads
// (16 rows at one d) free of bank conflicts; the row-wise reads are
// broadcasts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace flash {

// dtype codes passed from Python (ops/fused_attention.py:_DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kBlockM = 64;  // query rows of a tile
constexpr int kBlockN = 64;  // key rows of a tile
constexpr int kThreads = 256;
constexpr int kTx = 16;                      // threads along a tile's columns
constexpr int kRows = kBlockM / kTx;         // a thread's rows: 4
constexpr int kCols = kBlockN / kTx;         // a thread's score columns: 4
constexpr int kScoreStride = kBlockN + 1;    // score tiles in shared memory
constexpr int kMaxHeadDim = 128;
static_assert(kBlockM == kBlockN, "score tiles are square: rows and columns share kRows");

__device__ __forceinline__ float neg_inf() { return -CUDART_INF_F; }

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

// v as the TPU kernel's cast to T leaves it (a no-op for float32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Reductions over a row's 16 owner threads (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off /= 2) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int DP>
struct HeadDim {
  static_assert(DP % kTx == 0 && DP <= kMaxHeadDim, "padded head dim");
  static constexpr int kStride = DP + 1;   // shared-memory row stride
  static constexpr int kCols = DP / kTx;   // a thread's head-dim columns
};

// Rows [row0, row0 + tile_rows) of one head's (n_rows, d) matrix into a
// float32 shared tile of stride DP + 1; rows past n_rows and columns past d
// read as zero (the ragged T edge and the head-dim padding).
template <typename T, int DP>
__device__ void stage_tile(const T* __restrict__ src, int row0, int n_rows,
                           int d, float* dst, int tile_rows) {
  for (int i = threadIdx.x; i < tile_rows * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    const int row = row0 + r;
    dst[r * HeadDim<DP>::kStride + c] =
        (row < n_rows && c < d) ? to_f32(src[(size_t)row * d + c]) : 0.0f;
  }
}

// Whether score (qi, kj) of a head takes part: inside both lengths, and on
// or below the causal diagonal at the global positions qi + q_off,
// kj + k_off (pallas_attention.py:_block_mask).
__device__ __forceinline__ bool visible(int qi, int kj, int t_q, int t_k,
                                        int causal, int q_off, int k_off) {
  return qi < t_q && kj < t_k && (!causal || qi + q_off >= kj + k_off);
}

// One past the last key a block of queries [q0, q0 + rows) can see: key
// tiles from there on lie wholly above the causal diagonal and are skipped
// (pallas_attention.py:_causal_skip).  May be <= 0: no visible key.
__device__ __forceinline__ int key_end(int q0, int t_q, int t_k, int causal,
                                       int q_off, int k_off, int rows = kBlockM) {
  if (!causal) return t_k;
  const int q_last = min(q0 + rows, t_q) - 1;
  return min(t_k, q_last + q_off - k_off + 1);
}

// p = exp(s - lse) of a visible score, else 0; non-finite values (a row
// with lse = -inf) are 0 too (pallas_attention.py:_recompute_p).
__device__ __forceinline__ float recompute_p(float s, float lse, bool ok) {
  const float p = ok ? expf(s - lse) : 0.0f;
  return isfinite(p) ? p : 0.0f;
}

// launch(std::integral_constant<int, DP>) at the head dim padded to 16, 32,
// 64 or 128; d outside 1..128 is refused.
template <typename Launch>
int dispatch_head_dim(int d, Launch&& launch) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (d <= 16) return launch(std::integral_constant<int, 16>{});
  if (d <= 32) return launch(std::integral_constant<int, 32>{});
  if (d <= 64) return launch(std::integral_constant<int, 64>{});
  if (d <= kMaxHeadDim) return launch(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a kernel needs, set as its maximum before the
// launch (above 48 KB only after cudaFuncSetAttribute), then the launch
// and cudaGetLastError(); returns the CUDA error code (0 = launched).
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                  Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash
