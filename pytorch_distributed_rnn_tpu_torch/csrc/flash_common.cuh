// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: every q-side tensor (q, o, dO, dQ) and k-side tensor (k, v, dK,
// dV) is a head-major batch of rows with unit stride in D: element (batch
// b, head h, row r, column c) sits at b * batch + h * head + r * row + c
// (Rows), so the kernels read the (B, T, H, D) views of the model's
// projections where they lie, and the (B*H, T, D) form as H = 1.  lse and
// delta are (B*H, Tq) float32, contiguous.  Tensors are of one dtype
// (float32 or bfloat16).  Every product accumulates in float32.  The split
// float32 backward (flash_dq_kernel, flash_dkv_kernel) multiplies on the
// CUDA cores; the float32 forward and fused backward run on the tensor
// cores in 3xTF32, which keeps float32's accuracy where TF32 alone would
// miss the float32 tolerance; the bfloat16 kernels multiply bf16 operands
// on the tensor cores (flash_fwd.cu, flash_bwd.cu, with the building blocks
// of flash_mma.cuh), where the TPU kernel's cast of an operand to the input
// dtype before a product (p before p.V, ds before ds.K, ...) is the
// rounding of the bf16 operand itself.
//
// Tiles: kBlockM query rows by kBlockN key rows (also the tensor-core
// kernels' tiles).  The CUDA-core kernels stage them in shared memory as
// float32 with a row stride of DP + 1, where DP is the head dim padded to
// 16, 32, 64 or 128 (columns past D read as zero, so D = 1..128).  A block
// has 256 threads as a 16 x 16 grid (ty, tx): in a score tile thread
// (ty, tx) owns rows ty * 4 + r (r < 4) and columns tx + 16 * c (c < 4); in
// an output tile the same rows and the head-dim columns tx + 16 * c
// (c < DP / 16).  The odd row stride keeps the column-wise reads (16 rows at
// one d) free of bank conflicts; the row-wise reads are broadcasts.
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

template <int DP>
struct HeadDim {
  static_assert(DP % kTx == 0 && DP <= kMaxHeadDim, "padded head dim");
  static constexpr int kStride = DP + 1;   // shared-memory row stride
  static constexpr int kCols = DP / kTx;   // a thread's head-dim columns
};

// Element strides of a head-major batch of rows (D has stride 1); a
// dimension of size 1 may have any stride (the wrappers pass 0).
struct Rows {
  long long batch, head, row;
};

// Rows i of the strides array a C entry point takes: 3 a strided tensor,
// in the order of its pointer arguments.
inline Rows rows_at(const long long* strides, int i) {
  return {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// The first row of head bh (= batch * heads + head) of a strided tensor.
template <typename T>
__device__ __forceinline__ T* head_rows(T* p, const Rows& s, int bh, int heads) {
  return p + (bh / heads) * s.batch + (bh % heads) * s.head;
}

// Rows [row0, row0 + tile_rows) of one head's float32 rows (n_rows of them,
// `stride` elements apart) into a shared tile of stride DP + 1; rows past
// n_rows and columns past d read as zero (the ragged T edge and the
// head-dim padding).
template <int DP>
__device__ void stage_tile(const float* __restrict__ src, long long stride, int row0,
                           int n_rows, int d, float* dst, int tile_rows) {
  for (int i = threadIdx.x; i < tile_rows * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    const int row = row0 + r;
    dst[r * HeadDim<DP>::kStride + c] = (row < n_rows && c < d) ? src[row * stride + c] : 0.0f;
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
