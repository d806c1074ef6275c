// Tensor-core building blocks of the flash kernels (sm_90a), shared by
// flash_fwd.cu and flash_bwd.cu: inline PTX for mma.sync, ldmatrix and
// cp.async, the swizzled shared-memory tile layout the bf16 kernels read,
// the C-tile store and the launch; and the TF32 mma, the 3xTF32 operands
// and products and the float32 row staging of the float32 forward and
// fused backward (flash_fwd.cu: flash_fwd_f32_tc_kernel, flash_bwd.cu:
// flash_dqkv_tc_kernel).  Every row is addressed through its tensor's row
// stride (flash_common.cuh: Rows).
//
// Products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: A is a
// 16 x 16 bf16 tile (4 registers of 2 values), B a 16 x 8 one (2
// registers), C/D a 16 x 8 float32 tile (4 registers).  In a warp, lane l
// has g = l / 4 and t = l % 4; it holds C elements (g, 2t), (g, 2t + 1)
// (c[0], c[1]) and (g + 8, 2t), (g + 8, 2t + 1) (c[2], c[3]).  A's register
// i holds row g + 8 (i % 2), columns 2t, 2t + 1 plus 8 (i / 2); B's
// register i holds rows 2t, 2t + 1 plus 8 i of column g.  So the C tiles of
// two neighbouring 8-column blocks, rounded to bf16 pairwise (pack_bf16),
// are the A operand of the next product over those 16 columns: p and ds
// stay in registers between the two products.
//
// Tiles: (rows, DP) bf16, DP the head dim padded to 16, 32, 64 or 128, a
// row of DP / 8 16-byte chunks.  Chunk c of row r sits at chunk
// c ^ f(r) of its row (Swizzle): any 8 consecutive rows read at one chunk,
// which is what one 8 x 8 matrix of ldmatrix reads, fall in 8 distinct
// 16-byte bank groups, so ldmatrix is free of bank conflicts with or
// without .trans.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "flash_common.cuh"

namespace flash {

// The tensor-core kernels' blocks: a warp per 16 rows of a 64-row tile.
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockM == 16 * kTcWarps && kBlockN == 16 * kTcWarps, "16 rows a warp");

template <int DP>
struct Swizzle {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head dim");
  static constexpr int kChunks = DP / 8;  // 16-byte chunks in a row
  // rows that share one 128-byte line, and the chunk bits the XOR may touch
  static constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;

  // byte offset of chunk c of row r in the tile
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    return (uint32_t)(r * DP * 2 + ((c ^ ((r / kRowsPerLine) & kMask)) << 4));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (valid) or 16 zero bytes (not valid; src is not read) to shared
// memory at dst, asynchronously.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes, likewise.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on the tensor cores, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo exactly, hi x with its 13 low mantissa bits cleared (a TF32
// value), lo the rest: the 3xTF32 split.  A TF32 mma reads the top 19 bits
// of each operand, so lo enters truncated to TF32 (2^-10 of itself), and
// a . b summed as a_lo b_hi + a_hi b_lo + a_hi b_hi leaves out a_lo b_lo:
// about 2^-20 of the product, float32's accuracy, where TF32 alone (2^-11)
// misses the float32 tolerance.  Two full-rate instructions, no cvt.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a . b on the tensor cores, m16n8k8, TF32 operands, float32 sums.  A
// (16 x 8): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4); B (8 x 8): b0 (t, g), b1 (t + 4, g); C as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operands of a product over 16 N columns from the C tiles of the
// 8-column blocks 0..2N-1 of a 16 x 16N float32 result: a[h] covers columns
// 16h..16h+15.
template <int N>
__device__ __forceinline__ void c_to_a(const float (&c)[2 * N][4], uint32_t (&a)[N][4]) {
#pragma unroll
  for (int h = 0; h < N; ++h) {
    a[h][0] = pack_bf16(c[2 * h][0], c[2 * h][1]);
    a[h][1] = pack_bf16(c[2 * h][2], c[2 * h][3]);
    a[h][2] = pack_bf16(c[2 * h + 1][0], c[2 * h + 1][1]);
    a[h][3] = pack_bf16(c[2 * h + 1][2], c[2 * h + 1][3]);
  }
}

// Lane addresses of one ldmatrix_x4 into a swizzled (rows, DP) tile at
// byte address base:
// a_addr: the A operand rows r0..r0+15 x chunks 2s, 2s+1 (k-step s);
// b_addr: the B operand of a product by the tile's rows transposed (rows
//   are B's columns): rows r0..r0+15 (two 8-column blocks) x k-step s, r[0..1]
//   for rows r0..r0+7 and r[2..3] for r0+8..r0+15;
// bt_addr (with .trans): the B operand of a product by the tile itself
//   (rows are the contraction): rows r0..r0+15 x chunks c0, c0+1 (two
//   8-column blocks), r[0..1] for chunk c0 and r[2..3] for c0+1.
template <int DP>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int s, int lane) {
  return base + Swizzle<DP>::offset(r0 + ((lane >> 3) & 1) * 8 + (lane & 7), 2 * s + (lane >> 4));
}

template <int DP>
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int r0, int s, int lane) {
  return base + Swizzle<DP>::offset(r0 + (lane >> 4) * 8 + (lane & 7), 2 * s + ((lane >> 3) & 1));
}

template <int DP>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int r0, int c0, int lane) {
  return base + Swizzle<DP>::offset(r0 + ((lane >> 3) & 1) * 8 + (lane & 7), c0 + (lane >> 4));
}

// Rows [row0, row0 + ROWS) of one head's bf16 rows (n_rows of them,
// `stride` elements apart) into the swizzled (ROWS, DP) tile; rows past
// n_rows and columns past d are zero.  With vec (d % 8 == 0 and 16-byte
// aligned rows) by cp.async, which the caller commits and waits for;
// otherwise by plain element loads.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* __restrict__ src,
                                          long long stride, int row0, int n_rows, int d,
                                          bool vec) {
  using S = Swizzle<DP>;
  if (vec) {
    const uint32_t base = smem_addr(tile);
    for (int i = threadIdx.x; i < ROWS * S::kChunks; i += THREADS) {
      const int r = i / S::kChunks;
      const int c = i % S::kChunks;
      const int row = row0 + r;
      const bool ok = row < n_rows && c * 8 < d;
      cp_async_16(base + S::offset(r, c), ok ? src + row * stride + c * 8 : src, ok);
    }
    return;
  }
  char* bytes = reinterpret_cast<char*>(tile);
  for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
    const int r = i / DP;
    const int col = i % DP;
    const int row = row0 + r;
    const __nv_bfloat16 v =
        (row < n_rows && col < d) ? src[row * stride + col] : __float2bfloat16(0.0f);
    *reinterpret_cast<__nv_bfloat16*>(bytes + S::offset(r, col / 8) + (col % 8) * 2) = v;
  }
}

// One head's rows [row0 + 16 warp, +16) of the float32 C tiles acc (DP / 8
// blocks of 8 columns) into dst (n_rows rows, `stride` elements apart, d
// columns), rounded to bf16; a column pair whose address is 4-byte aligned
// in one store.
template <int DP>
__device__ __forceinline__ void store_tc_rows(__nv_bfloat16* __restrict__ dst, long long stride,
                                              const float (&acc)[DP / 8][4], int row0,
                                              int n_rows, int d, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= n_rows) continue;
    __nv_bfloat16* out = dst + row * stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col + 1 < d && reinterpret_cast<uintptr_t>(out + col) % 4 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        if (col < d) out[col] = __float2bfloat16(acc[j][2 * half]);
        if (col + 1 < d) out[col + 1] = __float2bfloat16(acc[j][2 * half + 1]);
      }
    }
  }
}

// The tensor-core kernels: the shared memory they need as their maximum
// and all of it as the SM's carveout (two blocks an SM where they fit),
// then the launch of THREADS threads a block and cudaGetLastError();
// returns the CUDA error code (0 = launched).
template <int THREADS = kTcThreads, typename Kernel, typename... Args>
int launch_tc(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Whether every row of a strided tensor of `item`-byte elements starts
// 16-byte aligned (cp.async); else the kernels stage it with element loads.
inline bool rows_aligned(const void* p, const Rows& s, int item) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.batch * item) % 16 == 0 &&
         (s.head * item) % 16 == 0 && (s.row * item) % 16 == 0;
}

// The 3xTF32 operands of m16n8k8 from float32 values, and the product.
// Inside each 8-wide step of a contraction, mma index t stands for the
// step's element 2t and t + 4 for 2t + 1 (any order of a sum's terms gives
// the same product): so A's a[0], a[2] are one row's neighbours 2t, 2t + 1,
// B's b0, b1 one column's, one 8-byte read each, and a C tile's (c[0],
// c[2], c[1], c[3]) is the A operand of the next product over its columns.
struct A3 {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ A3(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

struct B3 {
  uint32_t hi0, hi1, lo0, lo1;
  __device__ __forceinline__ B3(float b0, float b1) {
    split_tf32(b0, hi0, lo0);
    split_tf32(b1, hi1, lo1);
  }
};

__device__ __forceinline__ void mma3(float (&c)[4], const A3& a, const B3& b) {
  mma_tf32(c, a.lo, b.hi0, b.hi1);
  mma_tf32(c, a.hi, b.lo0, b.lo1);
  mma_tf32(c, a.hi, b.hi0, b.hi1);
}

// the same with the two small terms in their own sums, so a long
// contraction is two chains of dependent mma, not one
__device__ __forceinline__ void mma3(float (&c)[4], float (&small)[4], const A3& a, const B3& b) {
  mma_tf32(small, a.lo, b.hi0, b.hi1);
  mma_tf32(small, a.hi, b.lo0, b.lo1);
  mma_tf32(c, a.hi, b.hi0, b.hi1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + ROWS) of one head's float32 rows (n_rows of them,
// `stride` elements apart) into a shared tile of row stride STRIDE floats
// by cp.async, which the caller commits and waits for; rows past n_rows and
// columns past d are zero.  16-byte copies with vec (d % 4 == 0 and 16-byte
// aligned rows), else 4-byte ones.
template <int ROWS, int DP, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_f32_rows(float* tile, const float* __restrict__ src,
                                               long long stride, int row0, int n_rows, int d,
                                               int vec) {
  static_assert(STRIDE % 4 == 0, "16-byte aligned shared rows");
  const uint32_t base = smem_addr(tile);
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (DP / 4); i += THREADS) {
      const int r = i / (DP / 4);
      const int c = 4 * (i % (DP / 4));
      const int row = row0 + r;
      const bool ok = row < n_rows && c < d;
      cp_async_16(base + 4 * (r * STRIDE + c), ok ? src + row * stride + c : src, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
    const int r = i / DP;
    const int c = i % DP;
    const int row = row0 + r;
    const bool ok = row < n_rows && c < d;
    cp_async_4(base + 4 * (r * STRIDE + c), ok ? src + row * stride + c : src, ok);
  }
}

}  // namespace flash
