// Flash-attention backward for Hopper (sm_90a): the dQ and the dK/dV kernel,
// and the two fused into one for float32 at short key lengths.
//
// Replace the TPU kernels pytorch_distributed_rnn_tpu/ops/pallas_attention.py:
// _dq_kernel (flash_dq) and _dkv_kernel (flash_dkv), both launched by
// _bwd_impl, and for float32 at Tk <= 128, D <= 64 both of them and
// _delta_of (flash_dqkv).  All recompute the probabilities from the
// forward's row logsumexp instead of storing them:
//   p  = exp(q . k^T * scale - lse), 0 where masked or not finite
//   dp = dO . v^T,  ds = p * (dp - delta) * scale   (delta = rowsum(dO * o))
//   flash_dq:  dQ = ds . K            (ds cast to k's dtype first)
//   flash_dkv: dV = p^T . dO,  dK = ds^T . Q
//              (p cast to dO's dtype, ds to q's dtype first)
// JAX's split is kept: a dQ pass over key tiles per query tile, and a dK/dV
// pass over query tiles per key tile, so every output element is owned by
// one block: no atomics, and the results do not change from run to run.
// Tiles wholly above the causal diagonal are never visited (key_end,
// q_begin); the ragged T edge and the head-dim padding are masked in the
// kernels, not padded in device memory.  Every q-side and k-side tensor is
// read and written through its (batch, head, row) strides
// (flash_common.cuh: Rows), so the gradients land in the layout of the
// tensors they belong to, the model's (B, T, H, D) views included.
//
// What bounds them on an H100 SXM: operations.  At the long-context shape
// (BH = 64, T = 1024, D = 128, bf16) dQ does 6 BH T^2 D = 51.5 GFLOP and
// dK/dV 8 BH T^2 D = 68.7 GFLOP, 52 and 69 us at 989 TFLOP/s on the tensor
// cores, against 84 and 101 MB of traffic (25 and 30 us at 3.35 TB/s).  At
// the attention classifier's CLI shape (BH = 1024, T = 128, D = 32, f32):
// 3.22 and 4.29 GFLOP, 48 and 64 us at 67 TFLOP/s of float32, against
// 84.9 and 102 MB (25 and 30 us).
//
// bfloat16 (flash_dq_tc_kernel, flash_dkv_tc_kernel): every product on the
// tensor cores, mma.sync m16n8k16 bf16 -> float32 (csrc/flash_mma.cuh).
// 128 threads, four warps, each owning 16 rows of the block's 64-row tile
// (queries in dQ, keys in dK/dV) and walking the other side's 64-row tiles
// in 32-row chunks.  The warp's S and dP (dQ), or S^T and dP^T (dK/dV),
// come out as C tiles; p and ds are formed in those registers, each
// element's (query, key) taken from its lane position for the masks, and
// rounded to bf16 as the A operand of the next product (the TPU kernel's
// casts), so p and ds never touch shared memory.  The fixed tile (Q and dO,
// or K and V) stays in shared memory; the walked tiles arrive through a
// two-stage cp.async ring, tile i + 1 loading while tile i computes, into
// XOR-swizzled bf16 tiles that ldmatrix reads without bank conflicts (with
// .trans where the tile is the contraction side).  dQ keeps its Q and dO
// rows as A operands and dQ in registers; dK/dV keeps dK and dV in
// registers and reads its K and V rows again for every chunk.  96 KB of
// shared memory at D = 128, two blocks an SM.  What is left on the table:
// each ldmatrix feeds two mma.sync (one warp's 16 rows), where wgmma with
// TMA-fed tiles would feed a 64-row warpgroup.
//
// float32 beyond flash_dqkv's range (flash_dq_kernel, flash_dkv_kernel, on
// no main path): on the CUDA cores in float32, 256 threads, 64 x 64 tiles
// staged in shared memory as float32 (row stride DP + 1), each thread owning
// a 4 x 4 score micro tile and 4 x DP/16 output columns; the score and dp
// products share one pass over the head dim; ds (and p) go through shared
// memory for the second product.  dQ holds Q, dO, K, V and ds (149 KB at
// D = 128); dK/dV holds K, V, Q, dO, p^T, ds^T and the tile's lse and delta
// (166 KB), with dK and dV accumulating in registers.
//
// float32 at Tq, Tk <= 128 and D <= 64 (flash_dqkv_tc_kernel, the attention
// classifier's backward at BH = 1024, T = 128, D = 32): the split pair
// forms S and dP twice (7 products where 5 do), reads Q, K, V and dO twice,
// feeds its CUDA-core products with scalar shared-memory reads (about 3
// loads for 4 FMAs), and needs delta from a torch pass over O and dO.  Here
// one block of 8 warps owns a head: its K and V stay in shared memory, warp
// w owns keys 16w .. 16w + 15 and their dK and dV in registers, and the
// block walks the queries in chunks of 32, forming delta, S and dP once per
// (query, key), writing dQ per chunk and dK, dV once (no atomics, the same
// bits every run).  The products run on the tensor cores as 3xTF32
// (mma.sync m16n8k8: each float32 operand split into a TF32 high part and
// the rest, three TF32 products a product, float32 sums), which keeps
// float32's accuracy; on the CUDA cores the same products wait on
// shared-memory reads (16 bytes for every 8 FMAs with 4 x 4 register
// tiles).  p and ds go from the S^T and dP^T C tiles straight into the A
// operands of dV and dK; dS also goes through shared memory for dQ.  Bound at the CLI shape:
// 135 MB moved (40 us at 3.35 TB/s) against 5 products as three TF32
// products each, 16.1 GFLOP (33 us at the tensor cores' 495 TFLOP/s), so
// bytes bound.  108 KB of shared memory at D = 32: two blocks an SM.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

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

template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, long long stride,
                                           const float (&acc)[kRows][HeadDim<DP>::kCols],
                                           int row0, int n_rows, int d, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + ty * kRows + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < HeadDim<DP>::kCols; ++c) {
      const int col = tx + kTx * c;
      if (col < d) dst[row * stride + col] = acc[r][c];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, Rows qs, const float* __restrict__ k, Rows ks,
                    const float* __restrict__ v, Rows vs, const float* __restrict__ d_o,
                    Rows dos, const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Rows dqs, int heads, int t_q, int t_k, int d,
                    float scale, int causal, int q_off, int k_off) {
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
  const size_t q_base = (size_t)bh * t_q;  // lse, delta
  const float* k_h = head_rows(k, ks, bh, heads);
  const float* v_h = head_rows(v, vs, bh, heads);

  stage_tile<DP>(head_rows(q, qs, bh, heads), qs.row, q0, t_q, d, q_s, kBlockM);
  stage_tile<DP>(head_rows(d_o, dos, bh, heads), dos.row, q0, t_q, d, do_s, kBlockM);
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
    stage_tile<DP>(k_h, ks.row, k0, t_k, d, k_s, kBlockN);
    stage_tile<DP>(v_h, vs.row, k0, t_k, d, v_s, kBlockN);
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
        ds_s[row * kScoreStride + tx + kTx * j] = ds;
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
  store_rows<DP>(head_rows(dq, dqs, bh, heads), dqs.row, acc, q0, t_q, d, ty, tx);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, Rows qs, const float* __restrict__ k, Rows ks,
                     const float* __restrict__ v, Rows vs, const float* __restrict__ d_o,
                     Rows dos, const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, Rows dks, float* __restrict__ dv, Rows dvs,
                     int heads, int t_q, int t_k, int d, float scale, int causal, int q_off,
                     int k_off) {
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
  const size_t q_base = (size_t)bh * t_q;  // lse, delta
  const float* q_h = head_rows(q, qs, bh, heads);
  const float* do_h = head_rows(d_o, dos, bh, heads);

  stage_tile<DP>(head_rows(k, ks, bh, heads), ks.row, k0, t_k, d, k_s, kBlockN);
  stage_tile<DP>(head_rows(v, vs, bh, heads), vs.row, k0, t_k, d, v_s, kBlockN);
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
    stage_tile<DP>(q_h, qs.row, q0, t_q, d, q_s, kBlockM);
    stage_tile<DP>(do_h, dos.row, q0, t_q, d, do_s, kBlockM);
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
        pt_s[key * kScoreStride + col] = p;
        dst_s[key * kScoreStride + col] = ds;
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
  store_rows<DP>(head_rows(dk, dks, bh, heads), dks.row, dk_acc, k0, t_k, d, ty, tx);
  store_rows<DP>(head_rows(dv, dvs, bh, heads), dvs.row, dv_acc, k0, t_k, d, ty, tx);
}

// p = exp(s * scale - lse) of a visible score, else 0; not finite (a row
// with lse = -inf) gives 0 too.  s_log2 = s * scale * log2(e), lse_log2 =
// lse * log2(e).
__device__ __forceinline__ float recompute_p_log2(float s_log2, float lse_log2, bool ok) {
  const float p = ok ? exp2f(s_log2 - lse_log2) : 0.0f;
  return isfinite(p) ? p : 0.0f;
}

// ---------------------------------------------------------------------------
// float32 at short key lengths: dQ, dK, dV and delta in one block a head,
// on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kDqkvMaxKeys = 128;    // a head's keys, all in shared memory
constexpr int kDqkvMaxHeadDim = 64;
constexpr int kChunkRows = 32;       // queries a chunk
constexpr int kDsStride = kDqkvMaxKeys + 8;  // dS rows: 8 banks apart
constexpr int kDqParts = 4;  // dQ: the keys split in quarters over the warps

template <int DP>
struct Dqkv {
  static_assert(DP == 16 || DP == 32 || DP == 64, "padded head dim");
  // K, V, Q, dO and O rows 8 banks apart: a half-warp's 8-byte reads of
  // (row g, columns 2t, 2t + 1) are free of bank conflicts
  static constexpr int kStride = DP + 8;
  static constexpr int kVecs = DP / 4;                // 16-byte chunks a row
  static constexpr int kSteps = DP / 8;               // 8-wide steps of the head dim
  static constexpr int kMinBlocks = DP <= 32 ? 2 : 1;  // blocks an SM (registers <= 128)
};

// K, V; Q, dO and O in two stages; dS; dQ's partial sums; lse in two
// stages and delta of the chunk
template <int DP>
size_t dqkv_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * kDqkvMaxKeys + 6 * kChunkRows) * Dqkv<DP>::kStride +
                          kChunkRows * kDsStride + kDqParts * kChunkRows * (DP + 4) +
                          3 * kChunkRows);
}

// dQ, dK and dV of one head (blockIdx.x) of Tq, Tk <= 128, its keys in
// shared memory for the whole launch.  The block walks the queries in
// chunks of 32, Q, dO, O and lse of chunk c + 1 arriving by cp.async while
// chunk c computes.  Warp w owns keys 16w .. 16w + 15 and their dK, dV C
// tiles.  Per chunk:
//   1. delta = rowsum(dO * O) of the chunk's rows (8 lanes a row);
//   2. each warp: S^T = K_w Q^T and dP^T = V_w dO^T (four 16 x 8 C tiles
//      each), p^T and ds^T in those registers, ds^T also stored to shared
//      memory as dS; dV += P^T dO and dK += dS^T Q with P^T and dS^T as A
//      operands straight from the C tiles;
//   3. dQ = dS K for the chunk: warp w sums 16 queries by all columns over
//      a quarter of the keys (each A operand split once for DP / 8
//      products), the quarters are added in shared memory in a fixed order
//      and stored to device memory in 16-byte rows.
// Every output element has one writer and a fixed order of sums: no
// atomics, and two launches give the same bits.  Warps whose keys lie
// wholly past the chunk's last visible key skip their products.
template <int DP>
__global__ void __launch_bounds__(kThreads, Dqkv<DP>::kMinBlocks)
    flash_dqkv_tc_kernel(const float* __restrict__ q, Rows qs, const float* __restrict__ k,
                         Rows ks, const float* __restrict__ v, Rows vs,
                         const float* __restrict__ o, Rows os, const float* __restrict__ d_o,
                         Rows dos, const float* __restrict__ lse, float* __restrict__ dq,
                         Rows dqs, float* __restrict__ dk, Rows dks, float* __restrict__ dv,
                         Rows dvs, int heads, int t_q, int t_k, int d, float scale, int causal,
                         int q_off, int k_off, int vec) {
  using C = Dqkv<DP>;
  constexpr int S = C::kStride;
  constexpr int KS = C::kSteps;
  constexpr int kTile = kChunkRows * S;
  extern __shared__ float smem[];
  float* k_s = smem;                          // (128, S)
  float* v_s = k_s + kDqkvMaxKeys * S;        // (128, S)
  float* q_s = v_s + kDqkvMaxKeys * S;        // two stages of (32, S)
  float* do_s = q_s + 2 * kTile;              // two stages
  float* o_s = do_s + 2 * kTile;              // two stages
  float* ds_s = o_s + 2 * kTile;              // (32, kDsStride)
  float* part_s = ds_s + kChunkRows * kDsStride;  // (kDqParts, 32, DP + 4)
  float* lse_s = part_s + kDqParts * kChunkRows * (DP + 4);  // two stages of (32)
  float* delta_s = lse_s + 2 * kChunkRows;       // (32)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr = 16 * warp;  // the warp's keys
  const int bh = blockIdx.x;
  const size_t q_base = (size_t)bh * t_q;  // lse
  const float* q_h = head_rows(q, qs, bh, heads);
  const float* do_h = head_rows(d_o, dos, bh, heads);
  const float* o_h = head_rows(o, os, bh, heads);
  const int n_chunks = (t_q + kChunkRows - 1) / kChunkRows;
  const float scale_log2 = scale * kLog2e;

  auto stage_chunk = [&](int c) {
    const int st = c & 1;
    const int row0 = c * kChunkRows;
    stage_f32_rows<kChunkRows, DP, S, kThreads>(q_s + st * kTile, q_h, qs.row, row0, t_q, d, vec);
    stage_f32_rows<kChunkRows, DP, S, kThreads>(do_s + st * kTile, do_h, dos.row, row0, t_q, d,
                                                vec);
    stage_f32_rows<kChunkRows, DP, S, kThreads>(o_s + st * kTile, o_h, os.row, row0, t_q, d, vec);
    if (threadIdx.x < kChunkRows) {
      const bool ok = row0 + threadIdx.x < t_q;
      cp_async_4(smem_addr(lse_s + st * kChunkRows + threadIdx.x),
                 ok ? lse + q_base + row0 + threadIdx.x : lse, ok);
    }
  };
  stage_f32_rows<kDqkvMaxKeys, DP, S, kThreads>(k_s, head_rows(k, ks, bh, heads), ks.row, 0, t_k,
                                                d, vec);
  stage_f32_rows<kDqkvMaxKeys, DP, S, kThreads>(v_s, head_rows(v, vs, bh, heads), vs.row, 0, t_k,
                                                d, vec);
  stage_chunk(0);
  cp_async_commit();

  float dk_acc[KS][4], dv_acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int q0 = chunk * kChunkRows;
    cp_async_wait<0>();
    __syncthreads();  // the chunk has landed; every thread is done with the last one
    if (chunk + 1 < n_chunks) stage_chunk(chunk + 1);
    cp_async_commit();
    const int st = chunk & 1;
    const float* qc = q_s + st * kTile;
    const float* doc = do_s + st * kTile;
    const float* lc = lse_s + st * kChunkRows;
    const int k_end = key_end(q0, t_q, t_k, causal, q_off, k_off, kChunkRows);

    // 1. delta of row threadIdx.x / 8, its columns split over 8 lanes
    {
      const int row = threadIdx.x / 8;
      const float* a = doc + row * S;
      const float* b = o_s + st * kTile + row * S;
      float part = 0.0f;
#pragma unroll
      for (int c = threadIdx.x % 8; c < DP; c += 8) part = fmaf(a[c], b[c], part);
#pragma unroll
      for (int m = 1; m < 8; m *= 2) part += __shfl_xor_sync(0xffffffffu, part, m);
      if (threadIdx.x % 8 == 0) delta_s[row] = part;
    }
    __syncthreads();  // delta of the chunk

    // 2. the warp's 16 keys against the chunk's 32 queries (4 n-tiles)
    if (kr < k_end) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int col = 8 * ks + 2 * t;
        const float2 k0 = ld2(k_s + (kr + g) * S + col), k1 = ld2(k_s + (kr + g + 8) * S + col);
        const float2 v0 = ld2(v_s + (kr + g) * S + col), v1 = ld2(v_s + (kr + g + 8) * S + col);
        const A3 ka(k0.x, k1.x, k0.y, k1.y);
        const A3 va(v0.x, v1.x, v0.y, v1.y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 qv = ld2(qc + (8 * j + g) * S + col);
          const float2 ov = ld2(doc + (8 * j + g) * S + col);
          mma3(s[j], ka, B3(qv.x, qv.y));
          mma3(dp[j], va, B3(ov.x, ov.y));
        }
      }
      // p^T and ds^T in place: element e of tile j is (key kr + g + 8 (e >> 1),
      // query q0 + 8 j + 2 t + (e & 1))
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const int key = kr + g + 8 * (e >> 1);
          const bool ok = visible(q0 + qi, key, t_q, t_k, causal, q_off, k_off);
          const float p = recompute_p_log2(s[j][e] * scale_log2, lc[qi] * kLog2e, ok);
          const float ds = p * (dp[j][e] - delta_s[qi]) * scale;
          s[j][e] = p;
          dp[j][e] = ds;
          ds_s[qi * kDsStride + key] = ds;
        }
      }
      // dV += P^T dO and dK += dS^T Q: k-step j is the chunk's queries 8 j ..
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const A3 pa(s[j][0], s[j][2], s[j][1], s[j][3]);
        const A3 sa(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
        const float* o0 = doc + (8 * j + 2 * t) * S + g;
        const float* q0r = qc + (8 * j + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          mma3(dv_acc[n], pa, B3(o0[8 * n], o0[8 * n + S]));
          mma3(dk_acc[n], sa, B3(q0r[8 * n], q0r[8 * n + S]));
        }
      }
    }
    __syncthreads();  // dS of the chunk

    // 3. dQ of the chunk: warp w sums queries 16 (w % 2) .. + 15, all
    // columns, over the keys 32 (w / 2) .. + 31 of its quarter; the four
    // quarters' partial sums are added in shared memory in a fixed order
    {
      constexpr int P = DP + 4;  // partial rows: 4 banks apart
      const int m = 16 * (warp % 2);
      const int k0 = 32 * (warp / 2);
      float acc[KS][4] = {}, small[KS][4] = {};
      const int k1 = min(k0 + 32, (max(k_end, 0) + 7) / 8 * 8);  // dS is 0 from there on
      for (int kk = k0; kk < k1; kk += 8) {
        const float2 a0 = ld2(ds_s + (m + g) * kDsStride + kk + 2 * t);
        const float2 a1 = ld2(ds_s + (m + g + 8) * kDsStride + kk + 2 * t);
        const A3 a(a0.x, a1.x, a0.y, a1.y);
        const float* kb = k_s + (kk + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KS; ++n) mma3(acc[n], small[n], a, B3(kb[8 * n], kb[8 * n + S]));
      }
      float* part = part_s + (warp / 2) * kChunkRows * P;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<float2*>(part + (m + g) * P + col) =
            make_float2(acc[n][0] + small[n][0], acc[n][1] + small[n][1]);
        *reinterpret_cast<float2*>(part + (m + g + 8) * P + col) =
            make_float2(acc[n][2] + small[n][2], acc[n][3] + small[n][3]);
      }
      __syncthreads();  // the partial sums
      for (int i = threadIdx.x; i < kChunkRows * C::kVecs; i += kThreads) {
        const int r = i / C::kVecs;
        const int c = 4 * (i % C::kVecs);
        float4 sum = ld4(part_s + r * P + c);
#pragma unroll
        for (int h = 1; h < kDqParts; ++h) {
          const float4 x = ld4(part_s + (h * kChunkRows + r) * P + c);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        const int row = q0 + r;
        if (row >= t_q || c >= d) continue;
        float* out = head_rows(dq, dqs, bh, heads) + row * dqs.row + c;
        if (vec) {
          *reinterpret_cast<float4*>(out) = sum;
        } else {
          out[0] = sum.x;
          if (c + 1 < d) out[1] = sum.y;
          if (c + 2 < d) out[2] = sum.z;
          if (c + 3 < d) out[3] = sum.w;
        }
      }
    }
  }
  cp_async_wait<0>();
  float* dk_h = head_rows(dk, dks, bh, heads);
  float* dv_h = head_rows(dv, dvs, bh, heads);
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kr + g + 8 * (e >> 1);
      const int col = 8 * n + 2 * t + (e & 1);
      if (key < t_k && col < d) {
        dk_h[key * dks.row + col] = dk_acc[n][e];
        dv_h[key * dvs.row + col] = dv_acc[n][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;  // rows of the walked tile per pass

template <int DP>
constexpr size_t tile_bytes() {
  return (size_t)kBlockM * DP * sizeof(bf16);
}

// Q, dO, then K and V twice (the ring)
template <int DP>
size_t dq_tc_smem_bytes() {
  return 6 * tile_bytes<DP>();
}

// K, V, then Q, dO, lse, delta twice
template <int DP>
size_t dkv_tc_smem_bytes() {
  return 6 * tile_bytes<DP>() + 2 * 2 * kBlockM * sizeof(float);
}

// dQ of one (head, 64-query tile).  Warp w owns queries q0 + 16w..+15: its
// Q and dO rows are A operands held in registers, its dQ C tiles too.  Per
// 32-key chunk: S = Q_w . K^T and dP = dO_w . V^T (4 C tiles each), dS in
// those registers, then dQ += dS . K with K read transposed.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_dq_tc_kernel(const bf16* __restrict__ q, Rows qs, const bf16* __restrict__ k, Rows ks,
                       const bf16* __restrict__ v, Rows vs, const bf16* __restrict__ d_o,
                       Rows dos, const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, Rows dqs, int heads, int t_q, int t_k, int d,
                       float scale, int causal, int q_off, int k_off, int vec) {
  constexpr int KS = DP / 16;  // k-steps over the head dim
  constexpr int NT = DP / 8;   // 8-column blocks of the head dim
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* do_s = q_s + kBlockM * DP;
  bf16* k_s = do_s + kBlockM * DP;      // two stages
  bf16* v_s = k_s + 2 * kBlockN * DP;   // two stages

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* k_h = head_rows(k, ks, bh, heads);
  const bf16* v_h = head_rows(v, vs, bh, heads);
  const size_t q_base = (size_t)bh * t_q;  // lse, delta

  const int k_end = key_end(q0, t_q, t_k, causal, q_off, k_off);
  const int n_tiles = k_end > 0 ? (k_end + kBlockN - 1) / kBlockN : 0;

  load_tile<kBlockM, DP, kTcThreads>(q_s, head_rows(q, qs, bh, heads), qs.row, q0, t_q, d, vec);
  load_tile<kBlockM, DP, kTcThreads>(do_s, head_rows(d_o, dos, bh, heads), dos.row, q0, t_q, d,
                                     vec);
  if (n_tiles > 0) {
    load_tile<kBlockN, DP, kTcThreads>(k_s, k_h, ks.row, 0, t_k, d, vec);
    load_tile<kBlockN, DP, kTcThreads>(v_s, v_h, vs.row, 0, t_k, d, vec);
  }
  cp_async_commit();

  // the thread's two query rows: g and g + 8 of the warp's 16
  const int qr = q0 + 16 * warp + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qr + 8 * h;
    lse2[h] = qi < t_q ? lse[q_base + qi] * kLog2e : 0.0f;
    dlt[h] = qi < t_q ? delta[q_base + qi] : 0.0f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  uint32_t qa[KS][4], doa[KS][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockN;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      load_tile<kBlockN, DP, kTcThreads>(k_s + nxt * kBlockN * DP, k_h, ks.row, k0 + kBlockN,
                                         t_k, d, vec);
      load_tile<kBlockN, DP, kTcThreads>(v_s + nxt * kBlockN * DP, v_h, vs.row, k0 + kBlockN,
                                         t_k, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and Q, dO) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        ldmatrix_x4(qa[s], a_addr<DP>(smem_addr(q_s), 16 * warp, s, lane));
        ldmatrix_x4(doa[s], a_addr<DP>(smem_addr(do_s), 16 * warp, s, lane));
      }
    }
    const uint32_t kt = smem_addr(k_s + (it & 1) * kBlockN * DP);
    const uint32_t vt = smem_addr(v_s + (it & 1) * kBlockN * DP);

#pragma unroll 1
    for (int kc = 0; kc < kBlockN; kc += kChunk) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, b_addr<DP>(kt, kc + 16 * np, ks, lane));
          ldmatrix_x4(vb, b_addr<DP>(vt, kc + 16 * np, ks, lane));
          mma_bf16(s[2 * np], qa[ks], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[ks], kb[2], kb[3]);
          mma_bf16(dp[2 * np], doa[ks], vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], doa[ks], vb[2], vb[3]);
        }
      }
      // ds = p (dp - delta) scale, in place of s
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kj = k0 + kc + 8 * j + 2 * t + (e & 1);
          const bool ok = visible(qr + 8 * h, kj, t_q, t_k, causal, q_off, k_off);
          const float p = recompute_p_log2(s[j][e] * scale_log2, lse2[h], ok);
          s[j][e] = p * (dp[j][e] - dlt[h]) * scale;
        }
      }
      uint32_t dsa[2][4];
      c_to_a(s, dsa);
      // dQ += dS . K (K transposed: its keys are the contraction)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, bt_addr<DP>(kt, kc + 16 * h, 2 * np, lane));
          mma_bf16(acc[2 * np], dsa[h], kb[0], kb[1]);
          mma_bf16(acc[2 * np + 1], dsa[h], kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // stage it & 1 is read: the next iteration refills it
  }
  cp_async_wait<0>();
  store_tc_rows<DP>(head_rows(dq, dqs, bh, heads), dqs.row, acc, q0 + 16 * warp, t_q, d, lane);
}

// dK and dV of one (head, 64-key tile).  Warp w owns keys k0 + 16w..+15 and
// their dK and dV C tiles.  Per 32-query chunk: S^T = K_w . Q^T and
// dP^T = V_w . dO^T (4 C tiles each), p^T and ds^T in those registers, then
// dV += P^T . dO and dK += dS^T . Q with dO and Q read transposed.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_dkv_tc_kernel(const bf16* __restrict__ q, Rows qs, const bf16* __restrict__ k, Rows ks,
                        const bf16* __restrict__ v, Rows vs, const bf16* __restrict__ d_o,
                        Rows dos, const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, Rows dks, bf16* __restrict__ dv, Rows dvs,
                        int heads, int t_q, int t_k, int d, float scale, int causal, int q_off,
                        int k_off, int vec) {
  constexpr int KS = DP / 16;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* v_s = k_s + kBlockN * DP;
  bf16* q_s = v_s + kBlockN * DP;       // two stages
  bf16* do_s = q_s + 2 * kBlockM * DP;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBlockM * DP);  // (2, kBlockM)
  float* delta_s = lse_s + 2 * kBlockM;                              // (2, kBlockM)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* q_h = head_rows(q, qs, bh, heads);
  const bf16* do_h = head_rows(d_o, dos, bh, heads);
  const float* lse_h = lse + (size_t)bh * t_q;
  const float* delta_h = delta + (size_t)bh * t_q;

  // the first query tile with a query on or below the diagonal of this key
  // tile's first key; earlier tiles are wholly above it
  const int q_begin = causal ? max(0, k0 + k_off - q_off) / kBlockM * kBlockM : 0;
  const int n_tiles = q_begin < t_q ? (t_q - q_begin + kBlockM - 1) / kBlockM : 0;

  // Q, dO, lse and delta of the query tile at q0 into stage st
  auto load_queries = [&](int st, int q0) {
    load_tile<kBlockM, DP, kTcThreads>(q_s + st * kBlockM * DP, q_h, qs.row, q0, t_q, d, vec);
    load_tile<kBlockM, DP, kTcThreads>(do_s + st * kBlockM * DP, do_h, dos.row, q0, t_q, d, vec);
    const int i = threadIdx.x % kBlockM;
    const bool in = q0 + i < t_q;
    const float* src = threadIdx.x < kBlockM ? lse_h : delta_h;
    float* dst = (threadIdx.x < kBlockM ? lse_s : delta_s) + st * kBlockM + i;
    cp_async_4(smem_addr(dst), in ? src + q0 + i : src, in);
  };

  load_tile<kBlockN, DP, kTcThreads>(k_s, head_rows(k, ks, bh, heads), ks.row, k0, t_k, d, vec);
  load_tile<kBlockN, DP, kTcThreads>(v_s, head_rows(v, vs, bh, heads), vs.row, k0, t_k, d, vec);
  if (n_tiles > 0) load_queries(0, q_begin);
  cp_async_commit();

  // the thread's two keys: g and g + 8 of the warp's 16
  const int kr = k0 + 16 * warp + g;
  const float scale_log2 = scale * kLog2e;
  const uint32_t ka_base = smem_addr(k_s);
  const uint32_t va_base = smem_addr(v_s);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kBlockM;
    if (it + 1 < n_tiles) load_queries((it + 1) & 1, q0 + kBlockM);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and K, V) have landed
    __syncthreads();
    const int st = it & 1;
    const uint32_t qt = smem_addr(q_s + st * kBlockM * DP);
    const uint32_t dot = smem_addr(do_s + st * kBlockM * DP);
    const float* ls = lse_s + st * kBlockM;
    const float* dl = delta_s + st * kBlockM;

#pragma unroll 1
    for (int qc = 0; qc < kBlockM; qc += kChunk) {
      float s[4][4], dp[4][4];  // transposed: rows are keys, columns queries
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, a_addr<DP>(ka_base, 16 * warp, ks, lane));
        ldmatrix_x4(va, a_addr<DP>(va_base, 16 * warp, ks, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, b_addr<DP>(qt, qc + 16 * np, ks, lane));
          ldmatrix_x4(ob, b_addr<DP>(dot, qc + 16 * np, ks, lane));
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * np], va, ob[0], ob[1]);
          mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // p^T in place of s, ds^T in place of dp
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = qc + 8 * j + 2 * t;  // the query in the tile of c[0], c[2]
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 dd = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kr + 8 * (e >> 1);
          const bool ok = visible(q0 + col + (e & 1), key, t_q, t_k, causal, q_off, k_off);
          const float p = recompute_p_log2(s[j][e] * scale_log2,
                                           ((e & 1) ? l2.y : l2.x) * kLog2e, ok);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? dd.y : dd.x)) * scale;
        }
      }
      uint32_t pa[2][4], dsa[2][4];
      c_to_a(s, pa);
      c_to_a(dp, dsa);
      // dV += P^T . dO and dK += dS^T . Q (dO and Q transposed: their
      // queries are the contraction)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, bt_addr<DP>(dot, qc + 16 * h, 2 * np, lane));
          ldmatrix_x4_trans(qb, bt_addr<DP>(qt, qc + 16 * h, 2 * np, lane));
          mma_bf16(dv_acc[2 * np], pa[h], ob[0], ob[1]);
          mma_bf16(dv_acc[2 * np + 1], pa[h], ob[2], ob[3]);
          mma_bf16(dk_acc[2 * np], dsa[h], qb[0], qb[1]);
          mma_bf16(dk_acc[2 * np + 1], dsa[h], qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // stage it & 1 is read: the next iteration refills it
  }
  cp_async_wait<0>();
  store_tc_rows<DP>(head_rows(dk, dks, bh, heads), dks.row, dk_acc, k0 + 16 * warp, t_k, d,
                    lane);
  store_tc_rows<DP>(head_rows(dv, dvs, bh, heads), dvs.row, dv_acc, k0 + 16 * warp, t_k, d,
                    lane);
}

// ---------------------------------------------------------------------------
// launchers: float32 on the CUDA cores (split) or the tensor cores (fused),
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

// the Rows of the strided tensors, in the order of the C entry's pointers
struct Layouts {
  Rows q, k, v, d_o, out1, out2;  // dQ (out1), or dK and dV (out1, out2)
};

Layouts layouts(const long long* strides, bool two_outputs) {
  return {rows_at(strides, 0), rows_at(strides, 1), rows_at(strides, 2), rows_at(strides, 3),
          rows_at(strides, 4), two_outputs ? rows_at(strides, 5) : Rows{0, 0, 0}};
}

int launch_dq_f32(const void* q, const void* k, const void* v, const void* d_o,
                  const void* lse, const void* delta, void* dq, const Layouts& s, int bh,
                  int heads, int t_q, int t_k, int d, float scale, int causal, int q_off,
                  int k_off, cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_kernel(flash_dq_kernel<DP>, grid, dq_smem_bytes<DP>(), stream,
                         static_cast<const float*>(q), s.q, static_cast<const float*>(k), s.k,
                         static_cast<const float*>(v), s.v, static_cast<const float*>(d_o), s.d_o,
                         static_cast<const float*>(lse), static_cast<const float*>(delta),
                         static_cast<float*>(dq), s.out1, heads, t_q, t_k, d, scale, causal,
                         q_off, k_off);
  });
}

// cp.async tiles where d fills whole 16-byte chunks and every row of q, k,
// v and dO starts 16-byte aligned
bool bf16_vec(int d, const void* q, const void* k, const void* v, const void* d_o,
              const Layouts& s) {
  return d % 8 == 0 && rows_aligned(q, s.q, 2) && rows_aligned(k, s.k, 2) &&
         rows_aligned(v, s.v, 2) && rows_aligned(d_o, s.d_o, 2);
}

int launch_dq_bf16(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, void* dq, const Layouts& s, int bh,
                   int heads, int t_q, int t_k, int d, float scale, int causal, int q_off,
                   int k_off, cudaStream_t stream) {
  const int vec = bf16_vec(d, q, k, v, d_o, s);
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_tc(flash_dq_tc_kernel<DP>, grid, dq_tc_smem_bytes<DP>(), stream,
                     static_cast<const bf16*>(q), s.q, static_cast<const bf16*>(k), s.k,
                     static_cast<const bf16*>(v), s.v, static_cast<const bf16*>(d_o), s.d_o,
                     static_cast<const float*>(lse), static_cast<const float*>(delta),
                     static_cast<bf16*>(dq), s.out1, heads, t_q, t_k, d, scale, causal, q_off,
                     k_off, vec);
  });
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, void* dk, void* dv, const Layouts& s,
                   int bh, int heads, int t_q, int t_k, int d, float scale, int causal,
                   int q_off, int k_off, cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_k + kBlockN - 1) / kBlockN);
    return launch_kernel(flash_dkv_kernel<DP>, grid, dkv_smem_bytes<DP>(), stream,
                         static_cast<const float*>(q), s.q, static_cast<const float*>(k), s.k,
                         static_cast<const float*>(v), s.v, static_cast<const float*>(d_o), s.d_o,
                         static_cast<const float*>(lse), static_cast<const float*>(delta),
                         static_cast<float*>(dk), s.out1, static_cast<float*>(dv), s.out2, heads,
                         t_q, t_k, d, scale, causal, q_off, k_off);
  });
}

int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* d_o,
                    const void* lse, const void* delta, void* dk, void* dv, const Layouts& s,
                    int bh, int heads, int t_q, int t_k, int d, float scale, int causal,
                    int q_off, int k_off, cudaStream_t stream) {
  const int vec = bf16_vec(d, q, k, v, d_o, s);
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_k + kBlockN - 1) / kBlockN);
    return launch_tc(flash_dkv_tc_kernel<DP>, grid, dkv_tc_smem_bytes<DP>(), stream,
                     static_cast<const bf16*>(q), s.q, static_cast<const bf16*>(k), s.k,
                     static_cast<const bf16*>(v), s.v, static_cast<const bf16*>(d_o), s.d_o,
                     static_cast<const float*>(lse), static_cast<const float*>(delta),
                     static_cast<bf16*>(dk), s.out1, static_cast<bf16*>(dv), s.out2, heads, t_q,
                     t_k, d, scale, causal, q_off, k_off, vec);
  });
}

// strides: Rows of q, k, v, o, dO, dQ, dK and dV, in that order
template <int DP>
int launch_dqkv_dp(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                   const void* lse, void* dq, void* dk, void* dv, const long long* strides,
                   int bh, int heads, int t_q, int t_k, int d, float scale, int causal,
                   int q_off, int k_off, int vec, cudaStream_t stream) {
  // all of the SM's shared memory as the carveout: two blocks an SM up to DP = 32
  return launch_tc<kThreads>(
      flash_dqkv_tc_kernel<DP>, dim3(bh), dqkv_smem_bytes<DP>(), stream,
      static_cast<const float*>(q), rows_at(strides, 0), static_cast<const float*>(k),
      rows_at(strides, 1), static_cast<const float*>(v), rows_at(strides, 2),
      static_cast<const float*>(o), rows_at(strides, 3), static_cast<const float*>(d_o),
      rows_at(strides, 4), static_cast<const float*>(lse), static_cast<float*>(dq),
      rows_at(strides, 5), static_cast<float*>(dk), rows_at(strides, 6), static_cast<float*>(dv),
      rows_at(strides, 7), heads, t_q, t_k, d, scale, causal, q_off, k_off, vec);
}

int launch_dqkv(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                const void* lse, void* dq, void* dk, void* dv, const long long* strides, int bh,
                int heads, int t_q, int t_k, int d, float scale, int causal, int q_off,
                int k_off, cudaStream_t stream) {
  if (bh < 1 || t_q < 1 || t_q > kDqkvMaxKeys || t_k < 1 || t_k > kDqkvMaxKeys || d < 1 ||
      d > kDqkvMaxHeadDim) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte copies where d fills whole 16-byte chunks and every row of the
  // loaded tensors and of dQ (written in 16-byte rows) is 16-byte aligned
  bool vec = d % 4 == 0;
  const void* loaded[] = {q, k, v, o, d_o, dq};  // the first 6 strided tensors
  for (int i = 0; i < 6; ++i) vec = vec && rows_aligned(loaded[i], rows_at(strides, i), 4);
  if (d <= 16) {
    return launch_dqkv_dp<16>(q, k, v, o, d_o, lse, dq, dk, dv, strides, bh, heads, t_q, t_k, d,
                              scale, causal, q_off, k_off, vec, stream);
  }
  if (d <= 32) {
    return launch_dqkv_dp<32>(q, k, v, o, d_o, lse, dq, dk, dv, strides, bh, heads, t_q, t_k, d,
                              scale, causal, q_off, k_off, vec, stream);
  }
  return launch_dqkv_dp<64>(q, k, v, o, d_o, lse, dq, dk, dv, strides, bh, heads, t_q, t_k, d,
                            scale, causal, q_off, k_off, vec, stream);
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched); shapes,
// dtypes and strides are checked by the Python wrappers
// (ops/fused_attention.py: flash_dq, flash_dkv, flash_dqkv).  bh = batch *
// heads; strides holds the (batch, head, row) element strides of each
// strided tensor (3 each, in the order of the pointer arguments; D has
// stride 1); lse and delta are (bh, t_q) contiguous.  The dtype picks the
// kernel: float32 the CUDA-core kernels, bfloat16 the tensor-core ones.
// strides: q, k, v, dO, dQ
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* d_o,
                        const void* lse, const void* delta, void* dq, const long long* strides,
                        int bh, int heads, int t_q, int t_k, int d, float scale, int causal,
                        int q_off, int k_off, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || bh % heads != 0) return (int)cudaErrorInvalidValue;
  const Layouts s = layouts(strides, false);
  if (dtype == kFloat32) {
    return launch_dq_f32(q, k, v, d_o, lse, delta, dq, s, bh, heads, t_q, t_k, d, scale, causal,
                         q_off, k_off, st);
  }
  if (dtype == kBFloat16) {
    return launch_dq_bf16(q, k, v, d_o, lse, delta, dq, s, bh, heads, t_q, t_k, d, scale, causal,
                          q_off, k_off, st);
  }
  return (int)cudaErrorInvalidValue;
}

// strides: q, k, v, dO, dK, dV
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* d_o,
                         const void* lse, const void* delta, void* dk, void* dv,
                         const long long* strides, int bh, int heads, int t_q, int t_k, int d,
                         float scale, int causal, int q_off, int k_off, int dtype,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || bh % heads != 0) return (int)cudaErrorInvalidValue;
  const Layouts s = layouts(strides, true);
  if (dtype == kFloat32) {
    return launch_dkv_f32(q, k, v, d_o, lse, delta, dk, dv, s, bh, heads, t_q, t_k, d, scale,
                          causal, q_off, k_off, st);
  }
  if (dtype == kBFloat16) {
    return launch_dkv_bf16(q, k, v, d_o, lse, delta, dk, dv, s, bh, heads, t_q, t_k, d, scale,
                           causal, q_off, k_off, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dQ, dK and dV in one launch, float32 only, Tq, Tk <= 128 and D <= 64 (the
// wrapper's route, ops/fused_attention.py:flash_bwd_route); delta is formed
// in the kernel from o and dO.  strides: q, k, v, o, dO, dQ, dK, dV.  Other
// dtypes and shapes return cudaErrorInvalidValue.
extern "C" int flash_dqkv(const void* q, const void* k, const void* v, const void* o,
                          const void* d_o, const void* lse, void* dq, void* dk, void* dv,
                          const long long* strides, int bh, int heads, int t_q, int t_k, int d,
                          float scale, int causal, int q_off, int k_off, int dtype,
                          void* stream) {
  if (dtype != kFloat32 || heads < 1 || bh % heads != 0) return (int)cudaErrorInvalidValue;
  return launch_dqkv(q, k, v, o, d_o, lse, dq, dk, dv, strides, bh, heads, t_q, t_k, d, scale,
                     causal, q_off, k_off, static_cast<cudaStream_t>(stream));
}
