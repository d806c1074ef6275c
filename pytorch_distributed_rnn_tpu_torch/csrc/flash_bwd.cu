// Flash-attention backward for Hopper (sm_90a): the dQ and the dK/dV kernel.
//
// Replace the TPU kernels pytorch_distributed_rnn_tpu/ops/pallas_attention.py:
// _dq_kernel (flash_dq) and _dkv_kernel (flash_dkv), both launched by
// _bwd_impl.  Both recompute the probabilities from the forward's row
// logsumexp instead of storing them:
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
// kernels, not padded in device memory.
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
// float32 (flash_dq_kernel, flash_dkv_kernel): on the CUDA cores in float32
// (TF32 would miss the float32 tolerance), as csrc/flash_fwd.cu: 256
// threads, 64 x 64 tiles staged in shared memory as float32 (row stride
// DP + 1), each thread owning a 4 x 4 score micro tile and 4 x DP/16 output
// columns; the score and dp products share one pass over the head dim; ds
// (and p) go through shared memory for the second product.  dQ holds Q, dO,
// K, V and ds (149 KB at D = 128); dK/dV holds K, V, Q, dO, p^T, ds^T and
// the tile's lse and delta (166 KB), with dK and dV accumulating in
// registers.
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
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[kRows][HeadDim<DP>::kCols],
                                           int row0, int n_rows, int d, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + ty * kRows + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < HeadDim<DP>::kCols; ++c) {
      const int col = tx + kTx * c;
      if (col < d) dst[(size_t)row * d + col] = acc[r][c];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int t_q, int t_k, int d, float scale,
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

  stage_tile<float, DP>(q + q_base * d, q0, t_q, d, q_s, kBlockM);
  stage_tile<float, DP>(d_o + q_base * d, q0, t_q, d, do_s, kBlockM);
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
    stage_tile<float, DP>(k + k_base * d, k0, t_k, d, k_s, kBlockN);
    stage_tile<float, DP>(v + k_base * d, k0, t_k, d, v_s, kBlockN);
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
  store_rows<DP>(dq + q_base * d, acc, q0, t_q, d, ty, tx);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ d_o,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int t_q, int t_k, int d,
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

  stage_tile<float, DP>(k + k_base * d, k0, t_k, d, k_s, kBlockN);
  stage_tile<float, DP>(v + k_base * d, k0, t_k, d, v_s, kBlockN);
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
    stage_tile<float, DP>(q + q_base * d, q0, t_q, d, q_s, kBlockM);
    stage_tile<float, DP>(d_o + q_base * d, q0, t_q, d, do_s, kBlockM);
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
  store_rows<DP>(dk + k_base * d, dk_acc, k0, t_k, d, ty, tx);
  store_rows<DP>(dv + k_base * d, dv_acc, k0, t_k, d, ty, tx);
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

// p = exp(s * scale - lse) of a visible score, else 0; not finite (a row
// with lse = -inf) gives 0 too.  s_log2 = s * scale * log2(e), lse_log2 =
// lse * log2(e).
__device__ __forceinline__ float recompute_p_log2(float s_log2, float lse_log2, bool ok) {
  const float p = ok ? exp2f(s_log2 - lse_log2) : 0.0f;
  return isfinite(p) ? p : 0.0f;
}

// dQ of one (head, 64-query tile).  Warp w owns queries q0 + 16w..+15: its
// Q and dO rows are A operands held in registers, its dQ C tiles too.  Per
// 32-key chunk: S = Q_w . K^T and dP = dO_w . V^T (4 C tiles each), dS in
// those registers, then dQ += dS . K with K read transposed.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int t_q, int t_k, int d, float scale, int causal,
                       int q_off, int k_off, int vec) {
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
  const bf16* k_h = k + (size_t)bh * t_k * d;
  const bf16* v_h = v + (size_t)bh * t_k * d;
  const size_t q_base = (size_t)bh * t_q;

  const int k_end = key_end(q0, t_q, t_k, causal, q_off, k_off);
  const int n_tiles = k_end > 0 ? (k_end + kBlockN - 1) / kBlockN : 0;

  load_tile<kBlockM, DP, kTcThreads>(q_s, q + q_base * d, q0, t_q, d, vec);
  load_tile<kBlockM, DP, kTcThreads>(do_s, d_o + q_base * d, q0, t_q, d, vec);
  if (n_tiles > 0) {
    load_tile<kBlockN, DP, kTcThreads>(k_s, k_h, 0, t_k, d, vec);
    load_tile<kBlockN, DP, kTcThreads>(v_s, v_h, 0, t_k, d, vec);
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
      load_tile<kBlockN, DP, kTcThreads>(k_s + nxt * kBlockN * DP, k_h, k0 + kBlockN, t_k, d, vec);
      load_tile<kBlockN, DP, kTcThreads>(v_s + nxt * kBlockN * DP, v_h, k0 + kBlockN, t_k, d, vec);
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
  store_tc_rows<DP>(dq + q_base * d, acc, q0 + 16 * warp, t_q, d, lane);
}

// dK and dV of one (head, 64-key tile).  Warp w owns keys k0 + 16w..+15 and
// their dK and dV C tiles.  Per 32-query chunk: S^T = K_w . Q^T and
// dP^T = V_w . dO^T (4 C tiles each), p^T and ds^T in those registers, then
// dV += P^T . dO and dK += dS^T . Q with dO and Q read transposed.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int t_q, int t_k, int d,
                        float scale, int causal, int q_off, int k_off, int vec) {
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
  const bf16* q_h = q + (size_t)bh * t_q * d;
  const bf16* do_h = d_o + (size_t)bh * t_q * d;
  const float* lse_h = lse + (size_t)bh * t_q;
  const float* delta_h = delta + (size_t)bh * t_q;
  const size_t k_base = (size_t)bh * t_k;

  // the first query tile with a query on or below the diagonal of this key
  // tile's first key; earlier tiles are wholly above it
  const int q_begin = causal ? max(0, k0 + k_off - q_off) / kBlockM * kBlockM : 0;
  const int n_tiles = q_begin < t_q ? (t_q - q_begin + kBlockM - 1) / kBlockM : 0;

  // Q, dO, lse and delta of the query tile at q0 into stage st
  auto load_queries = [&](int st, int q0) {
    load_tile<kBlockM, DP, kTcThreads>(q_s + st * kBlockM * DP, q_h, q0, t_q, d, vec);
    load_tile<kBlockM, DP, kTcThreads>(do_s + st * kBlockM * DP, do_h, q0, t_q, d, vec);
    const int i = threadIdx.x % kBlockM;
    const bool in = q0 + i < t_q;
    const float* src = threadIdx.x < kBlockM ? lse_h : delta_h;
    float* dst = (threadIdx.x < kBlockM ? lse_s : delta_s) + st * kBlockM + i;
    cp_async_4(smem_addr(dst), in ? src + q0 + i : src, in);
  };

  load_tile<kBlockN, DP, kTcThreads>(k_s, k + k_base * d, k0, t_k, d, vec);
  load_tile<kBlockN, DP, kTcThreads>(v_s, v + k_base * d, k0, t_k, d, vec);
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
  store_tc_rows<DP>(dk + k_base * d, dk_acc, k0 + 16 * warp, t_k, d, lane);
  store_tc_rows<DP>(dv + k_base * d, dv_acc, k0 + 16 * warp, t_k, d, lane);
}

// ---------------------------------------------------------------------------
// launchers: float32 on the CUDA cores, bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

int launch_dq_f32(const void* q, const void* k, const void* v, const void* d_o,
                  const void* lse, const void* delta, void* dq, int bh, int t_q, int t_k,
                  int d, float scale, int causal, int q_off, int k_off, cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_kernel(flash_dq_kernel<DP>, grid, dq_smem_bytes<DP>(), stream,
                         static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<const float*>(d_o),
                         static_cast<const float*>(lse), static_cast<const float*>(delta),
                         static_cast<float*>(dq), t_q, t_k, d, scale, causal, q_off, k_off);
  });
}

int launch_dq_bf16(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, void* dq, int bh, int t_q, int t_k,
                   int d, float scale, int causal, int q_off, int k_off, cudaStream_t stream) {
  const int vec = rows_aligned(d, q, k, v, d_o);
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_tc(flash_dq_tc_kernel<DP>, grid, dq_tc_smem_bytes<DP>(), stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const bf16*>(d_o),
                     static_cast<const float*>(lse), static_cast<const float*>(delta),
                     static_cast<bf16*>(dq), t_q, t_k, d, scale, causal, q_off, k_off, vec);
  });
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, void* dk, void* dv, int bh, int t_q,
                   int t_k, int d, float scale, int causal, int q_off, int k_off,
                   cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_k + kBlockN - 1) / kBlockN);
    return launch_kernel(flash_dkv_kernel<DP>, grid, dkv_smem_bytes<DP>(), stream,
                         static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<const float*>(d_o),
                         static_cast<const float*>(lse), static_cast<const float*>(delta),
                         static_cast<float*>(dk), static_cast<float*>(dv), t_q, t_k, d, scale,
                         causal, q_off, k_off);
  });
}

int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* d_o,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int t_q,
                    int t_k, int d, float scale, int causal, int q_off, int k_off,
                    cudaStream_t stream) {
  const int vec = rows_aligned(d, q, k, v, d_o);
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_k + kBlockN - 1) / kBlockN);
    return launch_tc(flash_dkv_tc_kernel<DP>, grid, dkv_tc_smem_bytes<DP>(), stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const bf16*>(d_o),
                     static_cast<const float*>(lse), static_cast<const float*>(delta),
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_q, t_k, d, scale, causal,
                     q_off, k_off, vec);
  });
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched); shapes
// and dtypes are checked by the Python wrappers (ops/fused_attention.py:
// flash_dq, flash_dkv).  The dtype picks the kernel: float32 the CUDA-core
// kernels, bfloat16 the tensor-core ones.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* d_o, const void* lse, const void* delta,
                        void* dq, int bh, int t_q, int t_k, int d, float scale,
                        int causal, int q_off, int k_off, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dq_f32(q, k, v, d_o, lse, delta, dq, bh, t_q, t_k, d, scale, causal, q_off,
                         k_off, s);
  }
  if (dtype == kBFloat16) {
    return launch_dq_bf16(q, k, v, d_o, lse, delta, dq, bh, t_q, t_k, d, scale, causal, q_off,
                          k_off, s);
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
    return launch_dkv_f32(q, k, v, d_o, lse, delta, dk, dv, bh, t_q, t_k, d, scale, causal,
                          q_off, k_off, s);
  }
  if (dtype == kBFloat16) {
    return launch_dkv_bf16(q, k, v, d_o, lse, delta, dk, dv, bh, t_q, t_k, d, scale, causal,
                           q_off, k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}
