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
// What bounds it on an H100 SXM: operations.  At the long-context shape
// (BH = 64, T = 1024, D = 128, bf16): 4 BH T^2 D = 34.4 GFLOP, 35 us at 989
// TFLOP/s on the tensor cores, against 67.4 MB of q, k, v, o and lse (20 us
// at 3.35 TB/s).  At the attention classifier's CLI shape (BH = 256 x 4 =
// 1024, T = 128, D = 32, f32): 2.15 GFLOP, 32 us at 67 TFLOP/s of float32,
// against 67.6 MB (20 us).
//
// bfloat16 (flash_fwd_tc_kernel): every product on the tensor cores,
// mma.sync m16n8k16 bf16 -> float32 (csrc/flash_mma.cuh), as the backward's
// flash_dq_tc_kernel.  128 threads, four warps, each owning 16 rows of the
// block's 64-row query tile (eight warps on a 128-row tile would double the
// block's registers past what two blocks an SM can hold at D = 128).  The
// warp loads its Q rows once from the swizzled Q tile as A fragments and
// keeps them in registers for the whole key sweep.  Per 64-key tile, S =
// Q_w . K^T comes out as eight C tiles (16 x 64 per warp, 32 float32
// registers); the scale, the masks (each element's (query, key) from its
// lane position) and the online softmax run in those registers, a row's max
// and sum taken over its quad of lanes by two xor-shuffles, in base 2
// (exp2f of a log2(e)-prescaled argument) with m, l and the correction in
// float32.  p, rounded to bf16 as the TPU kernel casts it to v's dtype, is
// the A operand of O += P . V straight from those registers, with V read
// transposed; O is a 16 x DP float32 accumulator in registers (64 at D =
// 128).  K and V arrive through a two-stage cp.async ring, tile j + 1
// loading while tile j computes: 80 KB of shared memory at D = 128, two
// blocks an SM.  Key tiles wholly above the causal diagonal are not
// visited.  What is left on the table: each ldmatrix feeds two mma.sync of
// one warp's 16 rows, where wgmma with TMA-fed tiles would feed a 64-row
// warpgroup.
//
// float32 (flash_fwd_kernel): on the CUDA cores in float32 (TF32 would miss
// the float32 tolerance).  One block per (head, 64-row query tile), grid
// (BH, ceil(Tq/64)), looping over 64-row key tiles (the TPU grid's
// sequential key axis becomes the loop).  The query tile stays in shared
// memory; K and then V of a key tile share one buffer (staged one after the
// other, which keeps the block at 83 KB at D = 128, two blocks an SM); m, l
// and acc live in registers, a row's 16 owner threads reducing by shuffles;
// p goes through shared memory for p . v.  The ragged T edge and the
// head-dim padding are masked in the kernel, not padded in device memory,
// and key tiles wholly above the causal diagonal are never visited.
#include "flash_common.cuh"
#include "flash_mma.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float kLn2 = 0.6931471805599453f;

// Q, then K and V twice (the ring)
template <int DP>
size_t fwd_tc_smem_bytes() {
  return 5 * (size_t)kBlockM * DP * sizeof(bf16);
}

// o and lse of one (head, 64-query tile).  Warp w owns queries
// q0 + 16w..+15: its Q rows as A operands, its m, l and O in registers.
// The thread holds rows g and g + 8 of the warp's 16 (h = 0, 1) and, of
// each 8-column C tile, columns 2t and 2t + 1.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int t_q, int t_k, int d, float scale,
                        int causal, int q_off, int k_off, int vec) {
  constexpr int KS = DP / 16;       // k-steps over the head dim
  constexpr int NT = DP / 8;        // 8-column blocks of the head dim
  constexpr int SN = kBlockN / 8;   // 8-column blocks of a score tile
  constexpr int PK = kBlockN / 16;  // k-steps of p . v over a key tile
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* k_s = q_s + kBlockM * DP;      // two stages
  bf16* v_s = k_s + 2 * kBlockN * DP;  // two stages

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
  if (n_tiles > 0) {
    load_tile<kBlockN, DP, kTcThreads>(k_s, k_h, 0, t_k, d, vec);
    load_tile<kBlockN, DP, kTcThreads>(v_s, v_h, 0, t_k, d, vec);
  }
  cp_async_commit();

  const int qr = q0 + 16 * warp + g;
  const float scale_log2 = scale * kLog2e;
  float m[2] = {neg_inf(), neg_inf()};  // running max of s * scale * log2(e)
  float l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  uint32_t qa[KS][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockN;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      load_tile<kBlockN, DP, kTcThreads>(k_s + nxt * kBlockN * DP, k_h, k0 + kBlockN, t_k, d, vec);
      load_tile<kBlockN, DP, kTcThreads>(v_s + nxt * kBlockN * DP, v_h, k0 + kBlockN, t_k, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and Q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        ldmatrix_x4(qa[s], a_addr<DP>(smem_addr(q_s), 16 * warp, s, lane));
      }
    }
    const uint32_t kt = smem_addr(k_s + (it & 1) * kBlockN * DP);
    const uint32_t vt = smem_addr(v_s + (it & 1) * kBlockN * DP);

    // S = Q_w . K^T
    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, b_addr<DP>(kt, 16 * np, ks, lane));
        mma_bf16(s[2 * np], qa[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[ks], kb[2], kb[3]);
      }
    }

    // scale and mask (in log2 units), then the rows' tile max over the quad
    float tile_max[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = visible(qr + 8 * h, kj, t_q, t_k, causal, q_off, k_off);
        s[j][e] = ok ? s[j][e] * scale_log2 : neg_inf();
        tile_max[h] = fmaxf(tile_max[h], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
      const float m_new = fmaxf(m[h], tile_max[h]);
      // m = -inf: nothing seen yet (acc and l are 0); else m_new is finite
      corr[h] = m[h] == neg_inf() ? 0.0f : exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    // p in place of s: a visible score's s is finite, and so is m then
    float tile_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = s[j][e] == neg_inf() ? 0.0f : exp2f(s[j][e] - m[h]);
        tile_sum[h] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_sum[h] += __shfl_xor_sync(0xffffffffu, tile_sum[h], 1);
      tile_sum[h] += __shfl_xor_sync(0xffffffffu, tile_sum[h], 2);
      l[h] = l[h] * corr[h] + tile_sum[h];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P . V (V transposed: its keys are the contraction)
    uint32_t pa[PK][4];
    c_to_a(s, pa);
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, bt_addr<DP>(vt, 16 * kk, 2 * np, lane));
        mma_bf16(acc[2 * np], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage it & 1 is read: the next iteration refills it
  }
  cp_async_wait<0>();

  // o = acc / l and lse = m + log(l); a row with no visible key has l = 0
  // and acc = 0: o = 0 and lse = -inf
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_safe[h] = l[h] > 0.0f ? l[h] : 1.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] /= l_safe[0];
    acc[j][1] /= l_safe[0];
    acc[j][2] /= l_safe[1];
    acc[j][3] /= l_safe[1];
  }
  store_tc_rows<DP>(o + q_base * d, acc, q0 + 16 * warp, t_q, d, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qr + 8 * h;
      if (qi < t_q) {
        lse[q_base + qi] = l[h] > 0.0f ? (m[h] + log2f(l[h])) * kLn2 : neg_inf();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers: float32 on the CUDA cores, bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int t_q,
               int t_k, int d, float scale, int causal, int q_off, int k_off,
               cudaStream_t stream) {
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_kernel(flash_fwd_kernel<float, DP>, grid, fwd_smem_bytes<DP>(), stream,
                         static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<float*>(o),
                         static_cast<float*>(lse), t_q, t_k, d, scale, causal, q_off, k_off);
  });
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                int t_q, int t_k, int d, float scale, int causal, int q_off, int k_off,
                cudaStream_t stream) {
  const int vec = rows_aligned(d, q, k, v, v);
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_tc(flash_fwd_tc_kernel<DP>, grid, fwd_tc_smem_bytes<DP>(), stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(o),
                     static_cast<float*>(lse), t_q, t_k, d, scale, causal, q_off, k_off, vec);
  });
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); shapes and
// dtypes are checked by the Python wrapper (ops/fused_attention.py:flash_fwd).
// The dtype picks the kernel: float32 the CUDA-core kernel, bfloat16 the
// tensor-core one.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int t_q, int t_k, int d,
                         float scale, int causal, int q_off, int k_off,
                         int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_f32(q, k, v, o, lse, bh, t_q, t_k, d, scale, causal, q_off, k_off, s);
  }
  if (dtype == kBFloat16) {
    return launch_bf16(q, k, v, o, lse, bh, t_q, t_k, d, scale, causal, q_off, k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}
