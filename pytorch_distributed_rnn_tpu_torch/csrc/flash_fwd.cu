// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_attention.py:
// _fwd_kernel (launched by _fwd_impl).  For each head and query row:
//   s = (q . k^T) * scale (scale = D^-0.5, applied after the f32 product),
//   masked to -inf off the ragged edge and above the causal diagonal;
//   o = softmax(s) . v and lse = logsumexp(s), by the online softmax: a
//   running max m, denominator l and numerator acc in float32 over the key
//   tiles, p cast to v's dtype before p . v.  A row with no visible key
//   gives o = 0 and lse = -inf (not NaN).  q, k, v and o are read and
//   written through their (batch, head, row) strides (flash_common.cuh:
//   Rows): the model's (B, T, H, D) views of its projections, no copies.
//
// What bounds it on an H100 SXM.  At the long-context shape (BH = 64,
// T = 1024, D = 128, bf16): operations, 4 BH T^2 D = 34.4 GFLOP, 35 us at
// 989 TFLOP/s on the tensor cores, against 67.4 MB of q, k, v, o and lse
// (20 us at 3.35 TB/s).  At the attention classifier's CLI shape (BH = 256 x
// 4 = 1024, T = 128, D = 32, float32): bytes, 67.6 MB (20 us), against
// 2.15 GFLOP as three TF32 products each (13 us at 495 TFLOP/s).
//
// Both dtypes share one design: a warp owns 16 query rows of the block's
// tile; per 64-key tile, S = Q_w . K^T comes out as eight 16 x 8 C tiles;
// the scale, the masks (each element's (query, key) from its lane
// position) and the online softmax run in those registers, a row's max and
// sum taken over its quad of lanes by two xor-shuffles, in base 2 (exp2f of
// a log2(e)-prescaled argument) with m, l and the correction in float32; p
// is the A operand of O += P . V straight from those registers; O is a
// 16 x DP float32 accumulator in registers.  K and V arrive through a
// two-stage cp.async ring, tile j + 1 loading while tile j computes; key
// tiles wholly above the causal diagonal are not visited (by the block,
// and by each warp for its own rows).  The ragged T edge and the head-dim
// padding are zero in shared memory and masked, never padded in device
// memory.
//
// bfloat16 (flash_fwd_tc_kernel): mma.sync m16n8k16 bf16 -> float32, four
// warps on a 64-row tile (eight on a 128-row tile would double the block's
// registers past what two blocks an SM can hold at D = 128); Q rows loaded
// once from the swizzled Q tile as A fragments by ldmatrix, V read
// transposed; p rounded to bf16 as the TPU kernel casts it to v's dtype.
// 80 KB of shared memory at D = 128, two blocks an SM.  What is left on the
// table: each ldmatrix feeds two mma.sync of one warp's 16 rows, where
// wgmma with TMA-fed tiles would feed a 64-row warpgroup.
//
// float32 (flash_fwd_f32_tc_kernel): mma.sync m16n8k8 in 3xTF32 (each
// float32 operand split into a TF32 high part and the rest, three TF32
// products a product, flash_mma.cuh: A3, B3, mma3), which keeps float32's
// accuracy where TF32 alone misses the float32 tolerance (the fused
// backward's lesson).  The CUDA-core kernel it replaced staged K and then V
// through one buffer with four barriers a key tile, fed its score product
// with 8 scalar shared-memory reads for 16 FMAs and passed p through shared
// memory; here the loads run ahead in the ring, Q and K go to the tensor
// cores as 8-byte reads (row g, columns 2t, 2t + 1, which the mma index
// permutation makes one operand pair), p stays in registers, and at
// T <= 128 one block of 8 warps owns a whole head (kF32FwdWarps), so K and
// V are read once.  S sums its small terms in their own chain, and each
// key tile's P . V sums in zeroed tiles added to O with an FMA: the tensor
// cores truncate the sums they chain.  P . V runs key step by key step, so
// one split A operand of P is live at a time (splitting all of them first
// held a 64-register array, and ptxas spilled at D = 32 to keep two blocks
// an SM).  Shared rows of Q and K are DP + 8 floats long and of V DP + 4,
// so the 8-byte reads of Q and K (a half-warp's rows g at columns 2t,
// 2t + 1) and the column reads of V (rows 2t, 2t + 1) are free of bank
// conflicts.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

// warps a block (16 query rows each): 8 puts a head of T <= 128 in one
// block, its K and V loaded once
constexpr int kF32FwdWarps = 8;

template <int DP>
struct Fwd32 {
  static_assert(DP % 16 == 0 && DP <= kMaxHeadDim, "padded head dim");
  static constexpr int kQK = DP + 8;  // Q and K row stride (floats)
  static constexpr int kV = DP + 4;   // V row stride
  // keys a tile: 32 at D = 128, where O and the tile's P . V sums (64
  // registers a thread each) leave too few for a 64-key tile's S (32, and
  // 32 more for its small terms)
  static constexpr int kKeys = DP <= 64 ? kBlockN : kBlockN / 2;
};

// Q, then K and V twice (the ring)
template <int DP, int WARPS>
size_t fwd_f32_smem_bytes() {
  using F = Fwd32<DP>;
  return sizeof(float) * ((size_t)16 * WARPS * F::kQK + 2 * F::kKeys * (F::kQK + F::kV));
}

// o and lse of one (head, 16 WARPS-query tile).  Warp w owns queries
// q0 + 16w..+15 and its m, l and O; the thread holds rows g and g + 8 of
// the warp's 16 (h = 0, 1) and, of each 8-column C tile, columns 2t and
// 2t + 1.
template <int DP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    flash_fwd_f32_tc_kernel(const float* __restrict__ q, Rows qs, const float* __restrict__ k,
                            Rows ks, const float* __restrict__ v, Rows vs,
                            float* __restrict__ o, Rows os, float* __restrict__ lse, int heads,
                            int t_q, int t_k, int d, float scale, int causal, int q_off,
                            int k_off, int vec) {
  using F = Fwd32<DP>;
  constexpr int BM = 16 * WARPS;    // the block's query rows
  constexpr int THREADS = 32 * WARPS;
  constexpr int KS = DP / 8;        // 8-wide k-steps over the head dim
  constexpr int NT = DP / 8;        // 8-column blocks of the head dim
  constexpr int KN = F::kKeys;       // keys a tile
  constexpr int SN = KN / 8;         // 8-key blocks of a score tile (k-steps of P . V)
  extern __shared__ __align__(16) float f32_smem[];
  float* q_s = f32_smem;               // (BM, kQK)
  float* k_s = q_s + BM * F::kQK;      // two stages of (KN, kQK)
  float* v_s = k_s + 2 * KN * F::kQK;  // two stages of (KN, kV)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* k_h = head_rows(k, ks, bh, heads);
  const float* v_h = head_rows(v, vs, bh, heads);

  const int k_end = key_end(q0, t_q, t_k, causal, q_off, k_off, BM);
  const int n_tiles = k_end > 0 ? (k_end + KN - 1) / KN : 0;
  // one past the last key the warp's own rows see (0: no row of the warp)
  const int w0 = q0 + 16 * warp;
  const int warp_end = w0 < t_q ? key_end(w0, t_q, t_k, causal, q_off, k_off, 16) : 0;

  auto stage_keys = [&](int st, int k0) {
    stage_f32_rows<KN, DP, F::kQK, THREADS>(k_s + st * KN * F::kQK, k_h, ks.row, k0, t_k, d,
                                            vec);
    stage_f32_rows<KN, DP, F::kV, THREADS>(v_s + st * KN * F::kV, v_h, vs.row, k0, t_k, d, vec);
  };
  stage_f32_rows<BM, DP, F::kQK, THREADS>(q_s, head_rows(q, qs, bh, heads), qs.row, q0, t_q, d,
                                          vec);
  if (n_tiles > 0) stage_keys(0, 0);
  cp_async_commit();

  const int qr = w0 + g;
  const float scale_log2 = scale * kLog2e;
  const float* q_w = q_s + 16 * warp * F::kQK;
  float m[2] = {neg_inf(), neg_inf()};  // running max of s * scale * log2(e)
  float l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KN;
    if (it + 1 < n_tiles) stage_keys((it + 1) & 1, k0 + KN);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and Q) have landed
    __syncthreads();
    if (k0 < warp_end) {
      const float* kt = k_s + (it & 1) * KN * F::kQK;
      const float* vt = v_s + (it & 1) * KN * F::kV;

      // S = Q_w . K^T, the small terms in their own chain
      float s[SN][4], small[SN][4];
#pragma unroll
      for (int j = 0; j < SN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = small[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int col = 8 * kk + 2 * t;
        const float2 a0 = ld2(q_w + g * F::kQK + col);
        const float2 a1 = ld2(q_w + (g + 8) * F::kQK + col);
        const A3 qa(a0.x, a1.x, a0.y, a1.y);
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          const float2 b = ld2(kt + (8 * j + g) * F::kQK + col);
          mma3(s[j], small[j], qa, B3(b.x, b.y));
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
          s[j][e] = ok ? (s[j][e] + small[j][e]) * scale_log2 : neg_inf();
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

      // O = O corr + P . V: k-step j is the tile's keys 8j..8j+7, its A
      // operand split once and used for every column tile; the tile's sum
      // in zeroed tiles, then one FMA into O
      float pv[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const A3 pa(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* vr = vt + (8 * j + 2 * t) * F::kV + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) mma3(pv[n], pa, B3(vr[8 * n], vr[8 * n + F::kV]));
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
      }
    }
    __syncthreads();  // stage it & 1 is read: the next iteration refills it
  }
  cp_async_wait<0>();

  // o = acc / l and lse = m + log(l); a row with no visible key has l = 0
  // and acc = 0: o = 0 and lse = -inf
  float* o_h = head_rows(o, os, bh, heads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qr + 8 * h;
    if (qi >= t_q) continue;
    const float l_safe = l[h] > 0.0f ? l[h] : 1.0f;
    float* out = o_h + qi * os.row;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      const float x0 = acc[n][2 * h] / l_safe, x1 = acc[n][2 * h + 1] / l_safe;
      if (col + 1 < d && reinterpret_cast<uintptr_t>(out + col) % 8 == 0) {
        *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
      } else {
        if (col < d) out[col] = x0;
        if (col + 1 < d) out[col + 1] = x1;
      }
    }
    if (t == 0) {
      lse[(size_t)bh * t_q + qi] = l[h] > 0.0f ? (m[h] + log2f(l[h])) * kLn2 : neg_inf();
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

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
    flash_fwd_tc_kernel(const bf16* __restrict__ q, Rows qs, const bf16* __restrict__ k, Rows ks,
                        const bf16* __restrict__ v, Rows vs, bf16* __restrict__ o, Rows os,
                        float* __restrict__ lse, int heads, int t_q, int t_k, int d, float scale,
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
  const bf16* k_h = head_rows(k, ks, bh, heads);
  const bf16* v_h = head_rows(v, vs, bh, heads);
  const size_t q_base = (size_t)bh * t_q;  // lse

  const int k_end = key_end(q0, t_q, t_k, causal, q_off, k_off);
  const int n_tiles = k_end > 0 ? (k_end + kBlockN - 1) / kBlockN : 0;

  load_tile<kBlockM, DP, kTcThreads>(q_s, head_rows(q, qs, bh, heads), qs.row, q0, t_q, d, vec);
  if (n_tiles > 0) {
    load_tile<kBlockN, DP, kTcThreads>(k_s, k_h, ks.row, 0, t_k, d, vec);
    load_tile<kBlockN, DP, kTcThreads>(v_s, v_h, vs.row, 0, t_k, d, vec);
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
      load_tile<kBlockN, DP, kTcThreads>(k_s + nxt * kBlockN * DP, k_h, ks.row, k0 + kBlockN,
                                         t_k, d, vec);
      load_tile<kBlockN, DP, kTcThreads>(v_s + nxt * kBlockN * DP, v_h, vs.row, k0 + kBlockN,
                                         t_k, d, vec);
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
  store_tc_rows<DP>(head_rows(o, os, bh, heads), os.row, acc, q0 + 16 * warp, t_q, d, lane);
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
// launchers: float32 in 3xTF32, bfloat16 in bf16, both on the tensor cores
// ---------------------------------------------------------------------------

// strides: Rows of q, k, v and o, in that order
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
               const long long* strides, int bh, int heads, int t_q, int t_k, int d,
               float scale, int causal, int q_off, int k_off, cudaStream_t stream) {
  const Rows qs = rows_at(strides, 0), ks = rows_at(strides, 1), vs = rows_at(strides, 2);
  const int vec = d % 4 == 0 && rows_aligned(q, qs, 4) && rows_aligned(k, ks, 4) &&
                  rows_aligned(v, vs, 4);
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr int BM = 16 * kF32FwdWarps;
    const dim3 grid(bh, (t_q + BM - 1) / BM);
    return launch_tc<32 * kF32FwdWarps>(
        flash_fwd_f32_tc_kernel<DP, kF32FwdWarps>, grid, fwd_f32_smem_bytes<DP, kF32FwdWarps>(),
        stream, static_cast<const float*>(q), qs, static_cast<const float*>(k), ks,
        static_cast<const float*>(v), vs, static_cast<float*>(o), rows_at(strides, 3),
        static_cast<float*>(lse), heads, t_q, t_k, d, scale, causal, q_off, k_off, vec);
  });
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                const long long* strides, int bh, int heads, int t_q, int t_k, int d,
                float scale, int causal, int q_off, int k_off, cudaStream_t stream) {
  const Rows qs = rows_at(strides, 0), ks = rows_at(strides, 1), vs = rows_at(strides, 2);
  const int vec = d % 8 == 0 && rows_aligned(q, qs, 2) && rows_aligned(k, ks, 2) &&
                  rows_aligned(v, vs, 2);
  return dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid(bh, (t_q + kBlockM - 1) / kBlockM);
    return launch_tc(flash_fwd_tc_kernel<DP>, grid, fwd_tc_smem_bytes<DP>(), stream,
                     static_cast<const bf16*>(q), qs, static_cast<const bf16*>(k), ks,
                     static_cast<const bf16*>(v), vs, static_cast<bf16*>(o), rows_at(strides, 3),
                     static_cast<float*>(lse), heads, t_q, t_k, d, scale, causal, q_off, k_off,
                     vec);
  });
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); shapes,
// dtypes and strides are checked by the Python wrapper
// (ops/fused_attention.py:flash_fwd).  bh = batch * heads; strides holds
// the (batch, head, row) element strides of q, k, v and o (3 each, in that
// order; D has stride 1); lse is (bh, t_q) contiguous.  The dtype picks the
// kernel: float32 the 3xTF32 kernel, bfloat16 the bf16 one.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         const long long* strides, int bh, int heads, int t_q, int t_k, int d,
                         float scale, int causal, int q_off, int k_off, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads < 1 || bh % heads != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    return launch_f32(q, k, v, o, lse, strides, bh, heads, t_q, t_k, d, scale, causal, q_off,
                      k_off, s);
  }
  if (dtype == kBFloat16) {
    return launch_bf16(q, k, v, o, lse, strides, bh, heads, t_q, t_k, d, scale, causal, q_off,
                       k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}
