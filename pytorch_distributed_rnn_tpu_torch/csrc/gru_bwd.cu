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
// (1.54 ms at 67 TFLOP/s) against 0.74 GB (0.22 ms).  But the sweep is a
// chain of T dependent steps per batch row, so what a design can reach is
// set by how much of the card one step's work spreads over.
//
// Two variants; the caller (ops/fused_rnn.py:gru_bwd_tile) picks one by
// width, and a variant that does not launch is an error, never a reason to
// run the other.
//
// Shared memory (gru_bwd_kernel, up to H = 126): as csrc/lstm_bwd.cu, one
// block owns one tile of block_b rows for the whole reverse sweep, with two
// barriers a step.  Each step stages h_{t-1} in shared memory, recomputes
// the gates of the thread's units, publishes d_hgates to shared memory,
// and after the barrier each thread contracts it into dh for its own units
// - the units it needs next step - so the carried dh lives in a shared tile
// that only its owner touches.  W_hh^T is staged once into shared memory
// and serves both products (odd row stride, see gru_common.cuh).
//
// Cluster (gru_bwd_cluster_kernel, H = 127..512): at H = 512 W_hh^T is 3
// MiB, and a block that reads all of it from L2 every step runs its 128
// steps at one SM's issue rate.  So a cluster of kClusterCtas = 16 CTAs
// owns one tile of kClusterRows = 4 batch rows, and CTA c owns the units
// [c U, (c + 1) U), U = ceil(H / 16) (units past H are masked, so H need
// not divide by 16).  It keeps in shared memory, as float32, only the 3U
// columns of W_hh^T of its units' r, z and n gates, zero-padded to column
// quads, rows at an odd number of quads so that 16-byte reads of 8
// consecutive rows hit 8 distinct bank quads: (H, 100) floats, 200 KiB at
// H = 512.  That one slice serves both products:
//   - the gate recompute of its own units, h_{t-1} (R x H) . slice;
//   - its partial contraction for EVERY unit m,
//     part[r, m] = sum over its 3U columns n of d_hg[r, n] W_hh^T[m, n],
//     so no transposed copy of W is needed.
// A step t, on 512 threads:
//   1. gather: for each own unit, 16 lanes each read one peer's partial
//      (a float4 of the R rows, through DSMEM: cluster.map_shared_rank)
//      and sum them by shuffles: dh_{t-1} of exactly the units the CTA
//      owns, the only ones it needs;
//   2. the R x U items (row, own unit) form the gates from the gate sums,
//      the cotangents and dx_proj / dhgates, and leave d_hgates in shared
//      memory in place of the gate sums they read;
//   3. the contraction: thread (unit pair m, m + H/2) reads each d_hgates
//      quad once for both units; the partials go to a double-buffered
//      tile;
//   4. the cluster barrier, split: arrive (release: the partials are
//      published), then h_{t-2} is stored and the gate products of step
//      t - 1 run, since they need h and not dh (16 lanes per column quad,
//      reduced by shuffle exchanges), then wait (acquire).
// h_{t-2} and the items' x_proj[t - 1] and dh_all[t - 1] are loaded into
// registers before the contraction, so they land while it runs.  One CTA
// per SM (225 KiB of shared memory);
// clusters are independent, and B / R of them run in waves (7 resident on
// an H100 SXM: 64 clusters, 10 waves at B = 256).  What bounds it: each
// step reads the slice from shared memory twice, about 400 KB per SM
// (3100 cycles at 128 B a cycle), beside the chain of the gather, the
// items and the barrier.
#include <cooperative_groups.h>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pdrnn;

size_t bwd_smem_bytes(int hidden, int block_b) {
  // W, h_{t-1} (block_b, H), d_hgates (block_b, 3H), dh (block_b, H)
  return sizeof(float) *
         (gru_w_smem_floats(hidden) + 5 * (size_t)block_b * hidden);
}

// The shared-memory variant: one block, block_b rows, all of W_hh^T.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) gru_bwd_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h_all,
    const T* __restrict__ h0, const T* __restrict__ w_hh_t,
    const T* __restrict__ b_hh,
    const T* __restrict__ dh_all, const T* __restrict__ dh_T,
    T* __restrict__ dx_proj, T* __restrict__ dhgates, T* __restrict__ dh0,
    int seq_len, int batch, int hidden, int block_b) {
  extern __shared__ float smem[];
  const int gate_dim = 3 * hidden;
  float* w_s = smem;
  float* h_prev = smem + hidden * gru_w_stride(hidden);
  float* d_hg = h_prev + block_b * hidden;  // (block_b, 3H)
  float* dh_s = d_hg + block_b * gate_dim;  // (block_b, H), the carried dh
  const int row0 = blockIdx.x * block_b;
  const size_t step = (size_t)batch * hidden;
  const int unit_threads = gru_unit_threads(hidden, block_b);
  const int j0 = threadIdx.x % unit_threads;
  const int r0 = (threadIdx.x / unit_threads) * kRowsPerThread;

  stage_gru_weights(w_hh_t, w_s, hidden);
  // read first after the first barrier below
  stage_rows(dh_T, dh_s, row0, batch, hidden, block_b);
  const GruWeights w{w_s, hidden};

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

// ---------------------------------------------------------------------------
// the cluster variant
// ---------------------------------------------------------------------------

// Mirrored by ops/fused_rnn.py:GRU_CLUSTER_ROWS.
constexpr int kClusterRows = 4;      // R; a row quad travels as one float4
// the thread's share of an (R, H) tile of h
constexpr int kHLoads = kClusterRows * kClusterMaxHidden / kClusterThreads;
// lanes that split one column quad's gate products over m
constexpr int kGateLanes = 16;
static_assert(kClusterRows == 4, "rows travel as float4");
static_assert(kClusterThreads / kClusterCtas >=
                  (kClusterMaxHidden + kClusterCtas - 1) / kClusterCtas,
              "the gather's lane groups cover a CTA's units");

struct ClusterShape {
  int units;   // U: units a CTA owns
  int quads;   // Q: column quads of its W_hh^T slice (3U columns, zero-padded to 4Q)
  int stride;  // the slice's row stride in floats: 4 Q, plus 4 where Q is
               // even, so that 16-byte reads of 8 consecutive rows m (the
               // contraction) fall in 8 distinct bank quads
};

__host__ __device__ inline ClusterShape cluster_shape(int hidden) {
  ClusterShape s;
  s.units = (hidden + kClusterCtas - 1) / kClusterCtas;
  s.quads = (3 * s.units + 3) / 4;
  s.stride = 4 * (s.quads | 1);
  return s;
}

// the float4 tiles (the two partial stages, h, the gate sums / d_hgates),
// then the W slice
size_t cluster_smem_bytes(int hidden) {
  const ClusterShape s = cluster_shape(hidden);
  return sizeof(float) * (kClusterRows * (3 * (size_t)hidden + 4 * (size_t)s.quads) +
                          (size_t)hidden * s.stride);
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1) gru_bwd_cluster_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h_all,
    const T* __restrict__ h0, const T* __restrict__ w_hh_t,
    const T* __restrict__ b_hh, const T* __restrict__ dh_all,
    const T* __restrict__ dh_T, T* __restrict__ dx_proj,
    T* __restrict__ dhgates, T* __restrict__ dh0, int seq_len, int batch,
    int hidden) {
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterShape cs = cluster_shape(hidden);
  const int units = cs.units;
  const int cols = 3 * units;
  const int gate_dim = 3 * hidden;
  const size_t step = (size_t)batch * hidden;
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / kClusterCtas) * kClusterRows;
  const int unit0 = (int)cluster.block_rank() * units;

  extern __shared__ __align__(16) float smem[];
  float4* part = reinterpret_cast<float4*>(smem);  // (2, H) x R: partials
  float4* h_s = part + 2 * hidden;                 // (H) x R: h_{t-1}
  // (4Q) x R, column k U + u for gate k of own unit u: the gate sums, which
  // each item overwrites with its d_hgates after reading them
  float4* gd = h_s + hidden;
  float* w_s = reinterpret_cast<float*>(gd + 4 * cs.quads);  // (H, stride)
  const float4* w4 = reinterpret_cast<const float4*>(w_s);

  // the slice: w_s[m][k U + u] = W_hh^T[m][k H + unit0 + u], 0 past H and
  // past 3U
  for (int i = tid; i < hidden * 4 * cs.quads; i += kClusterThreads) {
    const int m = i / (4 * cs.quads);
    const int c = i - m * 4 * cs.quads;
    const int j = unit0 + c % units;
    w_s[m * cs.stride + c] =
        c < cols && j < hidden ? to_f32(w_hh_t[(size_t)m * gate_dim + (c / units) * hidden + j])
                               : 0.0f;
  }

  // h_{t-1} of the tile (h0 at t = 0): loaded into registers, then stored
  // transposed into h_s
  float h_reg[kHLoads];
  auto load_h = [&](int t) {
    const T* src = t > 0 ? h_all + (size_t)(t - 1) * step : h0;
#pragma unroll
    for (int u = 0; u < kHLoads; ++u) {
      const int i = tid + u * kClusterThreads;
      const int r = i / hidden;
      const int b = row0 + r;
      h_reg[u] = i < kClusterRows * hidden && b < batch
                     ? to_f32(src[(size_t)b * hidden + (i - r * hidden)])
                     : 0.0f;
    }
  };
  auto store_h = [&]() {
    float* hs = reinterpret_cast<float*>(h_s);
#pragma unroll
    for (int u = 0; u < kHLoads; ++u) {
      const int i = tid + u * kClusterThreads;
      const int r = i / hidden;
      if (i < kClusterRows * hidden) hs[(i - r * hidden) * kClusterRows + r] = h_reg[u];
    }
  };

  // The gather's lane groups: 16 lanes (one per CTA) for own unit gu.  The
  // items (row ir, own unit uj; global unit j) are lanes 0..R-1 of each
  // group, so a group's sum over the cluster reaches them by shuffles.
  const int peer = tid % kClusterCtas;
  const int gu = tid / kClusterCtas;
  const bool gathers = gu < units && unit0 + gu < hidden;
  const bool item = peer < kClusterRows && gu < units;
  const int ir = peer;
  const int uj = gu;
  const int j = unit0 + uj;
  const int b = row0 + ir;
  const bool unit_ok = item && j < hidden;
  const bool live = unit_ok && b < batch;  // an item with real data
  float bias[3], xg[3], dh_in;
#pragma unroll
  for (int k = 0; k < 3; ++k) bias[k] = unit_ok ? to_f32(b_hh[k * hidden + j]) : 0.0f;
  auto load_item = [&](int t) {
    const size_t g = ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
    for (int k = 0; k < 3; ++k) xg[k] = live ? to_f32(x_proj[g + k * hidden]) : 0.0f;
    dh_in = live ? to_f32(dh_all[t * step + (size_t)b * hidden + j]) : 0.0f;
  };
  // the cluster's sum of the partials of unit unit0 + gu at stage st, row ir
  auto gather = [&](int st) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gathers) v = *cluster.map_shared_rank(part + st * hidden + unit0 + gu, peer);
#pragma unroll
    for (int off = kClusterCtas / 2; off > 0; off /= 2) {
      const float4 o = shfl_xor4(v, off);
      v = make_float4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
    }
    return component(v, ir);
  };
  // dh z of the step before (dh_T at the start)
  float dh_carry = live ? to_f32(dh_T[(size_t)b * hidden + j]) : 0.0f;

  // The gate products: kGateLanes = 16 lanes per column quad q, lane ks
  // taking rows m = ks, ks + 16, ...; 16 sums (4 columns x R rows) a lane,
  // reduced over the 16 lanes so that lane ks ends with sum ks (column
  // 4q + ks / 4, row ks % 4).
  const int gq = tid / kGateLanes;
  const int ks = tid % kGateLanes;
  const bool quad_ok = gq < cs.quads;
  // warps with no quad sit out; in the last warp, lanes past the quads add
  // zeros to the shuffles
  const bool gate_warp = tid / 32 * (32 / kGateLanes) < cs.quads;
  auto gate_products = [&]() {
    if (!gate_warp) return;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
#pragma unroll 2
    for (int m = quad_ok ? ks : hidden; m < hidden; m += kGateLanes) {
      const float4 hv = h_s[m];
      const float4 wv = w4[m * (cs.stride / 4) + gq];
      const float w[4] = {wv.x, wv.y, wv.z, wv.w};
      const float h[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c * 4 + r] = fmaf(h[r], w[c], acc[c * 4 + r]);
      }
    }
    reduce_scatter<16, kGateLanes>(acc, ks);
    if (quad_ok) reinterpret_cast<float*>(gd + 4 * gq + ks / 4)[ks % 4] = acc[0];
  };

  load_h(seq_len - 1);
  store_h();
  load_item(seq_len - 1);
  __syncthreads();
  gate_products();
  cluster.sync();  // slices, h and gate sums staged; every CTA of the cluster running

  for (int t = seq_len - 1; t >= 0; --t) {
    // dh_t of the item: the carried dh z, the contraction of step t + 1
    // summed over the cluster, and dh_all[t]
    float dh = dh_carry + dh_in;
    if (t < seq_len - 1) dh += gather((t + 1) & 1);

    if (item) {
      float* g = reinterpret_cast<float*>(gd) + uj * kClusterRows + ir;
      const int gate_step = units * kClusterRows;  // between gates k and k + 1
      const float hr = bias[0] + g[0];
      const float hz = bias[1] + g[gate_step];
      const float hn = bias[2] + g[2 * gate_step];
      const float hp =
          unit_ok ? reinterpret_cast<const float*>(h_s)[j * kClusterRows + ir] : 0.0f;
      const float rg = sigmoid(xg[0] + hr);
      const float zg = sigmoid(xg[1] + hz);
      const float ng = tanhf(xg[2] + rg * hn);
      const float dn = dh * (1.0f - zg) * (1.0f - ng * ng);
      const float dz = dh * (hp - ng) * zg * (1.0f - zg);
      const float dr = dn * hn * rg * (1.0f - rg);
      g[0] = dr;
      g[gate_step] = dz;
      g[2 * gate_step] = dn * rg;
      dh_carry = dh * zg;
      if (live) {
        const size_t o = ((size_t)t * batch + b) * gate_dim + j;
        dx_proj[o] = from_f32<T>(dr);
        dx_proj[o + hidden] = from_f32<T>(dz);
        dx_proj[o + 2 * hidden] = from_f32<T>(dn);
        dhgates[o] = from_f32<T>(dr);
        dhgates[o + hidden] = from_f32<T>(dz);
        dhgates[o + 2 * hidden] = from_f32<T>(dn * rg);
      }
    }
    __syncthreads();  // d_hgates whole; h_{t-1} read

    // step t - 1's inputs (h_{t-2} for the gate products), in flight
    // during the contraction
    if (t > 0) {
      load_h(t - 1);
      load_item(t - 1);
    }

    // part[m][r] = sum over the slice's columns n of d_hg[n][r] W_hh^T[m][n],
    // four columns a 16-byte read (the padding columns hold zero weights);
    // units m and m + H/2 a thread, so each read of d_hgates feeds both
    float4* out = part + (t & 1) * hidden;
    const int half_h = (hidden + 1) / 2;
    for (int m0 = tid; m0 < half_h; m0 += kClusterThreads) {
      const int m1 = m0 + half_h < hidden ? m0 + half_h : m0;
      const float4* wr0 = w4 + m0 * (cs.stride / 4);
      const float4* wr1 = w4 + m1 * (cs.stride / 4);
      float4 a[4], b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = b[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
      for (int q = 0; q < cs.quads; ++q) {
        const float4 w0 = wr0[q];
        const float4 w1 = wr1[q];
        const float4 d0 = gd[4 * q];
        const float4 d1 = gd[4 * q + 1];
        const float4 d2 = gd[4 * q + 2];
        const float4 d3 = gd[4 * q + 3];
        fma4(a[0], d0, w0.x);
        fma4(a[1], d1, w0.y);
        fma4(a[2], d2, w0.z);
        fma4(a[3], d3, w0.w);
        fma4(b[0], d0, w1.x);
        fma4(b[1], d1, w1.y);
        fma4(b[2], d2, w1.z);
        fma4(b[3], d3, w1.w);
      }
      fma4(a[0], a[1], 1.0f);
      fma4(a[2], a[3], 1.0f);
      fma4(a[0], a[2], 1.0f);
      fma4(b[0], b[1], 1.0f);
      fma4(b[2], b[3], 1.0f);
      fma4(b[0], b[2], 1.0f);
      out[m0] = a[0];
      if (m1 != m0) out[m1] = b[0];
    }
    // publish the partials (release); the other stage, read by the peers
    // during this step, is free again once every CTA has arrived
    cluster_arrive();
    if (t > 0) {
      store_h();
      __syncthreads();  // h_{t-2} whole, d_hgates read
      gate_products();
    }
    cluster_wait();   // the peers' partials of this step (acquire)
    __syncthreads();  // and the gate sums of step t - 1
  }

  const float dh_last = gather(0);
  if (live) dh0[(size_t)b * hidden + j] = from_f32<T>(dh_carry + dh_last);
  cluster.sync();  // no CTA leaves while a peer reads its partials
}

// The cluster kernel's launch configuration at (hidden, batch): see
// cluster_launch_config (cluster_common.cuh).
template <typename T>
int cluster_config(int hidden, int batch, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                   cudaLaunchAttribute& attr, int* active) {
  return cluster_launch_config(gru_bwd_cluster_kernel<T>, cluster_smem_bytes(hidden),
                               (batch + kClusterRows - 1) / kClusterRows, stream, cfg, attr,
                               active);
}

template <typename T>
int launch_cluster(const void* x_proj, const void* h_all, const void* h0,
                   const void* w_hh_t, const void* b_hh, const void* dh_all,
                   const void* dh_T, void* dx_proj, void* dhgates, void* dh0,
                   int seq_len, int batch, int hidden, cudaStream_t stream) {
  if (hidden > kClusterMaxHidden) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  const int err = cluster_config<T>(hidden, batch, stream, cfg, attr, &active);
  if (err != 0) return err;
  cudaLaunchKernelEx(&cfg, gru_bwd_cluster_kernel<T>,
                     static_cast<const T*>(x_proj), static_cast<const T*>(h_all),
                     static_cast<const T*>(h0), static_cast<const T*>(w_hh_t),
                     static_cast<const T*>(b_hh), static_cast<const T*>(dh_all),
                     static_cast<const T*>(dh_T), static_cast<T*>(dx_proj),
                     static_cast<T*>(dhgates), static_cast<T*>(dh0), seq_len, batch, hidden);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
int launch_smem(const void* x_proj, const void* h_all, const void* h0,
                const void* w_hh_t, const void* b_hh, const void* dh_all,
                const void* dh_T, void* dx_proj, void* dhgates, void* dh0,
                int seq_len, int batch, int hidden, int block_b, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(hidden, block_b);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 threads(gru_threads(hidden, block_b));
  gru_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h_all),
      static_cast<const T*>(h0), static_cast<const T*>(w_hh_t),
      static_cast<const T*>(b_hh), static_cast<const T*>(dh_all),
      static_cast<const T*>(dh_T), static_cast<T*>(dx_proj),
      static_cast<T*>(dhgates), static_cast<T*>(dh0), seq_len, batch, hidden,
      block_b);
  return (int)cudaGetLastError();
}

// variant codes passed from Python (ops/fused_rnn.py:_GRU_BWD_VARIANTS)
constexpr int kVariantSmem = 0;
constexpr int kVariantCluster = 1;

template <typename T>
int launch_dtype(const void* x_proj, const void* h_all, const void* h0,
                 const void* w_hh_t, const void* b_hh, const void* dh_all,
                 const void* dh_T, void* dx_proj, void* dhgates, void* dh0,
                 int seq_len, int batch, int hidden, int block_b, int variant,
                 cudaStream_t stream) {
  if (variant == kVariantSmem) {
    return launch_smem<T>(x_proj, h_all, h0, w_hh_t, b_hh, dh_all, dh_T, dx_proj, dhgates,
                          dh0, seq_len, batch, hidden, block_b, stream);
  }
  if (variant == kVariantCluster && block_b == kClusterRows) {
    return launch_cluster<T>(x_proj, h_all, h0, w_hh_t, b_hh, dh_all, dh_T, dx_proj,
                             dhgates, dh0, seq_len, batch, hidden, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or the error
// that kept the variant from launching.  Shapes, dtypes, block_b and the
// variant are checked and chosen by the Python wrapper (ops/fused_rnn.py:
// gru_bwd): variant 0 runs the shared-memory kernel on block_b-row tiles,
// variant 1 the cluster kernel (block_b = kClusterRows).
extern "C" int gru_bwd(const void* x_proj, const void* h_all, const void* h0,
                       const void* w_hh_t, const void* b_hh, const void* dh_all,
                       const void* dh_T, void* dx_proj, void* dhgates, void* dh0,
                       int seq_len, int batch, int hidden, int block_b,
                       int variant, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dtype<float>(x_proj, h_all, h0, w_hh_t, b_hh, dh_all, dh_T, dx_proj,
                               dhgates, dh0, seq_len, batch, hidden, block_b, variant, s);
  }
  if (dtype == kBFloat16) {
    return launch_dtype<__nv_bfloat16>(x_proj, h_all, h0, w_hh_t, b_hh, dh_all, dh_T,
                                       dx_proj, dhgates, dh0, seq_len, batch, hidden,
                                       block_b, variant, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster variant's shape at (hidden, batch) for a report: out[0] CTAs
// a cluster, out[1] batch rows a cluster, out[2] clusters resident at once,
// out[3] dynamic shared memory bytes a CTA.  Returns the error code of
// cluster_config (0 = at least one cluster fits).
extern "C" int gru_bwd_cluster_shape(int hidden, int batch, int dtype, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  int err = (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) err = cluster_config<float>(hidden, batch, nullptr, cfg, attr, &active);
  if (dtype == kBFloat16) {
    err = cluster_config<__nv_bfloat16>(hidden, batch, nullptr, cfg, attr, &active);
  }
  out[0] = kClusterCtas;
  out[1] = kClusterRows;
  out[2] = active;
  out[3] = (int)cluster_smem_bytes(hidden);
  return err;
}
