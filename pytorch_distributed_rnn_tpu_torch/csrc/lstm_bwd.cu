// Fused LSTM backward time loop (reverse time) for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:
// _lstm_bwd_kernel (launched by _lstm_bwd_pallas).  Per step t, from T-1
// down to 0, with dh and dc carried in float32 (dh_T, dc_T at the start):
//   the activated gates of step t: read from the forward's where it saved
//   them (H <= 32, H > 110), else recomputed from h_{t-1} (h0 at t = 0)
//   dh += dh_all[t];  tc = tanh(c_all[t]);  do = dh * tc
//   dc += dh * o * (1 - tc^2);  di = dc * g;  df = dc * c_{t-1};  dg = dc * i
//   d_gates = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]  -> dx_proj[t]
//   dh = d_gates @ W_hh (w_hh_t read transposed);  dc = dc * f
// and dh0, dc0 after step 0.  dW_hh is NOT formed here: the caller takes
// it as one matrix product over (t, b) of dx_proj and h_{t-1}, as the JAX
// package leaves it to XLA (_fused_bwd).
//
// What bounds it: bytes.  At T=128, B=1440, H=32, f32 it reads the
// activated gates the forward saved (94 MB) and c_all, dh_all (47 MB) and
// writes dx_proj (94 MB): about 70 us at 3.35 TB/s, against 1.5 GFLOP of
// f32 FMAs (23 us); and it
// is a chain of T dependent steps, so what a design can reach is set by
// how short one step is.
//
// Up to H = kRegHidden = 32 (lstm_bwd_reg_kernel), as the forward
// (csrc/lstm_fwd.cu:lstm_fwd_kernel): a block of 4H threads owns one quad
// of 4 batch rows for the whole reverse sweep (1440 rows -> 360 blocks,
// several to an SM).  Lane p of the 4-lane group of unit j owns (row p,
// unit j): its dh and dc live in its registers.  A step: the lane forms
// its d_gates and stores them to a double-buffered shared tile; one
// barrier; then the group splits dh_{t-1}[., j] = d_gates[., :] . W_hh^T[j,
// :] by gate: lane p takes gate p's H columns for all four rows (its 32
// weights, W_hh^T[j, p H ..], sit in registers for the whole sweep), and
// the shuffle exchange (reduce_scatter) leaves lane p with row p's sum.
// The step's gates are the forward's saved activations (the forward saves
// them up to H = 32 for the backward), so no product recomputes them.  The
// next step's inputs are loaded while this one computes.  One barrier a
// step.
//
// From H = 33 to 110 (lstm_bwd_kernel) one block owns one tile of block_b
// rows.  The SAME shared-memory copy of W_hh^T serves the gate recompute
// (rows read across units) and dh_prev = d_gates @ W_hh (columns read
// across units; the odd row stride keeps both conflict-free).  Each step
// stages h_{t-1} in shared memory, recomputes the gates of the thread's
// unit, publishes d_gates to shared memory, and after a barrier each
// thread contracts it into dh for its own unit.
//
// Cluster (lstm_bwd_cluster_kernel, H = 111..512): as csrc/gru_bwd.cu:
// gru_bwd_cluster_kernel, a cluster of kClusterCtas = 16 CTAs owns one tile
// of kClusterRows = 4 batch rows, and CTA c owns the units [c U, (c + 1)
// U), U = ceil(H / 16), keeping the 4U columns of W_hh^T of its units'
// gates (its slice, in the weights' own dtype).  It does not recompute the
// gates: the forward's cluster kernel saved the activated gates (i, f, g,
// o; csrc/lstm_fwd.cu), which the caller keeps in place of x_proj, so the
// slice serves one product only, its partial contraction for EVERY unit m,
//   part[r, m] = sum over its 4U columns n of d_gates[r, n] W_hh^T[m, n].
// A step t, on 512 threads:
//   1. gather: for each own unit, 16 lanes each read one peer's partial (a
//      float4 of the R rows, through DSMEM) and sum them by shuffles:
//      dh_t of exactly the units the CTA owns;
//   2. the R x U items (row, own unit) form d_gates from the saved gates,
//      c_t, c_{t-1} and the cotangents, write dx_proj and leave d_gates in
//      shared memory; dc_{t-1} = dc f is per unit, so it stays in the
//      item's register and never crosses the cluster;
//   3. the contraction, two rows m a thread; the partials go to a
//      double-buffered tile;
//   4. the split cluster barrier: arrive (release), step t - 1's inputs
//      loaded, wait (acquire).
// Where the slice does not fit in shared memory (float32 above H = 464: at
// H = 512 it is 264 KiB), its last rows (at most 128) sit in registers:
// lane l of warp w keeps quad l of rows w, w + 16, ..., and the warp sums
// their products over its lanes by shuffles.  bf16 slices are held as bf16
// (exact) and fit up to H = 512.  What bounds it at (T=128, B=256, H=512,
// f32): the contraction's 68.7 GFLOP of f32 FMAs (1.03 ms at 67 TFLOP/s)
// against 0.74 GB (0.22 ms); each step reads the slice once, and B / R
// clusters run in waves.
#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pdrnn;

constexpr int kLanes = 4;       // lanes of a unit's group: the quad's rows, the gates
constexpr int kRegHidden = 32;  // up to this width W_hh^T sits in registers
// the d_gates tile: row r, gate k, unit j at r kDgRow + k kDgGate + j; the
// four lanes' 16-byte reads of their gate blocks fall in distinct bank
// quads (kDgGate = 9 quads), and a warp's stores of 4 rows x 8 units in
// distinct banks (kDgRow = 24 mod 32)
constexpr int kDgGate = kRegHidden + 4;
constexpr int kDgRow = 4 * kDgGate + 8;
static_assert(kLanes == kRowsPerThread, "lane p of a group owns row p of its quad");

template <typename T>
__global__ void __launch_bounds__(kLanes * kRegHidden, 3) lstm_bwd_reg_kernel(
    const T* __restrict__ gates, const T* __restrict__ c_all, const T* __restrict__ c0,
    const T* __restrict__ w_hh_t, const T* __restrict__ dh_all, const T* __restrict__ dh_T,
    const T* __restrict__ dc_T, T* __restrict__ dx_proj, T* __restrict__ dh0,
    T* __restrict__ dc0, int seq_len, int batch, int hidden) {
  __shared__ __align__(16) float dg_s[2][kLanes * kDgRow];
  const int gate_dim = 4 * hidden;
  const size_t step = (size_t)batch * hidden;
  const int tid = threadIdx.x;
  // thread (unit j, lane p); the block is rounded up to a whole warp, and
  // the threads past 4H shuffle along but write nothing
  const bool valid = tid < kLanes * hidden;
  const int p = tid % kLanes;
  const int j = valid ? tid / kLanes : 0;
  const int b = blockIdx.x * kLanes + p;
  const bool live = valid && b < batch;
  const size_t o = (size_t)b * hidden + j;

  // the columns and rows past H read as zero
  for (int i = tid; i < 2 * kLanes * kDgRow; i += blockDim.x) (&dg_s[0][0])[i] = 0.0f;
  // the contraction's weights: W_hh^T[j][p H + i], gate p's columns of row j
  float wc[kRegHidden];
#pragma unroll
  for (int i = 0; i < kRegHidden; ++i) {
    wc[i] = valid && i < hidden ? to_f32(w_hh_t[(size_t)j * gate_dim + p * hidden + i]) : 0.0f;
  }

  float dh = live ? to_f32(dh_T[o]) : 0.0f;
  float dc = live ? to_f32(dc_T[o]) : 0.0f;
  // step t's inputs: its activated gates, c_t, c_{t-1} and dh_all[t]
  float ga[4], c_t, c_prev, dh_in;
  auto load = [&](int t) {
    const size_t g = ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) ga[k] = live ? to_f32(gates[g + k * hidden]) : 0.0f;
    c_t = live ? to_f32(c_all[t * step + o]) : 0.0f;
    c_prev = live ? to_f32(t > 0 ? c_all[(t - 1) * step + o] : c0[o]) : 0.0f;
    dh_in = live ? to_f32(dh_all[t * step + o]) : 0.0f;
  };
  load(seq_len - 1);
  __syncthreads();  // the d_gates tiles zeroed

  for (int t = seq_len - 1; t >= 0; --t) {
    const float ig = ga[0], fg = ga[1], gg = ga[2], og = ga[3];
    const float dhv = dh + dh_in;
    const float tc = tanhf(c_t);
    const float dcv = dc + dhv * og * (1.0f - tc * tc);
    const float d[4] = {dcv * gg * ig * (1.0f - ig), dcv * c_prev * fg * (1.0f - fg),
                        dcv * ig * (1.0f - gg * gg), dhv * tc * og * (1.0f - og)};
    dc = dcv * fg;
    if (valid) {
      float* dgw = dg_s[t & 1] + p * kDgRow + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) dgw[k * kDgGate] = d[k];
    }
    if (live) {
      T* dx = dx_proj + ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) dx[k * hidden] = from_f32<T>(d[k]);
    }
    if (t > 0) load(t - 1);  // lands while the contraction runs
    __syncthreads();  // d_gates whole

    // dh_{t-1}[row r, j] over gate p's columns, then summed over the group
    float part[kLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* dgr = dg_s[t & 1] + p * kDgGate;
#pragma unroll
    for (int i4 = 0; i4 < kRegHidden / 4; ++i4) {
#pragma unroll
      for (int r = 0; r < kLanes; ++r) {
        const float4 dv = reinterpret_cast<const float4*>(dgr + r * kDgRow)[i4];
        part[r] = fmaf(dv.x, wc[4 * i4], part[r]);
        part[r] = fmaf(dv.y, wc[4 * i4 + 1], part[r]);
        part[r] = fmaf(dv.z, wc[4 * i4 + 2], part[r]);
        part[r] = fmaf(dv.w, wc[4 * i4 + 3], part[r]);
      }
    }
    reduce_scatter<kLanes, kLanes>(part, p);  // part[0]: row p
    dh = part[0];
    // no second barrier: the next step writes the other d_gates buffer,
    // which every thread finished reading before this barrier
  }
  if (live) {
    dh0[o] = from_f32<T>(dh);
    dc0[o] = from_f32<T>(dc);
  }
}

size_t bwd_smem_bytes(int hidden, int block_b) {
  return sizeof(float) * ((size_t)hidden * w_stride(hidden) +
                          (size_t)block_b * hidden +
                          (size_t)block_b * 4 * hidden);
}

template <typename T>
__global__ void lstm_bwd_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h_all,
    const T* __restrict__ c_all, const T* __restrict__ h0,
    const T* __restrict__ c0, const T* __restrict__ w_hh_t,
    const T* __restrict__ dh_all, const T* __restrict__ dh_T,
    const T* __restrict__ dc_T, T* __restrict__ dx_proj, T* __restrict__ dh0,
    T* __restrict__ dc0, int seq_len, int batch, int hidden, int block_b) {
  extern __shared__ float smem[];
  const int gate_dim = 4 * hidden;
  const int stride = w_stride(hidden);
  float* w = smem;
  float* h_prev = w + hidden * stride;         // (block_b, H)
  float* d_gates = h_prev + block_b * hidden;  // (block_b, 4H)
  const int row0 = blockIdx.x * block_b;
  const size_t step = (size_t)batch * hidden;

  stage_weights(w_hh_t, w, hidden);

  const int j = threadIdx.x % hidden;
  const int r0 = (threadIdx.x / hidden) * kRowsPerThread;
  float dh[kRowsPerThread];
  float dc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = row0 + r0 + r;
    const bool valid = b < batch;
    dh[r] = valid ? to_f32(dh_T[(size_t)b * hidden + j]) : 0.0f;
    dc[r] = valid ? to_f32(dc_T[(size_t)b * hidden + j]) : 0.0f;
  }

  for (int t = seq_len - 1; t >= 0; --t) {
    // h_{t-1} (h0 at t == 0) for the gate recompute
    stage_rows(t > 0 ? h_all + (t - 1) * step : h0, h_prev, row0, batch,
               hidden, block_b);
    __syncthreads();

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int b = row0 + r0 + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[r][k] =
            b < batch
                ? to_f32(x_proj[((size_t)t * batch + b) * gate_dim + k * hidden + j])
                : 0.0f;
      }
    }
    for (int m = 0; m < hidden; ++m) {
      const float* wm = w + m * stride + j;
      const float w0 = wm[0];
      const float w1 = wm[hidden];
      const float w2 = wm[2 * hidden];
      const float w3 = wm[3 * hidden];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float hv = h_prev[(r0 + r) * hidden + m];
        acc[r][0] = fmaf(hv, w0, acc[r][0]);
        acc[r][1] = fmaf(hv, w1, acc[r][1]);
        acc[r][2] = fmaf(hv, w2, acc[r][2]);
        acc[r][3] = fmaf(hv, w3, acc[r][3]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int b = row0 + r0 + r;
      const bool valid = b < batch;
      const size_t o = (size_t)b * hidden + j;
      const float ig = sigmoid(acc[r][0]);
      const float fg = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]);
      const float og = sigmoid(acc[r][3]);
      float c_prev = 0.0f, c_t = 0.0f, dh_t = 0.0f;
      if (valid) {
        c_prev = to_f32(t > 0 ? c_all[(t - 1) * step + o] : c0[o]);
        c_t = to_f32(c_all[t * step + o]);
        dh_t = to_f32(dh_all[t * step + o]);
      }
      const float dhv = dh[r] + dh_t;
      const float tc = tanhf(c_t);
      const float dcv = dc[r] + dhv * og * (1.0f - tc * tc);
      const float gi = dcv * gg * ig * (1.0f - ig);
      const float gf = dcv * c_prev * fg * (1.0f - fg);
      const float gc = dcv * ig * (1.0f - gg * gg);
      const float go = dhv * tc * og * (1.0f - og);
      float* dg_row = d_gates + (r0 + r) * gate_dim + j;
      dg_row[0] = gi;
      dg_row[hidden] = gf;
      dg_row[2 * hidden] = gc;
      dg_row[3 * hidden] = go;
      if (valid) {
        T* dx = dx_proj + ((size_t)t * batch + b) * gate_dim + j;
        dx[0] = from_f32<T>(gi);
        dx[hidden] = from_f32<T>(gf);
        dx[2 * hidden] = from_f32<T>(gc);
        dx[3 * hidden] = from_f32<T>(go);
      }
      dc[r] = dcv * fg;
    }
    __syncthreads();

    // dh_{t-1}[row, j] = sum_n d_gates[row, n] * w_hh_t[j, n]
    float acc_h[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc_h[r] = 0.0f;
    const float* wj = w + j * stride;
    for (int n = 0; n < gate_dim; ++n) {
      const float wv = wj[n];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc_h[r] = fmaf(d_gates[(r0 + r) * gate_dim + n], wv, acc_h[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) dh[r] = acc_h[r];
    // no barrier here: the next step first rewrites h_prev, which nobody
    // reads after the barrier above, and rewrites d_gates only after the
    // next step's first barrier, which every thread reaches after this loop
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = row0 + r0 + r;
    if (b < batch) {
      dh0[(size_t)b * hidden + j] = from_f32<T>(dh[r]);
      dc0[(size_t)b * hidden + j] = from_f32<T>(dc[r]);
    }
  }
}

template <typename T>
int launch_reg(const void* gates, const void* c_all, const void* c0, const void* w_hh_t,
               const void* dh_all, const void* dh_T, const void* dc_T, void* dx_proj, void* dh0,
               void* dc0, int seq_len, int batch, int hidden, cudaStream_t stream) {
  const dim3 grid((batch + kLanes - 1) / kLanes);
  const int threads = (kLanes * hidden + 31) / 32 * 32;
  lstm_bwd_reg_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c_all), static_cast<const T*>(c0),
      static_cast<const T*>(w_hh_t), static_cast<const T*>(dh_all),
      static_cast<const T*>(dh_T), static_cast<const T*>(dc_T), static_cast<T*>(dx_proj),
      static_cast<T*>(dh0), static_cast<T*>(dc0), seq_len, batch, hidden);
  return (int)cudaGetLastError();
}

// The one-block kernels: up to H = kRegHidden on quads of rows (block_b =
// kLanes) and the saved gates; above, on block_b-row tiles, recomputing
// the gates.
template <typename T>
int launch_smem(const void* x_proj, const void* gates, const void* h_all, const void* c_all,
                const void* h0, const void* c0, const void* w_hh_t,
                const void* dh_all, const void* dh_T, const void* dc_T,
                void* dx_proj, void* dh0, void* dc0, int seq_len, int batch,
                int hidden, int block_b, cudaStream_t stream) {
  if (hidden <= kRegHidden) {
    if (block_b != kLanes || gates == nullptr) return (int)cudaErrorInvalidValue;
    return launch_reg<T>(gates, c_all, c0, w_hh_t, dh_all, dh_T, dc_T, dx_proj, dh0, dc0,
                         seq_len, batch, hidden, stream);
  }
  if (gates != nullptr || block_b % kRowsPerThread != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(hidden, block_b);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 threads(hidden * (block_b / kRowsPerThread));
  lstm_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h_all),
      static_cast<const T*>(c_all), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<const T*>(w_hh_t),
      static_cast<const T*>(dh_all), static_cast<const T*>(dh_T),
      static_cast<const T*>(dc_T), static_cast<T*>(dx_proj),
      static_cast<T*>(dh0), static_cast<T*>(dc0), seq_len, batch, hidden,
      block_b);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the cluster variant (H = 111..512)
// ---------------------------------------------------------------------------

// R: batch rows a cluster, a row quad traveling as one float4; mirrored by
// ops/fused_rnn.py:LSTM_BWD_CLUSTER_ROWS
constexpr int kClusterRows = 4;
constexpr int kWarps = kClusterThreads / 32;
// where the f32 slice does not fit in shared memory, its rows past
// smem_rows (at most kWarps * kTailRows of them) sit in registers
constexpr int kTailRows = 8;
static_assert(kClusterRows == 4, "rows travel as float4");
static_assert(kClusterThreads / kClusterCtas >=
                  (kClusterMaxHidden + kClusterCtas - 1) / kClusterCtas,
              "the gather's lane groups cover a CTA's units");
static_assert(32 * 4 >= 4 * ((kClusterMaxHidden + kClusterCtas - 1) / kClusterCtas),
              "a warp's lanes cover a slice row's quads");

// out[r] = sum over e of d[e][r] w[e]: one row's four slice columns against
// the d_gates of those columns (a float4 of the R rows each)
__device__ __forceinline__ void quad_dot(const float4& w, const float4 (&d)[4], float (&out)[4]) {
  out[0] = fmaf(d[3].x, w.w, fmaf(d[2].x, w.z, fmaf(d[1].x, w.y, d[0].x * w.x)));
  out[1] = fmaf(d[3].y, w.w, fmaf(d[2].y, w.z, fmaf(d[1].y, w.y, d[0].y * w.x)));
  out[2] = fmaf(d[3].z, w.w, fmaf(d[2].z, w.z, fmaf(d[1].z, w.y, d[0].z * w.x)));
  out[3] = fmaf(d[3].w, w.w, fmaf(d[2].w, w.z, fmaf(d[1].w, w.y, d[0].w * w.x)));
}

// The backward's slice of W_hh^T in its own dtype: the 4U columns of the
// CTA's units' gates (Q = U column quads), rows at an odd number of quads
// apart, so that the quad reads of 8 consecutive rows m (the contraction)
// fall in distinct banks.
struct BwdShape {
  int units;   // U: units a CTA owns
  int quads;   // Q: column quads of the slice, 4Q = 4U columns
  int stride;  // the slice's row stride in elements, 4 (Q | 1)
};

__host__ __device__ inline BwdShape bwd_shape(int hidden) {
  BwdShape s;
  s.units = (hidden + kClusterCtas - 1) / kClusterCtas;
  s.quads = s.units;
  s.stride = 4 * (s.quads | 1);
  return s;
}

// the float4 tiles ahead of the slice: the two partial stages (H each) and
// the d_gates (4Q)
size_t bwd_tile_bytes(int hidden) {
  return sizeof(float4) * (2 * (size_t)hidden + 4 * bwd_shape(hidden).quads);
}

// The slice's rows m in shared memory at this width: all H where the slice
// fits beside the tiles (bf16 always, float32 up to H = 464), else the most
// rows, a multiple of 16, that fit, the others (at most 128) then sitting
// in registers; 0 where that does not fit either.
template <typename T>
int bwd_smem_rows(int hidden) {
  const size_t tiles = bwd_tile_bytes(hidden);
  const size_t row_bytes = sizeof(T) * bwd_shape(hidden).stride;
  if (tiles + hidden * row_bytes <= kMaxSmemBytes) return hidden;
  const int fit = (int)((kMaxSmemBytes - tiles) / row_bytes) / kWarps * kWarps;
  return hidden - fit <= kWarps * kTailRows ? fit : 0;
}

template <typename T>
size_t bwd_cluster_smem_bytes(int hidden) {
  return bwd_tile_bytes(hidden) +
         sizeof(T) * (size_t)bwd_smem_rows<T>(hidden) * bwd_shape(hidden).stride;
}

// kTail: the slice's rows past smem_rows sit in registers (float32 above
// the width where the whole slice fits in shared memory).
template <typename T, bool kTail>
__global__ void __launch_bounds__(kClusterThreads, 1) lstm_bwd_cluster_kernel(
    const T* __restrict__ gates, const T* __restrict__ c_all, const T* __restrict__ c0,
    const T* __restrict__ w_hh_t, const T* __restrict__ dh_all, const T* __restrict__ dh_T,
    const T* __restrict__ dc_T, T* __restrict__ dx_proj, T* __restrict__ dh0,
    T* __restrict__ dc0, int seq_len, int batch, int hidden, int smem_rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const BwdShape cs = bwd_shape(hidden);
  const int units = cs.units;
  const int cols = 4 * units;
  const int gate_dim = 4 * hidden;
  const size_t step = (size_t)batch * hidden;
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / kClusterCtas) * kClusterRows;
  const int unit0 = (int)cluster.block_rank() * units;

  extern __shared__ __align__(16) float smem[];
  float4* part = reinterpret_cast<float4*>(smem);  // (2, H) x R: partials
  // (4Q) x R, column k U + u for gate k of own unit u: the items' d_gates
  float4* gd = part + 2 * hidden;
  T* w_s = reinterpret_cast<T*>(gd + 4 * cs.quads);  // (smem_rows, stride)

  // W_hh^T's column of slice column c, -1 past H and past 4U
  auto column = [&](int c) {
    const int j = unit0 + c % units;
    return c < cols && j < hidden ? (c / units) * hidden + j : -1;
  };
  for (int i = tid; i < smem_rows * 4 * cs.quads; i += kClusterThreads) {
    const int m = i / (4 * cs.quads);
    const int c = i - m * 4 * cs.quads;
    const int col = column(c);
    w_s[m * cs.stride + c] = col >= 0 ? w_hh_t[(size_t)m * gate_dim + col] : from_f32<T>(0.0f);
  }
  // the rows past smem_rows: lane l of warp w keeps quad l of rows
  // smem_rows + w + 16 i, 0 past H and past the quads
  const int warp = tid / 32;
  const int lane = tid % 32;
  float4 w_tail[kTail ? kTailRows : 1];
  if constexpr (kTail) {
#pragma unroll
    for (int i = 0; i < kTailRows; ++i) {
      const int m = smem_rows + warp + kWarps * i;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = column(4 * lane + e);
        v[e] = m < hidden && col >= 0 ? to_f32(w_hh_t[(size_t)m * gate_dim + col]) : 0.0f;
      }
      w_tail[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

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
  float ga[4], dh_in, c_t, c_prev;
  auto load_item = [&](int t) {
    const size_t g = ((size_t)t * batch + b) * gate_dim + j;
    const size_t o = (size_t)b * hidden + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) ga[k] = live ? to_f32(gates[g + k * hidden]) : 0.0f;
    dh_in = live ? to_f32(dh_all[t * step + o]) : 0.0f;
    c_t = live ? to_f32(c_all[t * step + o]) : 0.0f;
    c_prev = live ? to_f32(t > 0 ? c_all[(t - 1) * step + o] : c0[o]) : 0.0f;
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
  const float dh_top = live ? to_f32(dh_T[(size_t)b * hidden + j]) : 0.0f;
  float dc_carry = live ? to_f32(dc_T[(size_t)b * hidden + j]) : 0.0f;

  // the rows in shared memory take two rows m an iteration of the
  // contraction in bf16, one in float32, which would spill otherwise
  constexpr int kUnroll = sizeof(T) == sizeof(float) ? 1 : 2;

  load_item(seq_len - 1);
  cluster.sync();  // slices staged; every CTA of the cluster running

  for (int t = seq_len - 1; t >= 0; --t) {
    // dh_t of the item: the contraction of step t + 1 summed over the
    // cluster (dh_T at the start), and dh_all[t]
    const float dh = dh_in + (t < seq_len - 1 ? gather((t + 1) & 1) : dh_top);

    if (item) {
      const float ig = ga[0], fg = ga[1], gg = ga[2], og = ga[3];
      const float tc = tanhf(c_t);
      const float dc = dc_carry + dh * og * (1.0f - tc * tc);
      const float di = dc * gg * ig * (1.0f - ig);
      const float df = dc * c_prev * fg * (1.0f - fg);
      const float dg = dc * ig * (1.0f - gg * gg);
      const float dov = dh * tc * og * (1.0f - og);
      float* g = reinterpret_cast<float*>(gd) + uj * kClusterRows + ir;
      const int gate_step = units * kClusterRows;  // between gates k and k + 1
      g[0] = di;
      g[gate_step] = df;
      g[2 * gate_step] = dg;
      g[3 * gate_step] = dov;
      dc_carry = dc * fg;  // dc_{t-1}: per unit, it never leaves the item
      if (live) {
        const size_t o = ((size_t)t * batch + b) * gate_dim + j;
        dx_proj[o] = from_f32<T>(di);
        dx_proj[o + hidden] = from_f32<T>(df);
        dx_proj[o + 2 * hidden] = from_f32<T>(dg);
        dx_proj[o + 3 * hidden] = from_f32<T>(dov);
      }
    }
    __syncthreads();  // d_gates whole

    // part[m][r] = sum over the slice's columns n of d_g[n][r] W_hh^T[m][n]
    float4* out = part + (t & 1) * hidden;
    if constexpr (kTail) {
      // the rows past smem_rows, first: lane l's four columns 4l .. 4l + 3
      // for each of its 8 rows and 4 batch rows (value 4 i + r), summed
      // over the warp's 32 lanes (the column quads) by halving exchanges,
      // so that lane l ends with row l / 4, batch row l % 4
      float4 d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = lane < cs.quads ? gd[4 * lane + e] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      // the first halving (rows i against i + 4, over lanes 16 apart) as
      // the rows' values are formed, so that 16 of them are live at once
      static_assert(kTailRows == 8, "rows i and i + 4 meet in the first halving");
      const bool upper = lane & 16;
      float p[16];
#pragma unroll
      for (int i = 0; i < kTailRows / 2; ++i) {
        float lo[4], hi[4];
        quad_dot(w_tail[i], d, lo);
        quad_dot(w_tail[i + kTailRows / 2], d, hi);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float give = upper ? lo[r] : hi[r];
          p[4 * i + r] = (upper ? hi[r] : lo[r]) + __shfl_xor_sync(0xffffffffu, give, 16);
        }
      }
      reduce_scatter<16, 16>(p, lane);
      const int m = smem_rows + warp + kWarps * (lane / 4);
      if (m < hidden) reinterpret_cast<float*>(out + m)[lane % 4] = p[0];
    }
    // the rows in shared memory, four columns a quad read (the padding
    // columns hold zero weights); rows m and m + half a thread, so each
    // read of d_gates feeds both
    const int half = (smem_rows + 1) / 2;
    for (int m0 = tid; m0 < half; m0 += kClusterThreads) {
      const int m1 = m0 + half < smem_rows ? m0 + half : m0;
      const T* wr0 = w_s + m0 * cs.stride;
      const T* wr1 = w_s + m1 * cs.stride;
      float4 a[4], b4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = b4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll kUnroll
      for (int q = 0; q < cs.quads; ++q) {
        const float4 w0 = load_quad(wr0 + 4 * q);
        const float4 w1 = load_quad(wr1 + 4 * q);
        const float4 d0 = gd[4 * q];
        const float4 d1 = gd[4 * q + 1];
        const float4 d2 = gd[4 * q + 2];
        const float4 d3 = gd[4 * q + 3];
        fma4(a[0], d0, w0.x);
        fma4(a[1], d1, w0.y);
        fma4(a[2], d2, w0.z);
        fma4(a[3], d3, w0.w);
        fma4(b4[0], d0, w1.x);
        fma4(b4[1], d1, w1.y);
        fma4(b4[2], d2, w1.z);
        fma4(b4[3], d3, w1.w);
      }
      fma4(a[0], a[1], 1.0f);
      fma4(a[2], a[3], 1.0f);
      fma4(a[0], a[2], 1.0f);
      fma4(b4[0], b4[1], 1.0f);
      fma4(b4[2], b4[3], 1.0f);
      fma4(b4[0], b4[2], 1.0f);
      out[m0] = a[0];
      if (m1 != m0) out[m1] = b4[0];
    }
    // publish the partials (release); the other stage, read by the peers
    // during this step, is free again once every CTA has arrived, and so
    // are the d_gates.  Step t - 1's inputs are loaded before the wait
    cluster_arrive();
    if (t > 0) load_item(t - 1);
    cluster_wait();  // the peers' partials of this step (acquire)
  }

  const float dh_last = gather(0);
  if (live) {
    dh0[(size_t)b * hidden + j] = from_f32<T>(dh_last);
    dc0[(size_t)b * hidden + j] = from_f32<T>(dc_carry);
  }
  cluster.sync();  // no CTA leaves while a peer reads its partials
}

// The launch arguments of the cluster kernel.
template <typename T>
struct BwdArgs {
  const T* gates;
  const T* c_all;
  const T* c0;
  const T* w_hh_t;
  const T* dh_all;
  const T* dh_T;
  const T* dc_T;
  T* dx_proj;
  T* dh0;
  T* dc0;
  int seq_len;
};

// The cluster kernel instance <T, kTail>: its launch configuration (see
// cluster_launch_config, cluster_common.cuh), the clusters resident at once
// in *active, then the launch unless args is null.
template <typename T, bool kTail>
int cluster_as(const BwdArgs<T>* args, int hidden, int batch, int smem_rows,
               cudaStream_t stream, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = cluster_launch_config(
      lstm_bwd_cluster_kernel<T, kTail>, bwd_cluster_smem_bytes<T>(hidden),
      (batch + kClusterRows - 1) / kClusterRows, stream, cfg, attr, active);
  if (err != 0 || args == nullptr) return err;
  cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<T, kTail>, args->gates, args->c_all,
                     args->c0, args->w_hh_t, args->dh_all, args->dh_T, args->dc_T,
                     args->dx_proj, args->dh0, args->dc0, args->seq_len, batch, hidden,
                     smem_rows);
  return (int)cudaGetLastError();
}

// The cluster kernel at (hidden, rows = kClusterRows), with the slice's
// tail in registers where the float32 slice does not fit in shared memory;
// cudaErrorInvalidValue where it does not take the width.
template <typename T>
int launch_cluster(const BwdArgs<T>* args, int hidden, int batch, int rows, cudaStream_t stream,
                   int* active) {
  const int smem_rows = bwd_smem_rows<T>(hidden);
  if (rows != kClusterRows || hidden > kClusterMaxHidden || smem_rows == 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_rows == hidden) return cluster_as<T, false>(args, hidden, batch, smem_rows, stream, active);
  if constexpr (sizeof(T) == sizeof(float)) {
    return cluster_as<T, true>(args, hidden, batch, smem_rows, stream, active);
  }
  return (int)cudaErrorInvalidValue;
}

// variant codes passed from Python (ops/fused_rnn.py:_VARIANTS)
constexpr int kVariantSmem = 0;
constexpr int kVariantCluster = 1;

template <typename T>
int launch_dtype(const void* x_proj, const void* h_all, const void* c_all, const void* h0,
                 const void* c0, const void* w_hh_t, const void* dh_all, const void* dh_T,
                 const void* dc_T, const void* gates, void* dx_proj, void* dh0, void* dc0,
                 int seq_len, int batch, int hidden, int block_b, int variant,
                 cudaStream_t stream) {
  if (variant == kVariantSmem) {
    return launch_smem<T>(x_proj, gates, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T,
                          dx_proj, dh0, dc0, seq_len, batch, hidden, block_b, stream);
  }
  if (variant == kVariantCluster && gates != nullptr) {
    const BwdArgs<T> args{
        static_cast<const T*>(gates),  static_cast<const T*>(c_all),
        static_cast<const T*>(c0),     static_cast<const T*>(w_hh_t),
        static_cast<const T*>(dh_all), static_cast<const T*>(dh_T),
        static_cast<const T*>(dc_T),   static_cast<T*>(dx_proj),
        static_cast<T*>(dh0),          static_cast<T*>(dc0),
        seq_len};
    int active = 0;
    return launch_cluster<T>(&args, hidden, batch, block_b, stream, &active);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or the error
// that kept the variant from launching.  Shapes, dtypes, block_b and the
// variant are checked and chosen by the Python wrapper (ops/fused_rnn.py:
// lstm_bwd, lstm_bwd_tile): variant 0 runs the one-block kernels: up to H
// = 32 on quads of rows (block_b = 4) on the activated gates the forward
// saved (then x_proj, h_all and h0 are unused); above, on block_b-row
// tiles, recomputing them from x_proj and h_all (gates null); variant 1 the
// cluster kernel (block_b =
// kClusterRows) on the activated gates the forward's cluster kernel saved
// (x_proj, h_all and h0 unused).
extern "C" int lstm_bwd(const void* x_proj, const void* h_all,
                        const void* c_all, const void* h0, const void* c0,
                        const void* w_hh_t, const void* dh_all,
                        const void* dh_T, const void* dc_T, const void* gates, void* dx_proj,
                        void* dh0, void* dc0, int seq_len, int batch,
                        int hidden, int block_b, int variant, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dtype<float>(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T, gates,
                               dx_proj, dh0, dc0, seq_len, batch, hidden, block_b, variant, s);
  }
  if (dtype == kBFloat16) {
    return launch_dtype<__nv_bfloat16>(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T,
                                       dc_T, gates, dx_proj, dh0, dc0, seq_len, batch, hidden,
                                       block_b, variant, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster variant's shape at (hidden, batch) for a report: out[0] CTAs
// a cluster, out[1] batch rows a cluster, out[2] clusters resident at once,
// out[3] dynamic shared memory bytes a CTA, out[4] rows of the W_hh^T
// slice in shared memory (the rest out of it).  Returns the error code of
// the launch configuration (0 = at least one cluster fits).
extern "C" int lstm_bwd_cluster_shape(int hidden, int batch, int dtype, int* out) {
  int active = 0;
  int err = (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    err = launch_cluster<float>(nullptr, hidden, batch, kClusterRows, nullptr, &active);
    out[3] = (int)bwd_cluster_smem_bytes<float>(hidden);
    out[4] = bwd_smem_rows<float>(hidden);
  }
  if (dtype == kBFloat16) {
    err = launch_cluster<__nv_bfloat16>(nullptr, hidden, batch, kClusterRows, nullptr, &active);
    out[3] = (int)bwd_cluster_smem_bytes<__nv_bfloat16>(hidden);
    out[4] = bwd_smem_rows<__nv_bfloat16>(hidden);
  }
  out[0] = kClusterCtas;
  out[1] = kClusterRows;
  out[2] = active;
  return err;
}
