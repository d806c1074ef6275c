// Fused LSTM forward time loop for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:
// _lstm_fwd_kernel (launched by _lstm_fwd_pallas).  Per step t:
//   gates = x_proj[t] + h @ w_hh_t;  i, f, g, o = sigmoid, sigmoid, tanh, sigmoid
//   c = f * c + i * g;  h = o * tanh(c);  h_all[t] = h;  c_all[t] = c
// with h and c carried in float32 and stored in the input dtype.
//
// What bounds it: bytes.  At the motion model's shape (T=128, B=1440,
// H=32, f32) it must read x_proj (94 MB) and write h_all + c_all (47 MB),
// about 42 us at 3.35 TB/s, against 1.5 GFLOP of f32 FMAs (23 us at
// 67 TFLOP/s); and it is a chain of T dependent steps, so what a design
// can reach is set by how short one step is.
//
// Design: T is a loop inside the block, and one block owns one tile of
// block_b batch rows (a multiple of 4) for the whole sequence; the ragged
// last tile is masked, not padded.  The block's threads form, for each
// quad of rows and each unit j, a group of kLanes = 4 neighbouring lanes
// that split the contraction over H: lane p takes the rows m of W_hh^T in
// its chunk [p K, (p + 1) K) for all four gates of unit j and all four
// rows of the quad, 16 sums, and the group's halving shuffle exchange
// (reduce_scatter) leaves lane p with the four gate sums of row p of the
// quad.  So lane p owns one (row, unit): its c lives in its register, and
// it forms h, writes h_all and c_all, and puts h into the double-buffered
// shared h tile (one barrier a step).  A step's chain is thus a quarter of
// a row's contraction per lane, two shuffle rounds and one cell update,
// and the next step's x_proj is loaded into registers while this step
// computes.  Up to H = kRegHidden = 32 a lane's chunk of W_hh^T (4 gates
// x 8 rows m, 32 floats) sits in its registers for the whole sequence and
// its h rows come as 16-byte broadcast reads; tiles of 4 rows make blocks
// of 128 threads, several to an SM.  Above it (up to H = 110) W_hh^T is
// staged once in shared memory (row stride 4H + 1) and read from there.
// No tensor cores: a (block_b, H) x (H, 4H) product per step is too small
// to feed them.
//
// Cluster (lstm_fwd_cluster_kernel, H = 111..512): at H = 512 W_hh^T is 4
// MiB in float32, and a block that reads it from L2 every step runs at one
// SM's issue rate.  So, as csrc/gru_fwd.cu:gru_fwd_cluster_kernel, a
// cluster of kClusterCtas = 16 CTAs owns one tile of kFwdClusterRows = 8
// batch rows (4 where the f32 slice does not fit, below), and CTA c owns
// the units [c U, (c + 1) U), U = ceil(H / 16), keeping the 4U columns of
// W_hh^T of its units' i, f, g and o gates (its slice, in the weights' own
// dtype), so no partial sum crosses the
// cluster: h_t does.  A step t, on 512 threads:
//   1. gather: h_{t-1} of all 16 U units and the R rows, pulled from the 16
//      owners' published tiles through DSMEM, into planes of 4 rows (one
//      float4 a unit);
//   2. the gate products h_{t-1} (R x H) . slice (H x 4U): a warp per
//      column octet, its 32 lanes splitting the H rows, reduced by shuffle
//      exchanges (reduce_scatter) into the gate sums tile;
//   3. the R x U items (row, own unit) form the gates, carry c in a
//      register, and publish h_t into the stage of this step's parity;
//   4. the split cluster barrier: arrive (release), h_all[t], c_all[t]
//      stored and x_proj[t + 1] loaded, wait (acquire).
// The items also store the activated gates i, f, g, o (T, B, 4H), which
// the backward's cluster kernel reads in place of recomputing them
// (csrc/lstm_bwd.cu); before the arrive, as their four registers would
// spill past it.
// Where the slice does not fit in shared memory (float32 above H = 448: at
// H = 512 it is 264 KiB, against 227 KiB a CTA, and 16 CTAs are the
// largest cluster), its last rows sit in registers: each lane keeps its
// octet of up to kTailRows of its rows m (32 floats), loaded once.  Beside
// the 64 sums of 8 rows that spills past the 128 registers 512 threads
// allow, so the cluster then takes kFwdTailClusterRows = 4 rows.  bf16
// slices are held as bf16 (exact: the products widen them to float32) and
// fit up to H = 512 (136 KiB).  What bounds it at (T=128, B=256, H=512,
// f32): 68.7 GFLOP of f32 FMAs (1.03 ms at 67 TFLOP/s) against 0.40 GB
// (0.12 ms); a step is R x H x 4U = 0.52 M FMA a CTA, and B / R clusters
// run in waves.
#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pdrnn;

constexpr int kLanes = 4;        // lanes splitting one (row quad, unit)'s contraction
constexpr int kRegHidden = 32;   // up to this width W_hh^T sits in registers
constexpr int kRegChunk = kRegHidden / kLanes;  // rows m of W a lane holds
constexpr int kFwdMaxThreads = 512;
static_assert(kLanes == kRowsPerThread, "lane p of a group owns row p of its quad");

// K: rows m of W_hh^T (and of the h tile) in a lane's chunk, a multiple
// of 4 so that h moves in 16-byte reads
__host__ __device__ inline int fwd_chunk(int hidden) {
  return hidden <= kRegHidden ? kRegChunk : 4 * ((hidden + 4 * kLanes - 1) / (4 * kLanes));
}

size_t fwd_smem_bytes(int hidden, int block_b, bool w_in_smem) {
  const size_t w = w_in_smem ? (size_t)hidden * w_stride(hidden) : 0;
  return sizeof(float) * (w + 2 * (size_t)block_b * kLanes * fwd_chunk(hidden));
}

template <typename T, bool kWRegs>
__global__ void __launch_bounds__(kFwdMaxThreads) lstm_fwd_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ w_hh_t, T* __restrict__ h_all, T* __restrict__ c_all,
    int seq_len, int batch, int hidden, int block_b) {
  extern __shared__ __align__(16) float smem[];
  const int gate_dim = 4 * hidden;
  const int chunk = kWRegs ? kRegChunk : fwd_chunk(hidden);
  const int h_stride = kLanes * chunk;  // floats a row of the h tile, zeros past H
  const int tile = block_b * h_stride;
  const int w_rows = kWRegs ? 0 : hidden;
  const float* w_s = smem;
  float* h_buf = smem + w_rows * w_stride(hidden);
  const int row0 = blockIdx.x * block_b;
  const int tid = threadIdx.x;

  // thread (row quad q, unit j, lane p); the block is rounded up to whole
  // warps, and the threads past the tile shuffle along but write nothing
  const bool valid = tid < block_b * hidden;
  const int p = tid % kLanes;
  const int j = (tid / kLanes) % hidden;
  const int q = valid ? tid / (kLanes * hidden) : 0;
  const int row = q * kLanes + p;  // the row this lane owns
  const int b = row0 + row;
  const bool live = valid && b < batch;
  const int m0 = p * chunk;

  if constexpr (!kWRegs) stage_weights(w_hh_t, smem, hidden);
  for (int i = tid; i < 2 * tile; i += blockDim.x) {
    const int r = i / h_stride;
    const int m = i - r * h_stride;
    const int bb = row0 + r;
    h_buf[i] = i < tile && m < hidden && bb < batch ? to_f32(h0[(size_t)bb * hidden + m]) : 0.0f;
  }

  float w_reg[4][kWRegs ? kRegChunk : 1];
  if constexpr (kWRegs) {
#pragma unroll
    for (int i = 0; i < kRegChunk; ++i) {
      const int m = m0 + i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w_reg[k][i] = m < hidden ? to_f32(w_hh_t[(size_t)m * gate_dim + k * hidden + j]) : 0.0f;
      }
    }
  }
  float c = live ? to_f32(c0[(size_t)b * hidden + j]) : 0.0f;
  float xg[4];
  auto load_x = [&](int t) {
    const T* xp = x_proj + ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) xg[k] = live ? to_f32(xp[k * hidden]) : 0.0f;
  };
  load_x(0);
  __syncthreads();

  for (int t = 0; t < seq_len; ++t) {
    const float* h_prev = h_buf + (t & 1) * tile + q * kLanes * h_stride + m0;
    float* h_next = h_buf + ((t + 1) & 1) * tile;
    float x_now[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x_now[k] = xg[k];
    if (t + 1 < seq_len) load_x(t + 1);  // lands while this step computes

    // acc[r * 4 + k]: gate k of row r of the quad, over this lane's chunk
    float acc[4 * kLanes];
#pragma unroll
    for (int i = 0; i < 4 * kLanes; ++i) acc[i] = 0.0f;
    if constexpr (kWRegs) {
#pragma unroll
      for (int i4 = 0; i4 < kRegChunk / 4; ++i4) {
#pragma unroll
        for (int r = 0; r < kLanes; ++r) {
          const float4 hv = reinterpret_cast<const float4*>(h_prev + r * h_stride)[i4];
          const float h[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[r * 4 + k] = fmaf(h[e], w_reg[k][4 * i4 + e], acc[r * 4 + k]);
            }
          }
        }
      }
    } else {
      const int stride = w_stride(hidden);
      const int m_end = min(chunk, hidden - m0);
#pragma unroll 2
      for (int i = 0; i < m_end; ++i) {
        const float* wm = w_s + (m0 + i) * stride + j;
        const float w[4] = {wm[0], wm[hidden], wm[2 * hidden], wm[3 * hidden]};
#pragma unroll
        for (int r = 0; r < kLanes; ++r) {
          const float hv = h_prev[r * h_stride + i];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r * 4 + k] = fmaf(hv, w[k], acc[r * 4 + k]);
        }
      }
    }
    reduce_scatter<4 * kLanes, kLanes>(acc, p);  // acc[0..3]: row p's four gates

    const float ig = sigmoid(x_now[0] + acc[0]);
    const float fg = sigmoid(x_now[1] + acc[1]);
    const float gg = tanhf(x_now[2] + acc[2]);
    const float og = sigmoid(x_now[3] + acc[3]);
    c = fg * c + ig * gg;
    const float h = og * tanhf(c);
    if (valid) h_next[row * h_stride + j] = h;
    if (live) {
      const size_t o = ((size_t)t * batch + b) * hidden + j;
      h_all[o] = from_f32<T>(h);
      c_all[o] = from_f32<T>(c);
    }
    __syncthreads();
  }
}

template <typename T, bool kWRegs>
int launch(const void* x_proj, const void* h0, const void* c0,
           const void* w_hh_t, void* h_all, void* c_all, int seq_len,
           int batch, int hidden, int block_b, cudaStream_t stream) {
  const int threads = (block_b * hidden + 31) / 32 * 32;
  if (block_b < kLanes || block_b % kLanes != 0 || threads > kFwdMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fwd_smem_bytes(hidden, block_b, !kWRegs);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T, kWRegs>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  lstm_fwd_kernel<T, kWRegs><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<const T*>(w_hh_t),
      static_cast<T*>(h_all), static_cast<T*>(c_all), seq_len, batch, hidden,
      block_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_smem(const void* x_proj, const void* h0, const void* c0,
                const void* w_hh_t, void* h_all, void* c_all, int seq_len,
                int batch, int hidden, int block_b, cudaStream_t stream) {
  if (hidden <= kRegHidden) {
    return launch<T, true>(x_proj, h0, c0, w_hh_t, h_all, c_all, seq_len, batch, hidden,
                           block_b, stream);
  }
  return launch<T, false>(x_proj, h0, c0, w_hh_t, h_all, c_all, seq_len, batch, hidden,
                          block_b, stream);
}

// ---------------------------------------------------------------------------
// the cluster variant (H = 111..512)
// ---------------------------------------------------------------------------

// R: batch rows a cluster where the slice fits in shared memory, and where
// the f32 slice's last rows sit in registers (where 8 rows leave no
// registers for them); mirrored by ops/fused_rnn.py:LSTM_FWD_CLUSTER_ROWS,
// LSTM_FWD_TAIL_CLUSTER_ROWS.
constexpr int kFwdClusterRows = 8;
constexpr int kFwdTailClusterRows = 4;
// a warp takes one column octet of the gate products, its 32 lanes split
// the rows m of the slice
constexpr int kGateLanes = 32;
constexpr int kOctet = 8;
// rows m of its octet a lane holds in registers where the f32 slice does
// not fit in shared memory: the slice's last 32 kTailRows rows at most
constexpr int kTailRows = 4;

// The forward's slice of W_hh^T in its own dtype: the 4U columns of the
// CTA's units' i, f, g and o gates, zero-padded to whole octets, rows at an
// odd number of 16-byte units apart, so that 16-byte reads of 8
// consecutive rows m fall in 8 distinct bank quads.
struct FwdShape {
  int units;   // U
  int octets;  // O: column octets, 8 O >= 4U
  int stride;  // row stride in elements: 8 O + 4 floats, or 8 (O | 1) bf16
};

template <typename T>
__host__ __device__ inline FwdShape fwd_shape(int hidden) {
  FwdShape s;
  s.units = (hidden + kClusterCtas - 1) / kClusterCtas;
  s.octets = (4 * s.units + kOctet - 1) / kOctet;
  s.stride = sizeof(T) == 4 ? kOctet * s.octets + 4 : kOctet * (s.octets | 1);
  return s;
}

// h_{t-1} of the cluster's 16 U units (R / 4 planes of 16 U float4); the
// own units' published h, one stage per step parity (2, U, R); the gate
// sums (R, 8 O): the float32 tiles ahead of the slice
size_t fwd_tile_bytes(int hidden, int rows) {
  const FwdShape s = fwd_shape<float>(hidden);
  return sizeof(float) * ((kClusterCtas + 2) * (size_t)s.units * rows +
                          (size_t)rows * kOctet * s.octets);
}

// The slice's rows m in shared memory at this width and rows a cluster:
// all H where the slice fits beside the tiles (at 8 rows: bf16 always,
// float32 up to H = 448), else the
// most rows, a multiple of 32, that fit, the other rows (at most kTailRows
// a lane) then sitting in registers; 0 where that does not fit either.
template <typename T>
int fwd_smem_rows(int hidden, int rows) {
  const size_t tiles = fwd_tile_bytes(hidden, rows);
  const size_t row_bytes = sizeof(T) * fwd_shape<T>(hidden).stride;
  if (tiles + hidden * row_bytes <= kMaxSmemBytes) return hidden;
  const int fit = (int)((kMaxSmemBytes - tiles) / row_bytes) / kGateLanes * kGateLanes;
  return hidden - fit <= kGateLanes * kTailRows ? fit : 0;
}

template <typename T>
size_t fwd_cluster_smem_bytes(int hidden, int rows) {
  return fwd_tile_bytes(hidden, rows) +
         sizeof(T) * (size_t)fwd_smem_rows<T>(hidden, rows) * fwd_shape<T>(hidden).stride;
}

// kTail: the slice's rows past smem_rows sit in registers (float32 above
// the width where the whole slice fits in shared memory).
template <typename T, int R, bool kTail>
__global__ void __launch_bounds__(kClusterThreads, 1) lstm_fwd_cluster_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ w_hh_t, T* __restrict__ h_all, T* __restrict__ c_all,
    T* __restrict__ gates, int seq_len, int batch, int hidden, int smem_rows) {
  // h travels and is read in planes of 4 rows, one float4 a unit
  constexpr int kPlanes = R / 4;
  // a lane's sums: 8 columns x R rows; after the reduction R / 4 of them
  constexpr int kSums = kOctet * R;
  constexpr int kKept = kSums / kGateLanes;
  // float4 a thread gathers a step, at most (16 CTAs x 32 units x R rows)
  constexpr int kGatherLoads =
      kClusterCtas * ((kClusterMaxHidden + kClusterCtas - 1) / kClusterCtas) * kPlanes /
      kClusterThreads;
  static_assert(R % 4 == 0 && kKept >= 1 && kGatherLoads >= 1, "rows travel in float4 planes");
  cg::cluster_group cluster = cg::this_cluster();
  const FwdShape cs = fwd_shape<T>(hidden);
  const int units = cs.units;
  const int cols = 4 * units;
  const int sum_stride = kOctet * cs.octets;  // a row of the gate sums tile
  const int gate_dim = 4 * hidden;
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / kClusterCtas) * R;
  const int unit0 = (int)cluster.block_rank() * units;

  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;  // plane s, unit m: rows 4s .. 4s + 3 of h_{t-1}[m] as a float4
  float* pub = h_s + kClusterCtas * units * R;  // (2, U, R): h_t of the own units
  float* gd = pub + 2 * units * R;              // (R, 8 O): column k U + u of gate k, unit u
  T* w_s = reinterpret_cast<T*>(gd + R * sum_stride);  // (smem_rows, stride)
  const float4* h4 = reinterpret_cast<const float4*>(h_s);

  // the slice: W_hh^T[m][k H + unit0 + u] at column k U + u, 0 past H and
  // past 4U (the padding columns between 8 O and the stride are never read)
  auto slice_at = [&](int m, int c) -> T {
    const int j = unit0 + c % units;
    return c < cols && j < hidden && m < hidden
               ? w_hh_t[(size_t)m * gate_dim + (c / units) * hidden + j]
               : from_f32<T>(0.0f);
  };
  for (int i = tid; i < smem_rows * sum_stride; i += kClusterThreads) {
    const int m = i / sum_stride;
    const int c = i - m * sum_stride;
    w_s[m * cs.stride + c] = slice_at(m, c);
  }
  // h0 of every unit, 0 past H and past the batch
  const int plane = kClusterCtas * units;  // float4 a plane
  for (int i = tid; i < kClusterCtas * units * R; i += kClusterThreads) {
    const int s = i / (4 * plane);
    const int m = (i / 4) % plane;
    const int b = row0 + 4 * s + i % 4;
    h_s[i] = m < hidden && b < batch ? to_f32(h0[(size_t)b * hidden + m]) : 0.0f;
  }

  // The items: (row ir, own unit uj; global unit j), units fastest, so that
  // x_proj, h_all and c_all move in runs of U consecutive values.  Each
  // carries its c in a register from step to step.
  const bool item = tid < units * R;
  const int uj = tid % units;
  const int ir = tid / units;
  const int j = unit0 + uj;
  const int b = row0 + ir;
  const bool unit_ok = item && j < hidden;
  const bool live = unit_ok && b < batch;  // an item with real data
  float xg[4];
  float c_carry = live ? to_f32(c0[(size_t)b * hidden + j]) : 0.0f;
  float h_new = 0.0f;
  auto load_x = [&](int t) {
    const size_t g = ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) xg[k] = live ? to_f32(x_proj[g + k * hidden]) : 0.0f;
  };

  // The gate products: warp go takes column octet go, lane ks the rows
  // m = ks, ks + 32, ... of the slice; 8R sums (8 columns x R rows, sum
  // c R + r) a lane, reduced over the warp so that lane ks ends with sums
  // kKept ks + e.  Warps past the octets sit out.  Past smem_rows the
  // lane's rows come from its registers.
  const int go = tid / kGateLanes;
  const int ks = tid % kGateLanes;
  float w_tail[kTail ? kTailRows : 1][kOctet];
  if constexpr (kTail) {
#pragma unroll
    for (int i = 0; i < kTailRows; ++i) {
#pragma unroll
      for (int c = 0; c < kOctet; ++c) {
        w_tail[i][c] = to_f32(slice_at(smem_rows + ks + kGateLanes * i, kOctet * go + c));
      }
    }
  }
  auto fma_rows = [&](float (&acc)[kSums], int m, const float (&w)[kOctet]) {
    float h[R];
#pragma unroll
    for (int s = 0; s < kPlanes; ++s) {
      const float4 hv = h4[s * plane + m];
      h[4 * s] = hv.x;
      h[4 * s + 1] = hv.y;
      h[4 * s + 2] = hv.z;
      h[4 * s + 3] = hv.w;
    }
#pragma unroll
    for (int c = 0; c < kOctet; ++c) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c * R + r] = fmaf(h[r], w[c], acc[c * R + r]);
    }
  };
  // two rows m an iteration in float32; one in bf16, whose unpacking
  // would otherwise spill at 8 rows
  constexpr int kUnroll = sizeof(T) == sizeof(float) ? 2 : 1;
  auto gate_products = [&]() {
    if (go >= cs.octets) return;
    float acc[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
#pragma unroll kUnroll
    for (int m = ks; m < smem_rows; m += kGateLanes) {
      float w[kOctet];
      load_octet(w_s + m * cs.stride + kOctet * go, w);
      fma_rows(acc, m, w);
    }
    if constexpr (kTail) {
#pragma unroll
      for (int i = 0; i < kTailRows; ++i) {
        const int m = smem_rows + ks + kGateLanes * i;
        if (m < hidden) fma_rows(acc, m, w_tail[i]);
      }
    }
    reduce_scatter<kSums, kGateLanes>(acc, ks);
#pragma unroll
    for (int e = 0; e < kKept; ++e) {
      const int v = kKept * ks + e;
      gd[(v % R) * sum_stride + kOctet * go + v / R] = acc[e];
    }
  };

  // h_{t-1} of every unit from the owners' stage st: float4 k of owner c
  // (unit u = k / kPlanes, plane k % kPlanes) lands at unit c U + u of its
  // plane; all of a thread's loads are in flight before its stores
  const int per_cta = units * kPlanes;  // float4 an owner publishes
  auto gather = [&](int st) {
    float4 v[kGatherLoads];
#pragma unroll
    for (int n = 0; n < kGatherLoads; ++n) {
      const int i = tid + n * kClusterThreads;
      const int c = i / per_cta;
      if (i < kClusterCtas * per_cta) {
        v[n] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(pub + st * units * R, c))[i - c * per_cta];
      }
    }
#pragma unroll
    for (int n = 0; n < kGatherLoads; ++n) {
      const int i = tid + n * kClusterThreads;
      const int c = i / per_cta;
      const int k = i - c * per_cta;
      if (i < kClusterCtas * per_cta) {
        reinterpret_cast<float4*>(h_s)[(k % kPlanes) * plane + c * units + k / kPlanes] = v[n];
      }
    }
  };

  load_x(0);
  __syncthreads();  // slice and h0 staged
  for (int t = 0; t < seq_len; ++t) {
    if (t > 0) {
      gather((t - 1) & 1);
      __syncthreads();  // h_{t-1} whole
    }
    gate_products();
    __syncthreads();  // gate sums whole; h_s read
    if (item) {
      const float* g = gd + ir * sum_stride + uj;
      const float act[4] = {sigmoid(xg[0] + g[0]), sigmoid(xg[1] + g[units]),
                            tanhf(xg[2] + g[2 * units]), sigmoid(xg[3] + g[3 * units])};
      c_carry = act[1] * c_carry + act[0] * act[2];
      h_new = act[3] * tanhf(c_carry);
      if (live) {  // the activated gates, saved for the backward
        const size_t o = ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) gates[o + k * hidden] = from_f32<T>(act[k]);
      }
      pub[(t & 1) * units * R + uj * R + ir] = unit_ok ? h_new : 0.0f;
    }
    // publish h_t (release); the stage of step t - 1, which the peers
    // gathered during this step, is free again once every CTA has arrived.
    // h_all[t] and c_all[t] are stored after the arrive, so that the
    // release does not wait on them, and x_proj[t + 1] is loaded
    cluster_arrive();
    if (live) {
      const size_t o = ((size_t)t * batch + b) * hidden + j;
      h_all[o] = from_f32<T>(h_new);
      c_all[o] = from_f32<T>(c_carry);
    }
    if (t + 1 < seq_len) load_x(t + 1);
    cluster_wait();  // the peers' h_t (acquire); no CTA leaves while a peer reads it
  }
}

// The launch arguments of the cluster kernel.
template <typename T>
struct FwdArgs {
  const T* x_proj;
  const T* h0;
  const T* c0;
  const T* w_hh_t;
  T* h_all;
  T* c_all;
  T* gates;
  int seq_len;
};

// The cluster kernel instance <T, R, kTail>: its launch configuration (see
// cluster_launch_config, cluster_common.cuh), the clusters resident at once
// in *active, then the launch unless args is null.
template <typename T, int R, bool kTail>
int cluster_as(const FwdArgs<T>* args, int hidden, int batch, int smem_rows,
               cudaStream_t stream, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err =
      cluster_launch_config(lstm_fwd_cluster_kernel<T, R, kTail>,
                            fwd_cluster_smem_bytes<T>(hidden, R), (batch + R - 1) / R, stream,
                            cfg, attr, active);
  if (err != 0 || args == nullptr) return err;
  cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<T, R, kTail>, args->x_proj, args->h0,
                     args->c0, args->w_hh_t, args->h_all, args->c_all, args->gates,
                     args->seq_len, batch, hidden, smem_rows);
  return (int)cudaGetLastError();
}

// The cluster kernel's rows at this width: kFwdClusterRows where the slice
// fits in shared memory, else kFwdTailClusterRows.
template <typename T>
int fwd_cluster_rows(int hidden) {
  return fwd_smem_rows<T>(hidden, kFwdClusterRows) == hidden ? kFwdClusterRows
                                                             : kFwdTailClusterRows;
}

// The cluster kernel at (hidden, rows = fwd_cluster_rows), with the slice's
// tail in registers where the float32 slice does not fit in shared memory;
// cudaErrorInvalidValue where it does not take the width.
template <typename T>
int launch_cluster(const FwdArgs<T>* args, int hidden, int batch, int rows, cudaStream_t stream,
                   int* active) {
  if (hidden > kClusterMaxHidden || rows != fwd_cluster_rows<T>(hidden)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == kFwdClusterRows) {
    return cluster_as<T, kFwdClusterRows, false>(args, hidden, batch, hidden, stream, active);
  }
  const int smem_rows = fwd_smem_rows<T>(hidden, kFwdTailClusterRows);
  if constexpr (sizeof(T) == sizeof(float)) {
    if (smem_rows > 0) {
      return cluster_as<T, kFwdTailClusterRows, true>(args, hidden, batch, smem_rows, stream,
                                                      active);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// variant codes passed from Python (ops/fused_rnn.py:_VARIANTS)
constexpr int kVariantSmem = 0;
constexpr int kVariantCluster = 1;

template <typename T>
int launch_dtype(const void* x_proj, const void* h0, const void* c0, const void* w_hh_t,
                 void* h_all, void* c_all, void* gates, int seq_len, int batch, int hidden,
                 int block_b, int variant, cudaStream_t stream) {
  if (variant == kVariantSmem) {
    return launch_smem<T>(x_proj, h0, c0, w_hh_t, h_all, c_all, seq_len, batch, hidden, block_b,
                          stream);
  }
  if (variant == kVariantCluster && gates != nullptr) {
    const FwdArgs<T> args{static_cast<const T*>(x_proj), static_cast<const T*>(h0),
                          static_cast<const T*>(c0),     static_cast<const T*>(w_hh_t),
                          static_cast<T*>(h_all),        static_cast<T*>(c_all),
                          static_cast<T*>(gates),        seq_len};
    int active = 0;
    return launch_cluster<T>(&args, hidden, batch, block_b, stream, &active);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or the error
// that kept the variant from launching.  Shapes, dtypes, block_b and the
// variant are checked and chosen by the Python wrapper (ops/fused_rnn.py:
// lstm_fwd, lstm_fwd_tile): variant 0 runs the one-block kernel (block_b a
// multiple of 4, block_b * hidden <= 512; gates unused, may be null),
// variant 1 the cluster kernel (block_b = fwd_cluster_rows: kFwdClusterRows,
// or kFwdTailClusterRows where the float32 slice's last rows sit in
// registers), which also writes the activated gates (T, B, 4H) for the
// backward's cluster kernel.
extern "C" int lstm_fwd(const void* x_proj, const void* h0, const void* c0,
                        const void* w_hh_t, void* h_all, void* c_all, void* gates,
                        int seq_len, int batch, int hidden, int block_b,
                        int variant, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dtype<float>(x_proj, h0, c0, w_hh_t, h_all, c_all, gates, seq_len,
                               batch, hidden, block_b, variant, s);
  }
  if (dtype == kBFloat16) {
    return launch_dtype<__nv_bfloat16>(x_proj, h0, c0, w_hh_t, h_all, c_all, gates,
                                       seq_len, batch, hidden, block_b, variant, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster variant's shape at (hidden, batch) for a report: out[0] CTAs
// a cluster, out[1] batch rows a cluster, out[2] clusters resident at once,
// out[3] dynamic shared memory bytes a CTA, out[4] rows of the W_hh^T
// slice in shared memory (the rest in registers).  Returns the error code
// of the launch configuration (0 = at least one cluster fits).
extern "C" int lstm_fwd_cluster_shape(int hidden, int batch, int dtype, int* out) {
  int active = 0;
  int err = (int)cudaErrorInvalidValue;
  int rows = 0;
  if (dtype == kFloat32) {
    rows = fwd_cluster_rows<float>(hidden);
    err = launch_cluster<float>(nullptr, hidden, batch, rows, nullptr, &active);
    out[3] = (int)fwd_cluster_smem_bytes<float>(hidden, rows);
    out[4] = fwd_smem_rows<float>(hidden, rows);
  }
  if (dtype == kBFloat16) {
    rows = fwd_cluster_rows<__nv_bfloat16>(hidden);
    err = launch_cluster<__nv_bfloat16>(nullptr, hidden, batch, rows, nullptr, &active);
    out[3] = (int)fwd_cluster_smem_bytes<__nv_bfloat16>(hidden, rows);
    out[4] = fwd_smem_rows<__nv_bfloat16>(hidden, rows);
  }
  out[0] = kClusterCtas;
  out[1] = rows;
  out[2] = active;
  return err;
}
