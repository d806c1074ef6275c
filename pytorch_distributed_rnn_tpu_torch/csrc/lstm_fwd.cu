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
// Where the caller passes a gates buffer, the kernel also stores the
// activated gates i, f, g, o (T, B, 4H), which the backward reads in place
// of recomputing them (csrc/lstm_bwd.cu); with none it stores nothing more.
//
// Cluster (lstm_fwd_cluster_kernel, H = 111..448 in float32, 111..512 in
// bf16): at these widths W_hh^T (4 MiB in float32 at H = 512) is more than
// one block's shared memory.  So, as csrc/gru_fwd.cu:gru_fwd_cluster_kernel,
// a cluster of kClusterCtas = 16 CTAs owns one tile of kFwdClusterRows = 8
// batch rows, and CTA c owns the units [c U, (c + 1) U), U = ceil(H / 16),
// keeping the 4U columns of W_hh^T of its units' i, f, g and o gates (its
// slice, in the weights' own dtype), so no partial sum crosses the
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
// The items store the activated gates before the arrive, as their four
// registers would spill past it.  bf16 slices are held as bf16 (exact: the
// products widen them to float32) and fit up to H = 512 (136 KiB).
//
// Tensor cores (lstm_fwd_tc_kernel, float32, H = 449..512): there the
// float32 slice (264 KiB at H = 512) does not fit a CTA's 227 KiB beside the
// tiles, and 16 CTAs are the largest cluster.  What bounds it at (T=128,
// B=256, H=512): 68.7 GFLOP of products, 0.40 GB moved (0.12 ms); and B / R
// clusters of a 128-step chain each, 7 of them resident at once on the
// H100, so a cluster takes enough rows R (a multiple of 8, up to
// kTcMaxRows = 40, chosen by the caller from the batch and the clusters
// resident at once: tc_rows) that the batch runs in one wave.  At R = 40 a
// CTA's step is 128 x 40 x 512 multiply-adds, too many for the CUDA cores,
// so the products run on the tensor cores as 3xTF32 mma.sync m16n8k8
// (csrc/flash_mma.cuh: split_tf32, mma_tf32; 3 x 68.7 GFLOP at 495
// TFLOP/s, 0.42 ms): the CTA's 128 gate columns are M (a warp per m-tile of
// 16, so 256 threads and up to 255 registers a thread), the R rows N and
// the 16 x 32 padded units K.  The slice is the A operand: each lane keeps
// its fragments of 11 k-steps of each half of K in registers (88 of them)
// and reads the others' from shared memory, stored fragment by fragment
// (one 16-byte read a lane).  h_{t-1} is B, gathered through DSMEM as
// above, a half of K at a time, into a row-major tile (one 8-byte read a
// lane and n-tile): two half tiles in turn leave room for the slice.  The
// accumulators start from x_proj[t], loaded while the previous step's cell
// update and barrier run; each k-step's products are summed into a zeroed
// tile before they join them (k_step), and the gate sums go to a tile that
// takes the h tile's place.  Then the items (a lane per unit, a warp per
// row, R / 8 rows a thread) and the split cluster barrier as above.
#include <cooperative_groups.h>

#include "flash_mma.cuh"  // split_tf32, mma_tf32
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
    T* __restrict__ gates, int seq_len, int batch, int hidden, int block_b) {
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
      if (gates != nullptr) {  // the activated gates, saved for the backward
        T* go = gates + ((size_t)t * batch + b) * gate_dim + j;
        go[0] = from_f32<T>(ig);
        go[hidden] = from_f32<T>(fg);
        go[2 * hidden] = from_f32<T>(gg);
        go[3 * hidden] = from_f32<T>(og);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kWRegs>
int launch(const void* x_proj, const void* h0, const void* c0,
           const void* w_hh_t, void* h_all, void* c_all, void* gates, int seq_len,
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
      static_cast<T*>(h_all), static_cast<T*>(c_all), static_cast<T*>(gates), seq_len, batch,
      hidden, block_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_smem(const void* x_proj, const void* h0, const void* c0,
                const void* w_hh_t, void* h_all, void* c_all, void* gates, int seq_len,
                int batch, int hidden, int block_b, cudaStream_t stream) {
  if (hidden <= kRegHidden) {
    return launch<T, true>(x_proj, h0, c0, w_hh_t, h_all, c_all, gates, seq_len, batch,
                           hidden, block_b, stream);
  }
  return launch<T, false>(x_proj, h0, c0, w_hh_t, h_all, c_all, gates, seq_len, batch, hidden,
                          block_b, stream);
}

// ---------------------------------------------------------------------------
// the cluster variant (H = 111..448 in float32, 111..512 in bf16)
// ---------------------------------------------------------------------------

// R: batch rows a cluster; mirrored by ops/fused_rnn.py:LSTM_FWD_CLUSTER_ROWS
constexpr int kFwdClusterRows = 8;
// a warp takes one column octet of the gate products, its 32 lanes split
// the rows m of the slice
constexpr int kGateLanes = 32;
constexpr int kOctet = 8;

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
// sums (R, 8 O): the float32 tiles ahead of the slice; then the slice
template <typename T>
size_t fwd_cluster_smem_bytes(int hidden) {
  const FwdShape s = fwd_shape<float>(hidden);
  const size_t tiles = sizeof(float) * ((kClusterCtas + 2) * (size_t)s.units * kFwdClusterRows +
                                        (size_t)kFwdClusterRows * kOctet * s.octets);
  return tiles + sizeof(T) * (size_t)hidden * fwd_shape<T>(hidden).stride;
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1) lstm_fwd_cluster_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ w_hh_t, T* __restrict__ h_all, T* __restrict__ c_all,
    T* __restrict__ gates, int seq_len, int batch, int hidden) {
  constexpr int R = kFwdClusterRows;
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
  T* w_s = reinterpret_cast<T*>(gd + R * sum_stride);  // (H, stride)
  const float4* h4 = reinterpret_cast<const float4*>(h_s);

  // the slice: W_hh^T[m][k H + unit0 + u] at column k U + u, 0 past H and
  // past 4U (the padding columns between 8 O and the stride are never read)
  for (int i = tid; i < hidden * sum_stride; i += kClusterThreads) {
    const int m = i / sum_stride;
    const int c = i - m * sum_stride;
    const int j = unit0 + c % units;
    w_s[m * cs.stride + c] = c < cols && j < hidden
                                 ? w_hh_t[(size_t)m * gate_dim + (c / units) * hidden + j]
                                 : from_f32<T>(0.0f);
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
  // kKept ks + e.  Warps past the octets sit out.
  const int go = tid / kGateLanes;
  const int ks = tid % kGateLanes;
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
    for (int m = ks; m < hidden; m += kGateLanes) {
      float w[kOctet];
      load_octet(w_s + m * cs.stride + kOctet * go, w);
      fma_rows(acc, m, w);
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
      if (live && gates != nullptr) {  // the activated gates, saved for the backward
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

// ---------------------------------------------------------------------------
// the tensor-core cluster variant (float32, H = 449..512)
// ---------------------------------------------------------------------------

// A CTA's units padded to kTcUnits: U = ceil(H / 16) is 29..32 at these
// widths.  Column c = 32 k + u of the gate sums is gate k of own unit u;
// K index 32 p + v is unit p U + v of CTA p.  Padding units have zero
// weights and publish h = 0.
constexpr int kTcUnits = 32;
constexpr int kTcMinHidden = kClusterCtas * (kTcUnits - 4) + 1;  // 449
constexpr int kTcCols = 4 * kTcUnits;          // M: 128 gate columns
constexpr int kTcWarps = kTcCols / 16;         // a warp per m-tile of 16 columns
constexpr int kTcThreads = 32 * kTcWarps;      // 256
constexpr int kTcHalfK = kClusterCtas / 2 * kTcUnits;  // K in two halves of 256
constexpr int kTcHalfSteps = kTcHalfK / 8;     // 32 k-steps of 8 a half
// a warp's k-steps of each half whose A fragments sit in its lanes'
// registers (4 each); the others' come from shared memory
constexpr int kTcRegSteps = 11;
constexpr int kTcSmemSteps = kTcHalfSteps - kTcRegSteps;
// rows a cluster at most (a multiple of 8, one n-tile each); mirrored by
// ops/fused_rnn.py:LSTM_FWD_TC_MAX_ROWS
constexpr int kTcMaxRows = 40;
// floats a row of the h tile: the 8-byte B reads of the lanes (g, q), rows
// g and columns 2q, are free of bank conflicts at a stride of 8 mod 32
constexpr int kTcHStride = kTcHalfK + 8;
// floats a row of the gate sums: the C stores of the lanes, rows 2q and
// columns g, are free of bank conflicts at a stride of 4 mod 32
constexpr int kTcGStride = kTcCols + 4;
static_assert(kTcGStride <= kTcHStride, "the gate sums take the h tile's place");

// The h tile of one half of K (R, kTcHStride), which the gate sums (R,
// kTcGStride) take over after the products; the own units' h_t, one stage
// per step parity (2, R, 32); the slice's fragments of the k-steps past
// kTcRegSteps of each half (2, kTcSmemSteps, kTcWarps, 32) float4.
size_t tc_smem_bytes(int rows) {
  return sizeof(float) * ((size_t)rows * kTcHStride + 2 * (size_t)rows * kTcUnits) +
         sizeof(float4) * 2 * (size_t)kTcSmemSteps * kTcWarps * 32;
}

// The rows a cluster at this batch when `active` clusters are resident at
// once: the fewest whole n-tiles that let the batch run in one wave, at
// most kTcMaxRows; reported by lstm_fwd_cluster_shape.
int tc_rows(int batch, int active) {
  const int per_cluster = (batch + active - 1) / active;
  const int rows = (per_cluster + 7) / 8 * 8;
  return rows < kTcMaxRows ? rows : kTcMaxRows;
}

// A thread's place in the tensor-core kernel: its warp (the m-tile: gate
// warp / 2, own units 16 (warp % 2) + 0..15, and its items' first row),
// its lane (its items' unit) and the mma lane coordinates g, q.
struct TcLane {
  int warp, lane, g, q;
  __device__ explicit TcLane(int tid) : warp(tid / 32), lane(tid % 32), g(lane / 4), q(lane % 4) {}
};

// The thread index, read anew each step: the addresses derived from it
// are then formed again each step, not held in registers across it, which
// spilled past the 255 registers a thread has (utils/ab.py tc, hoisted).
__device__ __forceinline__ int step_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

template <int R>
__global__ void __launch_bounds__(kTcThreads, 1) lstm_fwd_tc_kernel(
    const float* __restrict__ x_proj, const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ w_hh_t, float* __restrict__ h_all, float* __restrict__ c_all,
    float* __restrict__ gates, int seq_len, int batch, int hidden) {
  constexpr int kTiles = R / 8;  // n-tiles; also the items (rows) a thread owns
  static_assert(R % 8 == 0 && R <= kTcMaxRows, "rows in whole n-tiles");
  // float4 a thread gathers a half (8 owners x R rows x 8 float4), in
  // batches of at most kGatherBatch in flight
  constexpr int kGather = 64 * R / kTcThreads;
  constexpr int kGatherBatch = kGather <= 5 ? kGather : kGather % 5 == 0 ? 5 : kGather % 4 == 0 ? 4 : 3;
  static_assert(kGather % kGatherBatch == 0, "whole gather batches");
  cg::cluster_group cluster = cg::this_cluster();
  const int units = (hidden + kClusterCtas - 1) / kClusterCtas;
  const int gate_dim = 4 * hidden;
  const int row0 = (blockIdx.x / kClusterCtas) * R;
  const int unit0 = (int)cluster.block_rank() * units;

  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;  // (R, kTcHStride): a half of h_{t-1}, row r, column 32 p' + v
  float* gd = smem;   // (R, kTcGStride): the gate sums, after the products
  float* pub = smem + R * kTcHStride;  // (2, R, 32): h_t of the own units
  float4* w_s = reinterpret_cast<float4*>(pub + 2 * R * kTcUnits);

  // A[c][k], the slice transposed: W_hh^T[m][k' H + unit0 + u] for column
  // c = 32 k' + u and K index k = 32 p + v, m = p U + v; 0 for padding
  auto slice = [&](int k, int c) -> float {
    const int v = k % kTcUnits;
    const int m = (k / kTcUnits) * units + v;
    const int u = c % kTcUnits;
    const int j = unit0 + u;
    return v < units && m < hidden && u < units && j < hidden
               ? w_hh_t[(size_t)m * gate_dim + (c / kTcUnits) * hidden + j]
               : 0.0f;
  };
  // lane l's A fragment of m-tile mt at k-step s of K: a0 (g, q), a1 (g +
  // 8, q), a2 (g, q + 4), a3 (g + 8, q + 4), where mma k index q stands for
  // k = 8 s + 2 q and q + 4 for 8 s + 2 q + 1 (B's rows alike)
  auto a_frag = [&](int mt, int s, int l) {
    const int c = 16 * mt + l / 4;
    const int k = 8 * s + 2 * (l % 4);
    return make_float4(slice(k, c), slice(k, c + 8), slice(k + 1, c), slice(k + 1, c + 8));
  };
  const TcLane first(threadIdx.x);
  float4 w_reg[2][kTcRegSteps];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int s = 0; s < kTcRegSteps; ++s) {
      w_reg[half][s] = a_frag(first.warp, half * kTcHalfSteps + s, first.lane);
    }
  }
  // fragment (half, s, mt, l) at ((half kTcSmemSteps + s) kTcWarps + mt) 32 + l
  for (int i = threadIdx.x; i < 2 * kTcSmemSteps * kTcWarps * 32; i += kTcThreads) {
    const int hs = i / (32 * kTcWarps);
    const int half = hs / kTcSmemSteps;
    w_s[i] = a_frag((i / 32) % kTcWarps,
                    half * kTcHalfSteps + kTcRegSteps + hs - half * kTcSmemSteps, i % 32);
  }

  // The accumulators: acc[n][e] is C[16 warp + g + 8 (e / 2)][8 n + 2 q +
  // e % 2], gate sum of (row, column); they start from x_proj[t].
  float acc[kTiles][4];
  auto load_x = [&](const TcLane& L, int t) {
    const int u_lo = 16 * (L.warp % 2) + L.g;
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = row0 + 8 * n + 2 * L.q + e % 2;
        const int u = u_lo + 8 * (e / 2);
        acc[n][e] =
            u < units && unit0 + u < hidden && b < batch
                ? x_proj[((size_t)t * batch + b) * gate_dim + (L.warp / 2) * hidden + unit0 + u]
                : 0.0f;
      }
    }
  };
  // One k-step (s of the half in the h tile): A split once, then each
  // n-tile's 3 products (lo.hi, hi.lo, hi.hi) summed into a zeroed tile
  // that is added to the accumulators.  The tensor cores truncate each sum
  // they form: chained into accumulators of O(1), 192 times a step, that
  // bias reached a scaled error of 8.5e-6 against the f32 tolerance of
  // 1e-5; a k-step's tile is a fraction of them and the adds round to
  // nearest: 1.6e-6, for 11% more time (H100 80GB HBM3, 700 W;
  // utils/ab.py tc).
  auto k_step = [&](const TcLane& L, const float4& a, int s) {
    uint32_t ah[4], al[4];
    flash::split_tf32(a.x, ah[0], al[0]);
    flash::split_tf32(a.y, ah[1], al[1]);
    flash::split_tf32(a.z, ah[2], al[2]);
    flash::split_tf32(a.w, ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      const float2 bv =
          *reinterpret_cast<const float2*>(h_s + (8 * n + L.g) * kTcHStride + 8 * s + 2 * L.q);
      uint32_t bh0, bl0, bh1, bl1;
      flash::split_tf32(bv.x, bh0, bl0);
      flash::split_tf32(bv.y, bh1, bl1);
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      flash::mma_tf32(d, al, bh0, bh1);
      flash::mma_tf32(d, ah, bl0, bl1);
      flash::mma_tf32(d, ah, bh0, bh1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
    }
  };
  // The h tile of a half: h0 (t = 0), else h_{t-1} from the stage st of
  // its 8 owners: float4 i of owner c (row i / 8, units 4 (i % 8) ..) lands
  // at row i / 8, column 32 (c - 8 half) + 4 (i % 8)
  auto fill = [&](int tid, int t, int half) {
    if (t == 0) {
      for (int i = tid; i < R * kTcHalfK; i += kTcThreads) {
        const int r = i / kTcHalfK;
        const int k = half * kTcHalfK + i % kTcHalfK;
        const int v = k % kTcUnits;
        const int m = (k / kTcUnits) * units + v;
        const int b = row0 + r;
        h_s[r * kTcHStride + i % kTcHalfK] =
            v < units && m < hidden && b < batch ? h0[(size_t)b * hidden + m] : 0.0f;
      }
      return;
    }
    const float* stage = pub + ((t - 1) & 1) * R * kTcUnits;
#pragma unroll
    for (int n0 = 0; n0 < kGather; n0 += kGatherBatch) {
      float4 v[kGatherBatch];
#pragma unroll
      for (int n = 0; n < kGatherBatch; ++n) {
        const int i = tid + (n0 + n) * kTcThreads;
        const int c = i / (8 * R);
        v[n] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(stage, half * kClusterCtas / 2 + c))[i - c * 8 * R];
      }
#pragma unroll
      for (int n = 0; n < kGatherBatch; ++n) {
        const int i = tid + (n0 + n) * kTcThreads;
        const int c = i / (8 * R);
        const int k = i - c * 8 * R;
        *reinterpret_cast<float4*>(h_s + (k / 8) * kTcHStride + kTcUnits * c + 4 * (k % 8)) =
            v[n];
      }
    }
  };

  // The items: lane u is own unit u, rows warp + 8 e; c in registers.
  float c_carry[kTiles], h_new[kTiles];
#pragma unroll
  for (int e = 0; e < kTiles; ++e) {
    const int b = row0 + first.warp + 8 * e;
    const int j = unit0 + first.lane;
    c_carry[e] = first.lane < units && j < hidden && b < batch ? c0[(size_t)b * hidden + j] : 0.0f;
  }

  load_x(first, 0);
  __syncthreads();  // the slice staged
  for (int t = 0; t < seq_len; ++t) {
    const int tid = step_tid();
    const TcLane L(tid);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 1) __syncthreads();  // the first half read
      fill(tid, t, half);
      __syncthreads();  // the half of h_{t-1} whole
      const float4* w_half = w_s + (half * kTcSmemSteps * kTcWarps + L.warp) * 32 + L.lane;
#pragma unroll 1
      for (int s = 0; s < kTcSmemSteps; ++s) k_step(L, w_half[s * kTcWarps * 32], kTcRegSteps + s);
#pragma unroll
      for (int s = 0; s < kTcRegSteps; ++s) k_step(L, w_reg[half][s], s);
    }
    __syncthreads();  // the h tile read: the gate sums take its place
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gd[(8 * n + 2 * L.q + e % 2) * kTcGStride + 16 * L.warp + L.g + 8 * (e / 2)] = acc[n][e];
      }
    }
    __syncthreads();  // gate sums whole
    if (t + 1 < seq_len) load_x(L, t + 1);  // lands during the cell update and the barrier
    const int j = unit0 + L.lane;
    const bool unit_ok = L.lane < units && j < hidden;
#pragma unroll
    for (int e = 0; e < kTiles; ++e) {
      const int r = L.warp + 8 * e;
      const int b = row0 + r;
      const float* gs = gd + r * kTcGStride + L.lane;
      const float act[4] = {sigmoid(gs[0]), sigmoid(gs[kTcUnits]), tanhf(gs[2 * kTcUnits]),
                            sigmoid(gs[3 * kTcUnits])};
      c_carry[e] = act[1] * c_carry[e] + act[0] * act[2];
      h_new[e] = act[3] * tanhf(c_carry[e]);
      if (unit_ok && b < batch && gates != nullptr) {
        const size_t o = ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) gates[o + k * hidden] = act[k];
      }
      pub[(t & 1) * R * kTcUnits + r * kTcUnits + L.lane] = unit_ok ? h_new[e] : 0.0f;
    }
    // publish h_t (release); h_all[t] and c_all[t] stored after the arrive
    cluster_arrive();
#pragma unroll
    for (int e = 0; e < kTiles; ++e) {
      const int b = row0 + L.warp + 8 * e;
      if (unit_ok && b < batch) {
        const size_t o = ((size_t)t * batch + b) * hidden + j;
        h_all[o] = h_new[e];
        c_all[o] = c_carry[e];
      }
    }
    cluster_wait();  // the peers' h_t (acquire); no CTA leaves while a peer reads it
  }
}

// The launch arguments of the cluster kernels.
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

// A cluster kernel: its launch configuration (see cluster_launch_config,
// cluster_common.cuh), the clusters resident at once in *active, then the
// launch unless args is null.
template <typename T, typename Kernel>
int cluster_as(Kernel kernel, size_t smem, int rows, int threads, const FwdArgs<T>* args,
               int hidden, int batch, cudaStream_t stream, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = cluster_launch_config(kernel, smem, (batch + rows - 1) / rows, stream, cfg, attr,
                                        active, threads);
  if (err != 0 || args == nullptr) return err;
  cudaLaunchKernelEx(&cfg, kernel, args->x_proj, args->h0, args->c0, args->w_hh_t, args->h_all,
                     args->c_all, args->gates, args->seq_len, batch, hidden);
  return (int)cudaGetLastError();
}

// Whether the slice, in its dtype, fits in shared memory beside the tiles
// (bf16 always, float32 up to H = 448): the CUDA-core cluster kernel, else
// the tensor-core one.
template <typename T>
bool slice_fits(int hidden) {
  return fwd_cluster_smem_bytes<T>(hidden) <= kMaxSmemBytes;
}

// The cluster kernel at (hidden, rows): the CUDA-core one on
// kFwdClusterRows where the slice fits, else the tensor-core one (float32,
// H >= kTcMinHidden) on rows = 8, 16, .., kTcMaxRows; cudaErrorInvalidValue
// where no instance takes them.
template <typename T>
int launch_cluster(const FwdArgs<T>* args, int hidden, int batch, int rows, cudaStream_t stream,
                   int* active) {
  if (hidden > kClusterMaxHidden) return (int)cudaErrorInvalidValue;
  if (slice_fits<T>(hidden)) {
    if (rows != kFwdClusterRows) return (int)cudaErrorInvalidValue;
    return cluster_as<T>(lstm_fwd_cluster_kernel<T>, fwd_cluster_smem_bytes<T>(hidden), rows,
                         kClusterThreads, args, hidden, batch, stream, active);
  }
  if constexpr (sizeof(T) == sizeof(float)) {
    if (hidden < kTcMinHidden) return (int)cudaErrorInvalidValue;
    switch (rows) {
      case 8:
        return cluster_as<T>(lstm_fwd_tc_kernel<8>, tc_smem_bytes(8), 8, kTcThreads, args,
                             hidden, batch, stream, active);
      case 16:
        return cluster_as<T>(lstm_fwd_tc_kernel<16>, tc_smem_bytes(16), 16, kTcThreads, args,
                             hidden, batch, stream, active);
      case 24:
        return cluster_as<T>(lstm_fwd_tc_kernel<24>, tc_smem_bytes(24), 24, kTcThreads, args,
                             hidden, batch, stream, active);
      case 32:
        return cluster_as<T>(lstm_fwd_tc_kernel<32>, tc_smem_bytes(32), 32, kTcThreads, args,
                             hidden, batch, stream, active);
      case kTcMaxRows:
        return cluster_as<T>(lstm_fwd_tc_kernel<kTcMaxRows>, tc_smem_bytes(kTcMaxRows),
                             kTcMaxRows, kTcThreads, args, hidden, batch, stream, active);
      default:
        break;
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
    return launch_smem<T>(x_proj, h0, c0, w_hh_t, h_all, c_all, gates, seq_len, batch, hidden,
                          block_b, stream);
  }
  if (variant == kVariantCluster) {
    const FwdArgs<T> args{static_cast<const T*>(x_proj), static_cast<const T*>(h0),
                          static_cast<const T*>(c0),     static_cast<const T*>(w_hh_t),
                          static_cast<T*>(h_all),        static_cast<T*>(c_all),
                          static_cast<T*>(gates),        seq_len};
    int active = 0;
    return launch_cluster<T>(&args, hidden, batch, block_b, stream, &active);
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster kernel at (hidden, batch) as the caller launches it: its
// rows a cluster (the tensor-core kernel's from the clusters resident at
// once of its widest instance, tc_rows), the clusters resident at once in
// *active, its shared memory a CTA in *smem and the rows m of the slice
// in shared memory in *smem_rows (the tensor-core kernel's K rows past its
// register k-steps); returns the error code.
template <typename T>
int cluster_shape_of(int hidden, int batch, int* rows, int* active, int* smem, int* smem_rows) {
  if (slice_fits<T>(hidden) || sizeof(T) != sizeof(float)) {
    *rows = kFwdClusterRows;
    *smem = (int)fwd_cluster_smem_bytes<T>(hidden);
    *smem_rows = hidden;
  } else {
    const int err = launch_cluster<T>(nullptr, hidden, batch, kTcMaxRows, nullptr, active);
    if (err != 0) return err;
    *rows = tc_rows(batch, *active);
    *smem = (int)tc_smem_bytes(*rows);
    *smem_rows = 2 * 8 * kTcSmemSteps;
  }
  return launch_cluster<T>(nullptr, hidden, batch, *rows, nullptr, active);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or the error
// that kept the variant from launching.  Shapes, dtypes, block_b and the
// variant are checked and chosen by the Python wrapper (ops/fused_rnn.py:
// lstm_fwd, lstm_fwd_tile): variant 0 runs the one-block kernel (block_b a
// multiple of 4, block_b * hidden <= 512), variant 1 the cluster kernel
// (block_b = kFwdClusterRows where the slice fits in shared memory, else the
// tensor-core kernel's rows, lstm_fwd_cluster_shape).  Where gates is not
// null every kernel also writes the activated gates (T, B, 4H) for the
// backward.
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

// The cluster variant's shape at (hidden, batch) for the wrapper and a
// report: out[0] CTAs a cluster, out[1] batch rows a cluster, out[2]
// clusters resident at once, out[3] dynamic shared memory bytes a CTA,
// out[4] rows of the W_hh^T slice in shared memory (the rest in registers).
// Returns the error code of the launch configuration (0 = at least one
// cluster fits).
extern "C" int lstm_fwd_cluster_shape(int hidden, int batch, int dtype, int* out) {
  int err = (int)cudaErrorInvalidValue;
  out[1] = out[2] = out[3] = out[4] = 0;
  if (dtype == kFloat32) {
    err = cluster_shape_of<float>(hidden, batch, &out[1], &out[2], &out[3], &out[4]);
  }
  if (dtype == kBFloat16) {
    err = cluster_shape_of<__nv_bfloat16>(hidden, batch, &out[1], &out[2], &out[3], &out[4]);
  }
  out[0] = kClusterCtas;
  return err;
}
