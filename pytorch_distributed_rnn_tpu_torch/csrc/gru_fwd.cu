// Fused GRU forward time loop for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:
// _gru_fwd_kernel (launched by _gru_fwd_pallas).  Per step t:
//   h_proj = h @ w_hh_t + b_hh;  r = sigmoid(x_r + h_r);  z = sigmoid(x_z + h_z)
//   n = tanh(x_n + r * h_n);  h = (1 - z) * n + z * h;  h_all[t] = h
// with h carried in float32 and stored in the input dtype.
//
// What bounds it.  At the motion shape (T=128, B=1440, H=32, f32): bytes.
// It reads x_proj (71 MB) and writes h_all (24 MB), about 28 us at
// 3.35 TB/s, against 1.1 GFLOP of f32 FMAs (17 us at 67 TFLOP/s).  At the
// char-LM shape (T=128, B=256, H=512, f32): operations.  51.5 GFLOP of
// f32 FMAs (0.77 ms at 67 TFLOP/s, no tensor cores) against 0.27 GB of
// bytes (80 us).  Both are a chain of T dependent steps.
//
// Two variants; the caller (ops/fused_rnn.py:gru_tile) picks one by width,
// and a variant that does not launch is an error, never a reason to run
// the other.
//
// Shared memory (gru_fwd_kernel, up to H = 126): as csrc/lstm_fwd.cu did
// before its redesign, T is a loop inside the block and one block owns one
// tile of block_b batch rows for the whole sequence, with W_hh^T staged
// once into shared memory (12 KiB at H=32), h in a double-buffered shared
// tile (one barrier per step) and the ragged last tile masked, not padded.
//
// Cluster (gru_fwd_cluster_kernel, H = 127..512): at H = 512 W_hh^T is 3
// MiB, and one block that reads all of it from L2 every step runs its 128
// steps at one SM's issue rate.  So a cluster of kClusterCtas = 16 CTAs
// owns one tile of kFwdClusterRows = 8 batch rows, and CTA c owns the units
// [c U, (c + 1) U), U = ceil(H / 16) (units past H are masked).  It keeps
// in shared memory, as float32, the 3U columns of W_hh^T of its units' r, z
// and n gates, zero-padded to column octets, rows at an odd number of
// quads apart (fwd_shape): (H, 100) floats, 200 KiB at H = 512.  Every dot
// product a CTA needs runs over all H rows of its own columns, so no
// partial sums cross the cluster; what crosses it is h_t.  A step t, on 512
// threads:
//   1. gather: h_{t-1} of all 16 U units and the R rows, pulled from the 16
//      owners' published tiles through DSMEM (cluster.map_shared_rank),
//      16-byte reads, all of a thread's in flight at once, into planes of
//      4 rows (one float4 a unit) that the products read without bank
//      conflicts;
//   2. the gate products h_{t-1} (R x H) . slice (H x 3U): a warp per
//      column octet, its 32 lanes splitting the H rows, each keeping 8
//      columns x R rows of sums, reduced by shuffle exchanges
//      (reduce_scatter) into the gate sums tile;
//   3. the R x U items (row, own unit) form the gates, carry h in a
//      register, and publish h_t into the stage of this step's parity (so
//      a peer still gathering the last step's stage is never overwritten);
//   4. the cluster barrier, split: arrive (release: h_t is published), then
//      h_all[t] is stored and the items' x_proj[t + 1] loaded, then wait
//      (acquire).
// One CTA per SM (221 KiB of shared memory at H = 512); clusters are
// independent, and B / R of them run in waves (7 resident on an H100 SXM).
// What bounds a step: the R x H x 3U = 0.39 M FMA at H = 512 (3072 cycles
// of one SM's f32 issue) beside reading the slice and h from shared memory,
// then the gather and the barrier.
#include <cooperative_groups.h>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pdrnn;

size_t fwd_smem_bytes(int hidden, int block_b) {
  return sizeof(float) * (gru_w_smem_floats(hidden) + 2 * (size_t)block_b * hidden);
}

// The shared-memory variant: one block, block_b rows, all of W_hh^T.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) gru_fwd_kernel(const T* __restrict__ x_proj,
                               const T* __restrict__ h0,
                               const T* __restrict__ w_hh_t,
                               const T* __restrict__ b_hh,
                               T* __restrict__ h_all, int seq_len, int batch,
                               int hidden, int block_b) {
  extern __shared__ float smem[];
  const int gate_dim = 3 * hidden;
  const int tile = block_b * hidden;
  float* w_s = smem;
  float* h_buf = smem + hidden * gru_w_stride(hidden);
  const int row0 = blockIdx.x * block_b;
  const int unit_threads = gru_unit_threads(hidden, block_b);
  const int j0 = threadIdx.x % unit_threads;
  const int r0 = (threadIdx.x / unit_threads) * kRowsPerThread;

  stage_gru_weights(w_hh_t, w_s, hidden);
  stage_rows(h0, h_buf, row0, batch, hidden, block_b);
  __syncthreads();
  const GruWeights w{w_s, hidden};

  for (int t = 0; t < seq_len; ++t) {
    const float* h_prev = h_buf + (t & 1) * tile;
    float* h_next = h_buf + ((t + 1) & 1) * tile;

    for (int j = j0; j < hidden; j += unit_threads) {
      float xg[kRowsPerThread][3];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int b = row0 + r0 + r;
        const T* xp = x_proj + ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xg[r][k] = b < batch ? to_f32(xp[k * hidden]) : 0.0f;
        }
      }
      // h_proj = b_hh + h @ w_hh_t for the unit's three gates
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
        const float rg = sigmoid(xg[r][0] + acc[r][0]);
        const float zg = sigmoid(xg[r][1] + acc[r][1]);
        const float ng = tanhf(xg[r][2] + rg * acc[r][2]);
        const float h = (1.0f - zg) * ng + zg * h_prev[(r0 + r) * hidden + j];
        h_next[(r0 + r) * hidden + j] = h;
        const int b = row0 + r0 + r;
        if (b < batch) h_all[((size_t)t * batch + b) * hidden + j] = from_f32<T>(h);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the cluster variant
// ---------------------------------------------------------------------------

// R: batch rows a cluster; mirrored by ops/fused_rnn.py:GRU_FWD_CLUSTER_ROWS.
constexpr int kFwdClusterRows = 8;
// h travels and is read in planes of 4 rows, one float4 a unit
constexpr int kPlanes = kFwdClusterRows / 4;
// a warp takes one column octet of the gate products, its 32 lanes split
// the rows m of W
constexpr int kFwdGateLanes = 32;
constexpr int kOctet = 8;
// a lane's sums: 8 columns x R rows; after the reduction R / 4 of them
constexpr int kFwdSums = kOctet * kFwdClusterRows;
constexpr int kFwdKept = kFwdSums / kFwdGateLanes;
// float4 a thread gathers a step, at most (16 CTAs x 32 units x R rows)
constexpr int kGatherLoads =
    kClusterCtas * ((kClusterMaxHidden + kClusterCtas - 1) / kClusterCtas) * kPlanes /
    kClusterThreads;
static_assert(kFwdClusterRows % 4 == 0 && kFwdKept >= 1, "rows travel in float4 planes");

// The forward's slice: the 3U columns zero-padded to whole octets (an
// even number of quads), rows at an odd number of quads apart, so that
// 16-byte reads of 8 consecutive rows m fall in 8 distinct bank quads:
// (512, 100) floats at H = 512, as the backward's.
struct FwdShape {
  int units;    // U
  int octets;   // O: column octets, 8 O >= 3U
  int stride;   // row stride in floats, 8 O + 4
};

__host__ __device__ inline FwdShape fwd_shape(int hidden) {
  FwdShape s;
  s.units = (hidden + kClusterCtas - 1) / kClusterCtas;
  s.octets = (3 * s.units + kOctet - 1) / kOctet;
  s.stride = kOctet * s.octets + 4;
  return s;
}

// h_{t-1} of the cluster's 16 U units (R / 4 planes of 16 U float4); the
// own units' published h, one stage per step parity (2, U, R); the gate
// sums (R, 8 O); then the W slice (H, stride)
size_t fwd_cluster_smem_bytes(int hidden) {
  const FwdShape s = fwd_shape(hidden);
  const size_t rows = kFwdClusterRows;
  return sizeof(float) * ((kClusterCtas + 2) * (size_t)s.units * rows +
                          rows * kOctet * (size_t)s.octets + (size_t)hidden * s.stride);
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1) gru_fwd_cluster_kernel(
    const T* __restrict__ x_proj, const T* __restrict__ h0, const T* __restrict__ w_hh_t,
    const T* __restrict__ b_hh, T* __restrict__ h_all, int seq_len, int batch, int hidden) {
  constexpr int R = kFwdClusterRows;
  cg::cluster_group cluster = cg::this_cluster();
  const FwdShape cs = fwd_shape(hidden);
  const int units = cs.units;
  const int cols = 3 * units;
  const int sum_stride = kOctet * cs.octets;  // a row of the gate sums tile
  const int gate_dim = 3 * hidden;
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / kClusterCtas) * R;
  const int unit0 = (int)cluster.block_rank() * units;

  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;  // plane s, unit m: rows 4s .. 4s + 3 of h_{t-1}[m] as a float4
  float* pub = h_s + kClusterCtas * units * R;  // (2, U, R): h_t of the own units
  float* gd = pub + 2 * units * R;              // (R, 8 O): column k U + u of gate k, unit u
  float* w_s = gd + R * sum_stride;             // (H, stride)
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  const float4* h4 = reinterpret_cast<const float4*>(h_s);

  // the slice: w_s[m][k U + u] = W_hh^T[m][k H + unit0 + u], 0 past H and
  // past 3U
  // (the padding columns between 8 O and the stride are never read)
  for (int i = tid; i < hidden * sum_stride; i += kClusterThreads) {
    const int m = i / sum_stride;
    const int c = i - m * sum_stride;
    const int j = unit0 + c % units;
    w_s[m * cs.stride + c] =
        c < cols && j < hidden ? to_f32(w_hh_t[(size_t)m * gate_dim + (c / units) * hidden + j])
                               : 0.0f;
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
  // x_proj and h_all move in runs of U consecutive values.  Each carries
  // its h in a register from step to step.
  const bool item = tid < units * R;
  const int uj = tid % units;
  const int ir = tid / units;
  const int j = unit0 + uj;
  const int b = row0 + ir;
  const bool unit_ok = item && j < hidden;
  const bool live = unit_ok && b < batch;  // an item with real data
  float bias[3], xg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) bias[k] = unit_ok ? to_f32(b_hh[k * hidden + j]) : 0.0f;
  float h_carry = live ? to_f32(h0[(size_t)b * hidden + j]) : 0.0f;
  auto load_x = [&](int t) {
    const size_t g = ((size_t)t * batch + b) * gate_dim + j;
#pragma unroll
    for (int k = 0; k < 3; ++k) xg[k] = live ? to_f32(x_proj[g + k * hidden]) : 0.0f;
  };

  // The gate products: warp go takes column octet go, lane ks the rows
  // m = ks, ks + 32, ...; 8R sums (8 columns x R rows, sum c R + r) a
  // lane, reduced over the warp so that lane ks ends with sums
  // kFwdKept ks + e (R = 8: column 8 go + ks / 4, row 2 (ks % 4) + e).
  // Against 16 lanes on a column quad, each 16-byte read of h feeds twice
  // the products.  Warps past the octets sit out.
  const int go = tid / kFwdGateLanes;
  const int ks = tid % kFwdGateLanes;
  auto gate_products = [&]() {
    if (go >= cs.octets) return;
    float acc[kFwdSums];
#pragma unroll
    for (int i = 0; i < kFwdSums; ++i) acc[i] = 0.0f;
#pragma unroll 2
    for (int m = ks; m < hidden; m += kFwdGateLanes) {
      float h[R];
#pragma unroll
      for (int s = 0; s < kPlanes; ++s) {
        const float4 hv = h4[s * plane + m];
        h[4 * s] = hv.x;
        h[4 * s + 1] = hv.y;
        h[4 * s + 2] = hv.z;
        h[4 * s + 3] = hv.w;
      }
      const float4 wa = w4[m * (cs.stride / 4) + 2 * go];
      const float4 wb = w4[m * (cs.stride / 4) + 2 * go + 1];
      const float w[kOctet] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int c = 0; c < kOctet; ++c) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c * R + r] = fmaf(h[r], w[c], acc[c * R + r]);
      }
    }
    reduce_scatter<kFwdSums, kFwdGateLanes>(acc, ks);
#pragma unroll
    for (int e = 0; e < kFwdKept; ++e) {
      const int v = kFwdKept * ks + e;
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
      const float rg = sigmoid(xg[0] + bias[0] + g[0]);
      const float zg = sigmoid(xg[1] + bias[1] + g[units]);
      const float ng = tanhf(xg[2] + rg * (bias[2] + g[2 * units]));
      h_carry = (1.0f - zg) * ng + zg * h_carry;
      pub[(t & 1) * units * R + uj * R + ir] = unit_ok ? h_carry : 0.0f;
    }
    // publish h_t (release); the stage of step t - 1, which the peers
    // gathered during this step, is free again once every CTA has arrived.
    // h_all[t] is stored after the arrive, so that the release does not
    // wait on it, and x_proj[t + 1] is loaded
    cluster_arrive();
    if (live) h_all[((size_t)t * batch + b) * hidden + j] = from_f32<T>(h_carry);
    if (t + 1 < seq_len) load_x(t + 1);
    cluster_wait();  // the peers' h_t (acquire); no CTA leaves while a peer reads it
  }
}

template <typename T>
int fwd_cluster_config(int hidden, int batch, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                       cudaLaunchAttribute& attr, int* active) {
  return cluster_launch_config(gru_fwd_cluster_kernel<T>, fwd_cluster_smem_bytes(hidden),
                               (batch + kFwdClusterRows - 1) / kFwdClusterRows, stream, cfg,
                               attr, active);
}

template <typename T>
int launch_cluster(const void* x_proj, const void* h0, const void* w_hh_t, const void* b_hh,
                   void* h_all, int seq_len, int batch, int hidden, cudaStream_t stream) {
  if (hidden > kClusterMaxHidden) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  const int err = fwd_cluster_config<T>(hidden, batch, stream, cfg, attr, &active);
  if (err != 0) return err;
  cudaLaunchKernelEx(&cfg, gru_fwd_cluster_kernel<T>, static_cast<const T*>(x_proj),
                     static_cast<const T*>(h0), static_cast<const T*>(w_hh_t),
                     static_cast<const T*>(b_hh), static_cast<T*>(h_all), seq_len, batch,
                     hidden);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
int launch_smem(const void* x_proj, const void* h0, const void* w_hh_t,
                const void* b_hh, void* h_all, int seq_len, int batch, int hidden,
                int block_b, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(hidden, block_b);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 threads(gru_threads(hidden, block_b));
  gru_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const T*>(h0),
      static_cast<const T*>(w_hh_t), static_cast<const T*>(b_hh),
      static_cast<T*>(h_all), seq_len, batch, hidden, block_b);
  return (int)cudaGetLastError();
}

// variant codes passed from Python (ops/fused_rnn.py:_GRU_VARIANTS)
constexpr int kVariantSmem = 0;
constexpr int kVariantCluster = 1;

template <typename T>
int launch_dtype(const void* x_proj, const void* h0, const void* w_hh_t,
                 const void* b_hh, void* h_all, int seq_len, int batch,
                 int hidden, int block_b, int variant, cudaStream_t stream) {
  if (variant == kVariantSmem) {
    return launch_smem<T>(x_proj, h0, w_hh_t, b_hh, h_all, seq_len, batch, hidden, block_b,
                          stream);
  }
  if (variant == kVariantCluster && block_b == kFwdClusterRows) {
    return launch_cluster<T>(x_proj, h0, w_hh_t, b_hh, h_all, seq_len, batch, hidden, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or the error
// that kept the variant from launching.  Shapes, dtypes, block_b and the
// variant are checked and chosen by the Python wrapper (ops/fused_rnn.py:
// gru_fwd): variant 0 runs the shared-memory kernel on block_b-row tiles,
// variant 1 the cluster kernel (block_b = kFwdClusterRows).
extern "C" int gru_fwd(const void* x_proj, const void* h0, const void* w_hh_t,
                       const void* b_hh, void* h_all, int seq_len, int batch,
                       int hidden, int block_b, int variant, int dtype,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dtype<float>(x_proj, h0, w_hh_t, b_hh, h_all, seq_len,
                               batch, hidden, block_b, variant, s);
  }
  if (dtype == kBFloat16) {
    return launch_dtype<__nv_bfloat16>(x_proj, h0, w_hh_t, b_hh, h_all,
                                       seq_len, batch, hidden, block_b,
                                       variant, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster variant's shape at (hidden, batch) for a report: out[0] CTAs
// a cluster, out[1] batch rows a cluster, out[2] clusters resident at once,
// out[3] dynamic shared memory bytes a CTA.  Returns the error code of the
// launch configuration (0 = at least one cluster fits).
extern "C" int gru_fwd_cluster_shape(int hidden, int batch, int dtype, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  int err = (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) err = fwd_cluster_config<float>(hidden, batch, nullptr, cfg, attr, &active);
  if (dtype == kBFloat16) {
    err = fwd_cluster_config<__nv_bfloat16>(hidden, batch, nullptr, cfg, attr, &active);
  }
  out[0] = kClusterCtas;
  out[1] = kFwdClusterRows;
  out[2] = active;
  out[3] = (int)fwd_cluster_smem_bytes(hidden);
  return err;
}
