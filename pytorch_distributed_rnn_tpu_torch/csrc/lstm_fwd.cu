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
#include "lstm_common.cuh"

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
int launch_dtype(const void* x_proj, const void* h0, const void* c0,
                 const void* w_hh_t, void* h_all, void* c_all, int seq_len,
                 int batch, int hidden, int block_b, cudaStream_t stream) {
  if (hidden <= kRegHidden) {
    return launch<T, true>(x_proj, h0, c0, w_hh_t, h_all, c_all, seq_len, batch, hidden,
                           block_b, stream);
  }
  return launch<T, false>(x_proj, h0, c0, w_hh_t, h_all, c_all, seq_len, batch, hidden,
                          block_b, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  Shapes and
// dtypes are checked, and block_b (a multiple of 4, block_b * hidden <= 512)
// chosen, by the Python wrapper (ops/fused_rnn.py:lstm_fwd, lstm_fwd_tile).
extern "C" int lstm_fwd(const void* x_proj, const void* h0, const void* c0,
                        const void* w_hh_t, void* h_all, void* c_all,
                        int seq_len, int batch, int hidden, int block_b,
                        int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_dtype<float>(x_proj, h0, c0, w_hh_t, h_all, c_all, seq_len,
                               batch, hidden, block_b, s);
  }
  if (dtype == kBFloat16) {
    return launch_dtype<__nv_bfloat16>(x_proj, h0, c0, w_hh_t, h_all, c_all,
                                       seq_len, batch, hidden, block_b, s);
  }
  return (int)cudaErrorInvalidValue;
}
