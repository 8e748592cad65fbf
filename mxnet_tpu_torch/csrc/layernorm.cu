// LayerNorm forward and its input gradient over the trailing axis,
// statistics in fp32, outputs in x's dtype, float32 gain and shift.
//
// Replaces: mxnet_tpu/kernels/fused_norm.py, _ln_fwd_kernel (pallas_call
// in _ln_pallas_fwd) and _ln_bwd_kernel (pallas_call in _ln_pallas_dx).
// The forward computes, per row,
//   mu = mean(x), var = mean((x - mu)^2)   (two passes, as the TPU kernel)
//   rstd = 1 / sqrt(var + eps), out = (x - mu) * rstd * gamma + beta
// and writes mu and rstd (fp32) for the backward when asked (the
// inference path passes null pointers and none are written). The
// backward computes, with xhat = (x - mu) * rstd and wdy = gamma * dy,
//   dx = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat))
// in fp32; dgamma and dbeta, sums over rows, are reduced outside (as
// _ln_bwd does in jnp).
//
// Bound on the H100: bytes. Each element is read once and written once
// (the backward reads x and dy and writes dx) with about ten fp32
// operations, far below the card's 295 operations per byte; at BERT-base's
// (4096, 768) bf16 the forward moves 12.6 MB, about 3.8 us at 3.35 TB/s.
//
// Design: the row lives in registers, so device memory sees each byte
// once and the second (centred) pass costs no reload. Up to 1024 wide a
// warp owns a row (four rows a block) and every sum is a warp shuffle;
// wider rows (up to kMaxDim) take a block of 256 threads a row, summed
// through shared memory. Lanes read 16-byte chunks (8 bf16 or 4 fp32)
// where the row length is a multiple of the chunk and the pointers are
// 16-byte aligned; neighbouring lanes read neighbouring chunks, so every
// load is coalesced. Other rows fall back to one element a lane per step,
// still coalesced.
#include "common.cuh"

namespace {

constexpr int kMaxDim = 8192;
constexpr int kWarpRowMax = 1024;   // widest row a warp owns
constexpr int kBlockThreads = 256;  // threads of a block-per-row launch
constexpr int kRowsPerBlock = 4;    // rows of a warp-per-row block
// values a lane holds: 1024 / 32 in the warp layout, 8192 / 256 in the
// block layout
constexpr int kPerLane = 32;

// The row's elements this thread holds: W consecutive elements (one
// 16-byte chunk, or one element) at each of NCH steps, step i starting
// at element (tid + i * TPR) * W.
template <typename T, int W, int TPR>
struct RowSlice {
  static constexpr int NCH = kPerLane / W;
  float v[NCH][W];

  __device__ __forceinline__ static bool live(int i, int tid, int dim) {
    return (tid + i * TPR) * W < dim;
  }

  __device__ __forceinline__ void load(const T* __restrict__ row, int tid,
                                       int dim) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = (tid + i * TPR) * W;
#pragma unroll
      for (int j = 0; j < W; ++j) v[i][j] = 0.f;
      if (e < dim) {
        if constexpr (W == 1)
          v[i][0] = to_float(row[e]);
        else
          unpack<T>(load16(row + e), v[i]);
      }
    }
  }
};

// (row index, thread index within the row) of this thread
template <int TPR>
__device__ __forceinline__ int2 row_and_tid() {
  if constexpr (TPR == 32)
    return make_int2(blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5),
                     threadIdx.x & 31);
  else
    return make_int2(blockIdx.x, threadIdx.x);
}

template <typename T, int W, int TPR>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kRowsPerBlock : TPR)
    layernorm_kernel(T* __restrict__ out, float* __restrict__ mu_out,
                     float* __restrict__ rstd_out, const T* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, int rows, int dim,
                     float eps) {
  __shared__ float red[32];
  const int2 rt = row_and_tid<TPR>();
  const int row = rt.x, tid = rt.y;
  // a warp past the last row stays idle (the warp layout has no block
  // barrier, the block layout has no idle rows)
  if (row >= rows) return;
  using Slice = RowSlice<T, W, TPR>;
  const int64_t off = (int64_t)row * dim;
  Slice xs;
  xs.load(x + off, tid, dim);

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Slice::NCH; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) s += xs.v[i][j];
  const float mu = row_sum<TPR>(s, red) / (float)dim;

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < Slice::NCH; ++i) {
    if (!Slice::live(i, tid, dim)) continue;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float c = xs.v[i][j] - mu;
      ss += c * c;
    }
  }
  const float rstd = 1.0f / sqrtf(row_sum<TPR>(ss, red) / (float)dim + eps);
  if (tid == 0) {
    if (mu_out != nullptr) mu_out[row] = mu;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }

  T* orow = out + off;
#pragma unroll
  for (int i = 0; i < Slice::NCH; ++i) {
    if (!Slice::live(i, tid, dim)) continue;
    const int e = (tid + i * TPR) * W;
    float o[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      o[j] = (xs.v[i][j] - mu) * rstd * gamma[e + j] + beta[e + j];
    if constexpr (W == 1)
      orow[e] = from_float<T>(o[0]);
    else
      *reinterpret_cast<uint4*>(orow + e) = pack_chunk<T>(o);
  }
}

template <typename T, int W, int TPR>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kRowsPerBlock : TPR)
    layernorm_dx_kernel(T* __restrict__ dx, const T* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ mu_in,
                        const float* __restrict__ rstd_in,
                        const T* __restrict__ dy, int rows, int dim) {
  __shared__ float red[32];
  const int2 rt = row_and_tid<TPR>();
  const int row = rt.x, tid = rt.y;
  if (row >= rows) return;
  using Slice = RowSlice<T, W, TPR>;
  const int64_t off = (int64_t)row * dim;
  Slice xs, ws;
  xs.load(x + off, tid, dim);
  ws.load(dy + off, tid, dim);
  const float mu = mu_in[row], rstd = rstd_in[row];

  // xs becomes xhat, ws becomes wdy = gamma * dy (0 past the row's end)
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < Slice::NCH; ++i) {
    if (!Slice::live(i, tid, dim)) continue;
    const int e = (tid + i * TPR) * W;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float xh = (xs.v[i][j] - mu) * rstd;
      const float w = ws.v[i][j] * gamma[e + j];
      xs.v[i][j] = xh;
      ws.v[i][j] = w;
      s1 += w;
      s2 += w * xh;
    }
  }
  const float m1 = row_sum<TPR>(s1, red) / (float)dim;
  const float m2 = row_sum<TPR>(s2, red) / (float)dim;

  T* dxr = dx + off;
#pragma unroll
  for (int i = 0; i < Slice::NCH; ++i) {
    if (!Slice::live(i, tid, dim)) continue;
    const int e = (tid + i * TPR) * W;
    float o[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      o[j] = rstd * (ws.v[i][j] - m1 - xs.v[i][j] * m2);
    if constexpr (W == 1)
      dxr[e] = from_float<T>(o[0]);
    else
      *reinterpret_cast<uint4*>(dxr + e) = pack_chunk<T>(o);
  }
}

// Launch `Kernel<T, W, TPR>` over `rows` rows: a warp a row up to
// kWarpRowMax, a block a row above it.
template <typename T, template <typename, int, int> class Launch,
          typename... Args>
int launch_rows(bool vec, int64_t rows, int dim, cudaStream_t s,
                Args... args) {
  if (dim <= kWarpRowMax) {
    const unsigned blocks =
        (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
    if (vec)
      Launch<T, kVec<T>, 32>::run(blocks, 32 * kRowsPerBlock, s, args...);
    else
      Launch<T, 1, 32>::run(blocks, 32 * kRowsPerBlock, s, args...);
  } else {
    if (vec)
      Launch<T, kVec<T>, kBlockThreads>::run((unsigned)rows, kBlockThreads,
                                             s, args...);
    else
      Launch<T, 1, kBlockThreads>::run((unsigned)rows, kBlockThreads, s,
                                       args...);
  }
  return (int)cudaGetLastError();
}

template <typename T, int W, int TPR>
struct FwdLaunch {
  static void run(unsigned blocks, int threads, cudaStream_t s, void* out,
                  float* mu, float* rstd, const void* x, const float* gamma,
                  const float* beta, int rows, int dim, float eps) {
    layernorm_kernel<T, W, TPR><<<blocks, threads, 0, s>>>(
        (T*)out, mu, rstd, (const T*)x, gamma, beta, rows, dim, eps);
  }
};

template <typename T, int W, int TPR>
struct DxLaunch {
  static void run(unsigned blocks, int threads, cudaStream_t s, void* dx,
                  const void* x, const float* gamma, const float* mu,
                  const float* rstd, const void* dy, int rows, int dim) {
    layernorm_dx_kernel<T, W, TPR><<<blocks, threads, 0, s>>>(
        (T*)dx, (const T*)x, gamma, mu, rstd, (const T*)dy, rows, dim);
  }
};

bool bad_shape(int64_t rows, int dim) {
  return rows > 0x7fffffff || dim <= 0 || dim > kMaxDim;
}

}  // namespace

// x and out (rows, dim) in x's dtype; gamma, beta (dim,) float32; mu and
// rstd (rows,) float32, each may be null
extern "C" int mxtt_layernorm(void* out, float* mu, float* rstd,
                              const void* x, const float* gamma,
                              const float* beta, int64_t rows, int dim,
                              float eps, int x_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (bad_shape(rows, dim)) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  const bool ptrs16 = aligned16({out, x});
  if (x_dtype == MXTT_F32)
    return launch_rows<float, FwdLaunch>(
        ptrs16 && dim % kVec<float> == 0, rows, dim, s, out, mu, rstd, x,
        gamma, beta, (int)rows, dim, eps);
  if (x_dtype == MXTT_BF16)
    return launch_rows<__nv_bfloat16, FwdLaunch>(
        ptrs16 && dim % kVec<__nv_bfloat16> == 0, rows, dim, s, out, mu,
        rstd, x, gamma, beta, (int)rows, dim, eps);
  return MXTT_BAD_ARGUMENT;
}

// dx, x and dy (rows, dim) in x's dtype; gamma (dim,), mu and rstd
// (rows,) float32
extern "C" int mxtt_layernorm_dx(void* dx, const void* x, const float* gamma,
                                 const float* mu, const float* rstd,
                                 const void* dy, int64_t rows, int dim,
                                 int x_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (bad_shape(rows, dim)) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  const bool ptrs16 = aligned16({dx, x, dy});
  if (x_dtype == MXTT_F32)
    return launch_rows<float, DxLaunch>(
        ptrs16 && dim % kVec<float> == 0, rows, dim, s, dx, x, gamma, mu,
        rstd, dy, (int)rows, dim);
  if (x_dtype == MXTT_BF16)
    return launch_rows<__nv_bfloat16, DxLaunch>(
        ptrs16 && dim % kVec<__nv_bfloat16> == 0, rows, dim, s, dx, x,
        gamma, mu, rstd, dy, (int)rows, dim);
  return MXTT_BAD_ARGUMENT;
}
