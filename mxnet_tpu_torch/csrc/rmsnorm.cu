// RMSNorm forward and its input gradient over the trailing axis,
// statistics in fp32, outputs in x's dtype.
//
// Replaces: mxnet_tpu/kernels/fused_norm.py, _rms_fwd_kernel (pallas_call
// in _rms_pallas_fwd) and _rms_bwd_kernel (pallas_call in _rms_pallas_dx).
// The forward writes the per-row rrms = rsqrt(mean(x^2) + eps) (fp32)
// that the backward reads, as the TPU kernel does; a caller that needs
// no backward (the serving path) passes a null rrms and none is written.
// The backward computes
//   dx = rrms * (gamma * dy - x * mean(gamma * dy * x) * rrms^2)
// in fp32; dgamma, a sum over rows, is reduced outside (as _rms_bwd
// does in jnp).
//
// Bound on the H100: bytes. Each element is read once and written once
// with a handful of fp32 operations, far below the card's 295 operations
// per byte (the Llama path: 512 x 4096 bf16 at prefill, 8 x 4096 at
// decode; 4096 x 4096 per norm in a training step, 67 MB through the
// forward, 0.0200 ms at 3.35 TB/s; its backward reads x and dy and
// writes dx).
//
// Forward design: the row lives in registers (layernorm.cu's layout), so
// device memory sees each byte of x once and the scaling pass costs no
// reload. Up to 1024 wide a warp owns a row (four rows a block) and the
// sum of squares is a warp shuffle; wider rows (up to kMaxDim) take a
// block of 256 threads a row, summed through shared memory. Lanes read
// 16-byte chunks (8 bf16 or 4 fp32) where the row length is a multiple
// of the chunk and the pointers are 16-byte aligned, neighbouring lanes
// neighbouring chunks; other rows take one element a lane per step, still
// coalesced. The fp32 gain is twice the bytes of a bf16 row, so a thread
// loads its columns' gains once and keeps them in registers while its
// warp or block strides over rows: the grid holds only as many blocks as
// fit on the card at once, and each prefetches its next row's x while it
// reduces and writes the current one. With 8 rows (decode) that is one
// row a block. At the train shape this takes 0.0291 ms on the H100, 69%
// of the bound, against F.rms_norm's 0.0329 (chip_smoke.py, PERF.md).
//
// Backward design: one block per row. The block sums gamma * dy * x with
// warp shuffles and one shared-memory step, then makes a second pass over
// the row, which the first pass has just brought into L1/L2, so device
// memory sees each byte once. Neighbouring threads touch neighbouring
// elements, so both passes are coalesced.
#include <type_traits>

#include "common.cuh"

namespace {

// The sum of every thread's `v` over the block, returned to all threads
// (the dx kernel's reduction).
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = warp_sum(lane < nwarps ? partial[lane] : 0.f);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  return partial[0];
}

constexpr int kMaxDim = 8192;
constexpr int kWarpRowMax = 1024;   // widest row a warp owns
constexpr int kBlockThreads = 256;  // threads of a block-per-row launch
constexpr int kRowsPerBlock = 4;    // rows of a warp-per-row block

// A thread holds PER values of each row it normalises: PER / W steps of
// W consecutive elements (one 16-byte chunk, or one element), step i at
// element (tid + i * TPR) * W, and the gains of the same columns.
template <typename T, int W, int TPR, int PER>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kRowsPerBlock : TPR)
    rmsnorm_kernel(T* __restrict__ out, float* __restrict__ rrms,
                   const T* __restrict__ x, const float* __restrict__ gamma,
                   int rows, int dim, float eps) {
  constexpr int NCH = PER / W;
  using Raw = std::conditional_t<(W > 1), uint4, T>;
  __shared__ float red[32];
  const int tid = TPR == 32 ? threadIdx.x & 31 : threadIdx.x;
  int row = TPR == 32 ? blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5)
                      : blockIdx.x;
  const int step = TPR == 32 ? gridDim.x * kRowsPerBlock : gridDim.x;
  // a warp past the last row stays idle (the warp layout has no block
  // barrier; the block layout launches no more blocks than rows)
  if (row >= rows) return;

  float g[NCH][W];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = (tid + i * TPR) * W;
#pragma unroll
    for (int j = 0; j < W; ++j) g[i][j] = 0.f;
    if (e < dim) {
      if constexpr (W == 1) {
        g[i][0] = gamma[e];
      } else {
#pragma unroll
        for (int j = 0; j < W; j += 4)
          unpack<float>(load16(gamma + e + j), &g[i][j]);
      }
    }
  }

  auto load_row = [&](Raw (&raw)[NCH], int r) {
    const T* xr = x + (int64_t)r * dim;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = (tid + i * TPR) * W;
      if (e < dim) {
        if constexpr (W == 1)
          raw[i] = xr[e];
        else
          raw[i] = load16(xr + e);
      }
    }
  };

  Raw cur[NCH], nxt[NCH];
  load_row(cur, row);
  for (;;) {
    const int next = row + step;
    if (next < rows) load_row(nxt, next);   // in flight while this row works

    float v[NCH][W], ss = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int j = 0; j < W; ++j) v[i][j] = 0.f;
      if ((tid + i * TPR) * W < dim) {
        if constexpr (W == 1)
          v[i][0] = to_float(cur[i]);
        else
          unpack<T>(cur[i], v[i]);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) ss += v[i][j] * v[i][j];
    }
    const float r = 1.0f / sqrtf(row_sum<TPR>(ss, red) / (float)dim + eps);
    if (rrms != nullptr && tid == 0) rrms[row] = r;

    T* orow = out + (int64_t)row * dim;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = (tid + i * TPR) * W;
      if (e >= dim) continue;
      float o[W];
#pragma unroll
      for (int j = 0; j < W; ++j) o[j] = v[i][j] * r * g[i][j];
      if constexpr (W == 1)
        orow[e] = from_float<T>(o[0]);
      else
        *reinterpret_cast<uint4*>(orow + e) = pack_chunk<T>(o);
    }
    if (next >= rows) break;
    row = next;
#pragma unroll
    for (int i = 0; i < NCH; ++i) cur[i] = nxt[i];
  }
}

template <typename T>
__global__ void rmsnorm_dx_kernel(T* __restrict__ dx, const T* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ rrms,
                                  const T* __restrict__ dy, int dim) {
  __shared__ float partial[32];
  const int64_t off = (int64_t)blockIdx.x * dim;
  const T* xr = x + off;
  const T* dyr = dy + off;
  T* dxr = dx + off;
  float s = 0.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x)
    s += to_float(dyr[i]) * gamma[i] * to_float(xr[i]);
  const float r = rrms[blockIdx.x];
  const float corr = block_sum(s, partial) / (float)dim * r * r;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    const float wdy = to_float(dyr[i]) * gamma[i];
    dxr[i] = from_float<T>(r * (wdy - to_float(xr[i]) * corr));
  }
}

// a warp per row for narrow rows, up to 512 threads for the 4096-wide
// Llama rows (8 elements a thread): the dx kernel's block
int threads_for(int dim) {
  int threads = 32;
  while (threads < 512 && threads * 8 < dim) threads *= 2;
  return threads;
}

// Launch the forward over `rows` rows with no more blocks than fit on
// the card at once: each warp (TPR 32) or block strides over the rest.
template <typename T, int W, int TPR, int PER>
int launch_fwd(void* out, float* rrms, const void* x, const float* gamma,
               int rows, int dim, float eps, cudaStream_t s) {
  constexpr int threads = TPR == 32 ? 32 * kRowsPerBlock : TPR;
  const auto kernel = rmsnorm_kernel<T, W, TPR, PER>;
  static int per_sm = 0;   // resident blocks an SM; one value per kernel
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
    per_sm = n > 0 ? n : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t needed =
      TPR == 32 ? ((int64_t)rows + kRowsPerBlock - 1) / kRowsPerBlock : rows;
  const int64_t fit = (int64_t)per_sm * (sms > 0 ? sms : 1);
  const unsigned blocks = (unsigned)(needed < fit ? needed : fit);
  kernel<<<blocks, threads, 0, s>>>((T*)out, rrms, (const T*)x, gamma, rows,
                                    dim, eps);
  return (int)cudaGetLastError();
}

// The forward's layout for `dim`: a warp a row up to kWarpRowMax, a block
// above it, each thread holding the fewest values (8, 16 or 32) that
// cover the row.
template <typename T, int W>
int dispatch_fwd(void* out, float* rrms, const void* x, const float* gamma,
                 int rows, int dim, float eps, cudaStream_t s) {
  if (dim <= kWarpRowMax) {
    if (dim <= 32 * 8)
      return launch_fwd<T, W, 32, 8>(out, rrms, x, gamma, rows, dim, eps, s);
    if (dim <= 32 * 16)
      return launch_fwd<T, W, 32, 16>(out, rrms, x, gamma, rows, dim, eps, s);
    return launch_fwd<T, W, 32, 32>(out, rrms, x, gamma, rows, dim, eps, s);
  }
  constexpr int B = kBlockThreads;
  if (dim <= B * 8)
    return launch_fwd<T, W, B, 8>(out, rrms, x, gamma, rows, dim, eps, s);
  if (dim <= B * 16)   // Llama-3-8B's 4096
    return launch_fwd<T, W, B, 16>(out, rrms, x, gamma, rows, dim, eps, s);
  return launch_fwd<T, W, B, 32>(out, rrms, x, gamma, rows, dim, eps, s);
}

}  // namespace

// gamma is float32 whatever x's dtype, as the model keeps its norm gains;
// rrms (rows,) float32 may be null; rows up to kMaxDim wide
extern "C" int mxtt_rmsnorm(void* out, float* rrms, const void* x,
                            const float* gamma, int64_t rows, int dim,
                            float eps, int x_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffff || dim <= 0 || dim > kMaxDim)
    return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  const bool ptrs16 = aligned16({out, x, gamma});
  const int n = (int)rows;
  if (x_dtype == MXTT_F32)
    return ptrs16 && dim % kVec<float> == 0
               ? dispatch_fwd<float, kVec<float>>(out, rrms, x, gamma, n,
                                                  dim, eps, s)
               : dispatch_fwd<float, 1>(out, rrms, x, gamma, n, dim, eps, s);
  if (x_dtype == MXTT_BF16)
    return ptrs16 && dim % kVec<__nv_bfloat16> == 0
               ? dispatch_fwd<__nv_bfloat16, kVec<__nv_bfloat16>>(
                     out, rrms, x, gamma, n, dim, eps, s)
               : dispatch_fwd<__nv_bfloat16, 1>(out, rrms, x, gamma, n, dim,
                                                eps, s);
  return MXTT_BAD_ARGUMENT;
}

// dx, x and dy in x's dtype; gamma (dim,) and rrms (rows,) float32
extern "C" int mxtt_rmsnorm_dx(void* dx, const void* x, const float* gamma,
                               const float* rrms, const void* dy,
                               int64_t rows, int dim, int x_dtype,
                               void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffff || dim <= 0) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = threads_for(dim);
  if (x_dtype == MXTT_F32)
    rmsnorm_dx_kernel<float><<<(unsigned)rows, threads, 0, s>>>(
        (float*)dx, (const float*)x, gamma, rrms, (const float*)dy, dim);
  else if (x_dtype == MXTT_BF16)
    rmsnorm_dx_kernel<__nv_bfloat16><<<(unsigned)rows, threads, 0, s>>>(
        (__nv_bfloat16*)dx, (const __nv_bfloat16*)x, gamma, rrms,
        (const __nv_bfloat16*)dy, dim);
  else
    return MXTT_BAD_ARGUMENT;
  return (int)cudaGetLastError();
}
