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
// decode; 4096 x 4096 per norm in a training step, whose backward reads
// x and dy and writes dx).
//
// Design: one block per row. The block sums (x^2, or gamma * dy * x)
// with warp shuffles and one shared-memory step, then makes a second
// pass over the row, which the first pass has just brought into L1/L2,
// so device memory sees each byte once. Neighbouring threads touch
// neighbouring elements, so both passes are coalesced.
#include "common.cuh"

namespace {

// The sum of every thread's `v` over the block, returned to all threads.
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

template <typename T>
__global__ void rmsnorm_kernel(T* __restrict__ out, float* __restrict__ rrms,
                               const T* __restrict__ x,
                               const float* __restrict__ gamma, int dim,
                               float eps) {
  __shared__ float partial[32];
  const T* xr = x + (int64_t)blockIdx.x * dim;
  T* orow = out + (int64_t)blockIdx.x * dim;
  float ss = 0.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  const float r = 1.0f / sqrtf(block_sum(ss, partial) / (float)dim + eps);
  if (rrms != nullptr && threadIdx.x == 0) rrms[blockIdx.x] = r;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    orow[i] = from_float<T>(to_float(xr[i]) * r * gamma[i]);
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
// Llama rows (8 elements a thread)
int threads_for(int dim) {
  int threads = 32;
  while (threads < 512 && threads * 8 < dim) threads *= 2;
  return threads;
}

}  // namespace

// gamma is float32 whatever x's dtype, as the model keeps its norm gains;
// rrms (rows,) float32 may be null
extern "C" int mxtt_rmsnorm(void* out, float* rrms, const void* x,
                            const float* gamma, int64_t rows, int dim,
                            float eps, int x_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffff || dim <= 0) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = threads_for(dim);
  if (x_dtype == MXTT_F32)
    rmsnorm_kernel<float><<<(unsigned)rows, threads, 0, s>>>(
        (float*)out, rrms, (const float*)x, gamma, dim, eps);
  else if (x_dtype == MXTT_BF16)
    rmsnorm_kernel<__nv_bfloat16><<<(unsigned)rows, threads, 0, s>>>(
        (__nv_bfloat16*)out, rrms, (const __nv_bfloat16*)x, gamma, dim,
        eps);
  else
    return MXTT_BAD_ARGUMENT;
  return (int)cudaGetLastError();
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
