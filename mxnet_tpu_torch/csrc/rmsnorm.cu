// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * gamma over the
// trailing axis, statistics in fp32, output in x's dtype.
//
// Replaces: mxnet_tpu/kernels/fused_norm.py, _rms_fwd_kernel (pallas_call
// in _rms_pallas_fwd). The TPU kernel also writes the per-row rrms for
// the backward; nothing on the serving path reads it, so this forward
// does not write it.
//
// Bound on the H100: bytes. Each element is read once and written once
// with a handful of fp32 operations, far below the card's 295 operations
// per byte (the Llama path: 512 x 4096 bf16 at prefill, 8 x 4096 at
// decode).
//
// Design: one block per row. The block sums the squares with warp
// shuffles and one shared-memory step, then makes a second pass over the
// row, which the first pass has just brought into L1/L2, so device
// memory sees each byte once. Neighbouring threads touch neighbouring
// elements, so both passes are coalesced.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rmsnorm_kernel(T* __restrict__ out, const T* __restrict__ x,
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
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    ss = warp_sum(lane < nwarps ? partial[lane] : 0.f);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float rrms = 1.0f / sqrtf(partial[0] / (float)dim + eps);
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    orow[i] = from_float<T>(to_float(xr[i]) * rrms * gamma[i]);
  }
}

template <typename T>
int launch(void* out, const void* x, const float* gamma, int64_t rows,
           int dim, float eps, cudaStream_t stream) {
  // a warp per row for narrow rows, up to 512 threads for the 4096-wide
  // Llama rows (8 elements a thread)
  int threads = 32;
  while (threads < 512 && threads * 8 < dim) threads *= 2;
  rmsnorm_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      (T*)out, (const T*)x, gamma, dim, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// gamma is float32 whatever x's dtype, as the model keeps its norm gains
extern "C" int mxtt_rmsnorm(void* out, const void* x, const float* gamma,
                            int64_t rows, int dim, float eps, int x_dtype,
                            void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffff || dim <= 0) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == MXTT_F32)
    return launch<float>(out, x, gamma, rows, dim, eps, s);
  if (x_dtype == MXTT_BF16)
    return launch<__nv_bfloat16>(out, x, gamma, rows, dim, eps, s);
  return MXTT_BAD_ARGUMENT;
}
