// Sparse softmax cross-entropy over a large vocab, forward and backward,
// without materialising the (N, V) log-probabilities:
//
//   mxtt_ce_fwd  per row: lse = m + log sum exp(x - m), loss = lse -
//                x[label], both fp32
//   mxtt_ce_bwd  dx = (exp(x - lse) - onehot(label)) * dloss, in x's
//                dtype
//
// logits (N, V) float32 or bfloat16, labels (N,) int32, lse and loss
// (N,) fp32, dloss (N,) fp32. A label outside [0, V) picks nothing (its
// loss is lse), as the TPU kernel's one-hot compare does.
//
// Replaces: mxnet_tpu/kernels/fused_ce.py, _ce_fwd_kernel (pallas_call
// in _run_fwd) and _ce_bwd_kernel (pallas_call in _ce_pallas_bwd). The
// TPU kernel stages a (rows, V) block in VMEM with the vocab padded to a
// multiple of 128 with the dtype's most negative value, which bounds the
// vocab at 131072; a block here streams its row, so neither the padding
// nor the bound carries over.
//
// Bound on the H100: bytes. The forward reads each logit once (one exp
// and a few operations each), the backward reads each once and writes
// its gradient once: at the Llama-3-8B training shape (N = 4096 rows of
// V = 32000 bf16) 262 MB and 524 MB.
//
// Design: one block of 256 threads per row, each thread walking the row
// in 16-byte chunks (scalar elements where the rows are not 16-byte
// aligned) with neighbouring threads on neighbouring chunks. The forward
// keeps a running max and a running sum rescaled when the max grows (one
// exp per logit), so the 64 KB bf16 row is read once and never staged;
// the threads' (max, sum) pairs merge with warp shuffles and one
// shared-memory step. The backward is elementwise given the row's lse,
// and writes 16-byte chunks.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

struct Running {
  float m = -INFINITY, s = 0.f;

  __device__ __forceinline__ void add(float v) {
    if (v > m) {
      s = s * expf(m - v) + 1.f;   // m = -inf: s is 0 and stays 0 * 0
      m = v;
    } else if (v > -INFINITY) {
      s += expf(v - m);
    }
  }

  __device__ __forceinline__ void merge(float m2, float s2) {
    const float mn = fmaxf(m, m2);
    if (mn == -INFINITY) return;   // both empty
    s = s * expf(m - mn) + s2 * expf(m2 - mn);
    m = mn;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ce_fwd_kernel(float* __restrict__ loss, float* __restrict__ lse,
                  const T* __restrict__ x, const int* __restrict__ labels,
                  int V, int vec) {
  __shared__ float pm[NTHREADS / 32], ps[NTHREADS / 32];
  const T* xr = x + (int64_t)blockIdx.x * V;
  Running r;
  if (vec) {
    __align__(16) float f[kVec<T>];
    for (int c = threadIdx.x; c < V / kVec<T>; c += NTHREADS) {
      store_chunk<T>(f, load16(xr + c * kVec<T>));
#pragma unroll
      for (int i = 0; i < kVec<T>; ++i) r.add(f[i]);
    }
  } else {
    for (int i = threadIdx.x; i < V; i += NTHREADS) r.add(to_float(xr[i]));
  }
  for (int o = 16; o > 0; o >>= 1)
    r.merge(__shfl_xor_sync(0xffffffffu, r.m, o),
            __shfl_xor_sync(0xffffffffu, r.s, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    pm[warp] = r.m;
    ps[warp] = r.s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Running t;
    for (int w = 0; w < NTHREADS / 32; ++w) t.merge(pm[w], ps[w]);
    const float l = t.m + logf(t.s);
    const int lab = labels[blockIdx.x];
    const float xl = (lab >= 0 && lab < V) ? to_float(xr[lab]) : 0.f;
    loss[blockIdx.x] = l - xl;
    lse[blockIdx.x] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ce_bwd_kernel(T* __restrict__ dx, const T* __restrict__ x,
                  const int* __restrict__ labels,
                  const float* __restrict__ lse,
                  const float* __restrict__ dloss, int V, int vec) {
  const int64_t off = (int64_t)blockIdx.x * V;
  const T* xr = x + off;
  T* dr = dx + off;
  const float l = lse[blockIdx.x], g = dloss[blockIdx.x];
  const int lab = labels[blockIdx.x];
  if (vec) {
    __align__(16) float f[kVec<T>];
    for (int c = threadIdx.x; c < V / kVec<T>; c += NTHREADS) {
      const int j0 = c * kVec<T>;
      store_chunk<T>(f, load16(xr + j0));
#pragma unroll
      for (int i = 0; i < kVec<T>; ++i)
        f[i] = (expf(f[i] - l) - (j0 + i == lab ? 1.f : 0.f)) * g;
      *reinterpret_cast<uint4*>(dr + j0) = pack_chunk<T>(f);
    }
  } else {
    for (int j = threadIdx.x; j < V; j += NTHREADS)
      dr[j] = from_float<T>(
          (expf(to_float(xr[j]) - l) - (j == lab ? 1.f : 0.f)) * g);
  }
}

// 16-byte chunks where every row starts on a 16-byte boundary
template <typename T>
int rows_aligned(const void* a, const void* b, int V) {
  return ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0) &&
         ((int64_t)V * sizeof(T)) % 16 == 0;
}

}  // namespace

extern "C" int mxtt_ce_fwd(float* loss, float* lse, const void* x,
                           const int* labels, int64_t N, int V, int dtype,
                           void* stream) {
  if (N <= 0) return 0;
  if (N > 0x7fffffff || V <= 0) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXTT_F32)
    ce_fwd_kernel<float><<<(unsigned)N, NTHREADS, 0, s>>>(
        loss, lse, (const float*)x, labels, V,
        rows_aligned<float>(x, x, V));
  else if (dtype == MXTT_BF16)
    ce_fwd_kernel<__nv_bfloat16><<<(unsigned)N, NTHREADS, 0, s>>>(
        loss, lse, (const __nv_bfloat16*)x, labels, V,
        rows_aligned<__nv_bfloat16>(x, x, V));
  else
    return MXTT_BAD_ARGUMENT;
  return (int)cudaGetLastError();
}

extern "C" int mxtt_ce_bwd(void* dx, const void* x, const int* labels,
                           const float* lse, const float* dloss, int64_t N,
                           int V, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (N > 0x7fffffff || V <= 0) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXTT_F32)
    ce_bwd_kernel<float><<<(unsigned)N, NTHREADS, 0, s>>>(
        (float*)dx, (const float*)x, labels, lse, dloss, V,
        rows_aligned<float>(dx, x, V));
  else if (dtype == MXTT_BF16)
    ce_bwd_kernel<__nv_bfloat16><<<(unsigned)N, NTHREADS, 0, s>>>(
        (__nv_bfloat16*)dx, (const __nv_bfloat16*)x, labels, lse, dloss, V,
        rows_aligned<__nv_bfloat16>(dx, x, V));
  else
    return MXTT_BAD_ARGUMENT;
  return (int)cudaGetLastError();
}
