// Shared helpers of the port's CUDA kernels: dtype codes, conversions
// to and from the fp32 working type, warp reductions and the status
// convention of the C entry points.
//
// Every entry point returns 0 on success, a cudaError_t value when the
// launch was refused, or MXTT_BAD_ARGUMENT for a shape or dtype that no
// instantiation covers. The Python wrappers check shapes first, so
// MXTT_BAD_ARGUMENT only guards against a wrapper out of step with the
// instantiations below. MXTT_TENSOR_MAP: cuTensorMapEncodeTiled could not
// describe an operand to the TMA unit (the tensor-core kernels, sm90.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

enum { MXTT_F32 = 0, MXTT_BF16 = 1 };
enum { MXTT_BAD_ARGUMENT = 100000, MXTT_TENSOR_MAP = 100001 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// 16-byte chunks: the widest load a thread can issue. A chunk holds
// kVec<T> values (16 int8 codes); the wrappers require 16-byte aligned
// rows.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Widen one chunk to fp32 at `dst` (16-byte aligned shared memory).
template <typename T>
__device__ __forceinline__ void store_chunk(float* dst, uint4 raw);
template <>
__device__ __forceinline__ void store_chunk<float>(float* dst, uint4 raw) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                  __uint_as_float(raw.z), __uint_as_float(raw.w));
}
template <>
__device__ __forceinline__ void store_chunk<__nv_bfloat16>(float* dst,
                                                           uint4 raw) {
  // bf16 -> fp32 is exact: the 16 bits become the high half of the word
  // (element 0 of each pair is the low half, little-endian)
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(__uint_as_float(raw.x << 16),
                      __uint_as_float(raw.x & 0xffff0000u),
                      __uint_as_float(raw.y << 16),
                      __uint_as_float(raw.y & 0xffff0000u));
  d4[1] = make_float4(__uint_as_float(raw.z << 16),
                      __uint_as_float(raw.z & 0xffff0000u),
                      __uint_as_float(raw.w << 16),
                      __uint_as_float(raw.w & 0xffff0000u));
}
template <>
__device__ __forceinline__ void store_chunk<int8_t>(float* dst, uint4 raw) {
  // 16 int8 codes, byte 0 of each word first (little-endian); each code
  // widens exactly
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d4[i] = make_float4((float)(int8_t)(w[i] & 0xffu),
                        (float)(int8_t)((w[i] >> 8) & 0xffu),
                        (float)(int8_t)((w[i] >> 16) & 0xffu),
                        (float)(int8_t)(w[i] >> 24));
}

// Narrow kVec<T> fp32 values to one 16-byte chunk of T (the inverse of
// store_chunk), rounding as from_float does.
template <typename T>
__device__ __forceinline__ uint4 pack_chunk(const float* v);
template <>
__device__ __forceinline__ uint4 pack_chunk<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <>
__device__ __forceinline__ uint4 pack_chunk<__nv_bfloat16>(const float* v) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // element 2i is the low half of word i (little-endian)
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Where token t's row of kv head kh lives in a paged (N, K, bs, d) pool,
// in rows of d: through the batch row's own block-table row `btb`
// (physical block ids in logical order).
struct PagedRows {
  const int* btb;
  int K, kh, bs;
  __device__ int64_t operator()(int t) const {
    return ((int64_t)btb[t / bs] * K + kh) * bs + t % bs;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB this
// is required) and report the outcome in the entry points' convention.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
