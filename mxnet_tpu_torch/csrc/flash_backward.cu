// Causal or full, key-length-masked GQA attention backward, in two
// kernels that recompute the probabilities from the forward's saved
// log-sum-exp, so no (T, T) matrix is ever stored:
//
//   mxtt_flash_bwd_dq   dQ = scale * dS K, one block per q tile
//   mxtt_flash_bwd_dkv  dV = sum P^T dO, dK = scale * sum dS^T Q, one
//                       block per k tile and kv head
//
// with P = exp(scale * Q K^T - lse) (0 where masked) and
// dS = P * (dO V^T - delta), delta = rowsum(dO * O) computed outside in
// fp32. Layout as the forward (flash_prefill.cu): q, dO (B, T, H, d);
// k, v (B, T, K, d); lse, delta (B, H, T) fp32; lengths (B,) int32;
// outputs in q's dtype. Masks compare absolute positions: key s is seen
// by query t when s < lengths[b] and, if causal, s <= t.
//
// Replaces: mxnet_tpu/kernels/flash_attention.py, _pallas_backward:
// dq_kernel (its first pallas_call) and dkv_kernel (its second). The dq
// sweep stops at the diagonal and at lengths[b]; the dkv sweep starts at
// the diagonal and runs to T, not cut at lengths (query rows past
// lengths[b] still attend valid keys, so their cotangents reach dK and
// dV). The TPU kernel writes dK and dV per query head in q's dtype and
// sums each group of rep = H/K heads outside; here the block of a kv
// head walks its rep query heads itself and sums them in fp32, so no
// (B, T, H, d) intermediate exists and each kv row is rounded once
// (at bf16 the two differ by rounding alone).
//
// Bound on the H100: operations. Per (query, key) pair the dq kernel
// does 6 d multiply-adds' worth of flops (the score, dO V^T and dS K)
// and the dkv kernel 8 d (the score, dO V^T, P^T dO and dS^T Q), about
// 1,000 operations per byte read at the Llama-3-8B training shape (B=2,
// T=2048, H=32, K=8, d=128), far above the card's 295: only tensor cores
// (wgmma) would approach the bound, and these kernels run on the fp32
// SIMT units, so their floor is the fp32 rate.
//
// Route: the port launches dq and dkv here for float32 and d = 16
// (llama_tiny); bf16 at d = 64 or 128 takes the tensor-core kernels
// (flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu).
//
// Design: the forward's layout, with the roles of queries and keys
// swapped in dkv. A block has 8 warps; each warp owns 8 rows of the
// block's 64 (query rows in dq, key rows in dkv) and lane j owns row j of
// the other side's 32-row tile, so a lane's scores and dO V^T terms are
// two length-d dots against rows staged in shared memory (padded to
// d + 4 floats so the 16-byte reads of a quarter warp fall on distinct
// banks), and the row-sums of the outer products are walks over the
// tile with lane-consecutive columns. Tiles are staged in fp32; the
// accumulators (dQ, or dK and dV) stay in registers. No atomics: each
// output row is written by exactly one block, so results do not change
// from run to run.
#include "common.cuh"

namespace {

constexpr int BR = 64;               // rows a block owns
constexpr int BT = 32;               // rows of the swept tile: lane j owns j
constexpr int NWARPS = 8;
constexpr int RPW = BR / NWARPS;     // owned rows per warp
constexpr int NTHREADS = NWARPS * 32;

template <int D>
constexpr size_t dq_smem_bytes() {   // Q, dO; K, V tiles; dS
  return sizeof(float) * (2 * BR * D + 2 * BT * (D + 4) + BR * BT);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V; Q, dO tiles; P, dS
  return sizeof(float) * (2 * BR * D + 2 * BT * (D + 4) + 2 * BR * BT);
}

// Stage rows [r0, r0 + nrows) of a row-major matrix with row stride
// `stride` (elements) into shared memory as fp32 rows of `ld` floats,
// times `mul`; rows at or past `rend` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int64_t stride, int r0, int nrows,
                                           int rend, float mul) {
  constexpr int CPR = D / kVec<T>;   // 16-byte chunks a row
  for (int e = threadIdx.x; e < nrows * CPR; e += NTHREADS) {
    const int r = e / CPR, c = (e % CPR) * kVec<T>, t = r0 + r;
    float* d = dst + r * ld + c;
    store_chunk<T>(d, t < rend ? load16(src + t * stride + c)
                               : make_uint4(0u, 0u, 0u, 0u));
    if (mul != 1.f) {
#pragma unroll
      for (int i = 0; i < kVec<T>; ++i) d[i] *= mul;
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// For each of the warp's RPW owned rows (stride `own_ld` floats from
// `own_a` and `own_b`) and the lane's tile row (`lane_a`, `lane_b`, of
// stride D + 4): a[rr] = own_a[rr] . lane_a, b[rr] = own_b[rr] . lane_b.
template <int D>
__device__ __forceinline__ void two_dots(float (&a)[RPW], float (&b)[RPW],
                                         const float* own_a,
                                         const float* own_b,
                                         const float* lane_a,
                                         const float* lane_b) {
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) a[rr] = b[rr] = 0.f;
  const float4* la = reinterpret_cast<const float4*>(lane_a);
  const float4* lb = reinterpret_cast<const float4*>(lane_b);
#pragma unroll 4
  for (int c4 = 0; c4 < D / 4; ++c4) {
    const float4 xa = la[c4], xb = lb[c4];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      a[rr] = dot4(reinterpret_cast<const float4*>(own_a + rr * D)[c4], xa,
                   a[rr]);
      b[rr] = dot4(reinterpret_cast<const float4*>(own_b + rr * D)[c4], xb,
                   b[rr]);
    }
  }
}

// acc[rr][cc] += sum_j w[rr][j] * tile[j][lane + 32 cc] over the BT tile
// rows: w is the warp's RPW rows of BT weights, tile rows of D + 4.
template <int D, int NC>
__device__ __forceinline__ void accumulate(float (&acc)[RPW][NC],
                                           const float* w,
                                           const float* tile, int lane) {
  constexpr int KST = D + 4;
#pragma unroll 2
  for (int j4 = 0; j4 < BT / 4; ++j4) {
    float4 wv[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr)
      wv[rr] = reinterpret_cast<const float4*>(w + rr * BT)[j4];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = lane + 32 * cc;
      if (col < D) {
        const float t0 = tile[(4 * j4 + 0) * KST + col];
        const float t1 = tile[(4 * j4 + 1) * KST + col];
        const float t2 = tile[(4 * j4 + 2) * KST + col];
        const float t3 = tile[(4 * j4 + 3) * KST + col];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          float a = acc[rr][cc];
          a = fmaf(wv[rr].x, t0, a);
          a = fmaf(wv[rr].y, t1, a);
          a = fmaf(wv[rr].z, t2, a);
          a = fmaf(wv[rr].w, t3, a);
          acc[rr][cc] = a;
        }
      }
    }
  }
}

template <typename T, int D, int NC>
__device__ __forceinline__ void write_rows(T* __restrict__ dst,
                                           int64_t stride,
                                           const float (&acc)[RPW][NC],
                                           int r0, int rend, float mul) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int t = r0 + warp * RPW + rr;
    if (t >= rend) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = lane + 32 * cc;
      if (col < D) dst[t * stride + col] = from_float<T>(acc[rr][cc] * mul);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(T* __restrict__ dq, const T* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ lengths, int seq, int H,
                        int K, int causal, float scale) {
  constexpr int KST = D + 4;
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // BR x D, pre-scaled
  float* dOs = Qs + BR * D;          // BR x D
  float* Ks = dOs + BR * D;          // BT x KST
  float* Vs = Ks + BT * KST;         // BT x KST
  float* dSs = Vs + BT * KST;        // BR x BT

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)K * D;
  const int64_t qoff = (int64_t)b * seq * qstride + (int64_t)h * D;
  const int64_t koff = (int64_t)b * seq * kstride + (int64_t)kh * D;
  const float* lse_bh = lse + ((int64_t)b * H + h) * seq;
  const float* delta_bh = delta + ((int64_t)b * H + h) * seq;

  stage_rows<T, D>(Qs, D, q + qoff, qstride, q0, BR, seq, scale);
  stage_rows<T, D>(dOs, D, dout + qoff, qstride, q0, BR, seq, 1.f);
  float lse_r[RPW], delta_r[RPW], acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int t = q0 + warp * RPW + rr;
    // a row past T has no probabilities: lse = +inf makes them 0
    lse_r[rr] = t < seq ? lse_bh[t] : INFINITY;
    delta_r[rr] = t < seq ? delta_bh[t] : 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[rr][cc] = 0.f;
  }
  // keys [0, kend) may be seen by some row of this tile
  int kend = min(seq, lengths[b]);
  if (causal) kend = min(kend, q0 + BR);
  const int ntiles = kend > 0 ? (kend + BT - 1) / BT : 0;

  const float* own_q = Qs + warp * RPW * D;
  const float* own_do = dOs + warp * RPW * D;
  float* own_ds = dSs + warp * RPW * BT;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // Q and dO are staged and the last tile consumed
    stage_rows<T, D>(Ks, KST, k + koff, kstride, k0, BT, kend, 1.f);
    stage_rows<T, D>(Vs, KST, v + koff, kstride, k0, BT, kend, 1.f);
    __syncthreads();
    float sc[RPW], dp[RPW];
    two_dots<D>(sc, dp, own_q, own_do, Ks + lane * KST, Vs + lane * KST);
    const int s = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int t = q0 + warp * RPW + rr;
      const bool seen = s < kend && (!causal || s <= t);
      const float p = seen ? expf(sc[rr] - lse_r[rr]) : 0.f;
      own_ds[rr * BT + lane] = p * (dp[rr] - delta_r[rr]);
    }
    __syncwarp();
    accumulate<D, NC>(acc, own_ds, Ks, lane);
  }
  write_rows<T, D, NC>(dq + qoff, qstride, acc, q0, seq, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(T* __restrict__ dk, T* __restrict__ dv,
                         const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ lengths, int seq, int H,
                         int K, int causal, float scale) {
  constexpr int KST = D + 4;
  constexpr int NC = (D + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // BR x D, pre-scaled
  float* Vs = Ks + BR * D;           // BR x D
  float* Qt = Vs + BR * D;           // BT x KST
  float* dOt = Qt + BT * KST;        // BT x KST
  float* Ps = dOt + BT * KST;        // BR x BT
  float* dSs = Ps + BR * BT;         // BR x BT

  const int k0 = blockIdx.x * BR, kh = blockIdx.y, b = blockIdx.z;
  const int rep = H / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)K * D;
  const int64_t koff = (int64_t)b * seq * kstride + (int64_t)kh * D;
  const int klen = min(seq, lengths[b]);   // keys past it are masked

  float dk_acc[RPW][NC], dv_acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dk_acc[rr][cc] = dv_acc[rr][cc] = 0.f;

  if (k0 < klen) {
    stage_rows<T, D>(Ks, D, k + koff, kstride, k0, BR, klen, scale);
    stage_rows<T, D>(Vs, D, v + koff, kstride, k0, BR, klen, 1.f);
    // rows before the tile's first key see none of its keys
    const int t_start = causal ? k0 : 0;
    const float* own_k = Ks + warp * RPW * D;
    const float* own_v = Vs + warp * RPW * D;
    float* own_p = Ps + warp * RPW * BT;
    float* own_ds = dSs + warp * RPW * BT;
    for (int hr = 0; hr < rep; ++hr) {
      const int h = kh * rep + hr;
      const int64_t qoff = (int64_t)b * seq * qstride + (int64_t)h * D;
      const float* lse_bh = lse + ((int64_t)b * H + h) * seq;
      const float* delta_bh = delta + ((int64_t)b * H + h) * seq;
      for (int t0 = t_start; t0 < seq; t0 += BT) {
        __syncthreads();  // K and V are staged and the last tile consumed
        stage_rows<T, D>(Qt, KST, q + qoff, qstride, t0, BT, seq, 1.f);
        stage_rows<T, D>(dOt, KST, dout + qoff, qstride, t0, BT, seq, 1.f);
        __syncthreads();
        const int t = t0 + lane;
        const float lse_t = t < seq ? lse_bh[t] : INFINITY;
        const float delta_t = t < seq ? delta_bh[t] : 0.f;
        float sc[RPW], dp[RPW];
        two_dots<D>(sc, dp, own_k, own_v, Qt + lane * KST,
                    dOt + lane * KST);
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const int s = k0 + warp * RPW + rr;
          const bool seen = s < klen && t < seq && (!causal || s <= t);
          const float p = seen ? expf(sc[rr] - lse_t) : 0.f;
          own_p[rr * BT + lane] = p;
          own_ds[rr * BT + lane] = p * (dp[rr] - delta_t);
        }
        __syncwarp();
        accumulate<D, NC>(dv_acc, own_p, dOt, lane);
        accumulate<D, NC>(dk_acc, own_ds, Qt, lane);
      }
    }
  }
  write_rows<T, D, NC>(dk + koff, kstride, dk_acc, k0, seq, scale);
  write_rows<T, D, NC>(dv + koff, kstride, dv_acc, k0, seq, 1.f);
}

struct Problem {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lengths;
  int B, seq, H, K, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(void* dq, const Problem& p) {
  const size_t smem = dq_smem_bytes<D>();
  const int rc = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (rc) return rc;
  const dim3 grid((p.seq + BR - 1) / BR, p.H, p.B);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem, p.stream>>>(
      (T*)dq, (const T*)p.q, (const T*)p.k, (const T*)p.v,
      (const T*)p.dout, p.lse, p.delta, p.lengths, p.seq, p.H, p.K,
      p.causal, p.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(void* dk, void* dv, const Problem& p) {
  const size_t smem = dkv_smem_bytes<D>();
  const int rc = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (rc) return rc;
  const dim3 grid((p.seq + BR - 1) / BR, p.K, p.B);
  flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, smem, p.stream>>>(
      (T*)dk, (T*)dv, (const T*)p.q, (const T*)p.k, (const T*)p.v,
      (const T*)p.dout, p.lse, p.delta, p.lengths, p.seq, p.H, p.K,
      p.causal, p.scale);
  return (int)cudaGetLastError();
}

// outs: {dq} or {dk, dv}
template <typename T, int D>
int launch(bool dkv, void* const* outs, const Problem& p) {
  return dkv ? launch_dkv<T, D>(outs[0], outs[1], p)
             : launch_dq<T, D>(outs[0], p);
}

int dispatch(bool dkv, void* const* outs, int D, int dtype,
             const Problem& p) {
  if (p.B <= 0 || p.seq <= 0) return 0;
  if (p.K <= 0 || p.H % p.K || p.B > 65535 || p.H > 65535)
    return MXTT_BAD_ARGUMENT;
  if (dtype == MXTT_F32) {
    if (D == 16) return launch<float, 16>(dkv, outs, p);      // llama_tiny
    if (D == 64) return launch<float, 64>(dkv, outs, p);      // BERT
    if (D == 128) return launch<float, 128>(dkv, outs, p);    // Llama-3-8B
  } else if (dtype == MXTT_BF16) {
    if (D == 16) return launch<__nv_bfloat16, 16>(dkv, outs, p);
    if (D == 64) return launch<__nv_bfloat16, 64>(dkv, outs, p);
    if (D == 128) return launch<__nv_bfloat16, 128>(dkv, outs, p);
  }
  return MXTT_BAD_ARGUMENT;
}

}  // namespace

// dq, q, dout (B, T, H, d) and k, v (B, T, K, d) in one dtype; lse and
// delta (B, H, T) float32; lengths (B,) int32
extern "C" int mxtt_flash_bwd_dq(void* dq, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta,
                                 const int* lengths, int B, int seq, int H,
                                 int K, int D, int causal, float scale,
                                 int dtype, void* stream) {
  void* outs[1] = {dq};
  return dispatch(false, outs, D, dtype,
                  Problem{q, k, v, dout, lse, delta, lengths, B, seq, H, K,
                          causal, scale, (cudaStream_t)stream});
}

// dk, dv (B, T, K, d) in q's dtype; the other operands as mxtt_flash_bwd_dq
extern "C" int mxtt_flash_bwd_dkv(void* dk, void* dv, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const int* lengths,
                                  int B, int seq, int H, int K, int D,
                                  int causal, float scale, int dtype,
                                  void* stream) {
  void* outs[2] = {dk, dv};
  return dispatch(true, outs, D, dtype,
                  Problem{q, k, v, dout, lse, delta, lengths, B, seq, H, K,
                          causal, scale, (cudaStream_t)stream});
}
