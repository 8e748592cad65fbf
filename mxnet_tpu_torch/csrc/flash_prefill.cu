// Causal or full, key-length-masked GQA attention forward for the
// prefill and the training steps (causal for Llama; full with key
// padding for BERT's self-attention): q (B, T, H, d), k/v (B, T, K, d)
// with H % K == 0, lengths (B,) int32, out (B, T, H, d) in q's dtype,
// and optionally the (B, H, T) fp32 log-sum-exp of each row's scaled
// scores, which the backward (flash_backward.cu) reads. Query head h
// reads kv head h // (H/K). Keys at or past lengths[b] are masked; a row
// with no valid key is 0 and its lse +inf (so exp(s - lse) is 0 in the
// backward).
//
// Replaces: mxnet_tpu/kernels/flash_attention.py, the kernel of
// _pallas_forward (its pallas_call; lse as with return_lse=True). The
// TPU kernel only runs when T % 128 == 0; this one takes every T,
// masking the ragged tail itself. The serving path passes a null lse.
//
// Bound on the H100: at the Llama-3-8B prefill (T = 512, H = 32, K = 8,
// d = 128, bf16) the causal work is ~2.1 GFLOP against ~10.5 MB moved,
// about 200 operations per byte, under the card's 295: bytes bound in
// principle, but only a tensor-core kernel gets near either roof.
//
// Design: one block of 8 warps per (q tile of 64 rows, head, batch row).
// The TPU grid's sequential K/V sweep becomes a loop inside the block:
// 32-key tiles of K and V are staged in shared memory in fp32 (each
// thread loads its share of the next tile into registers with 16-byte
// loads while the current tile computes) and each
// warp keeps an online softmax (running max, sum, accumulator) for its 8
// rows in registers. Lane j scores key j of the tile, so the row max and
// sum are warp shuffles. The sweep stops at the diagonal tile and at
// lengths[b]: fully masked tiles are never read. Scores and products run
// on the fp32 SIMT units; tensor cores (wgmma) and TMA staging are later
// work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 32;               // keys per tile: lane j owns key j
constexpr int NWARPS = 8;
constexpr int RPW = BQ / NWARPS;     // query rows per warp
constexpr int NTHREADS = NWARPS * 32;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 4) + BK * D + BQ * BK);
}

// Issue this thread's 16-byte loads of the K and V rows of keys
// [k0, k0 + BK); zeros at or past kend.
template <typename T, int D, int NCH>
__device__ __forceinline__ void load_tile(uint4 (&kreg)[NCH],
                                          uint4 (&vreg)[NCH],
                                          const T* __restrict__ kb,
                                          const T* __restrict__ vb, int k0,
                                          int kend, int64_t kstride) {
  constexpr int CPR = D / kVec<T>;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    const int r = e / CPR, c = (e % CPR) * kVec<T>, s = k0 + r;
    kreg[i] = vreg[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < BK * CPR && s < kend) {
      kreg[i] = load16(kb + s * kstride + c);
      vreg[i] = load16(vb + s * kstride + c);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_prefill_kernel(T* __restrict__ out, float* __restrict__ lse,
                         const T* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ lengths, int seq, int H,
                         int K, int causal, float scale) {
  // K rows are padded to D + 4 floats: the 16-byte reads of K[lane]
  // by a quarter warp then fall on distinct banks
  constexpr int KST = D + 4;
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // BQ x D, pre-scaled
  float* Ks = Qs + BQ * D;       // BK x KST
  float* Vs = Ks + BK * KST;     // BK x D
  float* Ps = Vs + BK * D;       // BQ x BK probabilities of the tile

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)K * D;
  const T* qb = q + (int64_t)b * seq * qstride + (int64_t)h * D;
  const T* kb = k + (int64_t)b * seq * kstride + (int64_t)kh * D;
  const T* vb = v + (int64_t)b * seq * kstride + (int64_t)kh * D;

  constexpr int CPR = D / kVec<T>;                  // 16-byte chunks a row
  for (int e = tid; e < BQ * CPR; e += NTHREADS) {
    const int r = e / CPR, c = (e % CPR) * kVec<T>, t = q0 + r;
    float* dst = Qs + r * D + c;
    store_chunk<T>(dst, t < seq ? load16(qb + t * qstride + c)
                                : make_uint4(0u, 0u, 0u, 0u));
#pragma unroll
    for (int i = 0; i < kVec<T>; ++i) dst[i] *= scale;
  }
  // keys [0, kend) may be valid for some row of this tile
  int kend = min(seq, lengths[b]);
  if (causal) kend = min(kend, q0 + BQ);
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[rr][cc] = 0.f;
  }

  // K/V of the next tile travel in registers while this tile computes
  constexpr int NCH = (BK * CPR + NTHREADS - 1) / NTHREADS;   // a thread
  uint4 kreg[NCH], vreg[NCH];
  if (ntiles > 0) load_tile<T, D, NCH>(kreg, vreg, kb, vb, 0, kend, kstride);

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is staged and the previous tile is consumed
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = tid + i * NTHREADS;
      if (e < BK * CPR) {
        const int r = e / CPR, c = (e % CPR) * kVec<T>;
        store_chunk<T>(Ks + r * KST + c, kreg[i]);
        store_chunk<T>(Vs + r * D + c, vreg[i]);
      }
    }
    __syncthreads();
    if (kt + 1 < ntiles)
      load_tile<T, D, NCH>(kreg, vreg, kb, vb, k0 + BK, kend, kstride);

    float sc[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) sc[rr] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * KST);
#pragma unroll 4
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 kv = krow[c4];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qv =
            reinterpret_cast<const float4*>(Qs + (warp * RPW + rr) * D)[c4];
        sc[rr] = fmaf(qv.x, kv.x, sc[rr]);
        sc[rr] = fmaf(qv.y, kv.y, sc[rr]);
        sc[rr] = fmaf(qv.z, kv.z, sc[rr]);
        sc[rr] = fmaf(qv.w, kv.w, sc[rr]);
      }
    }

    const int s = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int t = q0 + warp * RPW + rr;
      const bool valid = s < kend && (!causal || s <= t);
      const float x = valid ? sc[rr] : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(x));
      // a row that has seen no valid key keeps m = -inf: its
      // probabilities and correction are 0, never exp(nan)
      const float p = m_new > -INFINITY ? expf(x - m_new) : 0.f;
      const float corr = m[rr] > -INFINITY ? expf(m[rr] - m_new) : 0.f;
      l[rr] = corr * l[rr] + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[rr][cc] *= corr;
      Ps[(warp * RPW + rr) * BK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float4 pv[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr)
        pv[rr] = reinterpret_cast<const float4*>(Ps + (warp * RPW + rr) * BK)[j4];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int col = lane + 32 * cc;
        if (col < D) {
          const float v0 = Vs[(4 * j4 + 0) * D + col];
          const float v1 = Vs[(4 * j4 + 1) * D + col];
          const float v2 = Vs[(4 * j4 + 2) * D + col];
          const float v3 = Vs[(4 * j4 + 3) * D + col];
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr) {
            float a = acc[rr][cc];
            a = fmaf(pv[rr].x, v0, a);
            a = fmaf(pv[rr].y, v1, a);
            a = fmaf(pv[rr].z, v2, a);
            a = fmaf(pv[rr].w, v3, a);
            acc[rr][cc] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int t = q0 + warp * RPW + rr;
    if (t >= seq) continue;
    if (lse != nullptr && lane == 0)
      lse[((int64_t)b * H + h) * seq + t] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : INFINITY;
    T* orow = out + ((int64_t)b * seq + t) * qstride + (int64_t)h * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = lane + 32 * cc;
      if (col < D)
        orow[col] = from_float<T>(l[rr] > 0.f ? acc[rr][cc] / l[rr] : 0.f);
    }
  }
}

template <typename T, int D>
int launch(void* out, float* lse, const void* q, const void* k,
           const void* v, const int* lengths, int B, int seq, int H, int K,
           int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  const int rc = allow_smem(flash_prefill_kernel<T, D>, smem);
  if (rc) return rc;
  const dim3 grid((seq + BQ - 1) / BQ, H, B);
  flash_prefill_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (T*)out, lse, (const T*)q, (const T*)k, (const T*)v, lengths, seq, H,
      K, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, void* out, float* lse, const void* q,
                 const void* k, const void* v, const int* lengths, int B,
                 int seq, int H, int K, int causal, float scale,
                 cudaStream_t s) {
  switch (D) {
    case 16:   // llama_tiny
      return launch<T, 16>(out, lse, q, k, v, lengths, B, seq, H, K,
                           causal, scale, s);
    case 64:   // BERT-base, BERT-large, transformer_base
      return launch<T, 64>(out, lse, q, k, v, lengths, B, seq, H, K,
                           causal, scale, s);
    case 128:  // Llama-3-8B
      return launch<T, 128>(out, lse, q, k, v, lengths, B, seq, H, K,
                            causal, scale, s);
    default:
      return MXTT_BAD_ARGUMENT;
  }
}

}  // namespace

// lse (B, H, T) float32 may be null
extern "C" int mxtt_flash_prefill(void* out, float* lse, const void* q,
                                  const void* k, const void* v,
                                  const int* lengths, int B, int seq, int H,
                                  int K, int D, int causal, float scale,
                                  int dtype, void* stream) {
  if (B <= 0 || seq <= 0) return 0;
  if (K <= 0 || H % K || B > 65535 || H > 65535) return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXTT_F32)
    return dispatch_dim<float>(D, out, lse, q, k, v, lengths, B, seq, H, K,
                               causal, scale, s);
  if (dtype == MXTT_BF16)
    return dispatch_dim<__nv_bfloat16>(D, out, lse, q, k, v, lengths, B,
                                       seq, H, K, causal, scale, s);
  return MXTT_BAD_ARGUMENT;
}
