// Single-token decode attention straight off the paged KV pool:
// q (B, H, d), k/v pages (N, K, bs, d), block_tables (B, nb) int32 of
// physical block ids in logical order, valid_len (B,) int32; out
// (B, H, d) in q's dtype. Query head h reads kv head h // (H/K).
//
// Replaces: mxnet_tpu/kernels/flash_decode.py, the kernel of
// _flash_decode_paged_pallas (its pallas_call). There the block table
// rides in scalar-prefetch memory and the pipeline DMAs block
// bt[b, i] per grid cell; a CUDA block has no scalar prefetch, so it
// reads its own table row and valid length.
//
// Bound on the H100: bytes. Every valid cached token's K and V rows are
// read once per kv head for rep = H/K query rows: 4 * rep operations per
// byte, far below the card's 295.
//
// Design: one block per (kv head, batch row). The block walks the
// logical blocks below valid_len in tiles of 64 tokens (4 pages of 16 or
// 8 pages of 8), gathering each token's K and V rows from its physical
// page into shared memory in fp32. With one block per SM there are no
// other warps to hide memory latency behind, so each thread issues all
// its 16-byte loads of the NEXT tile into registers before computing the
// current one: one memory round trip per tile, overlapped with the
// math, instead of one per element. The rep query rows of the kv head
// share every tile, so the pool is read once per kv head, not once per
// query head. Table entries at or past valid_len, which point at the
// scratch block 0, are never read. An online softmax (running max, sum,
// correction) carries across tiles as in flash_decode.py:278-305. With
// B * K = 64 blocks at the Llama-3-8B shape, the 132 SMs are not filled:
// splitting the token walk across blocks (split-K) is later work.
#include "common.cuh"

namespace {

constexpr int TT = 64;            // tokens per tile (two per lane in softmax)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_OUT = 8;        // outputs a thread owns: rep * D <= 1024

template <int D>
size_t smem_bytes(int rep) {
  return sizeof(float) *
         (rep * D + TT * (D + 4) + TT * D + rep * TT + 3 * rep);
}

// Issue this thread's 16-byte loads of the K and V rows of tokens
// [t0, t0 + TT), each gathered from its physical page; zeros past vl.
template <typename T, int D, int NCH>
__device__ __forceinline__ void load_tile(uint4 (&kreg)[NCH],
                                          uint4 (&vreg)[NCH],
                                          const T* __restrict__ kp,
                                          const T* __restrict__ vp,
                                          const int* __restrict__ btb, int t0,
                                          int vl, int K, int kh, int bs) {
  constexpr int CPR = D / kVec<T>;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    const int j = e / CPR, c = (e % CPR) * kVec<T>, pos = t0 + j;
    kreg[i] = vreg[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < TT * CPR && pos < vl) {
      const int64_t row = ((int64_t)btb[pos / bs] * K + kh) * bs + pos % bs;
      kreg[i] = load16(kp + row * D + c);
      vreg[i] = load16(vp + row * D + c);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_kernel(T* __restrict__ out, const T* __restrict__ q,
                        const T* __restrict__ kp, const T* __restrict__ vp,
                        const int* __restrict__ bt,
                        const int* __restrict__ valid_len, int H, int K,
                        int bs, int nb, float scale) {
  constexpr int KST = D + 4;       // padded K rows, as in flash_prefill.cu
  extern __shared__ __align__(16) float smem[];
  const int kh = blockIdx.x, b = blockIdx.y, rep = H / K;
  float* Qs = smem;                // rep x D, pre-scaled
  float* Ks = Qs + rep * D;        // TT x KST
  float* Vs = Ks + TT * KST;       // TT x D
  float* S = Vs + TT * D;          // rep x TT scores, then probabilities
  float* mrow = S + rep * TT;      // running max per query row
  float* lrow = mrow + rep;        // running sum
  float* crow = lrow + rep;        // this tile's correction factor

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vl = max(0, min(valid_len[b], nb * bs));
  const int* btb = bt + (int64_t)b * nb;
  // the rep query rows of kv head kh are contiguous in q and out
  const int64_t qoff = ((int64_t)b * H + (int64_t)kh * rep) * D;
  const int nout = rep * D;

  for (int e = tid; e < nout; e += NTHREADS)
    Qs[e] = to_float(q[qoff + e]) * scale;
  for (int r = tid; r < rep; r += NTHREADS) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  // K/V of the next tile travel in registers while this tile computes:
  // every thread issues all its 16-byte loads at once, then stages them
  constexpr int CPR = D / kVec<T>;                           // chunks a row
  constexpr int NCH = (TT * CPR + NTHREADS - 1) / NTHREADS;  // a thread
  uint4 kreg[NCH], vreg[NCH];
  if (vl > 0) load_tile<T, D, NCH>(kreg, vreg, kp, vp, btb, 0, vl, K, kh, bs);

  for (int t0 = 0; t0 < vl; t0 += TT) {
    __syncthreads();  // Q staged, previous tile consumed
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = tid + i * NTHREADS;
      if (e < TT * CPR) {
        const int j = e / CPR, c = (e % CPR) * kVec<T>;
        store_chunk<T>(Ks + j * KST + c, kreg[i]);
        store_chunk<T>(Vs + j * D + c, vreg[i]);
      }
    }
    __syncthreads();
    if (t0 + TT < vl)
      load_tile<T, D, NCH>(kreg, vreg, kp, vp, btb, t0 + TT, vl, K, kh, bs);

    for (int e = tid; e < rep * TT; e += NTHREADS) {
      const int r = e / TT, j = e % TT;
      const float4* qr = reinterpret_cast<const float4*>(Qs + r * D);
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * KST);
      float s = 0.f;
#pragma unroll 8
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 a = qr[c4], k4 = kr[c4];
        s = fmaf(a.x, k4.x, s);
        s = fmaf(a.y, k4.y, s);
        s = fmaf(a.z, k4.z, s);
        s = fmaf(a.w, k4.w, s);
      }
      S[e] = t0 + j < vl ? s : -INFINITY;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += NWARPS) {
      float* sr = S + r * TT;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = m_new > -INFINITY ? expf(x0 - m_new) : 0.f;
      const float p1 = m_new > -INFINITY ? expf(x1 - m_new) : 0.f;
      const float corr = m_old > -INFINITY ? expf(m_old - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = corr * lrow[r] + psum;
        crow[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int o = tid + i * NTHREADS;
      if (o < nout) {
        const int r = o / D, c = o % D;
        const float* pr = S + r * TT;
        float a = acc[i] * crow[r];
#pragma unroll 8
        for (int j = 0; j < TT; ++j) a = fmaf(pr[j], Vs[j * D + c], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // lrow is final

#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int o = tid + i * NTHREADS;
    if (o < nout) {
      const float lr = lrow[o / D];
      out[qoff + o] = from_float<T>(lr > 0.f ? acc[i] / lr : 0.f);
    }
  }
}

template <typename T, int D>
int launch(void* out, const void* q, const void* kp, const void* vp,
           const int* bt, const int* valid_len, int B, int H, int K, int bs,
           int nb, float scale, cudaStream_t stream) {
  const int rep = H / K;
  if (rep * D > NTHREADS * MAX_OUT) return MXTT_BAD_ARGUMENT;
  const size_t smem = smem_bytes<D>(rep);
  const int rc = allow_smem(paged_decode_kernel<T, D>, smem);
  if (rc) return rc;
  const dim3 grid(K, B);
  paged_decode_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (T*)out, (const T*)q, (const T*)kp, (const T*)vp, bt, valid_len, H, K,
      bs, nb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, void* out, const void* q, const void* kp,
                 const void* vp, const int* bt, const int* valid_len, int B,
                 int H, int K, int bs, int nb, float scale, cudaStream_t s) {
  switch (D) {
    case 16:   // llama_tiny
      return launch<T, 16>(out, q, kp, vp, bt, valid_len, B, H, K, bs, nb,
                           scale, s);
    case 128:  // Llama-3-8B
      return launch<T, 128>(out, q, kp, vp, bt, valid_len, B, H, K, bs, nb,
                            scale, s);
    default:
      return MXTT_BAD_ARGUMENT;
  }
}

}  // namespace

extern "C" int mxtt_paged_decode(void* out, const void* q, const void* k_pages,
                                 const void* v_pages, const int* block_tables,
                                 const int* valid_len, int B, int H, int K,
                                 int D, int bs, int nb, float scale, int dtype,
                                 void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || H % K || bs <= 0 || nb <= 0 || B > 65535)
    return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXTT_F32)
    return dispatch_dim<float>(D, out, q, k_pages, v_pages, block_tables,
                               valid_len, B, H, K, bs, nb, scale, s);
  if (dtype == MXTT_BF16)
    return dispatch_dim<__nv_bfloat16>(D, out, q, k_pages, v_pages,
                                       block_tables, valid_len, B, H, K, bs,
                                       nb, scale, s);
  return MXTT_BAD_ARGUMENT;
}
