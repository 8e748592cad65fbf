// Single-position GQA decode attention with an online softmax over the
// valid prefix, for the four KV caches of the port:
//
//   C symbol               cache, and the TPU kernel it replaces
//                          (mxnet_tpu/kernels/flash_decode.py)
//   mxtt_contig_decode     (B, K, S, d) in q's dtype:
//                          _flash_decode_pallas
//   mxtt_contig_decode_q8  (B, K, S, d) int8 + (B, K, S, 1) fp32 scales:
//                          _flash_decode_pallas_q8
//   mxtt_paged_decode      (N, K, bs, d) pages + block table:
//                          _flash_decode_paged_pallas
//   mxtt_paged_decode_q8   int8 pages + (N, K, bs, 1) scales + table:
//                          _flash_decode_paged_pallas_q8
//
// q (B, H, d) for one decode position, valid_len (B,) int32, out
// (B, H, d) in q's dtype; query head h reads kv head h // (H/K). On the
// TPU each is its own pallas_call: the contiguous kernels hold one kv
// head's whole cache in VMEM and sweep it with a fori_loop, the paged
// ones ride the block table in scalar-prefetch memory and DMA one page
// per grid cell. Here the four share one walk, a template over two
// policies: where token t's row lives (contiguous: (b*K + kh)*S + t;
// paged: (bt[b, t/bs]*K + kh)*bs + t%bs, each block reading its own
// table row) and how it is stored (q's dtype, or int8 codes with one
// fp32 scale per token). No TPU gate carries over: any S, valid_len
// clamped to the cache, only tiles below valid_len are read (table
// entries past it point at the scratch block 0 and are never touched).
//
// Bound on the H100: bytes. Every valid cached token's K and V rows
// (plus two fp32 scales for int8) are read once per kv head for
// rep = H/K query rows, 4 * rep * d operations against 4 * d bytes in
// bf16 (2 * d + 8 in int8): about rep operations per byte (2 * rep for
// int8), far below the card's 295.
//
// Design: one block per (kv head, batch row) walks the tokens below
// valid_len in tiles of 64, staging K and V in shared memory as fp32.
// With one block per SM there are no other warps to hide memory latency
// behind, so each thread issues all its 16-byte loads of the NEXT tile
// (and, for int8, one token's k or v scale) into registers before
// computing the current one: one memory round trip per tile, overlapped
// with the math. The rep query rows of the kv head share every tile, so
// the cache is read once per kv head, not once per query head. For int8
// the scales fold in as flash_decode.py:729-740 does: the k scale
// multiplies the score after the dot, s = (q . k8) * ks, and the v
// scale multiplies p before P.V, acc += (p * vs) * v8, while the running
// sum l adds the unscaled p. With B * K = 64 blocks at the Llama-3-8B
// shape the 132 SMs are not filled: splitting the token walk across
// blocks (split-K) is later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TT = 64;            // tokens per tile (two per lane in softmax)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_OUT = 8;        // outputs a thread owns: rep * D <= 1024
static_assert(NTHREADS == 2 * TT, "each thread stages one k or v scale");

struct Args {
  void* out;
  const void* q;
  const void* k;
  const void* v;
  const float* ks;      // per-token scales (int8 caches), else null
  const float* vs;
  const int* bt;        // (B, nb) block tables (paged), else null
  const int* valid_len;
  int H, K;
  int S;                // contiguous: cache length; paged: block size
  int nb;               // paged: table width; contiguous: 1
  float scale;
};

// Where token t's row of (batch row b, kv head kh) lives, in rows of d.
struct ContigRows {
  int64_t base;
  static __device__ ContigRows make(const Args& a, int b, int kh) {
    return {((int64_t)b * a.K + kh) * a.S};
  }
  __device__ int cap(const Args& a) const { return a.S; }
  __device__ int64_t operator()(int t) const { return base + t; }
};

struct PagedRows {
  const int* btb;
  int K, kh, bs;
  static __device__ PagedRows make(const Args& a, int b, int kh) {
    return {a.bt + (int64_t)b * a.nb, a.K, kh, a.S};
  }
  __device__ int cap(const Args& a) const { return a.nb * a.S; }
  __device__ int64_t operator()(int t) const {
    return ((int64_t)btb[t / bs] * K + kh) * bs + t % bs;
  }
};

template <int D, bool Q8>
size_t smem_bytes(int rep) {
  return sizeof(float) * (rep * D + TT * (D + 4) + TT * D + rep * TT +
                          3 * rep + (Q8 ? 2 * TT : 0));
}

// Issue this thread's 16-byte loads of the K and V rows of tokens
// [t0, t0 + TT) and, for int8, the k (threads < TT) or v scale of one
// token; zeros past vl.
template <typename C, int D, int NCH, bool Q8, typename Rows>
__device__ __forceinline__ void load_tile(uint4 (&kreg)[NCH],
                                          uint4 (&vreg)[NCH], float& sreg,
                                          const C* __restrict__ kp,
                                          const C* __restrict__ vp,
                                          const float* __restrict__ ks,
                                          const float* __restrict__ vs,
                                          const Rows& rows, int t0, int vl) {
  constexpr int CPR = D / kVec<C>;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    const int j = e / CPR, c = (e % CPR) * kVec<C>, pos = t0 + j;
    kreg[i] = vreg[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < TT * CPR && pos < vl) {
      const int64_t row = rows(pos);
      kreg[i] = load16(kp + row * D + c);
      vreg[i] = load16(vp + row * D + c);
    }
  }
  if constexpr (Q8) {
    const int pos = t0 + (int)threadIdx.x % TT;
    sreg = pos < vl ? (threadIdx.x < TT ? ks : vs)[rows(pos)] : 0.f;
  }
}

template <typename T, typename C, typename Rows, int D>
__global__ void __launch_bounds__(NTHREADS)
    decode_attention_kernel(const Args a) {
  constexpr bool Q8 = std::is_same<C, int8_t>::value;
  constexpr int KST = D + 4;       // padded K rows, as in flash_prefill.cu
  extern __shared__ __align__(16) float smem[];
  const int kh = blockIdx.x, b = blockIdx.y, rep = a.H / a.K;
  float* Qs = smem;                // rep x D, pre-scaled
  float* Ks = Qs + rep * D;        // TT x KST
  float* Vs = Ks + TT * KST;       // TT x D
  float* S = Vs + TT * D;          // rep x TT scores, then probabilities
  float* mrow = S + rep * TT;      // running max per query row
  float* lrow = mrow + rep;        // running sum
  float* crow = lrow + rep;        // this tile's correction factor
  float* kss = crow + rep;         // this tile's k scales (int8)
  float* vss = kss + TT;           // and v scales

  const T* q = static_cast<const T*>(a.q);
  const C* kp = static_cast<const C*>(a.k);
  const C* vp = static_cast<const C*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Rows rows = Rows::make(a, b, kh);
  const int vl = max(0, min(a.valid_len[b], rows.cap(a)));
  // the rep query rows of kv head kh are contiguous in q and out
  const int64_t qoff = ((int64_t)b * a.H + (int64_t)kh * rep) * D;
  const int nout = rep * D;

  for (int e = tid; e < nout; e += NTHREADS)
    Qs[e] = to_float(q[qoff + e]) * a.scale;
  for (int r = tid; r < rep; r += NTHREADS) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  // K/V of the next tile travel in registers while this tile computes:
  // every thread issues all its 16-byte loads at once, then stages them
  constexpr int CPR = D / kVec<C>;                           // chunks a row
  constexpr int NCH = (TT * CPR + NTHREADS - 1) / NTHREADS;  // a thread
  uint4 kreg[NCH], vreg[NCH];
  float sreg = 0.f;
  if (vl > 0)
    load_tile<C, D, NCH, Q8>(kreg, vreg, sreg, kp, vp, a.ks, a.vs, rows, 0,
                             vl);

  for (int t0 = 0; t0 < vl; t0 += TT) {
    __syncthreads();  // Q staged, previous tile consumed
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = tid + i * NTHREADS;
      if (e < TT * CPR) {
        const int j = e / CPR, c = (e % CPR) * kVec<C>;
        store_chunk<C>(Ks + j * KST + c, kreg[i]);
        store_chunk<C>(Vs + j * D + c, vreg[i]);
      }
    }
    if constexpr (Q8) (tid < TT ? kss : vss)[tid % TT] = sreg;
    __syncthreads();
    if (t0 + TT < vl)
      load_tile<C, D, NCH, Q8>(kreg, vreg, sreg, kp, vp, a.ks, a.vs, rows,
                               t0 + TT, vl);

    for (int e = tid; e < rep * TT; e += NTHREADS) {
      const int r = e / TT, j = e % TT;
      const float4* qr = reinterpret_cast<const float4*>(Qs + r * D);
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * KST);
      float s = 0.f;
#pragma unroll 8
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 x = qr[c4], k4 = kr[c4];
        s = fmaf(x.x, k4.x, s);
        s = fmaf(x.y, k4.y, s);
        s = fmaf(x.z, k4.z, s);
        s = fmaf(x.w, k4.w, s);
      }
      if constexpr (Q8) s *= kss[j];       // s = (q . k8) * ks
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
      const float psum = warp_sum(p0 + p1);  // l adds the unscaled p
      if constexpr (Q8) {                    // P.V takes p * vs
        sr[lane] = p0 * vss[lane];
        sr[lane + 32] = p1 * vss[lane + 32];
      } else {
        sr[lane] = p0;
        sr[lane + 32] = p1;
      }
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
        float x = acc[i] * crow[r];
#pragma unroll 8
        for (int j = 0; j < TT; ++j) x = fmaf(pr[j], Vs[j * D + c], x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();  // lrow is final

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int o = tid + i * NTHREADS;
    if (o < nout) {
      const float lr = lrow[o / D];
      out[qoff + o] = from_float<T>(lr > 0.f ? acc[i] / lr : 0.f);
    }
  }
}

template <typename T, typename C, typename Rows, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int rep = a.H / a.K;
  if (rep * D > NTHREADS * MAX_OUT) return MXTT_BAD_ARGUMENT;
  const size_t smem = smem_bytes<D, std::is_same<C, int8_t>::value>(rep);
  const int rc = allow_smem(decode_attention_kernel<T, C, Rows, D>, smem);
  if (rc) return rc;
  decode_attention_kernel<T, C, Rows, D>
      <<<dim3(a.K, B), NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename C, typename Rows>
int dispatch_dim(int D, const Args& a, int B, cudaStream_t s) {
  switch (D) {
    case 16:   // llama_tiny
      return launch<T, C, Rows, 16>(a, B, s);
    case 128:  // Llama-3-8B
      return launch<T, C, Rows, 128>(a, B, s);
    default:
      return MXTT_BAD_ARGUMENT;
  }
}

// q's dtype picks T; the cache holds T, or int8 codes when Q8.
template <bool Q8, typename Rows>
int dispatch(int dtype, int D, const Args& a, int B, void* stream) {
  if (B <= 0) return 0;
  if (a.K <= 0 || a.H % a.K || a.S <= 0 || a.nb <= 0 || B > 65535)
    return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXTT_F32)
    return dispatch_dim<float, std::conditional_t<Q8, int8_t, float>, Rows>(
        D, a, B, s);
  if (dtype == MXTT_BF16)
    return dispatch_dim<__nv_bfloat16,
                        std::conditional_t<Q8, int8_t, __nv_bfloat16>, Rows>(
        D, a, B, s);
  return MXTT_BAD_ARGUMENT;
}

}  // namespace

extern "C" int mxtt_contig_decode(void* out, const void* q, const void* k,
                                  const void* v, const int* valid_len, int B,
                                  int H, int K, int D, int S, float scale,
                                  int dtype, void* stream) {
  const Args a{out, q, k, v, nullptr, nullptr, nullptr, valid_len,
               H,   K, S, 1, scale};
  return dispatch<false, ContigRows>(dtype, D, a, B, stream);
}

extern "C" int mxtt_contig_decode_q8(void* out, const void* q, const void* k8,
                                     const float* ks, const void* v8,
                                     const float* vs, const int* valid_len,
                                     int B, int H, int K, int D, int S,
                                     float scale, int dtype, void* stream) {
  const Args a{out, q, k8, v8, ks, vs, nullptr, valid_len, H, K, S, 1, scale};
  return dispatch<true, ContigRows>(dtype, D, a, B, stream);
}

extern "C" int mxtt_paged_decode(void* out, const void* q, const void* k_pages,
                                 const void* v_pages, const int* block_tables,
                                 const int* valid_len, int B, int H, int K,
                                 int D, int bs, int nb, float scale, int dtype,
                                 void* stream) {
  const Args a{out, q,       k_pages,   v_pages, nullptr, nullptr,
               block_tables, valid_len, H,       K,       bs,      nb,
               scale};
  return dispatch<false, PagedRows>(dtype, D, a, B, stream);
}

extern "C" int mxtt_paged_decode_q8(void* out, const void* q,
                                    const void* k8_pages,
                                    const float* ks_pages,
                                    const void* v8_pages,
                                    const float* vs_pages,
                                    const int* block_tables,
                                    const int* valid_len, int B, int H, int K,
                                    int D, int bs, int nb, float scale,
                                    int dtype, void* stream) {
  const Args a{out,      q,            k8_pages,  v8_pages, ks_pages,
               vs_pages, block_tables, valid_len, H,        K,
               bs,       nb,           scale};
  return dispatch<true, PagedRows>(dtype, D, a, B, stream);
}
