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
// int8), far below the card's 295. Tensor cores would not help: at
// about rep operations per byte the work is loads and their latency,
// and the lever is how many blocks have their loads in flight at once.
//
// The walk: tokens in tiles of 64, K and V staged in shared memory as
// fp32. Each thread issues all its 16-byte loads of the NEXT tile (and,
// for int8, one token's k or v scale) into registers before computing
// the current one: one memory round trip per tile, overlapped with the
// math. The rep query rows of the kv head share every tile, so the
// cache is read once per kv head, not once per query head. For int8
// the scales fold in as flash_decode.py:729-740 does: the k scale
// multiplies the score after the dot, s = (q . k8) * ks, and the v
// scale multiplies p before P.V, acc += (p * vs) * v8, while the running
// sum l adds the unscaled p.
//
// Contiguous caches split the walk across blocks (split-K): one block
// per (token range of SPLIT, kv head, batch row) walks its range and
// writes its unnormalised partial softmax (acc, running max m, sum l,
// fp32) to a workspace the wrapper allocates from S alone; a second,
// small kernel, one thread an output, merges the partials of the ranges
// below valid_len in ascending order, out = sum_s w_s acc_s / sum_s w_s
// l_s with w_s = exp(m_s - max m). At generate()'s Llama-3-8B shape
// (B * K = 64, S = 544) one block per (kv head, batch row) left half of
// the 132 SMs idle and walked up to 9 tiles in series; the split puts
// about 350 blocks of one tile each in flight. Paged caches keep the
// single pass, one block per (kv head, batch row) walking every tile
// below valid_len. Both are one kernel template, decode_attention_kernel,
// whose Split parameter picks the token range and what it writes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TT = 64;            // tokens per tile (two per lane in softmax)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_OUT = 8;        // outputs a thread owns: rep * D <= 1024
static_assert(NTHREADS == 2 * TT, "each thread stages one k or v scale");
// tokens a block of the contiguous caches' split walk owns: whole tiles
// (64 measured against 128 and 256 by tools/decode_split.py)
constexpr int SPLIT = 64;
static_assert(SPLIT % TT == 0, "a split is whole tiles");

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
  float* ws;            // split walk: (B, K, ns, rep, D + 2) partials
};

// Where token t's row of (batch row b, kv head kh) lives, in rows of d:
// ContigRows here, PagedRows (common.cuh) through the block table.
struct ContigRows {
  int64_t base;
  __device__ int64_t operator()(int t) const { return base + t; }
};

// The address policy of (batch row b, kv head kh), and the most tokens it
// holds.
template <typename Rows>
__device__ Rows rows_of(const Args& a, int b, int kh);

template <>
__device__ ContigRows rows_of<ContigRows>(const Args& a, int b, int kh) {
  return {((int64_t)b * a.K + kh) * a.S};
}

template <>
__device__ PagedRows rows_of<PagedRows>(const Args& a, int b, int kh) {
  return {a.bt + (int64_t)b * a.nb, a.K, kh, a.S};
}

__device__ int capacity(const ContigRows&, const Args& a) { return a.S; }
__device__ int capacity(const PagedRows&, const Args& a) {
  return a.nb * a.S;
}

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

// One walk, two epilogues. Split false (the paged caches' single pass):
// block (kh, b) walks every token below valid_len and writes out = acc /
// l in q's dtype, zeros where l = 0. Split true (pass 1 of the
// contiguous caches' split walk): block (split, kh, b) walks tokens
// [split * SPLIT, min((split + 1) * SPLIT, vl)) and writes its
// unnormalised partial state to the workspace rows
// ((b * K + kh) * ns + split) * rep + r of D + 2 floats: acc (D), the
// running max m, the running sum l; a block whose range starts at or
// past vl writes nothing. One kernel body rather than a shared device
// function: the function's boundary cost the paged int8 kernel its
// uniform-register address arithmetic and read-only loads, and time.
template <typename T, typename C, typename Rows, int D, bool Split>
__global__ void __launch_bounds__(NTHREADS)
    decode_attention_kernel(const Args a, int ns) {
  constexpr bool Q8 = std::is_same<C, int8_t>::value;
  constexpr int KST = D + 4;       // padded K rows, as in flash_prefill.cu
  extern __shared__ __align__(16) float smem[];
  const int kh = Split ? blockIdx.y : blockIdx.x;
  const int b = Split ? blockIdx.z : blockIdx.y;
  const int rep = a.H / a.K;
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
  const Rows rows = rows_of<Rows>(a, b, kh);
  const int vl = max(0, min(a.valid_len[b], capacity(rows, a)));
  const int lo = Split ? blockIdx.x * SPLIT : 0;
  if (Split && lo >= vl) return;  // uniform: no barrier half-reached
  const int hi = Split ? min(lo + SPLIT, vl) : vl;
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
  if (lo < hi)
    load_tile<C, D, NCH, Q8>(kreg, vreg, sreg, kp, vp, a.ks, a.vs, rows, lo,
                             hi);

  for (int t0 = lo; t0 < hi; t0 += TT) {
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
    if (t0 + TT < hi)
      load_tile<C, D, NCH, Q8>(kreg, vreg, sreg, kp, vp, a.ks, a.vs, rows,
                               t0 + TT, hi);

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
      S[e] = t0 + j < hi ? s : -INFINITY;
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
  __syncthreads();  // mrow and lrow are final

  if constexpr (Split) {
    float* part =
        a.ws + (((int64_t)b * a.K + kh) * ns + blockIdx.x) * rep * (D + 2);
#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int o = tid + i * NTHREADS;
      if (o < nout) part[(o / D) * (D + 2) + o % D] = acc[i];
    }
    for (int r = tid; r < rep; r += NTHREADS) {
      part[r * (D + 2) + D] = mrow[r];
      part[r * (D + 2) + D + 1] = lrow[r];
    }
  } else {
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
}

// Pass 2: block (o-chunk, kh, b) merges, for NTHREADS of the rep * D
// outputs of kv head kh, batch row b (one a thread), the partials of the
// splits below ceil(vl / SPLIT) in ascending order: M = max_s m_s,
// w_s = exp(m_s - M), out = sum_s w_s acc_s / sum_s w_s l_s in q's dtype.
// The partials are read MERGE_CHUNK splits at a time, every load of a
// chunk issued before any is used: one round trip a chunk for M, one for
// the sums. Each element has one writer and a fixed order, so two
// launches agree bit for bit. A row with vl = 0 has no split and writes
// zeros (JAX's safe_l); a partial with m = -inf (none can be below
// ceil(vl / SPLIT)) weighs 0, not NaN.
constexpr int MERGE_CHUNK = 16;

template <typename T, typename Rows, int D>
__global__ void __launch_bounds__(NTHREADS)
    decode_merge_kernel(const Args a, int ns) {
  const int kh = blockIdx.y, b = blockIdx.z, rep = a.H / a.K;
  const int o = blockIdx.x * NTHREADS + threadIdx.x;
  if (o >= rep * D) return;
  const int vl = max(0, min(a.valid_len[b],
                            capacity(rows_of<Rows>(a, b, kh), a)));
  const int nsplit = (vl + SPLIT - 1) / SPLIT;
  const int64_t stride = (int64_t)rep * (D + 2);   // one split's rows
  // this output's row of split 0; its split s lies s * stride further
  const float* row = a.ws + ((int64_t)b * a.K + kh) * ns * stride +
                     (o / D) * (D + 2);
  float M = -INFINITY;
  for (int s0 = 0; s0 < nsplit; s0 += MERGE_CHUNK) {
    float mv[MERGE_CHUNK];
#pragma unroll
    for (int j = 0; j < MERGE_CHUNK; ++j)
      mv[j] = s0 + j < nsplit ? row[(s0 + j) * stride + D] : -INFINITY;
#pragma unroll
    for (int j = 0; j < MERGE_CHUNK; ++j) M = fmaxf(M, mv[j]);
  }
  float num = 0.f, den = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += MERGE_CHUNK) {
    float mv[MERGE_CHUNK], lv[MERGE_CHUNK], av[MERGE_CHUNK];
#pragma unroll
    for (int j = 0; j < MERGE_CHUNK; ++j) {
      mv[j] = -INFINITY;
      lv[j] = av[j] = 0.f;
      if (s0 + j < nsplit) {
        const float* p = row + (s0 + j) * stride;
        mv[j] = p[D];
        lv[j] = p[D + 1];
        av[j] = p[o % D];
      }
    }
#pragma unroll
    for (int j = 0; j < MERGE_CHUNK; ++j) {
      const float w = mv[j] > -INFINITY ? expf(mv[j] - M) : 0.f;
      num = fmaf(w, av[j], num);
      den = fmaf(w, lv[j], den);
    }
  }
  const int64_t qoff = ((int64_t)b * a.H + (int64_t)kh * rep) * D;
  static_cast<T*>(a.out)[qoff + o] =
      from_float<T>(den > 0.f ? num / den : 0.f);
}

// The split walk's two launches on one stream; ns = ceil(capacity /
// SPLIT) partials a (kv head, batch row), as the wrapper sized a.ws.
template <typename T, typename C, typename Rows, int D>
int launch_split(const Args& a, int B, size_t smem, cudaStream_t stream) {
  const int64_t ns = ((int64_t)a.nb * a.S + SPLIT - 1) / SPLIT;
  if (a.ws == nullptr || a.K > 65535 || ns > INT32_MAX)
    return MXTT_BAD_ARGUMENT;
  int rc = allow_smem(decode_attention_kernel<T, C, Rows, D, true>, smem);
  if (rc) return rc;
  decode_attention_kernel<T, C, Rows, D, true>
      <<<dim3((unsigned)ns, a.K, B), NTHREADS, smem, stream>>>(a, (int)ns);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int nblk = (a.H / a.K * D + NTHREADS - 1) / NTHREADS;
  decode_merge_kernel<T, Rows, D>
      <<<dim3(nblk, a.K, B), NTHREADS, 0, stream>>>(a, (int)ns);
  return (int)cudaGetLastError();
}

template <typename T, typename C, typename Rows, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int rep = a.H / a.K;
  if (rep * D > NTHREADS * MAX_OUT) return MXTT_BAD_ARGUMENT;
  const size_t smem = smem_bytes<D, std::is_same<C, int8_t>::value>(rep);
  if constexpr (std::is_same<Rows, ContigRows>::value) {
    return launch_split<T, C, Rows, D>(a, B, smem, stream);
  } else {
    const int rc =
        allow_smem(decode_attention_kernel<T, C, Rows, D, false>, smem);
    if (rc) return rc;
    decode_attention_kernel<T, C, Rows, D, false>
        <<<dim3(a.K, B), NTHREADS, smem, stream>>>(a, 1);
    return (int)cudaGetLastError();
  }
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
                                  const void* v, const int* valid_len,
                                  float* ws, int B, int H, int K, int D, int S,
                                  float scale, int dtype, void* stream) {
  const Args a{out, q, k, v, nullptr, nullptr, nullptr, valid_len,
               H,   K, S, 1, scale,   ws};
  return dispatch<false, ContigRows>(dtype, D, a, B, stream);
}

extern "C" int mxtt_contig_decode_q8(void* out, const void* q, const void* k8,
                                     const float* ks, const void* v8,
                                     const float* vs, const int* valid_len,
                                     float* ws, int B, int H, int K, int D,
                                     int S, float scale, int dtype,
                                     void* stream) {
  const Args a{out, q, k8, v8, ks, vs, nullptr, valid_len, H, K, S, 1, scale,
               ws};
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
