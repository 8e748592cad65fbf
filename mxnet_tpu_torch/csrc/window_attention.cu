// W-position window attention straight off the paged KV pool, each window
// row with its own valid length: the attention core of the chunked
// prefill and of the speculative verify tick.
//
//   q (B, W, H, d), pages (N, K, bs, d) in q's dtype, block_tables (B, nb)
//   int32, valid_lens (B, W) int32, out (B, W, H, d) in q's dtype. Query
//   head h reads kv head h / (H/K). Window row w attends the pool's tokens
//   [0, valid_lens[b, w]) (clamped to nb * bs), so in-window causality
//   needs no mask; a row with no valid key gives 0.
//
// Replaces: mxnet_tpu/kernels/flash_decode.py,
// _flash_decode_paged_window_pallas (its pallas_call). On the TPU the W
// window positions fold into the rep axis: one (b, kv head) grid cell
// carries R = W * rep query rows through a block-by-block DMA sweep of the
// whole table, masking row w * rep + i at valid_lens[b, w]. Here the same
// fold, cut into tiles of 64 folded rows: a 256-token chunk at rep = 4 is
// 1024 rows per kv head, beyond what one block's registers hold, so the
// decode template (decode_attention.cu: rep * d <= 1024 outputs per block)
// does not stretch to it.
//
// Bound on the H100: at the chunk shape (B = 1, W = 256, H = 32, K = 8,
// d = 128, 256 earlier tokens) each kv head's 512 keys serve 1024 query
// rows, about 256 operations per byte moved: near the card's balance point
// of 295, so a tensor-core kernel would be bounded by both. At the verify
// shape (B = 8, W = 5, rep = 4) a kv head's keys serve 20 rows: bytes.
//
// Design: one block of 8 warps per (tile of 64 folded rows, kv head,
// batch row), flash_prefill.cu's layout with each warp owning 8 rows. The
// block walks the paged tokens below the tile's largest valid length in
// tiles of 32 keys, staged in shared memory as fp32; each thread loads its
// share of the next tile into registers (16-byte loads through the block's
// own table row) while the current tile computes, as the decode walk does.
// Each row keeps its own online softmax in registers and masks keys at its
// own valid length. Rows past R (the ragged last tile) load zeros and are
// not stored. Scores and products run on the fp32 SIMT units. At the
// chunk shape the grid is 16 x 8 = 128 blocks; a verify tick (R = 20)
// fills a third of its tiles. This kernel keeps float32, d = 16 and the
// GQA factors and block sizes that window_attention_sm90.cu (the
// tensor-core route of bf16 at d = 64 and 128) does not take.
#include "common.cuh"

namespace {

constexpr int BQ = 64;               // folded query rows per block
constexpr int BK = 32;               // keys per tile: lane j owns key j
constexpr int NWARPS = 8;
constexpr int RPW = BQ / NWARPS;     // query rows per warp
constexpr int NTHREADS = NWARPS * 32;

struct Args {
  void* out;
  const void* q;
  const void* k;
  const void* v;
  const int* bt;        // (B, nb) block tables
  const int* vl;        // (B, W) valid lengths
  int W, H, K, bs, nb;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 4) + BK * D + BQ * BK);
}

// Offset of folded row r = w * rep + i (window position w, query head
// kh * rep + i) in q and out, in elements.
__device__ __forceinline__ int64_t row_offset(const Args& a, int b, int kh,
                                              int rep, int r, int D) {
  return (((int64_t)b * a.W + r / rep) * a.H + (int64_t)kh * rep + r % rep) *
         D;
}

// Issue this thread's 16-byte loads of the K and V rows of keys
// [k0, k0 + BK); zeros at or past kend.
template <typename T, int D, int NCH>
__device__ __forceinline__ void load_tile(uint4 (&kreg)[NCH],
                                          uint4 (&vreg)[NCH],
                                          const T* __restrict__ kp,
                                          const T* __restrict__ vp,
                                          const PagedRows& rows, int k0,
                                          int kend) {
  constexpr int CPR = D / kVec<T>;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    const int j = e / CPR, c = (e % CPR) * kVec<T>, s = k0 + j;
    kreg[i] = vreg[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < BK * CPR && s < kend) {
      const int64_t row = rows(s);
      kreg[i] = load16(kp + row * D + c);
      vreg[i] = load16(vp + row * D + c);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    window_attention_kernel(const Args a) {
  // K rows are padded to D + 4 floats: the 16-byte reads of K[lane] by a
  // quarter warp then fall on distinct banks
  constexpr int KST = D + 4;
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // BQ x D, pre-scaled
  float* Ks = Qs + BQ * D;       // BK x KST
  float* Vs = Ks + BK * KST;     // BK x D
  float* Ps = Vs + BK * D;       // BQ x BK probabilities of the tile
  __shared__ int warp_kend[NWARPS];

  const int kh = blockIdx.y, b = blockIdx.z, rep = a.H / a.K;
  const int R = a.W * rep, r0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cap = a.nb * a.bs;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const PagedRows rows{a.bt + (int64_t)b * a.nb, a.K, kh, a.bs};
  const int* vlb = a.vl + (int64_t)b * a.W;

  // each row's attendable length; the tile walks to the largest
  int len[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = r0 + warp * RPW + rr;
    len[rr] = r < R ? max(0, min(vlb[r / rep], cap)) : 0;
  }
  int mine = 0;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) mine = max(mine, len[rr]);
  if (lane == 0) warp_kend[warp] = mine;

  constexpr int CPR = D / kVec<T>;                  // 16-byte chunks a row
  for (int e = tid; e < BQ * CPR; e += NTHREADS) {
    const int r = e / CPR, c = (e % CPR) * kVec<T>, row = r0 + r;
    float* dst = Qs + r * D + c;
    store_chunk<T>(dst, row < R ? load16(q + row_offset(a, b, kh, rep, row,
                                                         D) + c)
                                : make_uint4(0u, 0u, 0u, 0u));
#pragma unroll
    for (int i = 0; i < kVec<T>; ++i) dst[i] *= a.scale;
  }
  __syncthreads();  // warp_kend
  int kend = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) kend = max(kend, warp_kend[w]);
  const int ntiles = (kend + BK - 1) / BK;

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
  if (ntiles > 0) load_tile<T, D, NCH>(kreg, vreg, kp, vp, rows, 0, kend);

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is staged and the previous tile is consumed
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = tid + i * NTHREADS;
      if (e < BK * CPR) {
        const int j = e / CPR, c = (e % CPR) * kVec<T>;
        store_chunk<T>(Ks + j * KST + c, kreg[i]);
        store_chunk<T>(Vs + j * D + c, vreg[i]);
      }
    }
    __syncthreads();
    if (kt + 1 < ntiles)
      load_tile<T, D, NCH>(kreg, vreg, kp, vp, rows, k0 + BK, kend);

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
      const float x = s < len[rr] ? sc[rr] : -INFINITY;
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
        pv[rr] =
            reinterpret_cast<const float4*>(Ps + (warp * RPW + rr) * BK)[j4];
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
            float x = acc[rr][cc];
            x = fmaf(pv[rr].x, v0, x);
            x = fmaf(pv[rr].y, v1, x);
            x = fmaf(pv[rr].z, v2, x);
            x = fmaf(pv[rr].w, v3, x);
            acc[rr][cc] = x;
          }
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = r0 + warp * RPW + rr;
    if (r >= R) continue;
    T* orow = out + row_offset(a, b, kh, rep, r, D);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = lane + 32 * cc;
      if (col < D)
        orow[col] = from_float<T>(l[rr] > 0.f ? acc[rr][cc] / l[rr] : 0.f);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  const int rc = allow_smem(window_attention_kernel<T, D>, smem);
  if (rc) return rc;
  const int R = a.W * (a.H / a.K);
  const dim3 grid((R + BQ - 1) / BQ, a.K, B);
  window_attention_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, const Args& a, int B, cudaStream_t s) {
  switch (D) {
    case 16:   // llama_tiny
      return launch<T, 16>(a, B, s);
    case 128:  // Llama-3-8B
      return launch<T, 128>(a, B, s);
    default:
      return MXTT_BAD_ARGUMENT;
  }
}

}  // namespace

extern "C" int mxtt_paged_window(void* out, const void* q, const void* k_pages,
                                 const void* v_pages, const int* block_tables,
                                 const int* valid_lens, int B, int W, int H,
                                 int K, int D, int bs, int nb, float scale,
                                 int dtype, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (K <= 0 || H % K || bs <= 0 || nb <= 0 || B > 65535 || K > 65535)
    return MXTT_BAD_ARGUMENT;
  const Args a{out, q, k_pages, v_pages, block_tables, valid_lens,
               W,   H, K,       bs,      nb,           scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXTT_F32) return dispatch_dim<float>(D, a, B, s);
  if (dtype == MXTT_BF16) return dispatch_dim<__nv_bfloat16>(D, a, B, s);
  return MXTT_BAD_ARGUMENT;
}
