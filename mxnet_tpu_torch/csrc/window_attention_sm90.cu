// W-position window attention straight off the paged KV pool on Hopper's
// tensor cores, bf16 at d in {64, 128}: the route of the chunked prefill
// and of the speculative verify tick. It computes what mxtt_paged_window
// (window_attention.cu, which keeps fp32, d = 16 and the other shapes)
// computes:
//
//   q (B, W, H, d), pages (N, K, bs, d), block_tables (B, nb) int32,
//   valid_lens (B, W) int32, out (B, W, H, d), all bf16 but the int32s.
//   Query head h reads kv head h / (H/K). Window row w attends the pool's
//   tokens [0, valid_lens[b, w]) (clamped to nb * bs), so in-window
//   causality needs no mask; a row with no valid key gives 0.
//
// Replaces: mxnet_tpu/kernels/flash_decode.py,
// _flash_decode_paged_window_pallas (its pallas_call, :613). As there,
// the W window positions fold into the GQA rep axis: one (b, kv head)
// carries R = W * rep query rows, row (w, i) masked at valid_lens[b, w].
//
// Bound on the H100: at the chunk shape (B = 1, W = 256, H = 32, K = 8,
// d = 128, valid lengths 257-512) each kv head's 512 keys serve 1024
// folded rows: 1.6 GFLOP against 6.3 MB moved, 0.0016 ms at the bf16
// tensor-core peak against 0.0019 ms at the memory rate, near the card's
// balance; at the verify shape (B = 8, W = 5, rep = 4) 20 rows a kv head
// read up to 505 keys: bytes. Only wgmma gets near the first, so the
// products run there, and TMA stages the pages as bf16 (the SIMT kernel
// ran fp32 FMAs on K and V staged as fp32).
//
// Design: flash_bwd_dq_sm90.cu's skeleton with one consumer warpgroup.
// One block of 2 warpgroups per (64 folded rows, kv head, batch row):
// - warpgroup 0, the producer: its first thread loads the block's Q tile
//   once by TMA, then walks the key tiles of 64 from key 0 to the block's
//   longest row, loading each tile's K and V page by page (64/bs boxes of
//   bs rows, through the batch row's block table) into a 3-stage ring, K
//   and V on their own mbarriers so that S can start before V lands. It
//   gives its registers up (setmaxnreg) to
// - warpgroup 1, the consumer, 64 folded rows: rep query heads x (64/rep)
//   window positions, head-major, so the Q tile is rep TMA boxes of
//   (64/rep) positions of one head (a box of 8-64 rows of 128 bytes
//   starts on a 1024-byte boundary, as the swizzle wants). Per key tile:
//   S = Q K^T (wgmma, Q and K from shared memory), the online softmax in
//   registers (scale * log2(e) folded into one multiply of the fp32
//   scores, exp2f, a row's max and sum over its quad), P rounded to bf16
//   as the A operand of O += P V (wgmma, V the MN-major B straight from
//   its TMA tile). A tile is masked only where it reaches past one of the
//   thread's row lengths.
// The kernel is written for CONSUMERS consumer warpgroups of 64 rows
// each; a consumer whose rows all end before a tile skips its products
// and still releases it. One consumer a block (twice the blocks: 128 at
// the chunk shape) ran 12% faster than two at the chunk shape and level
// at the verify shape, timed in turns on the same inputs by
// tools/window_consumers.py (PERF.md).
// Pages past the last one that holds a key below the block's longest row
// are never read from the table: the tile's remaining page slots re-load
// that last page (finite data, masked), so no uninitialised shared memory
// meets a zero probability (0 * NaN). Window positions past W come back
// from TMA as zero rows and are never stored; a consumer with no position
// below W loads no Q. Each output row is written once, by its quad, so
// two launches agree bit for bit.
//
// Numbers that differ from the JAX kernel: it computes p @ vblk in fp32
// (flash_decode.py:590); here P is rounded to bf16 (against the running
// max, before its normalisation) for the tensor cores, as the tensor-core
// forward (flash_fwd_sm90.cu) rounds it. The row sum l adds the
// unrounded fp32 P.
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 1;             // consumer warpgroups a block
constexpr int BM = 64 * CONSUMERS;       // folded rows a block
constexpr int BN = 64;                   // keys a tile
constexpr int STAGES = 3;                // K/V tiles in flight
constexpr int NTHREADS = 128 * (1 + CONSUMERS);
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int PRODUCER_REGS = 24;        // a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 240;       // 128 x 24 + 256 x 240 <= 65,536
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {                    // every tile starts on 1024 bytes
  bf16 q[BM * D];                // D / 64 boxes of BM x 64
  bf16 k[STAGES][BN * D];        // D / 64 boxes of BN x 64
  bf16 v[STAGES][BN * D];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], kv_empty[STAGES];
  int warp_kend[CONSUMER_WARPS];  // each consumer warp's longest row
};

// the dynamic shared memory a launch asks for: the tiles, and slack to
// start them on a 1024-byte boundary
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    window_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     bf16* __restrict__ out, const int* __restrict__ bt,
                     const int* __restrict__ vl, int W, int H, int K,
                     int bs, int nb, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));

  const int kh = blockIdx.y, b = blockIdx.z;
  const int rep = H / K, P = 64 / rep;   // window positions a consumer
  const int wb = blockIdx.x * CONSUMERS * P;   // the block's first one
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lt = threadIdx.x % 128, lane = lt % 32;

  // A consumer thread's rows r0 and r0 + 8 of its 64 (accumulator layout,
  // sm90.cuh): query head kh * rep + r / P at window position
  // w0 + r % P, attending keys [0, len). Positions past W have no keys.
  const int r0 = 16 * (lt / 32) + lane / 4;
  const int w0 = wb + (wg - 1) * P;
  int len[2] = {0, 0};
  if (wg > 0) {
    const int cap = nb * bs;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int w = w0 + (r0 + 8 * i) % P;
      if (w < W) len[i] = max(0, min(vl[(int64_t)b * W + w], cap));
    }
    const int m = __reduce_max_sync(0xffffffffu, max(len[0], len[1]));
    if (lane == 0) sm.warp_kend[threadIdx.x / 32 - 4] = m;
  }
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.kv_empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // keys [0, kend) reach some row of the block
  int kend = 0;
#pragma unroll
  for (int w = 0; w < CONSUMER_WARPS; ++w) kend = max(kend, sm.warp_kend[w]);
  const int ntiles = (kend + BN - 1) / BN;

  if (wg == 0) {
    // -- producer -------------------------------------------------------
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && ntiles > 0) {
      int live = 0;                 // consumers with a position below W
      for (int c = 0; c < CONSUMERS; ++c) live += wb + c * P < W;
      sm90::mbar_arrive_expect_tx(&sm.q_full, live * 64 * D * 2);
      for (int c = 0; c < live; ++c)
        for (int i = 0; i < rep; ++i)
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc)
            sm90::tma_load_4d(sm.q + cc * BM * 64 + (c * 64 + i * P) * 64,
                              &map_q, &sm.q_full, 64 * cc, kh * rep + i,
                              wb + c * P, b);
      const int* btb = bt + (int64_t)b * nb;
      const int last = (kend + bs - 1) / bs - 1;   // last page read
      const int ppt = BN / bs;                     // pages a tile
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        // the consumers released this stage's previous tile
        sm90::mbar_wait(&sm.kv_empty[st], ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.k_full[st], BN * D * 2);
        sm90::mbar_arrive_expect_tx(&sm.v_full[st], BN * D * 2);
        for (int j = 0; j < ppt; ++j) {
          const int row = (btb[min(it * ppt + j, last)] * K + kh) * bs;
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc)
            sm90::tma_load_4d(sm.k[st] + (cc * BN + j * bs) * 64, &map_k,
                              &sm.k_full[st], 64 * cc, 0, row, 0);
        }
        for (int j = 0; j < ppt; ++j) {
          const int row = (btb[min(it * ppt + j, last)] * K + kh) * bs;
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc)
            sm90::tma_load_4d(sm.v[st] + (cc * BN + j * bs) * 64, &map_v,
                              &sm.v_full[st], 64 * cc, 0, row, 0);
        }
      }
    }
  } else {
    // -- consumers: 64 folded rows each -----------------------------------
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int tq = lane % 4;
    const bf16* q_rows = sm.q + (wg - 1) * 64 * 64;
    const float c2 = scale * LOG2E;
    // keys at or past ckend reach none of this consumer's rows; keys at or
    // past lmin are masked for one of this thread's rows
    int ckend = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      ckend = max(ckend, sm.warp_kend[4 * (wg - 1) + w]);
    const int lmin = min(len[0], len[1]);

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    if (ckend > 0) sm90::mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int k0 = it * BN, st = it % STAGES;
      const int phase = (it / STAGES) & 1;
      sm90::mbar_wait(&sm.k_full[st], phase);
      if (k0 >= ckend) {          // no key of the tile reaches our rows
        sm90::mbar_wait(&sm.v_full[st], phase);
      } else {
        float s[BN / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_ss<BN>(s, sm90::desc_kmajor(q_rows, BM, kk),
                             sm90::desc_kmajor(sm.k[st], BN, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);

        if (k0 + BN > lmin) {     // a key here is past one of our lengths
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            const int key = k0 + 8 * (e / 4) + 2 * tq + e % 2;
            if (key >= len[(e / 2) % 2]) s[e] = -INFINITY;
          }
        }

        float corr[2], base[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = m[i];
#pragma unroll
          for (int e = 2 * i; e < BN / 2; e += 4)
            mx = fmaxf(mx, fmaxf(s[e], s[e + 1]));
          mx = sm90::quad_max(mx);
          // a row that has seen no valid key keeps m = -inf: its
          // probabilities are 0, never exp(nan). An unchanged max
          // rescales by exactly 1 (exp2f of an fma's residue need not
          // be), so a tile that holds none of a row's keys leaves the row
          // bit for bit as it was, whichever other rows share its block.
          base[i] = mx == -INFINITY ? 0.f : mx * c2;
          corr[i] = mx == m[i] ? 1.f : exp2f(m[i] * c2 - base[i]);
          m[i] = mx;
          l[i] *= corr[i];
        }
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int i = (e / 2) % 2;
          const float p = exp2f(fmaf(s[e], c2, -base[i]));
          s[e] = p;
          l[i] += p;
        }
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e / 2) % 2];

        uint32_t pa[BN / 16][4];
        sm90::to_a_frags<BN>(s, pa);
        sm90::mbar_wait(&sm.v_full[st], phase);
        sm90::fence_regs(o);
        sm90::fence_regs(pa);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          sm90::wgmma_rs<D>(o, pa[kk], sm90::desc_mnmajor(sm.v[st], BN, kk));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::fence_regs(pa);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.kv_empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, w = w0 + r % P;
      const float li = sm90::quad_sum(l[i]);
      if (w >= W) continue;
      bf16* orow = out + (((int64_t)b * W + w) * H + kh * rep + r / P) * D
                   + 2 * tq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float* oc = o + 4 * c + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            li > 0.f ? __floats2bfloat162_rn(oc[0] / li, oc[1] / li)
                     : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  }
}

template <int D>
int launch(void* out, const void* q, const void* k_pages,
           const void* v_pages, const int* block_tables,
           const int* valid_lens, int B, int W, int H, int K, int bs, int nb,
           int N, float scale, cudaStream_t stream) {
  const int rep = H / K;
  // the pool as one column of N * K * bs rows of D: a page of kv head kh
  // is a box of bs rows at row (block id * K + kh) * bs
  CUtensorMap mq, mk, mv;
  int rc = sm90_host::make_map(&mq, q, B, W, H, D, 64 / rep);
  if (!rc) rc = sm90_host::make_map(&mk, k_pages, 1, N * K * bs, 1, D, bs);
  if (!rc) rc = sm90_host::make_map(&mv, v_pages, 1, N * K * bs, 1, D, bs);
  const size_t smem = smem_bytes<D>();
  if (!rc) rc = allow_smem(window_tc_kernel<D>, smem);
  if (rc) return rc;
  const dim3 grid((W * rep + BM - 1) / BM, K, B);
  window_tc_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, (bf16*)out, block_tables, valid_lens, W, H, K, bs, nb,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The operands as mxtt_paged_window's, plus N, the pool's block count
// (the extent of the TMA maps over the pool). dtype must be bf16, D 64
// or 128, H / K in {1, 2, 4, 8}, bs in {8, 16, 32, 64}, N * K * bs below
// 2^31 and every tensor on a 16-byte boundary.
extern "C" int mxtt_paged_window_tc(void* out, const void* q,
                                    const void* k_pages, const void* v_pages,
                                    const int* block_tables,
                                    const int* valid_lens, int B, int W,
                                    int H, int K, int D, int bs, int nb,
                                    int N, float scale, int dtype,
                                    void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (K <= 0 || H % K || B > 65535 || K > 65535 || nb <= 0 || N <= 0 ||
      dtype != MXTT_BF16)
    return MXTT_BAD_ARGUMENT;
  const int rep = H / K;
  if ((rep != 1 && rep != 2 && rep != 4 && rep != 8) ||
      (bs != 8 && bs != 16 && bs != 32 && bs != 64) ||
      (int64_t)N * K * bs >= (1ll << 31) ||
      !aligned16({out, q, k_pages, v_pages}))
    return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>(out, q, k_pages, v_pages, block_tables, valid_lens, B,
                      W, H, K, bs, nb, N, scale, s);
  if (D == 128)   // Llama-3-8B
    return launch<128>(out, q, k_pages, v_pages, block_tables, valid_lens,
                       B, W, H, K, bs, nb, N, scale, s);
  return MXTT_BAD_ARGUMENT;
}

// What a launch at head dim D takes: out[0] bytes of dynamic shared
// memory, out[1] and out[2] registers a producer and a consumer thread
// (setmaxnreg). Returns MXTT_BAD_ARGUMENT for a D without a kernel.
extern "C" int mxtt_paged_window_tc_info(int D, int* out) {
  if (D != 64 && D != 128) return MXTT_BAD_ARGUMENT;
  out[0] = (int)(D == 64 ? smem_bytes<64>() : smem_bytes<128>());
  out[1] = PRODUCER_REGS;
  out[2] = CONSUMER_REGS;
  return 0;
}
