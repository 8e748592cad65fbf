// dK and dV of causal or full, key-length-masked GQA attention on
// Hopper's tensor cores, bf16 at d in {64, 128}: the route of the
// training step and BERT's backward. It computes what mxtt_flash_bwd_dkv
// (flash_backward.cu, which keeps fp32 and d = 16) computes:
//
//   dV = sum_t P^T dO,  dK = scale * sum_t dS^T Q
//
// with P = exp(scale * Q K^T - lse) (0 where masked) and
// dS = P * (dO V^T - delta), from the forward's lse and delta =
// rowsum(dO * O) (B, H, T) fp32. q, dO (B, T, H, d); k, v (B, T, K, d);
// dk, dv (B, T, K, d) bf16; lengths (B,) int32. Key s is seen by query t
// when s < lengths[b] and, if causal, s <= t. The sweep runs from the
// diagonal to T, not cut at lengths: query rows past lengths[b] still
// attend valid keys, so their cotangents reach dK and dV. Each kv head's
// rep = H/K query heads are summed in fp32 inside the block, with no
// atomics: every output row has one writer, so the result is the same
// bit for bit from run to run.
//
// Replaces: mxnet_tpu/kernels/flash_attention.py, _pallas_backward's
// dkv_kernel (its second pallas_call, :341). The TPU kernel writes dK and
// dV per query head in q's dtype and sums each group outside.
//
// Bound on the H100: operations. Per (query, key) pair 8 d flops (S, dP,
// P^T dO, dS^T Q): 137.5 GFLOP at the Llama training shape (B=2, T=2048,
// H=32, K=8, d=128, causal), 0.139 ms at the bf16 tensor-core peak,
// against 84 MB moved. All four products run on wgmma.
//
// Design: one block of 3 warpgroups per 128 keys of one kv head and
// batch row; key tile 0, whose causal walk is the longest, launches
// first (blockIdx.z is the key tile), so the last wave holds short walks.
// - warpgroup 0, the producer: its first thread loads the block's K and
//   V tiles once by TMA (bf16, 128-byte swizzle, sm90.cuh); then, for
//   each of the rep query heads and each 64-row query tile from the
//   diagonal to T, its first warp fills a 2-stage ring: the Q and dO
//   tiles by TMA and the rows' lse * log2(e) and delta by plain loads,
//   all completing on the stage's mbarrier. It gives its registers up
//   (setmaxnreg) to
// - warpgroups 1 and 2, the consumers, 64 keys each, which keep their
//   dK and dV rows in fp32 registers for the whole walk and per tile
//   run four wgmma products:
//     S^T  = K Q^T      A: K from shared memory   B: Q (K-major)
//     dP^T = V dO^T     A: V from shared memory   B: dO (K-major)
//     dV  += P^T dO     A: P^T, bf16 registers    B: dO (MN-major)
//     dK  += dS^T Q     A: dS^T, bf16 registers   B: Q (MN-major)
//   with P^T = exp2(S^T scale log2(e) - lse log2(e)), masked only on the
//   tiles that hold the diagonal or lengths[b], and dS^T = P^T (dP^T -
//   delta). Neither P nor dS passes through shared memory. A consumer
//   skips a tile whose queries all precede its keys.
//
// Numbers that differ from the JAX kernel: it computes P^T dO and
// dS^T Q in fp32 (flash_attention.py:288, :291); here P and dS are
// rounded to bf16 for the tensor cores (the port's plain forward and the
// jnp reference, flash_attention.py:61, round P the same way), and the
// group sum is taken in fp32 before the one rounding of each output row.
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BKV = 128;         // keys a block: 2 consumers x 64
constexpr int BQ = 64;           // query rows a stage
constexpr int STAGES = 2;        // query tiles in flight
constexpr int NTHREADS = 384;    // producer warpgroup + 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24;   // a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {                    // every tile starts on 1024 bytes
  bf16 k[BKV * D];               // D / 64 boxes of BKV x 64
  bf16 v[BKV * D];
  bf16 q[STAGES][BQ * D];        // D / 64 boxes of BQ x 64
  bf16 dout[STAGES][BQ * D];
  float lse2[STAGES][BQ];        // lse * log2(e); +inf past T
  float delta[STAGES][BQ];       // 0 past T
  uint64_t kv_full, full[STAGES], empty[STAGES];
};

// the dynamic shared memory a launch asks for: the tiles, and slack to
// start them on a 1024-byte boundary
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ lengths, int seq, int H,
                            int K, int causal, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));

  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int rep = H / K;
  const int klen = min(seq, lengths[b]);        // keys past it are masked
  // rows before the tile's first key see none of its keys
  const int t_start = causal ? k0 : 0;
  const int nqt = k0 < klen ? (seq - t_start + BQ - 1) / BQ : 0;
  const int nit = nqt * rep;                    // tiles of the walk

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&sm.full[s], 32);         // the producer warp
      sm90::mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -- producer -------------------------------------------------------
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0 && nit > 0) {
        sm90::mbar_arrive_expect_tx(&sm.kv_full, 2 * BKV * D * 2);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(sm.k + c * BKV * 64, &map_k, &sm.kv_full, 64 * c,
                            kh, k0, b);
          sm90::tma_load_4d(sm.v + c * BKV * 64, &map_v, &sm.kv_full, 64 * c,
                            kh, k0, b);
        }
      }
      for (int it = 0; it < nit; ++it) {
        const int h = kh * rep + it / nqt;
        const int t0 = t_start + (it % nqt) * BQ, st = it % STAGES;
        // the consumers released this stage's previous tile
        sm90::mbar_wait(&sm.empty[st], ((it / STAGES) & 1) ^ 1);
        const int64_t bh = ((int64_t)b * H + h) * seq;
        for (int i = lane; i < BQ; i += 32) {
          const int t = t0 + i;
          sm.lse2[st][i] = t < seq ? lse[bh + t] * LOG2E : INFINITY;
          sm.delta[st][i] = t < seq ? delta[bh + t] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&sm.full[st], 2 * BQ * D * 2);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            sm90::tma_load_4d(sm.q[st] + c * BQ * 64, &map_q, &sm.full[st],
                              64 * c, h, t0, b);
            sm90::tma_load_4d(sm.dout[st] + c * BQ * 64, &map_do,
                              &sm.full[st], 64 * c, h, t0, b);
          }
        } else {
          sm90::mbar_arrive(&sm.full[st]);   // releases this lane's rows
        }
      }
    }
  } else {
    // -- consumers: 64 keys each -------------------------------------------
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int lt = threadIdx.x % 128, lane = lt % 32;
    const int tq = lane % 4;
    const int kw0 = k0 + 64 * (wg - 1);     // this warpgroup's first key
    // this thread's keys: key0 and key0 + 8 (accumulator layout, sm90.cuh)
    const int key0 = kw0 + 16 * (lt / 32) + lane / 4;
    const bf16* k_rows = sm.k + (wg - 1) * 64 * 64;
    const bf16* v_rows = sm.v + (wg - 1) * 64 * 64;
    const float c2 = scale * LOG2E;
    // the tiles that hold the diagonal or lengths[b] need the mask
    const bool past_len = kw0 + 64 > klen;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

    if (nit > 0) sm90::mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < nit; ++it) {
      const int t0 = t_start + (it % nqt) * BQ, st = it % STAGES;
      sm90::mbar_wait(&sm.full[st], (it / STAGES) & 1);
      if (!causal || t0 + BQ > kw0) {   // some query sees one of our keys
        float s[BQ / 2], dp[BQ / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_ss<BQ>(s, sm90::desc_kmajor(k_rows, BKV, kk),
                             sm90::desc_kmajor(sm.q[st], BQ, kk), kk > 0);
        sm90::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_ss<BQ>(dp, sm90::desc_kmajor(v_rows, BKV, kk),
                             sm90::desc_kmajor(sm.dout[st], BQ, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);

        const bool edge = past_len || (causal && t0 < kw0 + 64);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int col = 8 * (e / 4) + 2 * tq + e % 2;   // query t0 + col
          float p = exp2f(fmaf(s[e], c2, -sm.lse2[st][col]));
          if (edge) {
            const int key = key0 + 8 * ((e / 2) % 2), t = t0 + col;
            if (key >= klen || (causal && key > t)) p = 0.f;
          }
          s[e] = p;
        }
        uint32_t pa[BQ / 16][4];
        sm90::to_a_frags<BQ>(s, pa);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(pa);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::wgmma_rs<D>(dv_acc, pa[kk],
                            sm90::desc_mnmajor(sm.dout[st], BQ, kk));
        sm90::wgmma_commit();

#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int col = 8 * (e / 4) + 2 * tq + e % 2;
          dp[e] = s[e] * (dp[e] - sm.delta[st][col]);
        }
        uint32_t da[BQ / 16][4];
        sm90::to_a_frags<BQ>(dp, da);
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(da);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::wgmma_rs<D>(dk_acc, da[kk],
                            sm90::desc_mnmajor(sm.q[st], BQ, kk));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(pa);
        sm90::fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[st]);
    }

    const int64_t kstride = (int64_t)K * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= seq) continue;
      const int64_t off = ((int64_t)b * seq + key) * kstride
                          + (int64_t)kh * D + 2 * tq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int e = 4 * c + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * c) =
            __floats2bfloat162_rn(dk_acc[e] * scale, dk_acc[e + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * c) =
            __floats2bfloat162_rn(dv_acc[e], dv_acc[e + 1]);
      }
    }
  }
}

template <int D>
int launch(void* dk, void* dv, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const int* lengths, int B, int seq, int H, int K, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = sm90_host::make_map(&mq, q, B, seq, H, D, BQ);
  if (!rc) rc = sm90_host::make_map(&mdo, dout, B, seq, H, D, BQ);
  if (!rc) rc = sm90_host::make_map(&mk, k, B, seq, K, D, BKV);
  if (!rc) rc = sm90_host::make_map(&mv, v, B, seq, K, D, BKV);
  const size_t smem = smem_bytes<D>();
  if (!rc) rc = allow_smem(flash_bwd_dkv_tc_kernel<D>, smem);
  if (rc) return rc;
  const dim3 grid(K, B, (seq + BKV - 1) / BKV);
  flash_bwd_dkv_tc_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, mdo, (bf16*)dk, (bf16*)dv, lse, delta, lengths, seq, H, K,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The operands as mxtt_flash_bwd_dkv's; dtype must be bf16 and D 64 or
// 128.
extern "C" int mxtt_flash_bwd_dkv_tc(void* dk, void* dv, const void* q,
                                     const void* k, const void* v,
                                     const void* dout, const float* lse,
                                     const float* delta, const int* lengths,
                                     int B, int seq, int H, int K, int D,
                                     int causal, float scale, int dtype,
                                     void* stream) {
  if (B <= 0 || seq <= 0) return 0;
  if (K <= 0 || H % K || B > 65535 || (seq + BKV - 1) / BKV > 65535 ||
      dtype != MXTT_BF16)
    return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)    // BERT-base, BERT-large, transformer_base
    return launch<64>(dk, dv, q, k, v, dout, lse, delta, lengths, B, seq, H,
                      K, causal, scale, s);
  if (D == 128)   // Llama-3-8B
    return launch<128>(dk, dv, q, k, v, dout, lse, delta, lengths, B, seq, H,
                       K, causal, scale, s);
  return MXTT_BAD_ARGUMENT;
}

// What a launch at head dim D takes: out[0] bytes of dynamic shared
// memory, out[1] and out[2] registers a producer and a consumer thread
// (setmaxnreg). Returns MXTT_BAD_ARGUMENT for a D without a kernel.
extern "C" int mxtt_flash_bwd_dkv_tc_info(int D, int* out) {
  if (D != 64 && D != 128) return MXTT_BAD_ARGUMENT;
  out[0] = (int)(D == 64 ? smem_bytes<64>() : smem_bytes<128>());
  out[1] = PRODUCER_REGS;
  out[2] = CONSUMER_REGS;
  return 0;
}
