// dQ of causal or full, key-length-masked GQA attention on Hopper's
// tensor cores, bf16 at d in {64, 128}: the route of the training step
// and BERT's and the Transformer's backward. It computes what
// mxtt_flash_bwd_dq (flash_backward.cu, which keeps fp32 and d = 16)
// computes:
//
//   dQ = scale * sum_s dS K
//
// with P = exp(scale * Q K^T - lse) (0 where masked) and
// dS = P * (dO V^T - delta), from the forward's lse and delta =
// rowsum(dO * O) (B, H, T) fp32. q, dO, dq (B, T, H, d); k, v
// (B, T, K, d); lengths (B,) int32. Query head h reads kv head
// h // (H/K). Key s is seen by query t when s < lengths[b] and, if
// causal, s <= t. The key sweep stops at the diagonal and at
// lengths[b]; rows at or past lengths[b] are still computed, and a row
// with no valid key gets dQ = 0. Each dQ row has one writer and the
// sweep runs in one fixed order, so the result is the same bit for bit
// from run to run.
//
// Replaces: mxnet_tpu/kernels/flash_attention.py, _pallas_backward's
// dq_kernel (its first pallas_call, :325).
//
// Bound on the H100: operations. Per (query, key) pair 6 d flops (S,
// dP, dS K): 103.1 GFLOP at the Llama training shape (B=2, T=2048,
// H=32, K=8, d=128, causal), 0.1043 ms at the bf16 tensor-core peak,
// against 118 MB moved. All three products run on wgmma.
//
// Design: the forward's block (flash_fwd_sm90.cu) with the online
// softmax taken out, one more resident tile and one more product. One
// block of 3 warpgroups per 128 query rows of one head and batch row;
// the q tiles with the longest causal sweep launch first.
// - warpgroup 0, the producer: its first thread loads the block's Q and
//   dO tiles once by TMA (bf16, 128-byte swizzle, sm90.cuh), then walks
//   the key tiles of 64 from key 0 to the sweep's end, loading each K
//   and V tile into a 3-stage ring, K and V on their own mbarriers so
//   that S can start before V lands. It gives its registers up
//   (setmaxnreg) to
// - warpgroups 1 and 2, the consumers, 64 query rows each, which keep
//   their dQ rows in fp32 registers for the whole sweep and per key
//   tile run three wgmma products:
//     S   = Q K^T     A: Q from shared memory    B: K (K-major)
//     dP  = dO V^T    A: dO from shared memory   B: V (K-major)
//     dQ += dS K      A: dS, bf16 registers      B: K (MN-major)
//   with P = exp2(S scale log2(e) - lse log2(e)), masked only on the
//   tiles that hold the consumer's diagonal, lengths[b] or T, and
//   dS = P (dP - delta). One K tile serves both majors; dS never leaves
//   registers. A consumer skips the products of a tile whose keys all
//   follow its rows, and still releases the tile.
// Registers a consumer thread: dQ 64 (d = 128), S 32, dP 32 and the
// dS fragments 16: 144 fp32 of the 240 that setmaxnreg grants. Shared
// memory: Q and dO 64 KiB and three K/V stages 96 KiB at d = 128 (half
// at d = 64), plus barriers. Three stages are faster than two at the
// training shape and level at BERT's, timed in turns on the same inputs
// by tools/dq_ring_depth.py (PERF.md).
//
// Numbers that differ from the JAX kernel: it computes dS K in fp32
// (flash_attention.py:249); here dS is rounded to bf16 for the tensor
// cores, as the tensor-core dkv kernel rounds it for dS^T Q, and dQ is
// rounded once, after the scale.
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // query rows a block: 2 consumers x 64
constexpr int BN = 64;           // keys a tile
constexpr int STAGES = 3;        // K/V tiles in flight
constexpr int NTHREADS = 384;    // producer warpgroup + 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24;   // a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {                    // every tile starts on 1024 bytes
  bf16 q[BM * D];                // D / 64 boxes of BM x 64
  bf16 dout[BM * D];
  bf16 k[STAGES][BN * D];        // D / 64 boxes of BN x 64
  bf16 v[STAGES][BN * D];
  uint64_t qdo_full, k_full[STAGES], v_full[STAGES], kv_empty[STAGES];
};

// the dynamic shared memory a launch asks for: the tiles, and slack to
// start them on a 1024-byte boundary
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           bf16* __restrict__ dq,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ lengths, int seq, int H,
                           int K, int causal, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kh = h / (H / K);
  const int klen = min(seq, lengths[b]);        // keys past it are masked
  // keys [0, kend) may be seen by some row of this tile
  const int kend = causal ? min(klen, q0 + BM) : klen;
  const int ntiles = kend > 0 ? (kend + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.qdo_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.kv_empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -- producer -------------------------------------------------------
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && ntiles > 0) {
      sm90::mbar_arrive_expect_tx(&sm.qdo_full, 2 * BM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(sm.q + c * BM * 64, &map_q, &sm.qdo_full, 64 * c,
                          h, q0, b);
        sm90::tma_load_4d(sm.dout + c * BM * 64, &map_do, &sm.qdo_full,
                          64 * c, h, q0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int k0 = it * BN, st = it % STAGES;
        // the consumers released this stage's previous tile
        sm90::mbar_wait(&sm.kv_empty[st], ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.k_full[st], BN * D * 2);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm90::tma_load_4d(sm.k[st] + c * BN * 64, &map_k, &sm.k_full[st],
                            64 * c, kh, k0, b);
        sm90::mbar_arrive_expect_tx(&sm.v_full[st], BN * D * 2);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm90::tma_load_4d(sm.v[st] + c * BN * 64, &map_v, &sm.v_full[st],
                            64 * c, kh, k0, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each --------------------------------------
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int lt = threadIdx.x % 128, lane = lt % 32;
    const int tq = lane % 4;
    const int rw0 = q0 + 64 * (wg - 1);     // this warpgroup's first row
    // this thread's rows: row0 and row0 + 8 (accumulator layout, sm90.cuh)
    const int row0 = rw0 + 16 * (lt / 32) + lane / 4;
    const bf16* q_rows = sm.q + (wg - 1) * 64 * 64;
    const bf16* do_rows = sm.dout + (wg - 1) * 64 * 64;
    const float c2 = scale * LOG2E;

    // a row past T has no probabilities: lse = +inf makes them 0
    float lse2[2], dlt[2];
    const int64_t bh = ((int64_t)b * H + h) * seq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row0 + 8 * i;
      lse2[i] = t < seq ? lse[bh + t] * LOG2E : INFINITY;
      dlt[i] = t < seq ? delta[bh + t] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

    if (ntiles > 0) sm90::mbar_wait(&sm.qdo_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int k0 = it * BN, st = it % STAGES;
      const int phase = (it / STAGES) & 1;
      sm90::mbar_wait(&sm.k_full[st], phase);
      if (causal && k0 >= rw0 + 64) {   // every key follows our rows
        sm90::mbar_wait(&sm.v_full[st], phase);
      } else {
        float s[BN / 2], dp[BN / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_ss<BN>(s, sm90::desc_kmajor(q_rows, BM, kk),
                             sm90::desc_kmajor(sm.k[st], BN, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::mbar_wait(&sm.v_full[st], phase);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_ss<BN>(dp, sm90::desc_kmajor(do_rows, BM, kk),
                             sm90::desc_kmajor(sm.v[st], BN, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);

        // the tiles that hold the diagonal, lengths[b] or T need the mask
        const bool edge = k0 + BN > klen || (causal && k0 + BN - 1 > rw0);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int i = (e / 2) % 2;
          // lse2 = +inf (a row past T) gives exp2(-inf) = 0
          float p = exp2f(fmaf(s[e], c2, -lse2[i]));
          if (edge) {
            const int key = k0 + 8 * (e / 4) + 2 * tq + e % 2;
            if (key >= klen || (causal && key > row0 + 8 * i)) p = 0.f;
          }
          s[e] = p;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          dp[e] = s[e] * (dp[e] - dlt[(e / 2) % 2]);
        uint32_t da[BN / 16][4];
        sm90::to_a_frags<BN>(dp, da);
        sm90::fence_regs(acc);
        sm90::fence_regs(da);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          sm90::wgmma_rs<D>(acc, da[kk], sm90::desc_mnmajor(sm.k[st], BN, kk));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.kv_empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row0 + 8 * i;
      if (t >= seq) continue;
      bf16* drow = dq + ((int64_t)b * seq + t) * H * D + (int64_t)h * D
                   + 2 * tq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float* ac = acc + 4 * c + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * c) =
            __floats2bfloat162_rn(ac[0] * scale, ac[1] * scale);
      }
    }
  }
}

template <int D>
int launch(void* dq, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const int* lengths, int B, int seq, int H, int K, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = sm90_host::make_map(&mq, q, B, seq, H, D, BM);
  if (!rc) rc = sm90_host::make_map(&mdo, dout, B, seq, H, D, BM);
  if (!rc) rc = sm90_host::make_map(&mk, k, B, seq, K, D, BN);
  if (!rc) rc = sm90_host::make_map(&mv, v, B, seq, K, D, BN);
  const size_t smem = smem_bytes<D>();
  if (!rc) rc = allow_smem(flash_bwd_dq_tc_kernel<D>, smem);
  if (rc) return rc;
  const dim3 grid(H, B, (seq + BM - 1) / BM);
  flash_bwd_dq_tc_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, mdo, (bf16*)dq, lse, delta, lengths, seq, H, K, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The operands as mxtt_flash_bwd_dq's; dtype must be bf16 and D 64 or
// 128.
extern "C" int mxtt_flash_bwd_dq_tc(void* dq, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    const int* lengths, int B, int seq,
                                    int H, int K, int D, int causal,
                                    float scale, int dtype, void* stream) {
  if (B <= 0 || seq <= 0) return 0;
  if (K <= 0 || H % K || B > 65535 || (seq + BM - 1) / BM > 65535 ||
      dtype != MXTT_BF16)
    return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)    // BERT-base, BERT-large, transformer_base
    return launch<64>(dq, q, k, v, dout, lse, delta, lengths, B, seq, H, K,
                      causal, scale, s);
  if (D == 128)   // Llama-3-8B
    return launch<128>(dq, q, k, v, dout, lse, delta, lengths, B, seq, H, K,
                       causal, scale, s);
  return MXTT_BAD_ARGUMENT;
}

// What a launch at head dim D takes: out[0] bytes of dynamic shared
// memory, out[1] and out[2] registers a producer and a consumer thread
// (setmaxnreg). Returns MXTT_BAD_ARGUMENT for a D without a kernel.
extern "C" int mxtt_flash_bwd_dq_tc_info(int D, int* out) {
  if (D != 64 && D != 128) return MXTT_BAD_ARGUMENT;
  out[0] = (int)(D == 64 ? smem_bytes<64>() : smem_bytes<128>());
  out[1] = PRODUCER_REGS;
  out[2] = CONSUMER_REGS;
  return 0;
}
