// Causal or full, key-length-masked GQA attention forward on Hopper's
// tensor cores, bf16 at d in {64, 128}: the route of the prefill, the
// training step and BERT's self-attention. It computes what
// mxtt_flash_prefill (flash_prefill.cu, which keeps fp32 and d = 16)
// computes: q (B, T, H, d), k/v (B, T, K, d) with H % K == 0, lengths
// (B,) int32, out (B, T, H, d) bf16 and optionally the (B, H, T) fp32
// log-sum-exp of each row's scaled scores. Query head h reads kv head
// h // (H/K); keys at or past lengths[b] are masked (and, if causal,
// keys past the row); a row with no valid key is 0 with lse +inf; any T
// (the ragged tail is masked); rows at or past lengths[b] are computed.
//
// Replaces: mxnet_tpu/kernels/flash_attention.py, the kernel of
// _pallas_forward (its pallas_call, :188; lse as with return_lse=True).
//
// Bound on the H100: at the Llama training shape (B=2, T=2048, H=32,
// K=8, d=128, causal) 68.7 GFLOP against 67 MB moved: operations, 0.0695
// ms at the bf16 tensor-core peak. At the serving prefill (B=1, T=512,
// one prompt of 205 tokens) the few keys make it bytes-bound (0.0028
// ms). Only wgmma reaches either roof, so every product runs there.
//
// Design (one block of 3 warpgroups per 128 query rows, head and batch
// row; the q tiles with the longest causal sweep launch first):
// - warpgroup 0 is the producer: its first thread loads the block's Q
//   tile, then K and V tiles of 128 keys into a 2-stage ring in shared
//   memory by TMA (bf16, 128-byte swizzle, sm90.cuh), each stage's K and
//   V on their own mbarrier so that S can start before V lands; it gives
//   its registers up (setmaxnreg) to
// - warpgroups 1 and 2, the consumers, 64 query rows each: S = Q K^T by
//   wgmma from shared memory into fp32 registers; the online softmax in
//   registers (scale * log2(e) folded into one multiply of the fp32
//   scores, exp2f; a row spans the 4 threads of a quad, so its max and
//   sum take two shuffles); P rounded to bf16 in registers becomes the A
//   operand of O += P V, with V the MN-major B operand straight from
//   its TMA tile. P never passes through shared memory.
// - The sweep runs from the last key tile down: the first tile it meets
//   is the only one that can hold the diagonal, lengths[b] or T, and is
//   the only one masked; tiles past them are never loaded.
//
// Numbers that differ from the JAX kernel: it computes P V in fp32
// (flash_attention.py:143); here P is rounded to bf16 (against the
// running max, before its normalisation) for the tensor cores, as the
// port's plain version (kernels/flash_attention.py, _softmax_apply)
// and the jnp reference (flash_attention.py:61) round the normalised P.
// The row sum l adds the unrounded fp32 P. Scale is applied to the fp32
// scores, never to bf16 Q (1/sqrt(128) is not a power of two).
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // query rows a block: 2 consumers x 64
constexpr int BN = 128;          // keys a tile
constexpr int STAGES = 2;        // K/V tiles in flight
constexpr int NTHREADS = 384;    // producer warpgroup + 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24;   // a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {                    // every tile starts on 1024 bytes
  bf16 q[BM * D];                // D / 64 boxes of BM x 64
  bf16 k[STAGES][BN * D];        // D / 64 boxes of BN x 64
  bf16 v[STAGES][BN * D];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], kv_empty[STAGES];
};

// the dynamic shared memory a launch asks for: the tiles, and slack to
// start them on a 1024-byte boundary
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        const int* __restrict__ lengths, int seq, int H,
                        int K, int causal, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kh = h / (H / K);
  const int klen = min(seq, lengths[b]);        // keys past it are masked
  // keys [0, kend) may be valid for some row of this tile
  const int kend = causal ? min(klen, q0 + BM) : klen;
  const int ntiles = kend > 0 ? (kend + BN - 1) / BN : 0;

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

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -- producer -------------------------------------------------------
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&sm.q_full, BM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        sm90::tma_load_4d(sm.q + c * BM * 64, &map_q, &sm.q_full, 64 * c, h,
                          q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int k0 = (ntiles - 1 - it) * BN, st = it % STAGES;
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
    // this thread's rows: row0 and row0 + 8 (accumulator layout, sm90.cuh)
    const int row0 = q0 + 64 * (wg - 1) + 16 * (lt / 32) + lane / 4;
    const bf16* q_rows = sm.q + (wg - 1) * 64 * 64;
    const float c2 = scale * LOG2E;

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int k0 = (ntiles - 1 - it) * BN, st = it % STAGES;
      const int phase = (it / STAGES) & 1;

      float s[BN / 2];
      sm90::mbar_wait(&sm.k_full[st], phase);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<BN>(s, sm90::desc_kmajor(q_rows, BM, kk),
                           sm90::desc_kmajor(sm.k[st], BN, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      if (it == 0) {  // the tile that holds the diagonal, lengths[b], T
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int key = k0 + 8 * (e / 4) + 2 * tq + e % 2;
          const int row = row0 + 8 * ((e / 2) % 2);
          if (key >= klen || (causal && key > row)) s[e] = -INFINITY;
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
        // probabilities and correction are 0, never exp(nan)
        base[i] = mx == -INFINITY ? 0.f : mx * c2;
        corr[i] = exp2f(m[i] * c2 - base[i]);
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
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.kv_empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row0 + 8 * i;
      const float li = sm90::quad_sum(l[i]);
      if (t >= seq) continue;
      bf16* orow = out + ((int64_t)b * seq + t) * H * D + (int64_t)h * D
                   + 2 * tq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float* oc = o + 4 * c + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            li > 0.f ? __floats2bfloat162_rn(oc[0] / li, oc[1] / li)
                     : __floats2bfloat162_rn(0.f, 0.f);
      }
      if (lse != nullptr && tq == 0)
        lse[((int64_t)b * H + h) * seq + t] =
            li > 0.f ? m[i] * scale + logf(li) : INFINITY;
    }
  }
}

template <int D>
int launch(void* out, float* lse, const void* q, const void* k,
           const void* v, const int* lengths, int B, int seq, int H, int K,
           int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = sm90_host::make_map(&mq, q, B, seq, H, D, BM);
  if (!rc) rc = sm90_host::make_map(&mk, k, B, seq, K, D, BN);
  if (!rc) rc = sm90_host::make_map(&mv, v, B, seq, K, D, BN);
  const size_t smem = smem_bytes<D>();
  if (!rc) rc = allow_smem(flash_fwd_tc_kernel<D>, smem);
  if (rc) return rc;
  const dim3 grid(H, B, (seq + BM - 1) / BM);
  flash_fwd_tc_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, (bf16*)out, lse, lengths, seq, H, K, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The operands as mxtt_flash_prefill's; dtype must be bf16 and D 64 or
// 128. lse (B, H, T) float32 may be null.
extern "C" int mxtt_flash_fwd_tc(void* out, float* lse, const void* q,
                                 const void* k, const void* v,
                                 const int* lengths, int B, int seq, int H,
                                 int K, int D, int causal, float scale,
                                 int dtype, void* stream) {
  if (B <= 0 || seq <= 0) return 0;
  if (K <= 0 || H % K || B > 65535 || (seq + BM - 1) / BM > 65535 ||
      dtype != MXTT_BF16)
    return MXTT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)    // BERT-base, BERT-large, transformer_base
    return launch<64>(out, lse, q, k, v, lengths, B, seq, H, K, causal,
                      scale, s);
  if (D == 128)   // Llama-3-8B
    return launch<128>(out, lse, q, k, v, lengths, B, seq, H, K, causal,
                       scale, s);
  return MXTT_BAD_ARGUMENT;
}

// What a launch at head dim D takes: out[0] bytes of dynamic shared
// memory, out[1] and out[2] registers a producer and a consumer thread
// (setmaxnreg). Returns MXTT_BAD_ARGUMENT for a D without a kernel.
extern "C" int mxtt_flash_fwd_tc_info(int D, int* out) {
  if (D != 64 && D != 128) return MXTT_BAD_ARGUMENT;
  out[0] = (int)(D == 64 ? smem_bytes<64>() : smem_bytes<128>());
  out[1] = PRODUCER_REGS;
  out[2] = CONSUMER_REGS;
  return 0;
}
