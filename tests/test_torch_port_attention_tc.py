"""The tensor-core attention kernels' roundings, rehearsed on the CPU.

The bf16 route of the attention forward (`csrc/flash_fwd_sm90.cu`), of dQ
(`csrc/flash_bwd_dq_sm90.cu`) and of dK/dV (`csrc/flash_bwd_dkv_sm90.cu`)
feeds wgmma with P and dS rounded to bf16, where the fp32 SIMT kernels
kept them in fp32. Here each kernel's arithmetic is emulated in fp32 on
bf16-valued inputs from a numpy seed:

- forward: 128-row query tiles, 128-key tiles swept from the last down,
  the online softmax against the running max, P rounded to bf16 after
  its exp and before P V, the row sum of the unrounded P, one rounding
  of the output;
- dQ: 128-row query tiles, 64-key tiles swept from key 0 to the
  diagonal or lengths[b], P = exp2(s scale log2(e) - lse log2(e)) and
  dS = P (dP - delta) in fp32, dS rounded to bf16 before dS K, the sum
  over key tiles in fp32, one rounding of the output after the scale;
- dK/dV: P = exp(s - lse) and dS = P (dP - delta) in fp32, both rounded
  to bf16 before P^T dO and dS^T Q, the GQA group summed in fp32, one
  rounding of each output.

Each emulation must lie within `chip_smoke.py`'s tolerances of the plain
versions (the tolerances the card holds the kernels to), and attention
off by one at the key length or the diagonal must lie outside them.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.kernels import flash_attention as fa

B, H, K, D = 2, 4, 2, 64
BM = BN = 128                       # the forward kernel's tiles
BN_DQ = 64                          # the dq kernel's key tiles (rows: BM)


def _inputs(T, seed):
    rs = np.random.RandomState(seed)

    def bf16(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)) \
            .to(torch.bfloat16)
    q, dout = bf16(B, T, H, D), bf16(B, T, H, D)
    k, v = bf16(B, T, K, D), bf16(B, T, K, D)
    lengths = torch.tensor([T, T // 2 + 3], dtype=torch.int32)
    return q, k, v, dout, lengths


def emulate_forward(q, k, v, causal, scale, lengths):
    """(out in q's dtype, lse fp32) as the tensor-core forward computes
    them, in fp32 on q's device."""
    Bq, T, Hq, d = q.shape
    rep = Hq // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf)   # unscaled dots
    c2 = scale * math.log2(math.e)
    out = torch.zeros(Bq, Hq, T, d, device=q.device)
    lse = torch.full((Bq, Hq, T), math.inf, device=q.device)
    key = torch.arange(T, device=q.device)
    for b in range(Bq):
        klen = min(T, int(lengths[b]))
        for q0 in range(0, T, BM):
            t1 = min(q0 + BM, T)
            rows = torch.arange(q0, t1, device=q.device)
            kend = min(klen, q0 + BM) if causal else klen
            m = torch.full((Hq, t1 - q0), -math.inf, device=q.device)
            l = torch.zeros_like(m)
            o = torch.zeros(Hq, t1 - q0, d, device=q.device)
            for kt in reversed(range((kend + BN - 1) // BN)):
                k0, k1 = kt * BN, min(kt * BN + BN, T)
                st = s[b, :, q0:t1, k0:k1]
                keep = key[None, k0:k1] < klen
                if causal:
                    keep = keep & (key[None, k0:k1] <= rows[:, None])
                st = st.masked_fill(~keep, -math.inf)
                mx = torch.maximum(m, st.amax(dim=-1))
                base = torch.where(mx == -math.inf, 0.0, mx * c2)
                corr = torch.exp2(m * c2 - base)
                p = torch.exp2(st * c2 - base[..., None])
                l = l * corr + p.sum(dim=-1)
                o = o * corr[..., None] + torch.einsum(
                    "hrk,khd->hrd", p.to(torch.bfloat16).float(),
                    vf[b, k0:k1])
                m = mx
            out[b, :, q0:t1] = torch.where(l[..., None] > 0,
                                           o / l[..., None], 0.0)
            lse[b, :, q0:t1] = torch.where(l > 0, m * scale + torch.log(l),
                                           math.inf)
    return out.transpose(1, 2).to(q.dtype), lse


def emulate_dq(q, k, v, dout, lse, delta, causal, scale, lengths):
    """dq in q's dtype as the tensor-core dq kernel computes it, in fp32
    on q's device."""
    Bq, T, Hq, d = q.shape
    rep = Hq // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    log2e = math.log2(math.e)
    c2 = scale * log2e
    dq = torch.zeros(Bq, Hq, T, d, device=q.device)
    key = torch.arange(T, device=q.device)
    for b in range(Bq):
        klen = min(T, int(lengths[b]))
        for q0 in range(0, T, BM):
            t1 = min(q0 + BM, T)
            rows = torch.arange(q0, t1, device=q.device)
            kend = min(klen, q0 + BM) if causal else klen
            lse2 = lse[b, :, q0:t1, None] * log2e
            dlt = delta[b, :, q0:t1, None]
            acc = torch.zeros(Hq, t1 - q0, d, device=q.device)
            for kt in range((kend + BN_DQ - 1) // BN_DQ):
                k0, k1 = kt * BN_DQ, min(kt * BN_DQ + BN_DQ, T)
                s = torch.einsum("thd,shd->hts", q[b, q0:t1].float(),
                                 kf[b, k0:k1])
                keep = key[None, k0:k1] < klen
                if causal:
                    keep = keep & (key[None, k0:k1] <= rows[:, None])
                p = torch.where(keep, torch.exp2(s * c2 - lse2), 0.0)
                dp = torch.einsum("thd,shd->hts", dout[b, q0:t1].float(),
                                  vf[b, k0:k1])
                ds = (p * (dp - dlt)).to(torch.bfloat16).float()
                acc = acc + torch.einsum("hts,shd->htd", ds, kf[b, k0:k1])
            dq[b, :, q0:t1] = acc * scale
    return dq.transpose(1, 2).to(q.dtype)


def emulate_dkv(q, k, v, dout, lse, delta, causal, scale, lengths):
    """(dk, dv) in k's dtype as the tensor-core dkv kernel computes them,
    in fp32 on q's device."""
    p, ds, rep = fa._probs_and_ds(q, k, v, dout, lse, delta, causal, scale,
                                  lengths)
    Bq, T, Hq, d = q.shape
    dv = torch.einsum("bhts,bthd->bshd", p.to(torch.bfloat16).float(),
                      dout.float())
    dk = torch.einsum("bhts,bthd->bshd", ds.to(torch.bfloat16).float(),
                      q.float()) * scale
    return tuple(g.reshape(Bq, T, k.shape[2], rep, d).sum(dim=3)
                 .to(k.dtype) for g in (dk, dv))


def _off_by_one(T, lengths, causal):
    """(name, lengths, diagonal offset) of the off-by-one variants that
    chip_smoke.py checks: lengths -1 and, where a row is cut, +1; the
    diagonal -1 and +1 if causal."""
    wrong = [("lengths-1", lengths - 1, 0), ("lengths+1", lengths + 1, 0)]
    if causal:
        wrong += [("diagonal-1", lengths, -1), ("diagonal+1", lengths, 1)]
    return wrong


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [77, 128])
def test_forward_rounding_within_the_card_tolerance(T, causal):
    q, k, v, _, lengths = _inputs(T, 11 + T)
    scale = 1.0 / math.sqrt(D)
    ref, lse_ref = fa.reference_attention_lse(q, k, v, causal, scale,
                                              lengths)
    out, lse = emulate_forward(q, k, v, causal, scale, lengths)
    tol = cs.attn_fwd_tol(torch, q, k, v, ref, scale, lengths, causal)
    assert tol.device == q.device
    assert bool(((out.float() - ref.float()).abs() <= tol).all())
    fin = torch.isfinite(lse_ref)
    assert bool((torch.isinf(lse) == ~fin).all())
    assert bool(((lse - lse_ref)[fin].abs()
                 <= cs.FP32_NOISE * (1 + lse_ref[fin].abs())).all())
    for name, ln, dg in _off_by_one(T, lengths, causal):
        wrong = cs.attn_apply(torch, cs.attn_probs(torch, q, k, scale, ln,
                                                   causal, dg), v, H)[0]
        over = int(((wrong.to(q.dtype).float() - ref.float()).abs()
                    > tol).sum())
        assert over > 0, f"{name} passes the tolerance"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [77, 128])
def test_dq_rounding_within_the_card_tolerance(T, causal):
    q, k, v, dout, lengths = _inputs(T, 47 + T)
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.reference_attention_lse(q, k, v, causal, scale, lengths)
    delta = fa.attention_delta(out, dout)
    ref = fa.flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal, scale,
                              lengths)
    refs = (ref,) + fa.flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal,
                                         scale, lengths)
    _, terms = cs.attn_backward_fp32(torch, q, k, v, dout, lse, delta, scale,
                                     lengths, causal=causal)
    tol = cs.attn_bwd_tols(torch, terms, refs)[0]
    got = emulate_dq(q, k, v, dout, lse, delta, causal, scale, lengths)
    assert tol.device == q.device
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    # the emulation rounds dS: it is not the plain version over again
    assert not torch.equal(got, ref)
    for name, ln, dg in _off_by_one(T, lengths, causal):
        grads, _ = cs.attn_backward_fp32(torch, q, k, v, dout, lse, delta,
                                         scale, ln, dg, causal=causal,
                                         terms=False)
        over = int(((grads[0].to(q.dtype).float() - ref.float()).abs()
                    > tol).sum())
        assert over > 0, f"dq {name} passes the tolerance"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [77, 128])
def test_dkv_rounding_within_the_card_tolerance(T, causal):
    q, k, v, dout, lengths = _inputs(T, 29 + T)
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.reference_attention_lse(q, k, v, causal, scale, lengths)
    delta = fa.attention_delta(out, dout)
    refs = (fa.flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal, scale,
                                lengths),) \
        + fa.flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal, scale,
                               lengths)
    _, terms = cs.attn_backward_fp32(torch, q, k, v, dout, lse, delta, scale,
                                     lengths, causal=causal)
    tols = cs.attn_bwd_tols(torch, terms, refs)
    dk, dv = emulate_dkv(q, k, v, dout, lse, delta, causal, scale, lengths)
    for name, got, ref, tol in zip(("dk", "dv"), (dk, dv), refs[1:],
                                   tols[1:]):
        assert tol.device == q.device
        assert bool(((got.float() - ref.float()).abs() <= tol).all()), name
    for name, ln, dg in _off_by_one(T, lengths, causal):
        grads, _ = cs.attn_backward_fp32(torch, q, k, v, dout, lse, delta,
                                         scale, ln, dg, causal=causal,
                                         terms=False)
        for g, wrong, ref, tol in zip(("dk", "dv"), grads[1:], refs[1:],
                                      tols[1:]):
            over = int(((wrong.to(k.dtype).float() - ref.float()).abs()
                        > tol).sum())
            assert over > 0, f"{g} {name} passes the tolerance"

