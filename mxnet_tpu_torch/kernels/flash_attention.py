"""Causal or full, key-length-masked GQA attention, forward and
backward: the CUDA kernels and their plain PyTorch versions.

Two routes on the card. bf16 at d in {64, 128} (every model the port
trains or serves on the card) takes the tensor-core kernels: the
forward `csrc/flash_fwd_sm90.cu`, dQ `csrc/flash_bwd_dq_sm90.cu` and
dK/dV `csrc/flash_bwd_dkv_sm90.cu` (wgmma on bf16 tiles staged by TMA).
float32, and d = 16 (`llama_tiny`), take the fp32 SIMT kernels
`csrc/flash_prefill.cu` and `csrc/flash_backward.cu`'s dq and dkv.

Counterpart of `mxnet_tpu/kernels/flash_attention.py`
(`flash_attention_raw`: the `_pallas_forward` kernel with its
log-sum-exp, and `_pallas_backward`'s `dq_kernel` and `dkv_kernel` under
a `custom_vjp`). Layout: q (B, T, H, d), k/v (B, T, K, d) with
H % K == 0, out (B, T, H, d). `lengths` (B,) masks key positions
>= lengths[b]; masks compare absolute positions.

    flash_attention_forward(q, k, v, causal, scale, lengths, return_lse)
        -> out, or (out, lse (B, H, T) fp32; +inf on a row with no key)
    flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, lengths)
        -> dq in q's dtype
    flash_bwd_dkv(...)  -> (dk, dv) in k's dtype, the rep = H/K query
        heads of a kv head summed in fp32 (the JAX kernel writes them per
        query head in q's dtype and sums outside: at bf16 the two differ
        by rounding alone)
    flash_attention(q, k, v, causal, scale, lengths) -> out,
        differentiable

`delta` = rowsum(dO * O) in fp32, (B, H, T), as the JAX backward
computes it outside its kernels. A CPU tensor takes the plain versions;
a CUDA tensor launches the kernel of its route (any T, d in {16, 64,
128}, float32 or bfloat16, contiguous rows on 16-byte boundaries) or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_forward", "flash_bwd_dq",
           "flash_bwd_dkv", "reference_attention", "reference_attention_lse",
           "flash_bwd_dq_ref", "flash_bwd_dkv_ref", "attention_delta",
           "FlashAttentionFunction"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: out, lse (may be NULL), q, k, v, lengths, B, T, H, K, d, causal,
#: scale, dtype, stream
_FWD = _build.CudaKernel("mxtt_flash_prefill",
                         [_P] * 6 + [_I] * 6 + [_F, _I, _P])
#: dq, q, k, v, dout, lse, delta, lengths, B, T, H, K, d, causal, scale,
#: dtype, stream
_DQ = _build.CudaKernel("mxtt_flash_bwd_dq",
                        [_P] * 8 + [_I] * 6 + [_F, _I, _P])
#: dk, dv, then as _DQ after dq
_DKV = _build.CudaKernel("mxtt_flash_bwd_dkv",
                         [_P] * 9 + [_I] * 6 + [_F, _I, _P])
#: the tensor-core route, arguments as _FWD's, _DQ's and _DKV's
_FWD_TC = _build.CudaKernel("mxtt_flash_fwd_tc", _FWD.argtypes)
_DQ_TC = _build.CudaKernel("mxtt_flash_bwd_dq_tc", _DQ.argtypes)
_DKV_TC = _build.CudaKernel("mxtt_flash_bwd_dkv_tc", _DKV.argtypes)

#: the head dims of the supported configs (llama_tiny; BERT-base,
#: BERT-large and transformer_base; Llama-3-8B)
HEAD_DIMS = (16, 64, 128)
#: the head dims the tensor-core kernels take, in bf16
TC_HEAD_DIMS = (64, 128)


def _route(q, simt, tensor_cores):
    """The kernel of q's route: the tensor-core one for bf16 at a head dim
    it takes, else the fp32 SIMT one (which keeps float32 and d = 16)."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS:
        return tensor_cores
    return simt


# -- plain versions ----------------------------------------------------------

def _scores(q, k, causal, scale, lengths):
    """fp32 scaled scores (B, H, T, S) with -inf where masked, and the
    GQA repeat factor."""
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    rep = H // K
    kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf.float()) * scale
    neg = float("-inf")
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, neg)
    if lengths is not None:
        keep = torch.arange(S, device=q.device)[None, :] \
            < lengths[:, None].long()
        s = s.masked_fill(~keep[:, None, None, :], neg)
    return s, rep


def _softmax_apply(s, v, rep, dtype):
    """softmax(s) @ V, (B, T, H, d) in `dtype`; rows with no valid key
    give 0. P is cast to v's dtype before P @ V, as the JAX reference
    does (flash_attention.py:61)."""
    vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s.amax(dim=-1, keepdim=True)), p, 0.0)
    return torch.einsum("bhts,bshd->bthd", p.to(vf.dtype), vf).to(dtype)


def reference_attention(q, k, v, causal=True, scale=None, lengths=None):
    """Exact softmax attention in fp32 scores (the forward kernel's
    plain version)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, rep = _scores(q, k, causal, scale, lengths)
    return _softmax_apply(s, v, rep, q.dtype)


def reference_attention_lse(q, k, v, causal=True, scale=None,
                            lengths=None):
    """The forward kernel's plain version with its statistics: (out,
    lse (B, H, T) fp32, +inf on a row with no valid key)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, rep = _scores(q, k, causal, scale, lengths)
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, float("inf"))
    return _softmax_apply(s, v, rep, q.dtype), lse


def attention_delta(out, dout):
    """delta = rowsum(dO * O) in fp32, (B, H, T), as the JAX backward
    computes it outside its kernels (flash_attention.py:392-396)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def _probs_and_ds(q, k, v, dout, lse, delta, causal, scale, lengths):
    """fp32 P = exp(s - lse) (0 where masked) and dS = P * (dO V^T -
    delta), (B, H, T, S) each, V repeated over the query heads."""
    s, rep = _scores(q, k, causal, scale, lengths)
    p = torch.exp(s - lse[..., None])
    vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    dp = torch.einsum("bthd,bshd->bhts", dout.float(), vf.float())
    return p, p * (dp - delta[..., None]), rep


def flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal=True, scale=None,
                     lengths=None):
    """dQ = scale * dS @ K in fp32, cast to q's dtype (dq_kernel)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds, rep = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale,
                               lengths)
    kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    dq = torch.einsum("bhts,bshd->bthd", ds, kf.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal=True, scale=None,
                      lengths=None):
    """(dK = scale * dS^T @ Q, dV = P^T @ dO), per query head in fp32,
    each group of rep query heads summed into its kv head in fp32, then
    cast to k's dtype (dkv_kernel; the group sum as the port's kernel
    takes it)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds, rep = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale,
                               lengths)
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, dout.float())
    return tuple(g.reshape(B, S, K, rep, d).sum(dim=3).to(k.dtype)
                 for g in (dk, dv))


# -- kernel wrappers ---------------------------------------------------------

def _check(q, k, v, lengths, extra=()):
    """Raise unless the operands are what the kernels take; returns
    (B, T, H, K, d, lengths), lengths made all-T when None."""
    dev = q.device
    _build.check_cuda_tensor(q, "q", dev, ndim=4, align16=True)
    for name, t in (("k", k), ("v", v)) + tuple(extra):
        _build.check_cuda_tensor(t, name, dev, dtypes=(q.dtype,), ndim=4,
                                 align16=True)
    B, T, H, d = q.shape
    K = k.shape[2]
    if k.shape != (B, T, K, d) or v.shape != k.shape or H % K:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, T, H, d) and "
                         f"(B, T, K, d) with H % K == 0")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                             f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    _build.check_cuda_tensor(lengths, "lengths", dev, dtypes=(torch.int32,),
                             ndim=1)
    if lengths.shape[0] != B:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, batch {B}")
    return B, T, H, K, d, lengths


def _check_stats(stats, B, H, T, dev):
    for name, t in stats:
        _build.check_cuda_tensor(t, name, dev, dtypes=(torch.float32,),
                                 ndim=3)
        if t.shape != (B, H, T):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                             f"{(B, H, T)}")


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_attention_forward(q, k, v, causal=True, scale=None, lengths=None,
                            return_lse=False):
    """Attention forward; `lengths` is an int32 (B,) tensor or None.
    With `return_lse`, also the (B, H, T) fp32 log-sum-exp the backward
    reads."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        if return_lse:
            return reference_attention_lse(q, k, v, causal, scale, lengths)
        return reference_attention(q, k, v, causal, scale, lengths)
    B, T, H, K, d, lengths = _check(q, k, v, lengths)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device) \
        if return_lse else None
    _build.launch(_route(q, _FWD, _FWD_TC), q.device, out.data_ptr(),
                  _build.ptr(lse), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), B, T, H, K, d, int(bool(causal)),
                  float(scale), _build.dtype_code(q))
    return (out, lse) if return_lse else out


def _backward_args(q, k, v, dout, lse, delta, lengths):
    B, T, H, K, d, lengths = _check(q, k, v, lengths, (("dout", dout),))
    _check_stats((("lse", lse), ("delta", delta)), B, H, T, q.device)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(), B, T, H,
            K, d)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=True, scale=None,
                 lengths=None):
    """dQ of attention from the forward's lse and delta (dq_kernel)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal, scale,
                                lengths)
    args = _backward_args(q, k, v, dout, lse, delta, lengths)
    dq = torch.empty_like(q)
    _build.launch(_route(q, _DQ, _DQ_TC), q.device, dq.data_ptr(), *args,
                  int(bool(causal)), float(scale), _build.dtype_code(q))
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal=True, scale=None,
                  lengths=None):
    """(dK, dV) of attention from the forward's lse and delta
    (dkv_kernel), GQA groups summed in fp32."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal, scale,
                                 lengths)
    args = _backward_args(q, k, v, dout, lse, delta, lengths)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(_route(q, _DKV, _DKV_TC), q.device, dk.data_ptr(),
                  dv.data_ptr(), *args, int(bool(causal)), float(scale),
                  _build.dtype_code(q))
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its backward (the JAX package's `_flash_pallas`
    custom_vjp): the forward saves (q, k, v, out, lse, lengths); the
    backward computes delta in fp32, casts dO to q's dtype and calls
    the dq and dkv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, lengths):
        out, lse = flash_attention_forward(q, k, v, causal, scale, lengths,
                                           return_lse=True)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        delta = attention_delta(out, dout)
        dout = dout.to(q.dtype).contiguous()
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal,
                              ctx.scale, lengths)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                                   ctx.scale, lengths)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, lengths=None):
    """Attention forward, differentiable through FlashAttentionFunction
    where autograd needs it; without a gradient one forward launch that
    writes no lse."""
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, lengths)
    return flash_attention_forward(q, k, v, causal, scale, lengths)
