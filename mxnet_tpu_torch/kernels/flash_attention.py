"""Causal, key-length-masked GQA attention forward: the CUDA prefill
kernel (`csrc/flash_prefill.cu`) and its plain PyTorch version.

Counterpart of `mxnet_tpu/kernels/flash_attention.py`
(`flash_attention_raw`, the `_pallas_forward` kernel). Layout: q
(B, T, H, d), k/v (B, T, K, d) with H % K == 0, out (B, T, H, d).
`lengths` (B,) masks key positions >= lengths[b]. A CPU tensor takes
`reference_attention`; a CUDA tensor launches the kernel (any T,
d in {16, 128}, float32 or bfloat16) or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_forward", "reference_attention"]

_KERNEL = _build.CudaKernel("mxtt_flash_prefill", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p])

#: the head dims of the supported configs (llama_tiny, Llama-3-8B)
HEAD_DIMS = (16, 128)


def reference_attention(q, k, v, causal=True, scale=None, lengths=None):
    """Exact softmax attention in fp32 scores; rows with no valid key
    give 0. P is cast to v's dtype before P @ V, as the JAX reference
    does (flash_attention.py:61)."""
    B, T, H, d = q.shape
    K = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep = H // K
    kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf.float()) * scale
    neg = float("-inf")
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, neg)
    if lengths is not None:
        keep = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
        s = s.masked_fill(~keep[:, None, None, :], neg)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s.amax(dim=-1, keepdim=True)), p, 0.0)
    out = torch.einsum("bhts,bshd->bthd", p.to(vf.dtype), vf)
    return out.to(q.dtype)


def flash_attention_forward(q, k, v, causal=True, scale=None,
                            lengths=None):
    """Attention forward; `lengths` is an int32 (B,) tensor or None."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, scale, lengths)
    dev = q.device
    _build.check_cuda_tensor(q, "q", dev, ndim=4, align16=True)
    for name, t in (("k", k), ("v", v)):
        _build.check_cuda_tensor(t, name, dev, dtypes=(q.dtype,), ndim=4,
                                 align16=True)
    B, T, H, d = q.shape
    K = k.shape[2]
    if k.shape != (B, T, K, d) or v.shape != k.shape or H % K:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, T, H, d) and "
                         f"(B, T, K, d) with H % K == 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    _build.check_cuda_tensor(lengths, "lengths", dev, dtypes=(torch.int32,),
                             ndim=1)
    if lengths.shape[0] != B:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, batch {B}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        _KERNEL(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), B, T, H, K, d, int(bool(causal)),
                float(scale), _build.dtype_code(q),
                _build.stream_handle(dev))
    return out
