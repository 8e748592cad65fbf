"""Single-source Llama layer math (counterpart of
`mxnet_tpu/models/llama_math.py`).

RMSNorm, RoPE, GQA attention, SwiGLU and the residual wiring live here;
the full forward (`llama.LlamaForCausalLM.forward`) and the serving
prefill and decode tick (`serving/executables.py`) all call these, so
they cannot drift apart. Functions take (B, T, ...) tensors and a layer
param dict `lp` with {ln1, wq, wk, wv, wo, ln2, gate, up, down} in the
dense convention y = x @ W.T. RMSNorm and attention dispatch to the CUDA
kernels on the card and to their plain versions on the CPU, through
their autograd Functions (`RMSNormFunction`, `FlashAttentionFunction`)
where a gradient is needed, so the training forward and the serving
programs run the same math; the large projections stay `F.linear`
(cuBLAS), as the JAX package left them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.fused_norm import rmsnorm

__all__ = ["rms", "rope_at", "layer_qkv", "swiglu", "layer_finish",
           "decoder_layer", "final_logits"]


def rms(x, g, eps):
    """RMSNorm with fp32 statistics, output in x.dtype. Callers pass the
    config's `rms_eps`."""
    return rmsnorm(x, g, eps)


def rope_at(x, positions, base):
    """Rotary embedding of (B, T, H, d) at absolute `positions` ((T,) or
    (B, T)): the first half of d rotates against the second half (not
    interleaved pairs), angles and rotation in fp32, output in x.dtype."""
    d = x.shape[-1]
    half = d // 2
    inv = base ** (-torch.arange(0, half, dtype=torch.float32,
                                 device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None] * inv                       # (B, T, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def layer_qkv(lp, x, positions, eps, base, H, K, d):
    """RMSNorm -> q/k/v projections -> RoPE. Returns q (B, T, H, d) and
    k, v (B, T, K, d), k after RoPE: the rows the KV cache stores."""
    B, T, _ = x.shape
    h = rms(x, lp["ln1"], eps)
    q = F.linear(h, lp["wq"]).reshape(B, T, H, d)
    k = F.linear(h, lp["wk"]).reshape(B, T, K, d)
    v = F.linear(h, lp["wv"]).reshape(B, T, K, d)
    return rope_at(q, positions, base), rope_at(k, positions, base), v


def swiglu(h, w_gate, w_up, w_down):
    return F.linear(F.silu(F.linear(h, w_gate)) * F.linear(h, w_up), w_down)


def layer_finish(lp, x, att, eps):
    """o-projection residual, RMSNorm, SwiGLU residual. att (B, T, H, d)."""
    B, T, _ = x.shape
    x = x + F.linear(att.reshape(B, T, -1), lp["wo"])
    return x + swiglu(rms(x, lp["ln2"], eps), lp["gate"], lp["up"],
                      lp["down"])


def decoder_layer(lp, x, positions, eps, base, H, K, d, lengths=None,
                  return_kv=False):
    """One decoder layer on (B, T, D): causal GQA attention with
    optional int32 `lengths` (B,) masking keys at or past lengths[b].
    The prefill passes return_kv=True to harvest the cache rows."""
    q, k, v = layer_qkv(lp, x, positions, eps, base, H, K, d)
    att = flash_attention(q, k, v, causal=True, scale=1.0 / math.sqrt(d),
                          lengths=lengths)
    out = layer_finish(lp, x, att, eps)
    return (out, k, v) if return_kv else out


def final_logits(params, x, eps):
    """Closing RMSNorm + LM head over (B, T, D)."""
    return F.linear(rms(x, params["norm"], eps), params["head"])
