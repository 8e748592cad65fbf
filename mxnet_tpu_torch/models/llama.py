"""Llama-3-style decoder (counterpart of `mxnet_tpu/models/llama.py`):
RMSNorm + RoPE + GQA + SwiGLU.

The modules are parameter containers whose parameter names are the JAX
package's (`model.layers.{i}.self_attn.q_proj.weight`, ...), so weights
move across by name (`load_jax_params`). Dense weights are (out, in):
y = x @ W.T, `nn.Linear`'s layout. The math is `llama_math`'s, shared
with the serving prefill and decode tick.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..context import resolve_device
from . import llama_math, register_model
from .llama_infer import _params_tree

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_3_8b", "load_jax_params"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: std of the random normal initial weights (norm gains start at 1)
INIT_STD = 0.02


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=14336, num_layers=32, num_heads=32,
                 num_kv_heads=8, max_seq_len=8192, rope_base=500000.0,
                 rms_eps=1e-5, dtype="bfloat16"):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {sorted(_DTYPES)}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = hidden_size // num_heads
        self.max_seq_len = max_seq_len
        self.rope_base = rope_base
        self.rms_eps = rms_eps
        self.dtype = dtype

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _dense(units, in_units, cfg):
    return nn.Linear(in_units, units, bias=False, dtype=cfg.torch_dtype,
                     device="meta")


class RMSNorm(nn.Module):
    """Gain-only norm (its eps is the config's `rms_eps`); the gain is
    float32 like the JAX package's default-dtype `gamma`, whatever the
    model dtype."""

    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, device="meta"))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        D, H, K, d = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)
        self.q_proj = _dense(H * d, D, cfg)
        self.k_proj = _dense(K * d, D, cfg)
        self.v_proj = _dense(K * d, D, cfg)
        self.o_proj = _dense(D, H * d, cfg)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _dense(I, D, cfg)
        self.up_proj = _dense(I, D, cfg)
        self.down_proj = _dense(D, I, cfg)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        self.mlp = LlamaMLP(cfg)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=cfg.torch_dtype,
                                         device="meta")
        self.layers = nn.ModuleList(LlamaLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size)


class LlamaForCausalLM(nn.Module):
    """The decoder plus LM head. Weights are allocated on `device`
    (default `cuda`) and drawn from a generator seeded with `seed`:
    normal with std INIT_STD, norm gains 1."""

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        self.model = LlamaModel(cfg)
        self.lm_head = _dense(cfg.vocab_size, cfg.hidden_size, cfg)
        dev = resolve_device(device)
        self.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".gamma"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, INIT_STD, generator=gen)

    @property
    def cfg(self) -> LlamaConfig:
        return self.model.cfg

    def forward(self, input_ids, lengths=None):
        """(B, T) token ids -> (B, T, V) logits; int32 `lengths` (B,)
        masks keys at or past lengths[b]."""
        cfg = self.cfg
        params = _params_tree(self)
        T = input_ids.shape[1]
        positions = torch.arange(T, device=input_ids.device)
        x = params["embed"][input_ids]
        for lp in params["layers"]:
            x = llama_math.decoder_layer(
                lp, x, positions, cfg.rms_eps, cfg.rope_base, cfg.num_heads,
                cfg.num_kv_heads, cfg.head_dim, lengths=lengths)
        return llama_math.final_logits(params, x, cfg.rms_eps)


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes: torch reads it as raw bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_jax_params(net: nn.Module, params: dict):
    """Fill `net` from the JAX net's `{name: p.data().asnumpy()}`. Every
    name must match both ways, and every shape and dtype must agree."""
    own = dict(net.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in own.items():
            t = _to_torch(params[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            if t.dtype != p.dtype:
                raise TypeError(f"{name}: dtype {t.dtype} != {p.dtype}")
            p.copy_(t)


@register_model("llama_tiny")
def llama_tiny(device=None, **kw):
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      max_seq_len=128, dtype="float32", **kw)
    return LlamaForCausalLM(cfg, device=device)


@register_model("llama_3_8b")
def llama_3_8b(device=None, **kw):
    return LlamaForCausalLM(LlamaConfig(**kw), device=device)
