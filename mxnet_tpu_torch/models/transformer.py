"""Transformer encoder-decoder for machine translation (counterpart of
`mxnet_tpu/models/transformer.py`; reference: gluon-nlp, Vaswani base).

The modules keep the JAX package's parameter names
(`encoder.layer0.attention.query_proj.weight`, `decoder.proj.bias`, ...)
so weights move across by name (`load_jax_params`). `MultiHeadAttention`
routes as the JAX block does: self-attention with key-padding `lengths`,
no mask and T == S goes to the port's `flash_attention(causal=False,
lengths=...)` (the CUDA kernels on the card, their plain versions on the
CPU); cross-attention with `lengths` builds the boolean mask; everything
else, every attention of the Transformer itself included (its encoder
and decoder always pass a mask), goes to `full_attention`. The JAX route
also needs T % 128 == 0 before it takes its Pallas kernel: that is the
TPU's tiling, and the port's kernel takes any T and computes the same
function, so the port has no such gate.

Positional encodings are fp32 constants added to the scaled embeddings,
so a net whose weights are bf16 carries fp32 activations from there on,
as in the JAX package (a bf16 + fp32 sum is fp32 in both, and `Dense`
promotes its operands). Built nets start in eval mode: dropout is active
only after `net.train()`, which `FusedTrainStep` sets for its forward.
`beam_search_translate` is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..context import resolve_device
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm, initialize
from ..kernels import flash_attention as fa
from . import register_model

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "EncoderLayer",
           "DecoderLayer", "TransformerEncoder", "TransformerDecoder",
           "TransformerMT", "full_attention", "transformer_base",
           "transformer_tiny"]


def _positional_encoding(T, D):
    """(T, D) fp32 sinusoidal encodings (the JAX package's own table)."""
    pos = np.arange(T)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / D)
    pe = np.zeros((T, D), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def full_attention(q, k, v, mask=None, scale=None):
    """(B, T, H, d) x (B, S, H, d) -> (B, T, H, d): softmax attention in
    fp32 scores; `mask` (T, S) or (B, T, S), nonzero or True = keep,
    masked scores set to -1e30; P is cast to v's dtype before P @ V
    (transformer.py:38-58 of the JAX package)."""
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        * (scale or 1.0 / math.sqrt(d))
    if mask is not None:
        mm = mask.bool()
        if mm.dim() == 2:
            mm = mm[None, None]
        elif mm.dim() == 3:
            mm = mm[:, None]
        s = torch.where(mm, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v).to(q.dtype)


def _key_mask(valid_len, B, T, S, device):
    """(B, T, S) boolean mask keeping keys s < valid_len[b]."""
    keep = torch.arange(S, device=device)[None, :] < valid_len.reshape(-1, 1)
    return keep.reshape(B, 1, S).expand(B, T, S)


def _maybe_dropout(rate, generator):
    return Dropout(rate, generator) if rate else None


class MultiHeadAttention(nn.Module):
    """Projections, attention routed as the module docstring says, the
    output projection and dropout (reference: gluon-nlp
    MultiHeadAttentionCell)."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 generator=None):
        super().__init__()
        self._units = units
        self._heads = num_heads
        for name in ("query_proj", "key_proj", "value_proj", "out_proj"):
            setattr(self, name, Dense(units, units, use_bias=use_bias,
                                      flatten=False))
        self.dropout = _maybe_dropout(dropout, generator)

    def forward(self, query, key, value, mask=None, lengths=None):
        B, T, _ = query.shape
        S = key.shape[1]
        H = self._heads
        d = self._units // H
        q = self.query_proj(query).reshape(B, T, H, d)
        k = self.key_proj(key).reshape(B, S, H, d)
        v = self.value_proj(value).reshape(B, S, H, d)
        if lengths is not None and mask is None and T == S:
            # key padding by lengths: the kernel masks natively, no
            # (B, T, S) mask is built
            out = fa.flash_attention(q, k, v, causal=False, lengths=lengths)
        else:
            if lengths is not None and mask is None:
                # cross-attention: the key padding becomes a boolean mask
                mask = _key_mask(lengths, B, T, S, query.device)
            out = full_attention(q, k, v, mask)
        out = self.out_proj(out.reshape(B, T, self._units))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(nn.Module):
    def __init__(self, units, hidden_size, dropout=0.0, activation="relu",
                 generator=None):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, units, flatten=False,
                           activation=activation)
        self.ffn_2 = Dense(units, hidden_size, flatten=False)
        self.dropout = _maybe_dropout(dropout, generator)
        self.layer_norm = LayerNorm(units)

    def forward(self, x):
        out = self.ffn_2(self.ffn_1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        return self.layer_norm(out + x)


class EncoderLayer(nn.Module):
    def __init__(self, units, hidden_size, num_heads, dropout,
                 generator=None):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            generator=generator)
        self.norm1 = LayerNorm(units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   generator=generator)

    def forward(self, x, mask=None):
        x = self.norm1(x + self.attention(x, x, x, mask))
        return self.ffn(x)


class DecoderLayer(nn.Module):
    def __init__(self, units, hidden_size, num_heads, dropout,
                 generator=None):
        super().__init__()
        self.self_attention = MultiHeadAttention(units, num_heads, dropout,
                                                 generator=generator)
        self.norm1 = LayerNorm(units)
        self.cross_attention = MultiHeadAttention(units, num_heads, dropout,
                                                  generator=generator)
        self.norm2 = LayerNorm(units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   generator=generator)

    def forward(self, x, mem, self_mask, mem_mask=None):
        x = self.norm1(x + self.self_attention(x, x, x, self_mask))
        x = self.norm2(x + self.cross_attention(x, mem, mem, mem_mask))
        return self.ffn(x)


def _embed_positions(module, ids):
    """Scaled token embeddings plus the fp32 positional encodings, then
    dropout: (B, T, units)."""
    units = module._units
    x = module.embed(ids) * math.sqrt(units)
    pe = torch.from_numpy(_positional_encoding(ids.shape[1], units))
    x = x + pe.to(x.device)
    return module.dropout(x) if module.dropout is not None else x


class TransformerEncoder(nn.Module):
    def __init__(self, vocab_size, units=512, hidden_size=2048,
                 num_layers=6, num_heads=8, dropout=0.1, max_len=512,
                 generator=None):
        super().__init__()
        self._units = units
        self._max_len = max_len
        self.embed = Embedding(vocab_size, units)
        self.dropout = _maybe_dropout(dropout, generator)
        self._layers = []
        for i in range(num_layers):
            layer = EncoderLayer(units, hidden_size, num_heads, dropout,
                                 generator)
            self.add_module(f"layer{i}", layer)
            self._layers.append(layer)
        self.norm = LayerNorm(units)

    def forward(self, src, src_valid_len=None):
        B, T = src.shape
        x = _embed_positions(self, src)
        mask = None
        if src_valid_len is not None:
            mask = _key_mask(src_valid_len, B, T, T, src.device)
        for layer in self._layers:
            x = layer(x, mask)
        return self.norm(x)


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size, units=512, hidden_size=2048,
                 num_layers=6, num_heads=8, dropout=0.1, max_len=512,
                 generator=None):
        super().__init__()
        self._units = units
        self.embed = Embedding(vocab_size, units)
        self.dropout = _maybe_dropout(dropout, generator)
        self._layers = []
        for i in range(num_layers):
            layer = DecoderLayer(units, hidden_size, num_heads, dropout,
                                 generator)
            self.add_module(f"layer{i}", layer)
            self._layers.append(layer)
        self.norm = LayerNorm(units)
        self.proj = Dense(vocab_size, units, flatten=False)

    def forward(self, tgt, memory, src_valid_len=None):
        B, T = tgt.shape
        x = _embed_positions(self, tgt)
        causal = torch.ones(T, T, dtype=torch.bool, device=tgt.device).tril()
        mem_mask = None
        if src_valid_len is not None:
            mem_mask = _key_mask(src_valid_len, B, T, memory.shape[1],
                                 tgt.device)
        for layer in self._layers:
            x = layer(x, memory, causal, mem_mask)
        return self.proj(self.norm(x))


def _dropout_generator(device, seed, generator=None):
    """The generator a net's Dropout layers draw from: `generator` when
    the caller passes one, else a new one on `device` seeded with
    `seed`."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


class TransformerMT(nn.Module):
    """The seq2seq model (reference: gluon-nlp machine_translation). Its
    weights are allocated on `device` (default `cuda`) and drawn from a
    generator seeded with `seed` (`gluon.nn.initialize`); dropout draws
    from `dropout_generator` (default: a generator on the device seeded
    with `seed`)."""

    def __init__(self, src_vocab, tgt_vocab, units=512, hidden_size=2048,
                 num_layers=6, num_heads=8, dropout=0.1, device=None,
                 seed=0, dropout_generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = _dropout_generator(dev, seed, dropout_generator)
        self.encoder = TransformerEncoder(src_vocab, units, hidden_size,
                                          num_layers, num_heads, dropout,
                                          generator=gen)
        self.decoder = TransformerDecoder(tgt_vocab, units, hidden_size,
                                          num_layers, num_heads, dropout,
                                          generator=gen)
        initialize(self, dev, seed)
        self.eval()

    def forward(self, src, tgt, src_valid_len=None):
        memory = self.encoder(src, src_valid_len)
        return self.decoder(tgt, memory, src_valid_len)


@register_model("transformer_base")
def transformer_base(src_vocab=32000, tgt_vocab=32000, **kw):
    return TransformerMT(src_vocab, tgt_vocab, units=512, hidden_size=2048,
                         num_layers=6, num_heads=8, dropout=0.1, **kw)


@register_model("transformer_tiny")
def transformer_tiny(src_vocab=100, tgt_vocab=100, **kw):
    return TransformerMT(src_vocab, tgt_vocab, units=32, hidden_size=64,
                         num_layers=2, num_heads=4, dropout=0.1, **kw)
