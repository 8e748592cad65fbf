"""BERT (counterpart of `mxnet_tpu/models/bert.py`; reference: gluon-nlp
bert.py): the encoder and the MLM + NSP pretraining heads.

The modules keep the JAX package's parameter names
(`bert.word_embed.weight`, `bert.layer0.attention.query_proj.weight`,
`bert.layer0.norm1.gamma`, `mlm_decoder.weight`, ...) so weights move
across by name (`load_jax_params`). `valid_length` reaches every layer
as int32 key-padding `lengths`, so self-attention takes the port's flash
kernels (non-causal) and no (B, T, T) mask is built; every LayerNorm
takes the port's LayerNorm kernels; GELU is the tanh form (`Dense`).
Built nets start in eval mode: dropout is active only after
`net.train()`, which `FusedTrainStep` sets for its forward.
"""
from __future__ import annotations

import torch
from torch import nn

from ..context import resolve_device
from ..gluon.nn import Dense, Embedding, LayerNorm, initialize
from . import register_model
from .transformer import (MultiHeadAttention, _dropout_generator,
                          _maybe_dropout)

__all__ = ["BERTEncoderLayer", "BERTModel", "BERTForPretraining",
           "bert_base", "bert_large", "bert_tiny"]


class BERTEncoderLayer(nn.Module):
    def __init__(self, units, hidden_size, num_heads, dropout,
                 generator=None):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            generator=generator)
        self.norm1 = LayerNorm(units)
        self.ffn1 = Dense(hidden_size, units, flatten=False,
                          activation="gelu")
        self.ffn2 = Dense(units, hidden_size, flatten=False)
        self.dropout = _maybe_dropout(dropout, generator)
        self.norm2 = LayerNorm(units)

    def forward(self, x, mask=None, lengths=None):
        x = self.norm1(x + self.attention(x, x, x, mask, lengths))
        out = self.ffn2(self.ffn1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        return self.norm2(x + out)


class BERTModel(nn.Module):
    """Encoder trunk: token + segment + position embeddings, N layers and
    the pooler over token 0. Dropout draws from `generator`."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_types=2, dropout=0.1, generator=None):
        super().__init__()
        self._units = units
        self.word_embed = Embedding(vocab_size, units)
        self.token_type_embed = Embedding(token_types, units)
        self.position_embed = Embedding(max_length, units)
        self.embed_norm = LayerNorm(units)
        self.embed_dropout = _maybe_dropout(dropout, generator)
        self._layers = []
        for i in range(num_layers):
            layer = BERTEncoderLayer(units, hidden_size, num_heads, dropout,
                                     generator)
            self.add_module(f"layer{i}", layer)
            self._layers.append(layer)
        self.pooler = Dense(units, units, activation="tanh")

    def forward(self, input_ids, token_types=None, valid_length=None):
        """(B, T) ids -> (sequence (B, T, units), pooled (B, units));
        `valid_length` (B,) masks keys at or past it in every layer."""
        B, T = input_ids.shape
        pos = torch.arange(T, device=input_ids.device).expand(B, T)
        x = self.word_embed(input_ids) + self.position_embed(pos)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_norm(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        lengths = None
        if valid_length is not None:
            lengths = valid_length.reshape(-1).to(torch.int32).contiguous()
        for layer in self._layers:
            x = layer(x, None, lengths)
        pooled = self.pooler(x[:, 0])
        return x, pooled


class BERTForPretraining(nn.Module):
    """The MLM and NSP heads over `BERTModel`. Weights are allocated on
    `device` (default `cuda`) and drawn from a generator seeded with
    `seed` (`gluon.nn.initialize`); dropout draws from
    `dropout_generator` (default: a generator on the device seeded with
    `seed`)."""

    def __init__(self, vocab_size=30522, units=768, device=None, seed=0,
                 dropout_generator=None, **bert_kw):
        super().__init__()
        dev = resolve_device(device)
        gen = _dropout_generator(dev, seed, dropout_generator)
        self.bert = BERTModel(vocab_size=vocab_size, units=units,
                              generator=gen, **bert_kw)
        self.mlm_dense = Dense(units, units, flatten=False,
                               activation="gelu")
        self.mlm_norm = LayerNorm(units)
        self.mlm_decoder = Dense(vocab_size, units, flatten=False)
        self.nsp_classifier = Dense(2, units)
        initialize(self, dev, seed)
        self.eval()

    def forward(self, input_ids, token_types=None, valid_length=None):
        """(MLM logits (B, T, vocab), NSP logits (B, 2))."""
        seq, pooled = self.bert(input_ids, token_types, valid_length)
        mlm = self.mlm_decoder(self.mlm_norm(self.mlm_dense(seq)))
        return mlm, self.nsp_classifier(pooled)


@register_model("bert_base")
def bert_base(vocab_size=30522, **kw):
    return BERTForPretraining(vocab_size=vocab_size, units=768,
                              hidden_size=3072, num_layers=12,
                              num_heads=12, **kw)


@register_model("bert_large")
def bert_large(vocab_size=30522, **kw):
    return BERTForPretraining(vocab_size=vocab_size, units=1024,
                              hidden_size=4096, num_layers=24,
                              num_heads=16, **kw)


@register_model("bert_tiny")
def bert_tiny(vocab_size=128, **kw):
    return BERTForPretraining(vocab_size=vocab_size, units=32,
                              hidden_size=64, num_layers=2, num_heads=4,
                              max_length=64, **kw)
