"""Core layers (counterpart of `mxnet_tpu/gluon/nn/basic_layers.py`):
`Dense`, `Embedding`, `LayerNorm` and `Dropout` as `nn.Module`s, with the
JAX package's parameter names (`weight`, `bias`, `gamma`, `beta`) and
layouts, float32 like its default-dtype parameters.

Parameters are created on the `meta` device; `initialize(net, device,
seed)` allocates them and fills them from a seeded generator, as
`Block.initialize` does there. The JAX layers infer `in_units` and
`in_channels` at the first forward; these take them at construction.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...context import resolve_device
from ...kernels import fused_norm

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout", "initialize",
           "INIT_STD"]

#: std of the random normal initial weights of every port net
#: (`mx.init.Normal(0.02)`, the BERT benchmark's initializer); biases and
#: shifts start at 0, gains at 1
INIT_STD = 0.02

#: `nd.Activation`'s table for the activations the ported models use;
#: "gelu" there is `jax.nn.gelu` with its default approximate=True, the
#: tanh form (the exact erf form is `LeakyReLU(act_type="gelu")`'s)
_ACTIVATIONS = {"relu": F.relu, "tanh": torch.tanh,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}


def _param(*shape):
    return nn.Parameter(torch.empty(*shape, device="meta"))


class Dense(nn.Module):
    """Fully connected: y = act(x @ W.T + b), weight (units, in_units).
    With `flatten`, an input of more than two dimensions is reshaped to
    (B, -1) first (`nd.FullyConnected`). Operands of two float dtypes
    are promoted to the wider one, as jnp.matmul does."""

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 flatten=True):
        super().__init__()
        if activation is not None and activation not in _ACTIVATIONS:
            raise NotImplementedError(
                f"activation {activation!r} is not ported (have "
                f"{sorted(_ACTIVATIONS)})")
        self._flatten = flatten
        self._act = _ACTIVATIONS[activation] if activation else None
        self.weight = _param(units, in_units)
        self.bias = _param(units) if use_bias else None

    def forward(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        w, b = self.weight, self.bias
        dt = torch.promote_types(x.dtype, w.dtype)
        if b is not None:
            dt = torch.promote_types(dt, b.dtype)
            b = b.to(dt)
        out = F.linear(x.to(dt), w.to(dt), b)
        return self._act(out) if self._act is not None else out


class Embedding(nn.Module):
    """Row gather from weight (input_dim, output_dim); indices are
    clipped into range (`nd.Embedding`)."""

    def __init__(self, input_dim, output_dim):
        super().__init__()
        self.weight = _param(input_dim, output_dim)

    def forward(self, idx):
        return F.embedding(idx.long().clamp(0, self.weight.shape[0] - 1),
                           self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis through the port's kernels
    (`kernels.fused_norm.layernorm`): float32 gamma and beta
    (in_channels,)."""

    def __init__(self, in_channels, epsilon=1e-5):
        super().__init__()
        self._eps = epsilon
        self.gamma = _param(in_channels)
        self.beta = _param(in_channels)

    def forward(self, x):
        return fused_norm.layernorm(x.contiguous(), self.gamma, self.beta,
                                    self._eps)


class Dropout(nn.Module):
    """Inverted dropout, active only in training mode: each element is
    kept with probability 1 - rate and scaled by 1 / (1 - rate). The
    uniform draws come in fp32 from `generator`, the caller's
    `torch.Generator` on the input's device (no global RNG state), so
    nets of two dtypes draw the same masks from the same generator
    state."""

    def __init__(self, rate, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode draws from an "
                               "explicit torch.Generator; none was given")
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < 1.0 - self.rate, x / (1.0 - self.rate), 0.0)


def initialize(net: nn.Module, device=None, seed: int = 0) -> nn.Module:
    """Allocate `net`'s parameters on `device` (default `cuda`) and fill
    them from a generator seeded with `seed`: gains (`gamma`) 1, shifts
    and biases (`beta`, `bias`) 0, every other weight normal with std
    INIT_STD."""
    dev = resolve_device(device)
    net.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1.0)
            elif leaf in ("beta", "bias"):
                p.zero_()
            else:
                p.normal_(0.0, INIT_STD, generator=gen)
    return net
