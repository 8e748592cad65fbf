"""The weight bridge from the JAX package: `load_jax_params` fills any
port net from the JAX net's parameters by name (Llama, BERT and the
Transformer keep the JAX package's parameter names and layouts)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params"]


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
