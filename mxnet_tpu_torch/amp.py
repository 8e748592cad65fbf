"""Mixed precision (counterpart of `mxnet_tpu/amp.py`): `convert_block`
so far. bf16 needs no loss scaling; the fp16 `DynamicLossScaler` and the
process-wide policy (`init`, `init_trainer`) are not ported yet (ROADMAP
A10, second part).
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["convert_block"]

#: parameter leaves that stay float32 (norm gains, shifts and statistics)
KEEP_FP32 = ("gamma", "beta", "running_mean", "running_var")


def convert_block(net: nn.Module, target_dtype=torch.bfloat16) -> nn.Module:
    """Cast every float parameter of `net` to `target_dtype` in place,
    except those whose last name component is in KEEP_FP32, as the JAX
    package's `convert_block` does (amp.py:43-54 there)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if not p.is_floating_point():
                continue
            if name.rsplit(".", 1)[-1] in KEEP_FP32:
                continue
            p.data = p.data.to(target_dtype)
    return net
