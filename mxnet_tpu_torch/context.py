"""Device resolution for the port's entry points.

Counterpart of `mxnet_tpu/context.py`. The port runs on the CUDA card:
`device=None` means `cuda`, and a machine without CUDA is an error, not
a quiet move to the CPU. The CPU runs only when the caller asks for it
(`device="cpu"`, as the tests do), and then every kernel wrapper takes
its plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_weights_on"]


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; `"cpu"` and `"cuda[:i]"` as given. Raises when
    CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "and drops to the CPU only when asked (device='cpu')")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def check_weights_on(net, device: torch.device):
    """Raise unless `net`'s weights live on `device` (a resolved device;
    `cuda` without an index matches any card)."""
    wdev = next(net.parameters()).device
    if wdev.type != device.type or (
            device.index is not None and wdev != device):
        raise ValueError(f"the net's weights are on {wdev}, the entry point "
                         f"runs on {device}")
