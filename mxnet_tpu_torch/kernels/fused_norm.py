"""RMSNorm over the trailing axis: the CUDA kernel (`csrc/rmsnorm.cu`)
and its plain PyTorch version.

Counterpart of `mxnet_tpu/kernels/fused_norm.py` (`fused_rmsnorm`, the
`_rms_fwd_kernel` Pallas kernel). Statistics in fp32, output in x's
dtype. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rmsnorm", "rmsnorm_ref"]

_KERNEL = _build.CudaKernel("mxtt_rmsnorm", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    """x * rsqrt(mean(x^2) + eps) * gamma in fp32, cast to x.dtype."""
    xs = x.float()
    ms = xs.square().mean(dim=-1, keepdim=True)
    return (xs * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    """RMSNorm over the trailing axis of x (..., D) with a float32 gain
    (D,), as the model keeps its norm gains."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    _build.check_cuda_tensor(x, "x", x.device)
    _build.check_cuda_tensor(gamma, "gamma", x.device,
                             dtypes=(torch.float32,), ndim=1)
    D = x.shape[-1]
    if gamma.shape[0] != D:
        raise ValueError(f"gamma has {gamma.shape[0]} entries for rows of {D}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _KERNEL(out.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                x.numel() // D if D else 0, D, float(eps),
                _build.dtype_code(x), _build.stream_handle(x.device))
    return out
