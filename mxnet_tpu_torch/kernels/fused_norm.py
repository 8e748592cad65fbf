"""RMSNorm over the trailing axis, forward and backward: the CUDA kernels
(`csrc/rmsnorm.cu`) and their plain PyTorch versions.

Counterpart of `mxnet_tpu/kernels/fused_norm.py` (`fused_rmsnorm`, the
`_rms_fwd_kernel` and `_rms_bwd_kernel` Pallas kernels and their
`custom_vjp`). Statistics in fp32, outputs in x's dtype, float32 gains.

    rmsnorm_fwd(x, gamma, eps, with_rrms) -> (out, rrms (rows,) or None)
    rmsnorm_dx(x, gamma, rrms, dy)        -> dx, x's dtype
    rmsnorm(x, gamma, eps)                -> out, differentiable

`rmsnorm` goes through `RMSNormFunction` when autograd needs a gradient
and straight to the forward (no rrms written) otherwise. A CPU tensor
takes the plain versions; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rmsnorm", "rmsnorm_ref", "rmsnorm_fwd", "rmsnorm_fwd_ref",
           "rmsnorm_dx", "rmsnorm_dx_ref", "RMSNormFunction"]

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
#: out, rrms (may be NULL), x, gamma, rows, dim, eps, dtype, stream
_FWD = _build.CudaKernel("mxtt_rmsnorm", [_P] * 4 + [_I64, _I, _F, _I, _P])
#: dx, x, gamma, rrms, dy, rows, dim, dtype, stream
_DX = _build.CudaKernel("mxtt_rmsnorm_dx", [_P] * 5 + [_I64, _I, _I, _P])


# -- plain versions -----------------------------------------------------------

def rmsnorm_fwd_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    """(x * rrms * gamma in fp32 cast to x.dtype, rrms (rows,) fp32)
    with rrms = rsqrt(mean(x^2) + eps) over the trailing axis."""
    xs = x.float()
    rrms = torch.rsqrt(xs.square().mean(dim=-1, keepdim=True) + eps)
    return (xs * rrms * gamma.float()).to(x.dtype), rrms.reshape(-1)


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    """The forward's output alone."""
    return rmsnorm_fwd_ref(x, gamma, eps)[0]


def rmsnorm_dx_ref(x, gamma, rrms, dy):
    """dx = rrms * (gamma * dy - x * mean(gamma * dy * x) * rrms^2) in
    fp32, cast to x.dtype (fused_norm.py:72-81 of the JAX package); x
    and dy (..., D), rrms one entry per row."""
    D = x.shape[-1]
    xs = x.reshape(-1, D).float()
    r = rrms.reshape(-1, 1).float()
    wdy = dy.reshape(-1, D).float() * gamma.float()
    corr = (wdy * xs).mean(dim=-1, keepdim=True) * r * r
    return (r * (wdy - xs * corr)).to(x.dtype).reshape(x.shape)


# -- kernel wrappers ----------------------------------------------------------

def _check_rows(x, gamma, device):
    _build.check_cuda_tensor(x, "x", device)
    _build.check_cuda_tensor(gamma, "gamma", device, dtypes=(torch.float32,),
                             ndim=1)
    D = x.shape[-1]
    if gamma.shape[0] != D:
        raise ValueError(f"gamma has {gamma.shape[0]} entries for rows of {D}")
    return x.numel() // D if D else 0, D


def rmsnorm_fwd(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                with_rrms: bool = True):
    """RMSNorm over the trailing axis of x (..., D) with a float32 gain
    (D,): (out, rrms (rows,) fp32, or None without `with_rrms`)."""
    if x.device.type == "cpu":
        out, rrms = rmsnorm_fwd_ref(x, gamma, eps)
        return out, rrms if with_rrms else None
    rows, D = _check_rows(x, gamma, x.device)
    out = torch.empty_like(x)
    rrms = torch.empty(rows, dtype=torch.float32, device=x.device) \
        if with_rrms else None
    _build.launch(_FWD, x.device, out.data_ptr(), _build.ptr(rrms),
                  x.data_ptr(), gamma.data_ptr(), rows, D, float(eps),
                  _build.dtype_code(x))
    return out, rrms


def rmsnorm_dx(x, gamma, rrms, dy):
    """The input gradient of RMSNorm from the forward's rrms: x and dy
    (..., D) of one dtype, gamma (D,) and rrms (rows,) float32."""
    if x.device.type == "cpu":
        return rmsnorm_dx_ref(x, gamma, rrms, dy)
    rows, D = _check_rows(x, gamma, x.device)
    _build.check_cuda_tensor(dy, "dy", x.device, dtypes=(x.dtype,))
    _build.check_cuda_tensor(rrms, "rrms", x.device,
                             dtypes=(torch.float32,), ndim=1)
    if dy.shape != x.shape or rrms.shape[0] != rows:
        raise ValueError(f"dy {tuple(dy.shape)} and rrms "
                         f"{tuple(rrms.shape)} for x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    _build.launch(_DX, x.device, dx.data_ptr(), x.data_ptr(),
                  gamma.data_ptr(), rrms.data_ptr(), dy.data_ptr(), rows, D,
                  _build.dtype_code(x))
    return dx


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with its backward (the JAX package's `_rms` custom_vjp):
    the forward saves (x, gamma, rrms); dx comes from `rmsnorm_dx` with
    dy cast to x's dtype (fused_norm.py:141), dgamma = sum over rows of
    dy * x * rrms in fp32, cast to gamma's dtype (:142-144)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        out, rrms = rmsnorm_fwd(x, gamma, eps)
        ctx.save_for_backward(x, gamma, rrms)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rrms = ctx.saved_tensors
        dx = dg = None
        if ctx.needs_input_grad[0]:
            dx = rmsnorm_dx(x, gamma, rrms, dy.to(x.dtype).contiguous())
        if ctx.needs_input_grad[1]:
            D = x.shape[-1]
            xhat = x.reshape(-1, D).float() * rrms[:, None]
            dg = (dy.reshape(-1, D).float() * xhat).sum(dim=0) \
                .to(gamma.dtype)
        return dx, dg, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    """RMSNorm over the trailing axis of x (..., D) with a float32 gain
    (D,): differentiable through RMSNormFunction where autograd needs
    it, one forward launch writing no rrms where it does not."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return RMSNormFunction.apply(x, gamma, eps)
    return rmsnorm_fwd(x, gamma, eps, with_rrms=False)[0]
