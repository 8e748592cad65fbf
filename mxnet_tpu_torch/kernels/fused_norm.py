"""RMSNorm and LayerNorm over the trailing axis, forward and backward:
the CUDA kernels (`csrc/rmsnorm.cu`, `csrc/layernorm.cu`) and their
plain PyTorch versions.

Counterpart of `mxnet_tpu/kernels/fused_norm.py` (`fused_rmsnorm` and
`fused_layernorm`: the `_rms_fwd_kernel`, `_rms_bwd_kernel`,
`_ln_fwd_kernel` and `_ln_bwd_kernel` Pallas kernels and their
`custom_vjp`s). Statistics in fp32, outputs in x's dtype, float32 gains
and shifts.

    rmsnorm_fwd(x, gamma, eps, with_rrms) -> (out, rrms (rows,) or None)
    rmsnorm_dx(x, gamma, rrms, dy)        -> dx, x's dtype
    rmsnorm(x, gamma, eps)                -> out, differentiable
    layernorm_fwd(x, gamma, beta, eps, with_stats)
        -> (out, mu (rows,), rstd (rows,)), the statistics None without
        `with_stats`
    layernorm_dx(x, gamma, mu, rstd, dy)  -> dx, x's dtype
    layernorm(x, gamma, beta, eps)        -> out, differentiable

`rmsnorm` and `layernorm` go through their autograd Functions when
autograd needs a gradient and straight to the forward (no statistics
written) otherwise. A CPU tensor takes the plain versions; a CUDA tensor
launches the kernel (rows up to RMS_MAX_DIM and LN_MAX_DIM wide) or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rmsnorm", "rmsnorm_ref", "rmsnorm_fwd", "rmsnorm_fwd_ref",
           "rmsnorm_dx", "rmsnorm_dx_ref", "RMSNormFunction", "layernorm",
           "layernorm_ref", "layernorm_fwd", "layernorm_fwd_ref",
           "layernorm_dx", "layernorm_dx_ref", "LayerNormFunction",
           "RMS_MAX_DIM", "LN_MAX_DIM"]

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
#: out, rrms (may be NULL), x, gamma, rows, dim, eps, dtype, stream
_FWD = _build.CudaKernel("mxtt_rmsnorm", [_P] * 4 + [_I64, _I, _F, _I, _P])
#: dx, x, gamma, rrms, dy, rows, dim, dtype, stream
_DX = _build.CudaKernel("mxtt_rmsnorm_dx", [_P] * 5 + [_I64, _I, _I, _P])
#: out, mu, rstd (each may be NULL), x, gamma, beta, rows, dim, eps, dtype,
#: stream
_LN_FWD = _build.CudaKernel("mxtt_layernorm",
                            [_P] * 6 + [_I64, _I, _F, _I, _P])
#: dx, x, gamma, mu, rstd, dy, rows, dim, dtype, stream
_LN_DX = _build.CudaKernel("mxtt_layernorm_dx", [_P] * 6 + [_I64, _I, _I, _P])

#: the widest RMSNorm forward and LayerNorm rows the kernels take (kMaxDim
#: in rmsnorm.cu and layernorm.cu: 256 threads of a block hold 32 values
#: each)
RMS_MAX_DIM = LN_MAX_DIM = 8192


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
    if D > RMS_MAX_DIM:
        raise ValueError(f"rows of {D} exceed the kernel's {RMS_MAX_DIM}")
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


# -- LayerNorm: plain versions --------------------------------------------------

def layernorm_fwd_ref(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float):
    """(out, mu (rows,), rstd (rows,)) of LayerNorm over the trailing axis,
    as the TPU kernel computes it (fused_norm.py:174-184 of the JAX
    package): mu first, then the variance of the centred values, in
    fp32; out = (x - mu) * rstd * gamma + beta cast to x.dtype."""
    xs = x.float()
    mu = xs.mean(dim=-1, keepdim=True)
    xc = xs - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    out = (xc * rstd * gamma.float() + beta.float()).to(x.dtype)
    return out, mu.reshape(-1), rstd.reshape(-1)


def layernorm_ref(x, gamma, beta, eps):
    """The forward's output alone."""
    return layernorm_fwd_ref(x, gamma, beta, eps)[0]


def layernorm_dx_ref(x, gamma, mu, rstd, dy):
    """dx = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat)) in fp32,
    cast to x.dtype, with xhat = (x - mu) * rstd and wdy = gamma * dy
    (fused_norm.py:186-197); x and dy (..., D), mu and rstd one entry
    per row."""
    D = x.shape[-1]
    r = rstd.reshape(-1, 1).float()
    xhat = (x.reshape(-1, D).float() - mu.reshape(-1, 1).float()) * r
    wdy = dy.reshape(-1, D).float() * gamma.float()
    m1 = wdy.mean(dim=-1, keepdim=True)
    m2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    return (r * (wdy - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)


# -- LayerNorm: kernel wrappers -------------------------------------------------

def _check_ln(x, gamma, beta):
    rows, D = _check_rows(x, gamma, x.device)
    if D > LN_MAX_DIM:
        raise ValueError(f"LayerNorm rows of {D} exceed the kernels' "
                         f"{LN_MAX_DIM}")
    if beta is not None:
        _build.check_cuda_tensor(beta, "beta", x.device,
                                 dtypes=(torch.float32,), ndim=1)
        if beta.shape[0] != D:
            raise ValueError(f"beta has {beta.shape[0]} entries for rows "
                             f"of {D}")
    return rows, D


def layernorm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float, with_stats: bool = True):
    """LayerNorm over the trailing axis of x (..., D) with a float32 gain
    and shift (D,): (out, mu, rstd), the (rows,) fp32 statistics None
    without `with_stats`."""
    if x.device.type == "cpu":
        out, mu, rstd = layernorm_fwd_ref(x, gamma, beta, eps)
        return (out, mu, rstd) if with_stats else (out, None, None)
    rows, D = _check_ln(x, gamma, beta)
    out = torch.empty_like(x)
    mu, rstd = (torch.empty(rows, dtype=torch.float32, device=x.device)
                for _ in range(2)) if with_stats else (None, None)
    _build.launch(_LN_FWD, x.device, out.data_ptr(), _build.ptr(mu),
                  _build.ptr(rstd), x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), rows, D, float(eps), _build.dtype_code(x))
    return out, mu, rstd


def layernorm_dx(x, gamma, mu, rstd, dy):
    """The input gradient of LayerNorm from the forward's mu and rstd: x
    and dy (..., D) of one dtype, gamma (D,), mu and rstd (rows,)
    float32."""
    if x.device.type == "cpu":
        return layernorm_dx_ref(x, gamma, mu, rstd, dy)
    rows, D = _check_ln(x, gamma, None)
    _build.check_cuda_tensor(dy, "dy", x.device, dtypes=(x.dtype,))
    for name, t in (("mu", mu), ("rstd", rstd)):
        _build.check_cuda_tensor(t, name, x.device, dtypes=(torch.float32,),
                                 ndim=1)
    if dy.shape != x.shape or mu.shape[0] != rows or rstd.shape[0] != rows:
        raise ValueError(f"dy {tuple(dy.shape)}, mu {tuple(mu.shape)} and "
                         f"rstd {tuple(rstd.shape)} for x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    _build.launch(_LN_DX, x.device, dx.data_ptr(), x.data_ptr(),
                  gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                  dy.data_ptr(), rows, D, _build.dtype_code(x))
    return dx


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with its backward (the JAX package's `_ln` custom_vjp):
    the forward saves (x, gamma, mu, rstd); dx comes from `layernorm_dx`
    with dy cast to x's dtype (fused_norm.py:262); dgamma = sum over rows
    of dy * xhat and dbeta = sum of dy, from fp32 dy, cast to gamma's
    dtype (:263-268)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out, mu, rstd = layernorm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mu, rstd = ctx.saved_tensors
        dx = dg = db = None
        if ctx.needs_input_grad[0]:
            dx = layernorm_dx(x, gamma, mu, rstd, dy.to(x.dtype).contiguous())
        D = x.shape[-1]
        dyf = dy.reshape(-1, D).float()
        if ctx.needs_input_grad[1]:
            xhat = (x.reshape(-1, D).float() - mu[:, None]) * rstd[:, None]
            dg = (dyf * xhat).sum(dim=0).to(gamma.dtype)
        if ctx.needs_input_grad[2]:
            db = dyf.sum(dim=0).to(gamma.dtype)
        return dx, dg, db, None


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float):
    """LayerNorm over the trailing axis of x (..., D) with a float32 gain
    and shift (D,): differentiable through LayerNormFunction where
    autograd needs it, one forward launch writing no statistics where it
    does not."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return LayerNormFunction.apply(x, gamma, beta, eps)
    return layernorm_fwd(x, gamma, beta, eps, with_stats=False)[0]
