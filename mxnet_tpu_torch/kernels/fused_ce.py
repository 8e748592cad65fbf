"""Fused sparse softmax cross-entropy over a large vocab, forward and
backward: the CUDA kernels (`csrc/fused_ce.cu`) and their plain PyTorch
versions.

Counterpart of `mxnet_tpu/kernels/fused_ce.py` (`fused_softmax_ce_raw`,
the `_ce_fwd_kernel` and `_ce_bwd_kernel` Pallas kernels and their
`custom_vjp`). Logits (N, V) float32 or bfloat16, labels (N,) integer.

    ce_fwd(x, labels) -> (loss (N,), lse (N,)), both fp32
    ce_bwd(x, labels, lse, dloss) -> dx (N, V) in x's dtype
    softmax_ce(x, labels) -> loss (N,) fp32, differentiable in x

The JAX package takes the kernel for 1024 <= V <= 131072 on the TPU; the
upper bound is its VMEM staging limit. A CUDA block streams its row, so
`eligible` keeps only the lower gate (MIN_VOCAB, a constant). A CPU
tensor takes the plain versions; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["softmax_ce", "ce_fwd", "ce_bwd", "ce_fwd_ref", "ce_bwd_ref",
           "eligible", "MIN_VOCAB", "SoftmaxCEFunction"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: loss, lse, x, labels, N, V, dtype, stream
_FWD = _build.CudaKernel("mxtt_ce_fwd", [_P] * 4 + [_I64, _I, _I, _P])
#: dx, x, labels, lse, dloss, N, V, dtype, stream
_BWD = _build.CudaKernel("mxtt_ce_bwd", [_P] * 5 + [_I64, _I, _I, _P])

#: the smallest vocab the fused route takes (the JAX package's default
#: MXNET_TPU_CE_MIN_VOCAB): below it the log_softmax route is as cheap
MIN_VOCAB = 1024


def eligible(vocab: int) -> bool:
    """Whether `SoftmaxCrossEntropyLoss` takes the fused route."""
    return vocab >= MIN_VOCAB


# -- plain versions -----------------------------------------------------------

def ce_fwd_ref(x, labels):
    """Per row in fp32: lse = logsumexp(x), loss = lse - x[label]."""
    xf = x.float()
    lse = torch.logsumexp(xf, dim=-1)
    picked = xf.gather(1, labels.long()[:, None])[:, 0]
    return lse - picked, lse


def ce_bwd_ref(x, labels, lse, dloss):
    """dx = (exp(x - lse) - onehot(label)) * dloss in fp32, cast to x's
    dtype."""
    p = torch.exp(x.float() - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(1, labels.long()[:, None], 1.0)
    return ((p - onehot) * dloss.float()[:, None]).to(x.dtype)


# -- kernel wrappers ----------------------------------------------------------

def _check(x, labels):
    dev = x.device
    _build.check_cuda_tensor(x, "logits", dev, ndim=2)
    _build.check_cuda_tensor(labels, "labels", dev, dtypes=(torch.int32,),
                             ndim=1)
    if labels.shape[0] != x.shape[0]:
        raise ValueError(f"labels has {labels.shape[0]} rows, logits "
                         f"{x.shape[0]}")
    return x.shape


def ce_fwd(x, labels):
    """(loss, lse), (N,) fp32 each, of logits (N, V) and int32 labels
    (N,)."""
    if x.device.type == "cpu":
        return ce_fwd_ref(x, labels)
    N, V = _check(x, labels)
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    _build.launch(_FWD, x.device, loss.data_ptr(), lse.data_ptr(),
                  x.data_ptr(), labels.data_ptr(), N, V,
                  _build.dtype_code(x))
    return loss, lse


def ce_bwd(x, labels, lse, dloss):
    """dx (N, V) in x's dtype from the forward's lse and the fp32 (N,)
    loss cotangent."""
    if x.device.type == "cpu":
        return ce_bwd_ref(x, labels, lse, dloss)
    N, V = _check(x, labels)
    for name, t in (("lse", lse), ("dloss", dloss)):
        _build.check_cuda_tensor(t, name, x.device, dtypes=(torch.float32,),
                                 ndim=1)
        if t.shape[0] != N:
            raise ValueError(f"{name} has {t.shape[0]} rows, logits {N}")
    dx = torch.empty_like(x)
    _build.launch(_BWD, x.device, dx.data_ptr(), x.data_ptr(),
                  labels.data_ptr(), lse.data_ptr(), dloss.data_ptr(), N, V,
                  _build.dtype_code(x))
    return dx


class SoftmaxCEFunction(torch.autograd.Function):
    """Sparse softmax CE with its backward (the JAX package's
    `_ce_pallas` custom_vjp): the forward saves (x, labels, lse); the
    backward casts the loss cotangent to fp32 (fused_ce.py:144)."""

    @staticmethod
    def forward(ctx, x, labels):
        loss, lse = ce_fwd(x, labels)
        ctx.save_for_backward(x, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x, labels, lse = ctx.saved_tensors
        return ce_bwd(x, labels, lse, dloss.float().contiguous()), None


def softmax_ce(x, labels):
    """Per-row sparse softmax cross-entropy: logits (N, V), integer
    labels (N,) -> (N,) fp32 loss; differentiable in x through
    SoftmaxCEFunction where autograd needs it."""
    x = x.contiguous()
    labels = labels.to(device=x.device, dtype=torch.int32).contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return SoftmaxCEFunction.apply(x, labels)
    return ce_fwd(x, labels)[0]
