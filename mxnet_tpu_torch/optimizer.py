"""Optimizers (counterpart of `mxnet_tpu/optimizer.py`): the `Optimizer`
base with `SGD` (with momentum), `Adam` and `AdamW`.

Each rule's `_step(w, g, state, hyper)` is a pure function of one
parameter, its gradient, its state and the step's hyperparameters
(`hyper`: fp32 0-d tensors `lr`, `wd`, `rescale` and the step count
`t`), operation for operation the JAX package's, dtype casts included:
Adam-family updates are computed in fp32 and applied as
`w - (lr * upd).to(w.dtype)`. `FusedTrainStep` drives it. States are the
rule's own (Adam keeps two fp32 moments); no fp32 master copy of a bf16
weight is kept, as in the JAX package's fused step, which calls
`create_state` and never `create_state_multi_precision`
(data_parallel.py:383 there): every rule accepts `multi_precision=` and
it has no effect under `FusedTrainStep`.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register"]

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported (have {sorted(_REGISTRY)}); "
            f"NAG, LAMB, LARS and the other rules are ROADMAP A10's second "
            f"part")
    return _REGISTRY[key](**kwargs)


def _state_zeros(weight, n):
    """n distinct fp32 zero buffers shaped like `weight`."""
    return tuple(torch.zeros(weight.shape, dtype=torch.float32,
                             device=weight.device) for _ in range(n))


class Optimizer:
    """Learning rate, weight decay, gradient rescale and clip shared by
    the rules. `multi_precision` is kept for the JAX package's call
    pattern (bench.py passes it for BERT) and has no effect: the fused
    step keeps no fp32 master weights. Learning-rate schedules are not
    ported yet (ROADMAP A10, second part)."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, multi_precision=False):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision

    @property
    def learning_rate(self):
        return self.lr

    def create_state(self, index, weight):
        return None

    def _preprocess(self, g, hyper):
        g = g * hyper["rescale"].to(g.dtype)
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def _bias_correction(self, hyper):
        """Adam-family bias corrections (1 - beta**t), in fp32."""
        t = hyper["t"].to(torch.float32)
        return 1.0 - self.beta1 ** t, 1.0 - self.beta2 ** t

    def _step(self, w, g, state, hyper):
        """(new weight, new state) of one parameter."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr}, wd={self.wd})"


@register
class SGD(Optimizer):
    """SGD with momentum; the momentum buffer is fp32 for half-precision
    weights, the weight's dtype otherwise."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        dtype = torch.float32 if weight.dtype in (
            torch.float16, torch.bfloat16) else weight.dtype
        return torch.zeros_like(weight, dtype=dtype)

    def _step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        g = self._preprocess(g, hyper)
        g = g + wd.to(g.dtype) * w.to(g.dtype)
        if state is None:
            return w - lr.to(w.dtype) * g.to(w.dtype), None
        mom = self.momentum * state + g.to(state.dtype)
        return w - lr.to(w.dtype) * mom.to(w.dtype), mom


@register
class Adam(Optimizer):
    """Adam with L2 weight decay folded into the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _state_zeros(weight, 2)

    def _moments(self, g, state):
        m, v = state
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        return m, v

    def _step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        g = self._preprocess(g.to(torch.float32), hyper)
        g = g + wd * w.to(torch.float32)
        m, v = self._moments(g, state)
        c1, c2 = self._bias_correction(hyper)
        upd = (m / c1) / (torch.sqrt(v / c2) + self.epsilon)
        return w - (lr * upd).to(w.dtype), (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def _step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        g = self._preprocess(g.to(torch.float32), hyper)
        m, v = self._moments(g, state)
        c1, c2 = self._bias_correction(hyper)
        upd = (m / c1) / (torch.sqrt(v / c2) + self.epsilon) + \
            wd * w.to(torch.float32)
        return w - (lr * upd).to(w.dtype), (m, v)
