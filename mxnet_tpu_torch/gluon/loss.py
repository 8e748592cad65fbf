"""Loss blocks (counterpart of `mxnet_tpu/gluon/loss.py`): `Loss` and
`SoftmaxCrossEntropyLoss`.

A loss maps (pred, label[, sample_weight]) to one value per sample: the
weighted per-element loss averaged over every axis but `batch_axis`.
The sparse softmax cross-entropy over the trailing axis takes the fused
route (`kernels/fused_ce.py`: the CUDA kernels on the card, their plain
versions on the CPU) when the vocab is eligible, as the JAX package's
LM hot path does (gluon/loss.py:94-108 there); otherwise, and for dense
labels or log-probability inputs, `log_softmax` and a pick, the JAX
package's own non-kernel route.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..kernels import fused_ce

__all__ = ["Loss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if pred.shape != label.shape else label


class Loss:
    """Base of the loss blocks: `weight` scales every element,
    `batch_axis` is the axis kept by the mean."""

    def __init__(self, weight=None, batch_axis=0):
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy over `axis`: integer labels (`sparse_label`)
    or label distributions; `from_logits` takes log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if (self._sparse and not self._from_logits
                and self._axis in (-1, pred.dim() - 1) and pred.dim() >= 2
                and fused_ce.eligible(pred.shape[-1])):
            # one fused pass over the (N, V) logits, no log-probabilities
            vocab = pred.shape[-1]
            per_row = fused_ce.softmax_ce(pred.reshape(-1, vocab),
                                          label.reshape(-1))
            loss = per_row.reshape(tuple(pred.shape[:-1]) + (1,))
            loss = _apply_weighting(loss, self._weight, sample_weight)
            return self._mean(loss)
        if not self._from_logits:
            pred = F.log_softmax(pred, dim=self._axis)
        if self._sparse:
            # mx.nd.pick clips the index into range
            idx = label.long().clamp(0, pred.shape[self._axis] - 1)
            loss = -pred.gather(self._axis, idx.unsqueeze(self._axis))
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)
