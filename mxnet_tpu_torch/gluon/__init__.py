"""Gluon of the port (counterpart of `mxnet_tpu/gluon`): the loss blocks
the training step needs so far (`loss.SoftmaxCrossEntropyLoss`)."""
from . import loss

__all__ = ["loss"]
