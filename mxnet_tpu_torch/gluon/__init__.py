"""Gluon of the port (counterpart of `mxnet_tpu/gluon`): the loss blocks
the training steps need (`loss.SoftmaxCrossEntropyLoss`) and the layers
of BERT and the Transformer (`nn`)."""
from . import loss, nn

__all__ = ["loss", "nn"]
