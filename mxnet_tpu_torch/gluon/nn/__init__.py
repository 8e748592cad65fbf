"""Layers of the port (counterpart of `mxnet_tpu/gluon/nn`): the ones
BERT and the Transformer use so far."""
from .basic_layers import Dense, Dropout, Embedding, LayerNorm, initialize

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "initialize"]
