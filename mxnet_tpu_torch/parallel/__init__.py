"""Training steps of the port (counterpart of `mxnet_tpu/parallel`): the
one-device `FusedTrainStep` so far."""
from . import data_parallel
from .data_parallel import FusedTrainStep

__all__ = ["data_parallel", "FusedTrainStep"]
