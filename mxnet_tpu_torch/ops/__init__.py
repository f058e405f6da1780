"""Operator registry and definitions of the port (the subset of
``mxnet_tpu/ops`` that ResNet training and serving, LSTM and GRU training
with dropout, the fused ``RNN`` op, SSD serving and training and DCGAN
training run, and the elementwise, reduce and tensor ops)."""

from . import registry
from .registry import OpDef, OpMode, Param, register, get, exists, list_ops

# Importing the defs modules populates the registry.
from . import defs_elemwise  # noqa: F401
from . import defs_tensor  # noqa: F401
from . import defs_reduce  # noqa: F401
from . import defs_nn  # noqa: F401
from . import defs_optimizer  # noqa: F401
from . import defs_contrib  # noqa: F401
from . import defs_random  # noqa: F401
from . import defs_rnn  # noqa: F401
