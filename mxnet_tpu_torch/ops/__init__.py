"""Operator registry and definitions of the port (the subset of
``mxnet_tpu/ops`` that ResNet training and serving, LSTM training, SSD
serving and training and DCGAN training run)."""

from . import registry
from .registry import OpDef, OpMode, Param, register, get, exists, list_ops

# Importing the defs modules populates the registry.
from . import defs_elemwise  # noqa: F401
from . import defs_tensor  # noqa: F401
from . import defs_nn  # noqa: F401
from . import defs_optimizer  # noqa: F401
from . import defs_contrib  # noqa: F401
from . import defs_random  # noqa: F401
