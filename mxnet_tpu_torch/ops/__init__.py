"""Operator registry and definitions of the port (the ResNet serving
subset of ``mxnet_tpu/ops``)."""

from . import registry
from .registry import OpDef, OpMode, Param, register, get, exists, list_ops

# Importing the defs modules populates the registry.
from . import defs_elemwise  # noqa: F401
from . import defs_tensor  # noqa: F401
from . import defs_nn  # noqa: F401
