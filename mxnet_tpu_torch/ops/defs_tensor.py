"""Tensor-manipulation operators (the subset on the ResNet serving path).

Counterpart of ``mxnet_tpu/ops/defs_tensor.py``: ``Flatten`` and
``identity``/``_copy``. The other tensor ops are not yet ported.
"""

from __future__ import annotations

from .registry import register

register(
    "Flatten",
    lambda ins, p, m: ins[0].reshape(ins[0].shape[0], -1),
    arg_names=["data"],
    aliases=("flatten",),
)

register("identity", lambda ins, p, m: ins[0], arg_names=["data"],
         aliases=("_copy",))
