"""Elementwise operators (the subset on the ResNet serving path).

Counterpart of ``mxnet_tpu/ops/defs_elemwise.py``: the same-shape add,
registered under the JAX package's canonical name ``_plus`` with the
aliases ``_Plus``/``elemwise_add`` (the residual add ``Symbol.__add__``
builds), so graph JSON names it the same way. The other elementwise,
broadcast and scalar ops are not yet ported.
"""

from __future__ import annotations

import torch

from .registry import register

register(
    "_plus",
    lambda ins, p, m: torch.add(ins[0], ins[1]),
    arg_names=["lhs", "rhs"],
    aliases=("_Plus", "elemwise_add"),
)
