"""Random sampling operators (the uniform and normal samplers).

Counterpart of ``mxnet_tpu/ops/defs_random.py:29-75``: ``_random_uniform``
and ``_random_normal`` with their aliases (``uniform``/``random_uniform``/
``_sample_uniform``, ``normal``/``random_normal``/``_sample_normal``), so
``nd.random_normal(loc=0, scale=1, shape=...)`` and the symbol forms exist.
They draw from the port's per-device ``torch.Generator``
(:mod:`mxnet_tpu_torch.random`), so ``mx.random.seed`` makes runs
reproducible; the bits differ from ``jax.random``'s. The output lands on
the executor's device, on the ``ctx`` parameter's, or on the current
context. The gamma, exponential, Poisson and multinomial samplers are not
yet ported.
"""

from __future__ import annotations

import torch

from ..base import np_dtype, parse_float, parse_shape, parse_str
from .registry import Param, register, torch_dtype


def _shape_schema():
    return {
        "shape": Param(parse_shape, ()),
        "dtype": Param(parse_str, "float32"),
        "ctx": Param(parse_str, None),
    }


def _draw(params, mode, fill):
    """A tensor of the op's shape and dtype on its device, filled by
    ``fill(tensor, generator)`` (nothing is drawn on ``meta``)."""
    from ..context import Context, current_context
    from ..random import generator

    device, pinned = mode.device, False
    if device is None:
        ctx = current_context()
        if params["ctx"]:  # "gpu(0)", the string form of a Context
            kind, _, dev_id = params["ctx"].partition("(")
            ctx = Context(kind, int(dev_id.rstrip(")") or 0))
        device, pinned = ctx.torch_device(), ctx.pinned
    out = torch.empty(tuple(params["shape"]),
                      dtype=torch_dtype(params["dtype"]), device=device,
                      pin_memory=pinned)
    if out.device.type != "meta":
        fill(out, generator(out.device))
    return out


register(
    "_random_uniform",
    lambda ins, p, m: _draw(p, m, lambda t, g: t.uniform_(
        p["low"], p["high"], generator=g)),
    arg_names=[],
    param_schema={
        **_shape_schema(),
        "low": Param(parse_float, 0.0),
        "high": Param(parse_float, 1.0),
    },
    infer_dtype=lambda p: np_dtype(p["dtype"]),
    aliases=("uniform", "random_uniform", "_sample_uniform"),
)

register(
    "_random_normal",
    lambda ins, p, m: _draw(p, m, lambda t, g: t.normal_(
        p["loc"], p["scale"], generator=g)),
    arg_names=[],
    param_schema={
        **_shape_schema(),
        "loc": Param(parse_float, 0.0),
        "scale": Param(parse_float, 1.0),
    },
    infer_dtype=lambda p: np_dtype(p["dtype"]),
    aliases=("normal", "random_normal", "_sample_normal"),
)
