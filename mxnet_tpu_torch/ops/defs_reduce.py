"""Reductions and ordering operators.

Counterpart of ``mxnet_tpu/ops/defs_reduce.py`` (reference
``broadcast_reduce_op_value.cc``, ``broadcast_reduce_op_index.cc``,
``ordering_op.cc``): ``sum``/``mean``/``prod``/``nansum``/``nanprod``/
``max``/``min`` with MXNet's ``axis`` (None or ``()``: every axis),
``keepdims`` and ``exclude`` (reduce over the complement); ``norm``;
``argmax``/``argmin``/``argmax_channel``; ``topk``, ``sort`` and
``argsort``. Index outputs come back in the input's dtype, as in the
reference. Each is plain PyTorch and its backward is autograd's: ``max``
and ``min`` share the gradient evenly among ties (``torch.amax``, as
jax's reduce-max VJP), ``prod`` reduces one axis at a time so that its
gradient at zeros is the product of the others, and ``norm`` is
``sqrt(sum(x * x))`` written out, whose gradient at an all-zero input is
NaN as the reference's. ``topk``, ``sort`` and ``argsort`` take a stable
sort, so ties keep the lower index first as ``lax.top_k`` and
``jnp.argsort`` do (a descending ``sort``/``argsort`` is the ascending one
flipped, as in the reference).
"""

from __future__ import annotations

import torch

from ..base import parse_bool, parse_int, parse_shape, parse_str
from .registry import Param, register


def _norm_axes(ndim, axis, exclude):
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _reduce_schema():
    return {
        "axis": Param(parse_shape, None),
        "keepdims": Param(parse_bool, False),
        "exclude": Param(parse_bool, False),
    }


def _per_axis(fn):
    """A reducer over several axes from a one-axis ``fn(x, dim, keepdim)``:
    one axis at a time, the highest first."""
    def run(x, dim, keepdim):
        for a in sorted(dim, reverse=True):
            x = fn(x, a, keepdim)
        return x

    return run


def _nanprod(x, dim, keepdim):
    return torch.prod(torch.where(torch.isnan(x), torch.ones_like(x), x),
                      dim, keepdim)


_REDUCERS = {
    "sum": torch.sum,
    "mean": torch.mean,
    "prod": _per_axis(torch.prod),
    "nansum": torch.nansum,
    "nanprod": _per_axis(_nanprod),
    "max": torch.amax,
    "min": torch.amin,
}

_REDUCE_ALIASES = {
    "sum": ("sum_axis",),
    "max": ("max_axis",),
    "min": ("min_axis",),
}


def _make_reduce(fn):
    def body(ins, params, mode):
        (x,) = ins
        axes = _norm_axes(x.dim(), params["axis"], params["exclude"])
        if not axes:
            return x  # the reference reduces over no axis: x as it is
        return fn(x, axes, params["keepdims"])

    return body


for _n, _f in _REDUCERS.items():
    register(_n, _make_reduce(_f), arg_names=["data"],
             param_schema=_reduce_schema(),
             aliases=_REDUCE_ALIASES.get(_n, ()))


register("norm",
         lambda ins, p, m: torch.sqrt(torch.sum(ins[0] * ins[0])).reshape(1),
         arg_names=["data"])


# --- arg reductions ---------------------------------------------------------
def _make_argred(fn):
    def body(ins, params, mode):
        (x,) = ins
        ax = params["axis"]
        out = fn(x, dim=ax).to(x.dtype)
        if params["keepdims"] and ax is not None:
            out = torch.unsqueeze(out, ax)
        return out

    return body


for _n, _f in (("argmax", torch.argmax), ("argmin", torch.argmin)):
    register(_n, _make_argred(_f), arg_names=["data"],
             param_schema={"axis": Param(parse_int, None),
                           "keepdims": Param(parse_bool, False)})

register("argmax_channel",
         lambda ins, p, m: torch.argmax(ins[0], dim=1).to(ins[0].dtype),
         arg_names=["data"])


# --- ordering ---------------------------------------------------------------
def _topk(ins, params, mode):
    (x,) = ins
    ax, k, ret_typ = params["axis"], params["k"], params["ret_typ"]
    if ret_typ not in ("value", "indices", "both", "mask"):
        raise ValueError(f"topk: unknown ret_typ {ret_typ}")
    if ax is None:
        x = x.reshape(-1)
        ax = 0
    ax = ax % x.dim()
    xm = torch.movedim(x, ax, -1)
    n = xm.shape[-1]
    kk = n if k == 0 else k
    idx = torch.sort(xm, dim=-1, descending=not params["is_ascend"],
                     stable=True).indices[..., :kk]
    if ret_typ == "mask":
        mask = torch.zeros_like(xm).scatter_(-1, idx, 1.0)
        return torch.movedim(mask, -1, ax)
    vals = torch.movedim(torch.gather(xm, -1, idx), -1, ax)
    idx = torch.movedim(idx, -1, ax).to(x.dtype)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    return [vals, idx]


register(
    "topk",
    _topk,
    arg_names=["data"],
    param_schema={
        "axis": Param(parse_int, -1),
        "k": Param(parse_int, 1),
        "ret_typ": Param(parse_str, "indices"),
        "is_ascend": Param(parse_bool, False),
    },
    num_outputs=lambda p: 2 if p["ret_typ"] == "both" else 1,
)


def _sorted(x, ax, is_ascend, indices):
    if ax is None:
        x, ax = x.reshape(-1), 0
    res = torch.sort(x, dim=ax, stable=True)
    out = res.indices.to(x.dtype) if indices else res.values
    return out if is_ascend else torch.flip(out, (ax,))


_ORDER_SCHEMA = {"axis": Param(parse_int, -1),
                 "is_ascend": Param(parse_bool, True)}

register("sort",
         lambda ins, p, m: _sorted(ins[0], p["axis"], p["is_ascend"], False),
         arg_names=["data"], param_schema=dict(_ORDER_SCHEMA))

register("argsort",
         lambda ins, p, m: _sorted(ins[0], p["axis"], p["is_ascend"], True),
         arg_names=["data"], param_schema=dict(_ORDER_SCHEMA))
