"""Tensor-manipulation operators.

Counterpart of ``mxnet_tpu/ops/defs_tensor.py``: ``Reshape`` with MXNet's
special codes (0, -1, -2, -3, -4, ``reverse``), ``Flatten``, ``transpose``
(a view; empty ``axes`` reverses them), ``expand_dims``, ``SwapAxis``,
``Concat``, ``stack``, ``SliceChannel`` (multi-output, with
``squeeze_axis``), ``dot`` (the last axis of ``a`` with the first of
``b``; two vectors give shape (1,)) and ``batch_dot``, ``slice`` (None
and negative bounds) and ``slice_axis``, ``Embedding``, ``take`` (its
``clip`` and ``wrap`` modes), ``batch_take``, ``one_hot``, ``pick``,
``gather_nd``, ``clip``, ``repeat``, ``tile``, ``reverse``, ``where`` (a
1-D condition selects rows), ``BlockGrad`` (a zero gradient),
``identity``, ``broadcast_to``/``broadcast_axis``, ``zeros_like``/
``ones_like`` and the creation ops ``_zeros``, ``_ones``, ``_full`` and
``_arange``. Each is plain PyTorch and its backward is autograd's;
``Embedding`` is a gather with a dense weight gradient, as the JAX package
computes it with ``jnp.take`` outside any fused kernel. ``Cast`` and
``Pad`` are not yet ported.
"""

from __future__ import annotations

import ast
import math

import torch
import torch.nn.functional as F

from ..base import (MXNetError, np_dtype, parse_bool, parse_float, parse_int,
                    parse_shape, parse_str)
from .registry import Param, register, torch_dtype


# --- reshape with MXNet special codes --------------------------------------
def infer_reshape(data_shape, target, reverse=False):
    """The MXNet Reshape output shape (``matrix_op-inl.h`` semantics; a copy
    of the JAX package's ``infer_reshape``)."""
    if reverse:
        out = infer_reshape(tuple(reversed(data_shape)),
                            tuple(reversed(target)), reverse=False)
        return tuple(reversed(out))
    src = list(data_shape)
    out = []
    src_idx = 0
    infer_idx = -1
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_idx])
            src_idx += 1
        elif t == -1:
            if infer_idx >= 0:
                raise MXNetError("Reshape: more than one -1")
            infer_idx = len(out)
            out.append(1)
            src_idx += 1
        elif t == -2:
            out.extend(src[src_idx:])
            src_idx = len(src)
        elif t == -3:
            out.append(src[src_idx] * src[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            d = src[src_idx]
            if d1 == -1:
                d1 = d // d2
            if d2 == -1:
                d2 = d // d1
            out.extend([d1, d2])
            src_idx += 1
            i += 2
        else:
            out.append(t)
            src_idx = min(src_idx + 1, len(src))
        i += 1
    total = math.prod(data_shape)
    if infer_idx >= 0:
        known = math.prod(d for j, d in enumerate(out) if j != infer_idx)
        out[infer_idx] = total // known
    if math.prod(out) != total:
        raise MXNetError(
            f"Reshape: cannot reshape {tuple(data_shape)} into {target} "
            f"(got {out})")
    return tuple(out)


register(
    "Reshape",
    lambda ins, p, m: ins[0].reshape(
        infer_reshape(tuple(ins[0].shape), p["shape"], p["reverse"])),
    arg_names=["data"],
    param_schema={
        "shape": Param(parse_shape),
        "reverse": Param(parse_bool, False),
        "target_shape": Param(parse_shape, None),  # deprecated, ignored
        "keep_highest": Param(parse_bool, False),  # deprecated, ignored
    },
    aliases=("reshape",),
)

register(
    "Flatten",
    lambda ins, p, m: ins[0].reshape(ins[0].shape[0], -1),
    arg_names=["data"],
    aliases=("flatten",),
)

def _transpose(ins, params, mode):
    (x,) = ins
    axes = params["axes"] or tuple(reversed(range(x.dim())))
    return x.permute(*axes)


register(
    "transpose",
    _transpose,
    arg_names=["data"],
    param_schema={"axes": Param(parse_shape, ())},
)

register(
    "expand_dims",
    lambda ins, p, m: torch.unsqueeze(ins[0], p["axis"]),
    arg_names=["data"],
    param_schema={"axis": Param(parse_int)},
)

register("identity", lambda ins, p, m: ins[0], arg_names=["data"],
         aliases=("_copy",))


# --- concat / split --------------------------------------------------------
register(
    "Concat",
    lambda ins, p, m: torch.cat(ins, dim=p["dim"]),
    arg_names=lambda p: [f"arg{i}" for i in range(p["num_args"])],
    param_schema={"num_args": Param(int), "dim": Param(parse_int, 1)},
    aliases=("concat",),
)


def _slice_channel(ins, params, mode):
    (x,) = ins
    n, ax = params["num_outputs"], params["axis"]
    if x.shape[ax] % n:
        raise MXNetError(f"SliceChannel: axis {ax} of {tuple(x.shape)} does "
                         f"not split into {n} equal parts")
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if params["squeeze_axis"]:
        parts = [torch.squeeze(q, ax) for q in parts]
    return list(parts)


register(
    "SliceChannel",
    _slice_channel,
    arg_names=["data"],
    param_schema={
        "num_outputs": Param(parse_int),
        "axis": Param(parse_int, 1),
        "squeeze_axis": Param(parse_bool, False),
    },
    num_outputs=lambda p: p["num_outputs"],
    aliases=("split",),
)


# --- indexing --------------------------------------------------------------
def _embedding(ins, params, mode):
    data, weight = ins
    idx = torch.clamp(data.to(torch.int64), 0, params["input_dim"] - 1)
    return F.embedding(idx, weight)


register(
    "Embedding",
    _embedding,
    arg_names=["data", "weight"],
    param_schema={
        "input_dim": Param(parse_int),
        "output_dim": Param(parse_int),
        "dtype": Param(parse_str, "float32"),
    },
    fill_in_shapes=lambda shapes, p: [
        shapes[0], shapes[1] or (p["input_dim"], p["output_dim"])],
)


register(
    "SwapAxis",
    lambda ins, p, m: torch.swapaxes(ins[0], p["dim1"], p["dim2"]),
    arg_names=["data"],
    param_schema={"dim1": Param(parse_int, 0), "dim2": Param(parse_int, 0)},
    aliases=("swapaxes",),
)

register(
    "stack",
    lambda ins, p, m: torch.stack(ins, dim=p["axis"]),
    arg_names=lambda p: [f"arg{i}" for i in range(p["num_args"])],
    param_schema={"num_args": Param(int), "axis": Param(parse_int, 0)},
)


# --- dot / batch_dot (mxnet_tpu/ops/defs_tensor.py:44-92) -------------------
def _dot(ins, params, mode):
    """MXNet's ``dot``: the last axis of ``a`` with the first of ``b``
    (``transpose_*`` reverse every axis); two vectors give shape (1,)."""
    a, b = ins
    if params["transpose_a"]:
        a = a.permute(*reversed(range(a.dim())))
    if params["transpose_b"]:
        b = b.permute(*reversed(range(b.dim())))
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b).reshape(1)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


def _batch_dot(ins, params, mode):
    a, b = ins
    if params["transpose_a"]:
        a = torch.swapaxes(a, -1, -2)
    if params["transpose_b"]:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


for _name, _body in (("dot", _dot), ("batch_dot", _batch_dot)):
    register(_name, _body, arg_names=["lhs", "rhs"],
             param_schema={"transpose_a": Param(parse_bool, False),
                           "transpose_b": Param(parse_bool, False)})


# --- slicing ---------------------------------------------------------------
def _parse_shape_opt(v):
    """A shape tuple that may hold None entries (``(0, None)``)."""
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(None if x is None else int(x) for x in v)
    val = ast.literal_eval(str(v).replace("None", "-2147483648"))
    if isinstance(val, int):
        val = (val,)
    return tuple(None if x == -2147483648 else int(x) for x in val)


def _slice(ins, params, mode):
    """``x[b0:e0, b1:e1, ...]``: a None or missing bound takes the axis's
    end, a negative one counts from the end."""
    (x,) = ins
    begin, end = params["begin"], params["end"]
    idx = []
    for i in range(x.dim()):
        b = begin[i] if i < len(begin) and begin[i] is not None else 0
        e = end[i] if i < len(end) and end[i] is not None else x.shape[i]
        idx.append(slice(b, e))
    return x[tuple(idx)]


register(
    "slice",
    _slice,
    arg_names=["data"],
    param_schema={"begin": Param(_parse_shape_opt),
                  "end": Param(_parse_shape_opt)},
    aliases=("crop",),
)


def _slice_axis(ins, params, mode):
    (x,) = ins
    ax = params["axis"]
    n = x.shape[ax]
    b = params["begin"] or 0
    e = params["end"]
    if b < 0:
        b += n
    if e is None:
        e = n
    elif e < 0:
        e += n
    return torch.narrow(x, ax, b, e - b)


register(
    "slice_axis",
    _slice_axis,
    arg_names=["data"],
    param_schema={
        "axis": Param(parse_int),
        "begin": Param(parse_int, 0),
        "end": Param(parse_int, None),
    },
)


# --- indexing --------------------------------------------------------------
def _index(t):
    """Index values as int64 (floats truncate toward zero, as ``astype``)."""
    return t.to(torch.int64)


def _take(ins, params, mode):
    """``take`` along ``axis`` after ``clip`` (into range) or ``wrap``
    (modulo the axis, the divisor's sign)."""
    data, indices = ins
    ax = params["axis"] % data.dim()
    idx = _index(indices)
    n = data.shape[ax]
    if params["mode"] == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    elif params["mode"] == "wrap":
        idx = torch.remainder(idx, n)
    out = torch.index_select(data, ax, idx.reshape(-1))
    return out.reshape(data.shape[:ax] + idx.shape + data.shape[ax + 1:])


register(
    "take",
    _take,
    arg_names=["a", "indices"],
    param_schema={"axis": Param(parse_int, 0),
                  "mode": Param(parse_str, "clip")},
)

register(
    "batch_take",
    lambda ins, p, m: torch.gather(
        ins[0], 1, _index(ins[1]).unsqueeze(1)).squeeze(1),
    arg_names=["a", "indices"],
)


def _one_hot(ins, params, mode):
    """``on_value`` where the index hits, ``off_value`` elsewhere (an index
    out of range hits nothing), in ``dtype``."""
    (indices,) = ins
    dt = torch_dtype(params["dtype"])
    hot = (_index(indices).unsqueeze(-1) == torch.arange(
        params["depth"], device=indices.device)).to(dt)
    return hot * params["on_value"] + (1.0 - hot) * params["off_value"]


register(
    "one_hot",
    _one_hot,
    arg_names=["indices"],
    param_schema={
        "depth": Param(parse_int),
        "on_value": Param(parse_float, 1.0),
        "off_value": Param(parse_float, 0.0),
        "dtype": Param(parse_str, "float32"),
    },
    infer_dtype=lambda p: np_dtype(p["dtype"]),
)


def _pick(ins, params, mode):
    data, index = ins
    ax = -1 if params["axis"] is None else params["axis"]
    out = torch.gather(data, ax, _index(index).unsqueeze(ax))
    return out if params["keepdims"] else torch.squeeze(out, ax)


register(
    "pick",
    _pick,
    arg_names=["data", "index"],
    param_schema={"axis": Param(parse_int, -1),
                  "keepdims": Param(parse_bool, False)},
)

register(
    "gather_nd",
    lambda ins, p, m: ins[0][tuple(_index(ins[1]))],
    arg_names=["data", "indices"],
)


# --- elementwise with parameters -------------------------------------------
def _clip(ins, params, mode):
    """``minimum(maximum(x, a_min), a_max)`` with the bounds in ``x``'s
    dtype, as ``jnp.clip``: at a bound the gradient is shared in halves."""
    (x,) = ins
    lo = torch.tensor(params["a_min"], dtype=x.dtype, device=x.device)
    hi = torch.tensor(params["a_max"], dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


register(
    "clip",
    _clip,
    arg_names=["data"],
    param_schema={"a_min": Param(parse_float), "a_max": Param(parse_float)},
)

register(
    "repeat",
    lambda ins, p, m: torch.repeat_interleave(ins[0], p["repeats"],
                                              dim=p["axis"]),
    arg_names=["data"],
    param_schema={"repeats": Param(parse_int), "axis": Param(parse_int, None)},
)

register(
    "tile",
    lambda ins, p, m: torch.tile(ins[0], p["reps"]),
    arg_names=["data"],
    param_schema={"reps": Param(parse_shape)},
)

register(
    "reverse",
    lambda ins, p, m: torch.flip(ins[0], tuple(p["axis"])),
    arg_names=["data"],
    param_schema={"axis": Param(parse_shape)},
    aliases=("flip",),
)


def _where(ins, params, mode):
    """``x`` where ``condition`` is non-zero, else ``y``; a 1-D condition
    of another shape than ``x`` selects rows."""
    cond, x, y = ins
    if cond.shape != x.shape and cond.dim() == 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)


register("where", _where, arg_names=["condition", "x", "y"])

register(
    "BlockGrad",
    lambda ins, p, m: ins[0].detach(),
    arg_names=["data"],
    aliases=("stop_gradient",),
)


def _broadcast_to(ins, params, mode):
    (x,) = ins
    shape = tuple(x.shape[i] if s == 0 else s
                  for i, s in enumerate(params["shape"]))
    return x.expand(shape)


register(
    "broadcast_to",
    _broadcast_to,
    arg_names=["data"],
    param_schema={"shape": Param(parse_shape)},
)


def _broadcast_axis(ins, params, mode):
    (x,) = ins
    shape = list(x.shape)
    for ax, s in zip(params["axis"], params["size"]):
        shape[ax] = s
    return x.expand(tuple(shape))


register(
    "broadcast_axis",
    _broadcast_axis,
    arg_names=["data"],
    param_schema={"axis": Param(parse_shape, ()),
                  "size": Param(parse_shape, ())},
    aliases=("broadcast_axes",),
)

register("zeros_like", lambda ins, p, m: torch.zeros_like(ins[0]),
         arg_names=["data"])
register("ones_like", lambda ins, p, m: torch.ones_like(ins[0]),
         arg_names=["data"])


# --- creation (no-input) ops -----------------------------------------------
def _device_of(params, mode):
    """Where an op without inputs places its output: the executor's device,
    else the ``ctx`` parameter's or the current context's."""
    from ..context import Context, current_context

    if mode.device is not None:
        return mode.device
    ctx = current_context()
    if params["ctx"]:  # "gpu(0)", the string form of a Context
        kind, _, dev_id = params["ctx"].partition("(")
        ctx = Context(kind, int(dev_id.rstrip(")") or 0))
    return ctx.torch_device()


def _creation_schema():
    return {"shape": Param(parse_shape),
            "dtype": Param(parse_str, "float32"),
            "ctx": Param(parse_str, None)}


def _filled(value):
    def body(ins, params, mode):
        v = params["value"] if value is None else value
        return torch.full(tuple(params["shape"]), v,
                          dtype=torch_dtype(params["dtype"]),
                          device=_device_of(params, mode))

    return body


for _name, _value in (("_zeros", 0.0), ("_ones", 1.0), ("_full", None)):
    _schema = _creation_schema()
    if _value is None:
        _schema["value"] = Param(parse_float)
    register(_name, _filled(_value), arg_names=[], param_schema=_schema,
             infer_dtype=lambda p: np_dtype(p["dtype"]))


def _arange(ins, params, mode):
    start, stop, step = params["start"], params["stop"], params["step"]
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(params["dtype"]),
                       device=_device_of(params, mode))
    if params["repeat"] > 1:
        out = torch.repeat_interleave(out, params["repeat"])
    return out


register(
    "_arange",
    _arange,
    arg_names=[],
    param_schema={
        "start": Param(parse_float, 0.0),
        "stop": Param(parse_float, None),
        "step": Param(parse_float, 1.0),
        "repeat": Param(parse_int, 1),
        "dtype": Param(parse_str, "float32"),
        "ctx": Param(parse_str, None),
    },
    infer_dtype=lambda p: np_dtype(p["dtype"]),
)
