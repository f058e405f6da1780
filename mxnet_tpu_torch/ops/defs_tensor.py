"""Tensor-manipulation operators (the subset on the ResNet, LSTM and SSD
paths).

Counterpart of ``mxnet_tpu/ops/defs_tensor.py``: ``Reshape`` with MXNet's
special codes (0, -1, -2, -3, -4, ``reverse``), ``Flatten``, ``transpose``
(a view; empty ``axes`` reverses them), ``expand_dims``, ``Concat``,
``SliceChannel`` (multi-output, with ``squeeze_axis``), ``Embedding`` and
``identity``/``_copy``. Each is plain PyTorch and its backward is
autograd's; ``Embedding`` is a gather with a dense weight gradient, as the
JAX package computes it with ``jnp.take`` outside any fused kernel. The
other tensor ops are not yet ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, parse_bool, parse_int, parse_shape, parse_str
from .registry import Param, register


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
