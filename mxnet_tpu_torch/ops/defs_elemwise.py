"""Elementwise operators (the subset on the ResNet, LSTM and SSD paths).

Counterpart of ``mxnet_tpu/ops/defs_elemwise.py``: the same-shape add,
subtract and multiply, registered under the JAX package's canonical names
``_plus``, ``_minus`` and ``_mul`` with its aliases
(``elemwise_add``/``elemwise_sub``/``elemwise_mul``, which
``Symbol.__add__``/``__sub__``/``__mul__`` build), so graph JSON names them
the same way; ``broadcast_sub`` (alias ``broadcast_minus``); and every
scalar op of the reference's two scalar loops
(``_plus_scalar``, ``_rminus_scalar``, ``_greater_scalar``, ...), whose
scalar takes the array's dtype; and the comparisons ``_equal``,
``_not_equal``, ``_greater``, ``_greater_equal``, ``_lesser`` and
``_lesser_equal`` with their ``broadcast_*`` forms, which return 0/1 in
the first input's dtype. The backward is autograd's. The other broadcast
ops, the other same-shape ops and the unary zoo are not yet ported.
"""

from __future__ import annotations

import torch

from ..base import parse_float
from .registry import Param, register

register(
    "_plus",
    lambda ins, p, m: torch.add(ins[0], ins[1]),
    arg_names=["lhs", "rhs"],
    aliases=("_Plus", "elemwise_add"),
)

register(
    "_minus",
    lambda ins, p, m: torch.sub(ins[0], ins[1]),
    arg_names=["lhs", "rhs"],
    aliases=("_Minus", "elemwise_sub"),
)

register(
    "broadcast_sub",
    lambda ins, p, m: torch.sub(ins[0], ins[1]),
    arg_names=["lhs", "rhs"],
    aliases=("broadcast_minus",),
)

register(
    "_mul",
    lambda ins, p, m: torch.mul(ins[0], ins[1]),
    arg_names=["lhs", "rhs"],
    aliases=("_Mul", "elemwise_mul"),
)


# --- scalar variants (mxnet_tpu/ops/defs_elemwise.py:121-137) --------------
_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "mod": torch.remainder,  # jnp.mod: the sign of the divisor
    "hypot": torch.hypot,
}

_BINARY_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
}


def _cmp_op(f):
    """A comparison's body: 0/1 in the first input's dtype."""
    return lambda ins, p, m: f(ins[0], ins[1]).to(ins[0].dtype)


def _scalar_op(f, reverse=False):
    """The op body: the scalar as a 0-d tensor of the array's dtype (the
    reference's ``jnp.asarray(scalar, dtype=a.dtype)``), kept on the host
    (a 0-d CPU tensor combines with a tensor on any device without a copy
    to it); comparisons come back in the array's dtype."""

    def fn(ins, params, mode):
        (a,) = ins
        s = torch.tensor(params["scalar"], dtype=torch.float64).to(a.dtype)
        out = f(s, a) if reverse else f(a, s)
        if out.dtype == torch.bool:
            out = out.to(a.dtype)
        return out

    return fn


def _register_scalar(name, f, reverse=False, aliases=()):
    register(name, _scalar_op(f, reverse), arg_names=["data"],
             param_schema={"scalar": Param(parse_float)}, aliases=aliases)


for _n, _f in _BINARY.items():
    _mx = {"add": "plus", "sub": "minus"}.get(_n, _n)
    _register_scalar(f"_{_mx}_scalar", _f,
                     aliases=(f"_{_mx.capitalize()}Scalar",))
    if _n in ("sub", "div", "power", "mod"):
        _rname = {"sub": "rminus", "div": "rdiv", "power": "rpower",
                  "mod": "rmod"}[_n]
        _register_scalar(f"_{_rname}_scalar", _f, reverse=True)
for _n, _f in _BINARY_CMP.items():
    register(f"_{_n}", _cmp_op(_f), arg_names=["lhs", "rhs"])
    register(f"broadcast_{_n}", _cmp_op(_f), arg_names=["lhs", "rhs"])
    _register_scalar(f"_{_n}_scalar", _f)
