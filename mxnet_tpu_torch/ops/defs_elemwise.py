"""Elementwise, broadcast, scalar and unary operators.

Counterpart of ``mxnet_tpu/ops/defs_elemwise.py``, every name it
registers: the same-shape binary ops under the reference's canonical names
(``_plus``, ``_minus``, ``_mul``, ``_div``, ``_power``, ``_maximum``,
``_minimum``, ``_mod``) with its aliases (``elemwise_add``/``_sub``/
``_mul``/``_div``, which ``Symbol.__add__`` and its siblings build), so
graph JSON names them the same way; their ``broadcast_*`` forms (and
``broadcast_hypot``, ``broadcast_plus``, ``broadcast_minus``); every scalar
op of the reference's two scalar loops (``_plus_scalar``,
``_rminus_scalar``, ``_greater_scalar``, ...), whose scalar takes the
array's dtype; the comparisons ``_equal``, ``_not_equal``, ``_greater``,
``_greater_equal``, ``_lesser`` and ``_lesser_equal`` with their
``broadcast_*`` forms, which return 0/1 in the first input's dtype; the
unary zoo; and ``add_n`` (``ElementWiseSum``). Each is one PyTorch call
and its backward is autograd's, as the reference's are jax's. Where the
two libraries differ: ``mod`` is ``jnp.mod`` (the divisor's sign:
``torch.remainder``, not ``fmod``); ``gamma`` is ``exp(gammaln(x))``,
without the sign, exactly as the reference computes it; ``fix`` is
``trunc``; ``round`` and ``rint`` round half to even, as jnp does;
``cbrt`` is ``sign(x) * |x| ** (1/3)``, since torch has none (within a few
float32 ulps of jnp's); ``logical_not`` returns ``x``'s dtype.
"""

from __future__ import annotations

import torch

from ..base import parse_float
from .registry import Param, register

_ELEMWISE_ALIASES = {
    "add": ("_plus", "_Plus", "elemwise_add"),
    "sub": ("_minus", "_Minus", "elemwise_sub"),
    "mul": ("_mul", "_Mul", "elemwise_mul"),
    "div": ("_div", "_Div", "elemwise_div"),
    "power": ("_power", "_Power"),
    "maximum": ("_maximum", "_Maximum"),
    "minimum": ("_minimum", "_Minimum"),
    "mod": ("_mod", "_Mod"),
}
_BROADCAST_ALIASES = {"add": ("broadcast_plus",),
                      "sub": ("broadcast_minus",)}


def _binary_op(f):
    return lambda ins, p, m: f(ins[0], ins[1])


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
    _names = _ELEMWISE_ALIASES.get(_n, ())
    if _names:
        register(_names[0], _binary_op(_f), arg_names=["lhs", "rhs"],
                 aliases=_names[1:])
    register(f"broadcast_{_n}", _binary_op(_f), arg_names=["lhs", "rhs"],
             aliases=_BROADCAST_ALIASES.get(_n, ()))
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


# --- unary zoo (mxnet_tpu/ops/defs_elemwise.py:146-199) ---------------------
def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "rint": torch.round,  # half to even, as jnp.rint
    "round": torch.round,  # half to even, as jnp.round
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "erf": torch.erf,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _n, _f in _UNARY.items():
    register(_n, (lambda f: lambda ins, p, m: f(ins[0]))(_f),
             arg_names=["data"])


# --- n-ary sum --------------------------------------------------------------
def _add_n(ins, params, mode):
    out = ins[0]
    for x in ins[1:]:
        out = out + x
    return out


register(
    "add_n",
    _add_n,
    arg_names=lambda p: [f"arg{i}" for i in range(p["num_args"])],
    param_schema={"num_args": Param(int)},
    aliases=("ElementWiseSum", "_sum"),
)
