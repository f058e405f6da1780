"""Base types, errors and small utilities of the PyTorch port.

A copy of ``mxnet_tpu/base.py``: the error type, dtype tables and
string-parsing helpers shared by the op registry and Symbol attribute
handling. Host-only; the port keeps its own copy so that it never imports
the JAX package.
"""

from __future__ import annotations

import ast

import numpy as np

__version__ = "0.1.0"


class MXNetError(Exception):
    """Framework error type (reference: python/mxnet/base.py:44-69)."""


# dtype name <-> numpy dtype tables. The reference enumerates these in
# mshadow type switches (MSHADOW_TYPE_SWITCH); plus bfloat16.
_DTYPE_NAMES = [
    "float32",
    "float64",
    "float16",
    "bfloat16",
    "uint8",
    "int32",
    "int8",
    "int64",
    "bool",
]


def np_dtype(dtype):
    """Normalise a user-provided dtype (str/np.dtype/type) to np.dtype."""
    if dtype is None:
        return np.dtype("float32")
    if isinstance(dtype, str):
        if dtype == "bfloat16":
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(dtype)
    try:
        return np.dtype(dtype)
    except TypeError as e:
        raise MXNetError(f"unknown dtype {dtype!r}") from e


def dtype_name(dtype) -> str:
    d = np_dtype(dtype)
    return d.name


def parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, np.integer)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise MXNetError(f"cannot parse boolean from {v!r}")


def parse_shape(v):
    """Parse a shape tuple from python value or its string form '(1, 2)'."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    s = str(v).strip()
    if s in ("None", ""):
        return None
    val = ast.literal_eval(s)
    if isinstance(val, (int, float)):
        return (int(val),)
    return tuple(int(x) for x in val)


def parse_int(v):
    if v is None:
        return None
    if isinstance(v, str) and v.strip() == "None":
        return None
    return int(v)


def parse_float(v):
    if v is None:
        return None
    if isinstance(v, str) and v.strip() == "None":
        return None
    return float(v)


def parse_str(v):
    return None if v is None else str(v)


def string_attrs(attrs: dict) -> dict:
    """Render attribute values to strings, the Symbol/JSON representation."""
    out = {}
    for k, v in attrs.items():
        if v is None:
            continue
        if isinstance(v, bool):
            out[k] = "true" if v else "false"
        elif isinstance(v, (tuple, list)):
            out[k] = "(" + ", ".join(str(x) for x in v) + ")"
        else:
            out[k] = str(v)
    return out
