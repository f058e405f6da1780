"""Operator registry of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/registry.py``. Each op is registered once
with:

* ``fn(inputs, params, mode) -> outputs`` or ``(outputs, new_aux)`` — plain
  PyTorch on tensors. ``mode.is_train`` selects the training forward. The
  backward is autograd's by default: the executor records the training
  forward and ``torch.autograd`` differentiates the op bodies. Where a
  hand-written kernel carries an op (BatchNorm, SoftmaxOutput), the body
  runs a ``torch.autograd.Function`` whose backward is a kernel too.
  ``is_loss`` marks an op whose backward ignores the head gradient, so
  ``Executor.backward()`` without ``out_grads`` drives it.
* ``param_schema`` — typed parameters with defaults; values parse from
  python natives *or* the string form used in Symbol attributes / JSON.
* ``fill_in_shapes(in_shapes, params)`` — optional completion of *unknown
  input* shapes (e.g. FullyConnected's weight from data + num_hidden).

Output shapes come from running ``fn`` itself on tensors on the ``meta``
device (shape and dtype, no data), where the JAX package runs
``jax.eval_shape``: inference can never disagree with execution. Host-side
shape arithmetic inside an op body (Pooling's ``full`` convention) stays
plain Python, so it runs the same on meta tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..base import MXNetError, np_dtype

_REQUIRED = object()

# Graph-level node attributes (AttrScope metadata), not op parameters.
_GRAPH_ATTRS = {"ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage"}


@dataclass(frozen=True)
class OpMode:
    """Execution-time context handed to every op ``fn``: ``is_train``
    selects the training forward (batch statistics, the loss-layer
    backward); ``device`` is where an op without inputs (a sampler)
    places its output: the executor's device, ``meta`` during shape
    inference, None for an imperative call (the op's ``ctx`` parameter or
    the current context)."""

    is_train: bool = False
    device: Optional[torch.device] = None


class Param:
    """One typed op parameter (analogue of a dmlc::Parameter field)."""

    __slots__ = ("parse", "default", "doc")

    def __init__(self, parse, default=_REQUIRED, doc=""):
        self.parse = parse
        self.default = default
        self.doc = doc

    @property
    def required(self):
        return self.default is _REQUIRED


def torch_dtype(dtype):
    """The torch dtype of a numpy-style dtype name or np.dtype."""
    name = np_dtype(dtype).name
    try:
        return getattr(torch, name)
    except AttributeError as e:
        raise MXNetError(f"dtype {name} has no torch counterpart") from e


class OpDef:
    """A registered operator."""

    def __init__(
        self,
        name: str,
        fn: Callable,
        arg_names,
        param_schema: Optional[dict] = None,
        aux_names=None,
        fill_in_shapes: Optional[Callable] = None,
        num_outputs=1,
        num_visible_outputs=None,
        aliases: Sequence[str] = (),
        is_loss: bool = False,
        mutate: Sequence = (),
        doc: str = "",
        infer_dtype: Optional[Callable] = None,
    ):
        self.name = name
        self.fn = fn
        self._arg_names = arg_names
        self.param_schema = param_schema or {}
        self._aux_names = aux_names or []
        self.fill_in_shapes = fill_in_shapes
        self._num_outputs = num_outputs
        self._num_visible_outputs = num_visible_outputs
        self.aliases = tuple(aliases)
        self.is_loss = bool(is_loss)
        # (input name, output index): imperative calls write that output
        # back into the input's array (optimizer state)
        self.mutate = list(mutate)
        self.doc = doc
        # (params) -> output dtype, for ops whose inputs do not decide it
        self._infer_dtype = infer_dtype

    # --- introspection ---------------------------------------------------
    def arg_names(self, params) -> list:
        if callable(self._arg_names):
            return list(self._arg_names(params))
        return list(self._arg_names)

    def aux_names(self, params) -> list:
        if callable(self._aux_names):
            return list(self._aux_names(params))
        return list(self._aux_names)

    def num_outputs(self, params) -> int:
        if callable(self._num_outputs):
            return int(self._num_outputs(params))
        return int(self._num_outputs)

    def num_visible_outputs(self, params) -> int:
        if self._num_visible_outputs is None:
            return self.num_outputs(params)
        if callable(self._num_visible_outputs):
            return int(self._num_visible_outputs(params))
        return int(self._num_visible_outputs)

    # --- params ----------------------------------------------------------
    def parse_params(self, raw: dict, strict: bool = True) -> dict:
        """Parse raw attrs (python values or strings) into typed params.

        Dunder-wrapped keys (``__ctx_group__`` etc.) are Symbol-level
        metadata and are skipped. With ``strict`` (op creation, JSON load)
        unknown keys raise; non-strict (node re-parse at execution) ignores
        them.
        """
        out = {}
        for k, spec in self.param_schema.items():
            if k in raw and raw[k] is not None:
                try:
                    out[k] = spec.parse(raw[k])
                except (ValueError, SyntaxError) as e:
                    raise MXNetError(
                        f"op {self.name}: cannot parse param {k}={raw[k]!r}"
                    ) from e
            elif spec.required:
                raise MXNetError(f"op {self.name}: missing required param {k}")
            else:
                out[k] = spec.default
        if strict:
            for k in raw:
                if k not in self.param_schema and not (
                    k.startswith("__") and k.endswith("__")
                ) and k not in _GRAPH_ATTRS:
                    raise MXNetError(f"op {self.name}: unknown param {k!r}")
        return out

    # --- execution -------------------------------------------------------
    def apply(self, inputs, params, mode: OpMode):
        """Run ``fn``; normalise the result to ``(outputs, new_aux)`` lists."""
        res = self.fn(list(inputs), params, mode)
        if isinstance(res, tuple) and len(res) == 2 and isinstance(res[0], list):
            outputs, new_aux = res
        elif isinstance(res, (list, tuple)):
            outputs, new_aux = list(res), []
        else:
            outputs, new_aux = [res], []
        return outputs, new_aux

    # --- inference -------------------------------------------------------
    def infer_shape(self, in_shapes, params, in_dtypes=None):
        """Return (completed_in_shapes, out_shapes, aux_shapes).

        ``in_shapes`` covers args then aux, entries may be None (unknown).
        """
        names = self.arg_names(params) + self.aux_names(params)
        if len(in_shapes) != len(names):
            raise MXNetError(
                f"op {self.name}: expected {len(names)} inputs "
                f"({names}), got {len(in_shapes)} shapes"
            )
        shapes = list(in_shapes)
        if self.fill_in_shapes is not None:
            shapes = list(self.fill_in_shapes(shapes, params))
        if any(s is None for s in shapes):
            missing = [n for n, s in zip(names, shapes) if s is None]
            raise MXNetError(
                f"op {self.name}: cannot infer shapes of inputs {missing}"
            )
        if in_dtypes is None:
            in_dtypes = [None] * len(shapes)
        dtypes = self._complete_dtypes(in_dtypes)
        metas = [torch.empty(tuple(s), dtype=torch_dtype(d), device="meta")
                 for s, d in zip(shapes, dtypes)]
        try:
            outs, _new_aux = self.apply(
                metas, params,
                OpMode(is_train=False, device=torch.device("meta")))
        except Exception as e:
            raise MXNetError(
                f"op {self.name}: shape inference failed for inputs "
                f"{list(zip(names, shapes))}: {e}"
            ) from e
        n_args = len(self.arg_names(params))
        arg_shapes = [tuple(s) for s in shapes[:n_args]]
        aux_shapes = [tuple(s) for s in shapes[n_args:]]
        out_shapes = [tuple(o.shape) for o in outs]
        return arg_shapes, out_shapes, aux_shapes

    def infer_dtype(self, in_dtypes, params):
        """Ops keep their inputs' dtype: unknown inputs take the first
        known one, outputs take the first input's (or the op's own
        ``infer_dtype``, a sampler's ``dtype`` parameter)."""
        dtypes = self._complete_dtypes(list(in_dtypes))
        if self._infer_dtype is not None:
            out = np_dtype(self._infer_dtype(params))
        else:
            out = dtypes[0] if dtypes else np_dtype("float32")
        out_dtypes = [out] * self.num_outputs(params)
        n_args = len(self.arg_names(params))
        return dtypes[:n_args], out_dtypes, dtypes[n_args:]

    @staticmethod
    def _complete_dtypes(in_dtypes):
        known = next((d for d in in_dtypes if d is not None), "float32")
        return [np_dtype(d if d is not None else known) for d in in_dtypes]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_OPS: dict = {}


def register(name, fn=None, **kwargs):
    """Register an op. Usable directly or as a decorator."""

    def _do(f):
        opdef = OpDef(name, f, **kwargs)
        if name in _OPS:
            raise MXNetError(f"op {name} registered twice")
        _OPS[name] = opdef
        for alias in opdef.aliases:
            _OPS[alias] = opdef
        return f

    if fn is not None:
        return _do(fn)
    return _do


def get(name: str) -> OpDef:
    op = _OPS.get(name)
    if op is None:
        raise MXNetError(f"operator {name!r} is not ported to mxnet_tpu_torch")
    return op


def exists(name: str) -> bool:
    return name in _OPS


def list_ops():
    return sorted(_OPS.keys())
