"""Standalone inference predictor.

Counterpart of ``mxnet_tpu/predictor.py`` (reference: the C predict ABI,
``include/mxnet/c_predict_api.h``): create a predictor from symbol JSON +
params, set input, forward, get output — no training machinery in the
loop. Sharded (``mesh``) predictors and the partial-forward / flat-buffer
accessors of the C shim are not yet ported.

**Default device.** The JAX Predictor defaults to ``dev_type="cpu"``,
mirroring ``MXPredCreate``. The port's default is ``dev_type="gpu"``: it
runs on the card unless the caller asks for the CPU, and without a card a
gpu predictor raises :class:`MXNetError`.

Thread safety (the serving batcher's contract): every public method takes
the predictor's internal re-entrant lock, so individual calls are atomic.
The ``set_input`` → ``forward`` → ``get_output`` SEQUENCE is *not* atomic
across threads; concurrent callers use :meth:`Predictor.run`, which
performs the whole cycle under the lock and returns numpy outputs.
``get_output`` copies to the host, which waits for the device, so the
arrays it returns are final.
"""

from __future__ import annotations

import threading

import numpy as np

from .base import MXNetError, np_dtype, parse_shape
from .context import Context, cpu
from .executor import Executor
from .ndarray import NDArray, array, load as nd_load, load_buffer, zeros
from .symbol import Symbol, fromjson, load as sym_load


class Predictor:
    """Inference-only predictor (reference ``MXPredCreate`` semantics)."""

    def __init__(self, symbol_json_or_file, param_source, input_shapes,
                 ctx=None, dev_type="gpu", dev_id=0, output_index=None,
                 fold_bn=True, input_types=None):
        self._lock = threading.RLock()
        if isinstance(symbol_json_or_file, Symbol):
            symbol = symbol_json_or_file
        elif isinstance(symbol_json_or_file, str) and \
                symbol_json_or_file.lstrip().startswith("{"):
            symbol = fromjson(symbol_json_or_file)
        else:
            symbol = sym_load(symbol_json_or_file)
        if output_index is not None:
            symbol = symbol[output_index]
        self.symbol = symbol
        self._fold_bn = fold_bn
        self.ctx = ctx if ctx is not None else Context(dev_type, dev_id)
        self.ctx.torch_device()  # no card for a gpu predictor: raise now

        if isinstance(param_source, bytes):
            params = load_buffer(param_source)  # MXPredCreate param blob
        elif isinstance(param_source, str):
            params = nd_load(param_source)
        else:
            params = param_source
        self.arg_params = {}
        self.aux_params = {}
        for k, v in params.items():
            if k.startswith("arg:"):
                self.arg_params[k[4:]] = v
            elif k.startswith("aux:"):
                self.aux_params[k[4:]] = v
            else:
                self.arg_params[k] = v

        self.input_shapes = dict(input_shapes)
        # input dtypes: float32 unless declared (reference MXPredCreateEx)
        self.input_types = {
            k: np_dtype(v) for k, v in (input_types or {}).items()
        }
        unknown_types = set(self.input_types) - set(self.input_shapes)
        if unknown_types:
            raise MXNetError(
                f"input_types names {sorted(unknown_types)} are not inputs "
                f"(inputs: {sorted(self.input_shapes)})")
        if self._fold_bn:
            # deployment-time optimization: inference BatchNorms collapse
            # into their producer conv/fc (contrib/quantize_fold.py)
            from .contrib import fold_batchnorm

            try:
                self.symbol, self.arg_params = fold_batchnorm(
                    self.symbol, self.arg_params, self.aux_params
                )
            except MXNetError:
                pass  # malformed/partial param sets: predict unfolded
        self._bind()

    def _infer_shapes(self):
        """``(arg_shapes, aux_shapes)`` for the bound input shapes,
        completing partial ``__shape__`` hints (0 = batch) on extra input
        args with the inputs' batch size."""
        shape_kwargs = dict(self.input_shapes)
        attrs = self.symbol.attr_dict()
        bsz = next(iter(self.input_shapes.values()))[0]
        for name in self.symbol.list_arguments():
            if name in shape_kwargs or name in self.arg_params:
                continue
            hint = (attrs.get(name) or {}).get("__shape__")
            if hint:
                s = parse_shape(hint)
                if s:
                    shape_kwargs[name] = tuple(
                        bsz if d == 0 else d for d in s)
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shape_kwargs)
        return arg_shapes, aux_shapes

    def _bind(self):
        arg_names = self.symbol.list_arguments()
        unknown = set(self.input_shapes) - set(arg_names)
        if unknown:
            raise MXNetError(
                f"input_shapes names {sorted(unknown)} are not arguments "
                f"of this symbol (arguments: {arg_names})")
        arg_shapes, aux_shapes = self._infer_shapes()
        aux_names = self.symbol.list_auxiliary_states()
        args = {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in self.input_shapes:
                args[name] = zeros(shape, ctx=self.ctx,
                                   dtype=self.input_types.get(name))
            elif name in self.arg_params:
                if tuple(self.arg_params[name].shape) != tuple(shape):
                    raise MXNetError(
                        f"param {name} shape mismatch: bound {shape}, "
                        f"file {self.arg_params[name].shape}"
                    )
                # params live ON the inference device: host-resident
                # arrays would re-transfer on every forward
                args[name] = self.arg_params[name].as_in_context(self.ctx)
            else:
                # reference c_predict_api leaves args absent from the param
                # file zero-initialised (labels etc., c_predict_api.cc:195)
                args[name] = zeros(shape, ctx=self.ctx)
        auxs = {}
        for name, shape in zip(aux_names, aux_shapes):
            if name in self.aux_params:
                auxs[name] = self.aux_params[name].as_in_context(self.ctx)
            else:
                auxs[name] = zeros(shape, ctx=self.ctx)
        self._exec = Executor(self.symbol, self.ctx, args=args,
                              grad_req="null", aux_states=auxs)

    def reshape(self, input_shapes):
        """Re-bind with new input shapes (reference MXPredReshape)."""
        with self._lock:
            old = self.input_shapes
            self.input_shapes = dict(input_shapes)
            try:
                self._bind()
            except MXNetError:
                self.input_shapes = old  # keep the predictor usable
                raise

    def set_input(self, name, data):
        """Write one input, coerced to the BOUND argument's dtype."""
        with self._lock:
            if name not in self.input_shapes:
                raise MXNetError(f"{name!r} is not an input")
            tgt = self._exec.arg_dict[name]
            if not isinstance(data, NDArray):
                data = np.asarray(data)
                if tuple(data.shape) != tgt.shape:
                    raise MXNetError(
                        f"set_input: shape mismatch for {name}: bound "
                        f"{tgt.shape}, got {tuple(data.shape)}")
                data = array(data, ctx=cpu(), dtype=tgt.dtype)
            data.copyto(tgt)

    def forward(self, **kwargs):
        with self._lock:
            for k, v in kwargs.items():
                self.set_input(k, v)
            self._exec.forward(is_train=False)

    def compile(self, kinds=("forward",)):
        """Warm this predictor's forward (see :meth:`Executor.compile`)."""
        with self._lock:
            return self._exec.compile(list(kinds))

    def input_dtypes(self):
        """Bound numpy dtype per input name (the serving admission
        coercion contract)."""
        with self._lock:
            return {n: np_dtype(self._exec.arg_dict[n].dtype)
                    for n in self.input_shapes}

    def run(self, **inputs):
        """Atomic set-inputs → forward → fetch under the predictor lock
        (the serving batcher's entry point). Returns numpy outputs."""
        with self._lock:
            self.forward(**inputs)
            return [self.get_output(i) for i in range(self.num_outputs)]

    def set_params(self, arg_params, aux_params=None, allow_missing=False):
        """Swap weight VALUES into the bound executor without re-binding
        (shapes must match). Every non-input bound argument must be present
        unless ``allow_missing``; every entry is validated before the
        first copy, so a failure leaves the bound weights untouched."""
        aux_params = aux_params or {}
        with self._lock:
            missing = [n for n in self._exec.arg_names
                       if n not in self.input_shapes
                       and n not in arg_params and n in self.arg_params]
            if missing and not allow_missing:
                raise MXNetError(
                    f"set_params: missing {len(missing)} bound params "
                    f"(e.g. {missing[:3]}); pass allow_missing=True to "
                    "keep current values for them")
            arg_swaps, aux_swaps = [], []
            for name, v in arg_params.items():
                if name in self.input_shapes:
                    continue
                if name not in self._exec.arg_dict:
                    raise MXNetError(f"set_params: {name!r} is not a "
                                     "bound argument")
                tgt = self._exec.arg_dict[name]
                arg_swaps.append((tgt, name, self._check_one(tgt, name, v)))
            for name, v in aux_params.items():
                if name not in self._exec.aux_dict:
                    continue  # folded-out BN stats etc.
                tgt = self._exec.aux_dict[name]
                aux_swaps.append((tgt, name, self._check_one(tgt, name, v)))
            for tgt, name, v in arg_swaps:
                v.copyto(tgt)
                self.arg_params[name] = v
            for tgt, name, v in aux_swaps:
                v.copyto(tgt)
                self.aux_params[name] = v

    @staticmethod
    def _check_one(tgt, name, v):
        if not isinstance(v, NDArray):
            v = array(np.asarray(v), ctx=tgt.context, dtype=tgt.dtype)
        if tuple(v.shape) != tuple(tgt.shape):
            raise MXNetError(
                f"set_params: {name} shape mismatch: bound "
                f"{tuple(tgt.shape)}, new {tuple(v.shape)}")
        return v

    def get_output(self, index):
        """Output ``index`` as a numpy array (waits for the device)."""
        with self._lock:
            return self._exec.outputs[index].asnumpy()

    @property
    def num_outputs(self):
        with self._lock:
            return len(self._exec.output_names)


def create_predictor(symbol_json, param_bytes, input_shapes, dev_type="gpu",
                     dev_id=0):
    """Entry point of the C predict shim (MXPredCreate marshalling)."""
    return Predictor(
        symbol_json, param_bytes, input_shapes,
        dev_type=dev_type, dev_id=dev_id,
    )
