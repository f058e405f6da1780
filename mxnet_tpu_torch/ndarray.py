"""NDArray over a ``torch.Tensor``, and the ``.params`` file format.

Counterpart of ``mxnet_tpu/ndarray.py`` for what the serving and training
paths need: the array handle with ``asnumpy``/``copyto``/``copy``/
``as_in_context``, assignment, the arithmetic the optimizer, initializers
and metrics use, the creation helpers :func:`array`, :func:`zeros`,
:func:`ones` and :func:`empty`, :func:`clip`, one function per registered
op (``nd.sgd_mom_update(w, g, mom, out=w, ...)``), and ``.params``
:func:`save`/:func:`load`/:func:`load_buffer`, byte-compatible with the
JAX package and the reference (``src/ndarray/ndarray.cc`` NDArray::Save V2,
list container magic 0x112); :func:`load` also reads the legacy V1 and V0
array records of reference-era files (``ndarray.cc`` LegacyLoad). Sparse
storage and ``autograd`` are not yet ported.

Assignment (``a[:] = v``), ``copyto`` an NDArray, ``out=`` and the in-place
operators write into the array's existing tensor, where the JAX package
rebinds its immutable buffer: the storage stays put, so device tables and
launch parameters that hold pointers to parameters stay valid.

Creation without a ``ctx`` places the array on the current context, which
defaults to ``gpu(0)``; :func:`load` places arrays on the CPU, as the
reference's loader does, and callers move them.

Types: the JAX package runs without 64-bit types, so it narrows int64 to
int32 and float64 to float32 wherever an array is made, with a warning
where a creation function (``zeros``, ``ones``, ``astype``) was asked for
the wide type. The port narrows int64 to int32 the same way (and warns the
same way), and float64 to float32 where the
caller named no dtype; it keeps float64 where the caller asks for it
(``dtype="float64"``, or an NDArray that already holds it), because the
port's float32-against-float64 readings of its own rounding (the CPU
yardsticks of ``chip_smoke.py``) need it. ``.params`` files load in both
directions: an int64 record loads as int32, as in the reference.
"""

from __future__ import annotations

import io
import struct
import sys
import warnings

import numpy as np
import torch

from . import telemetry as _telemetry
from .base import MXNetError, np_dtype
from .context import Context, context_of, cpu, current_context
from .ops import registry as _reg
from .ops.registry import OpMode, torch_dtype

# every device->host copy flows through asnumpy
_SYNC_ASNUMPY = _telemetry.counter("ndarray.asnumpy")


def _to_numpy(t):
    # a copy: arrays are updated in place, so a view of a CPU tensor would
    # change under the caller (.cpu() copies a device tensor and waits)
    t = t.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _from_numpy(arr):
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _pinned_copy(t):
    """A copy of ``t`` in page-locked host memory."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def _to_tensor(arr, device, pinned=False):
    if pinned:
        # one copy, into page-locked memory, made by torch with the
        # interpreter lock released (a prefetch thread runs this)
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = np.array(arr, order="C", copy=True)
        return _pinned_copy(_from_numpy(arr))
    arr = np.array(arr, order="C", copy=True)  # owned and writable
    return _from_numpy(arr).to(device)


class NDArray:
    """Mutable handle over a ``torch.Tensor`` (``_data``)."""

    __slots__ = ("_data",)

    def __init__(self, data):
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        return np_dtype(str(self._data.dtype).replace("torch.", ""))

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context

    def asnumpy(self):
        """A numpy copy; waits for the device."""
        _SYNC_ASNUMPY.inc()
        return _to_numpy(self._data)

    def copyto(self, other):
        """Copy into ``other``'s storage (an NDArray, cast to its dtype) or
        to a new array on a Context."""
        if isinstance(other, NDArray):
            if other is self:
                return other
            other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            device = other.torch_device()  # raises where the card is missing
            if other.pinned:
                return NDArray(_pinned_copy(self._data))
            return NDArray(self._data.to(device, copy=True))
        raise MXNetError(f"copyto does not support type {type(other)}")

    def as_in_context(self, context):
        if self.context == context:
            return self
        return self.copyto(context)

    def copy(self):
        """A new array with the same values on the same device."""
        return NDArray(self._data.clone())

    def asscalar(self):
        return self.asnumpy().reshape(-1)[0]

    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(_narrow(dtype, "astype"))))

    def reshape(self, shape, reverse=False):
        """A view of another shape: an int or a tuple with MXNet's codes
        (0 copies a dimension, -1 infers one, -2 copies the rest, -3 merges
        two, -4 splits one), read right to left under ``reverse``."""
        from .ops.defs_tensor import infer_reshape

        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(
            infer_reshape(self.shape, tuple(shape), reverse)))

    @property
    def T(self):
        """The array with its axes reversed (a view)."""
        return NDArray(self._data.permute(*reversed(range(self.ndim))))

    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __getitem__(self, key):
        return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """Write into this array's tensor (in place)."""
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value),
                                    dtype=self._data.dtype)
        self._data[key] = value.to(self._data.device)

    # --- arithmetic -------------------------------------------------------
    @staticmethod
    def _operand(o):
        return o._data if isinstance(o, NDArray) else o

    def __add__(self, o):
        return NDArray(self._data + self._operand(o))

    __radd__ = __add__

    def __sub__(self, o):
        return NDArray(self._data - self._operand(o))

    def __rsub__(self, o):
        return NDArray(self._operand(o) - self._data)

    def __mul__(self, o):
        return NDArray(self._data * self._operand(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return NDArray(self._data / self._operand(o))

    def __rtruediv__(self, o):
        return NDArray(self._operand(o) / self._data)

    def __neg__(self):
        return NDArray(-self._data)

    def __mod__(self, o):
        # jnp.mod is the floor modulo, with the sign of the divisor
        return NDArray(torch.remainder(self._data, self._operand(o)))

    def __pow__(self, o):
        return NDArray(torch.pow(self._data, self._operand(o)))

    def __abs__(self):
        return NDArray(torch.abs(self._data))

    # --- comparisons: 0/1 in this array's dtype, as the reference's _cmp
    def _cmp(self, o, fn):
        return NDArray(fn(self._data, self._operand(o)).to(self._data.dtype))

    def __eq__(self, o):
        if o is None:
            return False
        return self._cmp(o, torch.eq)

    def __ne__(self, o):
        if o is None:
            return True
        return self._cmp(o, torch.ne)

    def __gt__(self, o):
        return self._cmp(o, torch.gt)

    def __ge__(self, o):
        return self._cmp(o, torch.ge)

    def __lt__(self, o):
        return self._cmp(o, torch.lt)

    def __le__(self, o):
        return self._cmp(o, torch.le)

    __hash__ = object.__hash__

    def __iadd__(self, o):
        self._data.add_(self._operand(o))
        return self

    def __isub__(self, o):
        self._data.sub_(self._operand(o))
        return self

    def __imul__(self, o):
        self._data.mul_(self._operand(o))
        return self

    def __itruediv__(self, o):
        self._data.div_(self._operand(o))
        return self

    def sum(self, axis=None, keepdims=False):
        if axis is None:
            return NDArray(self._data.sum())
        return NDArray(self._data.sum(dim=axis, keepdim=keepdims))

    def clip(self, a_min, a_max):
        return NDArray(torch.clamp(self._data, a_min, a_max))

    def __repr__(self):
        return (f"<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self.context}>")


def _narrow(dtype, fn=None):
    """``dtype`` with int64 narrowed to int32, warning as the reference
    does where a creation function ``fn`` was asked for int64 (``array``
    narrows silently, as ``jnp.asarray`` does; see the module docstring)."""
    if dtype is not None and np_dtype(dtype) == np.int64:
        if fn is not None:
            warnings.warn(f"Explicitly requested dtype int64 requested in "
                          f"{fn} is not available, and will be truncated to "
                          "dtype int32.", UserWarning, stacklevel=3)
        return np.dtype(np.int32)
    return dtype


def array(source_array, ctx=None, dtype=None):
    """An NDArray from an NDArray, numpy array or nested list (float32
    unless ``dtype``, as in the reference; int64 narrows to int32); on
    ``cpu_pinned`` it is page-locked."""
    ctx = ctx or current_context()
    device = ctx.torch_device()
    dtype = _narrow(dtype)
    if isinstance(source_array, NDArray):
        t = source_array._data
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        elif t.dtype == torch.int64:
            t = t.to(torch.int32)
        if ctx.pinned:
            return NDArray(_pinned_copy(t))
        return NDArray(t.to(device, copy=True))
    arr = np.asarray(source_array, dtype=np_dtype(dtype) if dtype else None)
    if dtype is None and (arr.dtype == np.float64 or (
            arr.dtype == np.int64 and not isinstance(source_array, np.ndarray))):
        arr = arr.astype(np.float32)  # mxnet default dtype is float32
    elif arr.dtype == np.int64:  # a numpy int64 array: JAX keeps 32 bits
        arr = arr.astype(np.int32)
    return NDArray(_to_tensor(arr, device, ctx.pinned))


def _filled(fill, shape, ctx, dtype, fn):
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx or current_context()
    return NDArray(fill(tuple(shape), dtype=torch_dtype(_narrow(dtype, fn)),
                        device=ctx.torch_device(), pin_memory=ctx.pinned))


def zeros(shape, ctx=None, dtype=None):
    return _filled(torch.zeros, shape, ctx, dtype, "zeros")


def ones(shape, ctx=None, dtype=None):
    return _filled(torch.ones, shape, ctx, dtype, "ones")


def empty(shape, ctx=None, dtype=None):
    return _filled(torch.empty, shape, ctx, dtype, "empty")


def clip(data, a_min, a_max, out=None):
    """Elementwise ``min(max(data, a_min), a_max)``."""
    res = torch.clamp(data._data, a_min, a_max)
    if out is None:
        return NDArray(res)
    out._data.copy_(res)
    return out


def waitall():
    """Wait for every kernel queued on the current device."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# save / load — the reference's binary .params format
# ---------------------------------------------------------------------------
_LIST_MAGIC = 0x112
_ND_V2_MAGIC = 0xF993FAC9
_ND_V1_MAGIC = 0xF993FAC8

# mshadow type flags (mshadow/base.h); 100 is the JAX package's bfloat16
_TYPE_FLAG_TO_NP = {
    0: "float32", 1: "float64", 2: "float16", 3: "uint8", 4: "int32",
    5: "int8", 6: "int64", 100: "bfloat16",
}
_NP_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_NP.items()}


def _write_shape(f, shape):
    # nnvm::Tuple::Save: uint32 ndim + int64 dims
    f.write(struct.pack("<I", len(shape)))
    f.write(struct.pack(f"<{len(shape)}q", *shape))


def _read_shape(f):
    (ndim,) = struct.unpack("<I", f.read(4))
    if not ndim:
        return ()
    dims = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
    if any(d < 0 or d >= (1 << 32) for d in dims):
        raise MXNetError("corrupt TShape while loading .params")
    return tuple(int(d) for d in dims)


def _save_one(f, arr):
    """One dense NDArray in the reference V2 layout (ndarray.cc:806-870)."""
    values = np.ascontiguousarray(arr.asnumpy())
    if values.ndim == 0:
        values = values.reshape(1)  # reference TShape has no rank-0
    f.write(struct.pack("<I", _ND_V2_MAGIC))
    f.write(struct.pack("<i", 0))  # stype: default (dense)
    _write_shape(f, values.shape)
    f.write(struct.pack("<ii", 1, 0))  # Context: kCPU, dev_id 0
    dtype_name = values.dtype.name
    if dtype_name not in _NP_TO_TYPE_FLAG:  # unknown dtypes fall back
        values = values.astype(np.float32)
        dtype_name = "float32"
    f.write(struct.pack("<i", _NP_TO_TYPE_FLAG[dtype_name]))
    f.write(values.tobytes())


def _load_one(f):
    (magic,) = struct.unpack("<I", f.read(4))
    if magic != _ND_V2_MAGIC:
        return _load_legacy(f, magic)
    (stype_id,) = struct.unpack("<i", f.read(4))
    if stype_id != 0:
        raise MXNetError("sparse NDArray records are not yet ported to "
                         "mxnet_tpu_torch")
    shape = _read_shape(f)
    if not shape:
        return array(np.zeros((0,), np.float32), ctx=cpu())
    f.read(8)  # Context (ignored: arrays load on the CPU)
    (type_flag,) = struct.unpack("<i", f.read(4))
    dtype_name = _TYPE_FLAG_TO_NP[type_flag]
    itemsize = 2 if dtype_name == "bfloat16" else np.dtype(dtype_name).itemsize
    nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
    if dtype_name == "bfloat16":
        import ml_dtypes

        values = np.frombuffer(f.read(nbytes), dtype=ml_dtypes.bfloat16)
    else:
        values = np.frombuffer(f.read(nbytes), dtype=dtype_name)
    return array(values.reshape(shape), ctx=cpu(), dtype=values.dtype)


def _load_legacy(f, magic):
    """One dense array in the legacy layouts (``ndarray.cc`` LegacyLoad):
    V1 is its magic, an int64 TShape, the context, the type flag and the
    values; V0 has no magic, its first word is the rank, followed by
    uint32 dims."""
    if magic == _ND_V1_MAGIC:
        shape = _read_shape(f)
    else:
        ndim = magic  # V0: the first word is the rank
        shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim)) if ndim else ()
    if not shape:
        return array(np.zeros((0,), np.float32), ctx=cpu())
    f.read(8)  # Context (ignored: arrays load on the CPU)
    (type_flag,) = struct.unpack("<i", f.read(4))
    dtype_name = _TYPE_FLAG_TO_NP[type_flag]
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(
        dtype_name).itemsize
    values = np.frombuffer(f.read(nbytes), dtype=dtype_name)
    return array(values.reshape(shape), ctx=cpu(), dtype=values.dtype)


def save(fname, data):
    """Save NDArrays in the reference's binary .params container."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = list(data.items())
        names = [k for k, _ in items]
    elif isinstance(data, (list, tuple)):
        items = [("", d) for d in data]
        names = []
    else:
        raise MXNetError("save: data must be NDArray, list or dict")
    for _, arr in items:
        if not isinstance(arr, NDArray):
            raise MXNetError("save: values must be NDArray")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(items)))
        for _, arr in items:
            _save_one(f, arr)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            nb = n.encode()
            f.write(struct.pack("<Q", len(nb)))
            f.write(nb)


def load(fname):
    """Load a .params file onto the CPU. Returns a list or a dict."""
    with open(fname, "rb") as f:
        return _load_stream(f, fname)


def load_buffer(data):
    """Load NDArrays from an in-memory .params blob."""
    return _load_stream(io.BytesIO(data), "<buffer>")


def _load_stream(f, fname):
    (header,) = struct.unpack("<Q", f.read(8))
    (_reserved,) = struct.unpack("<Q", f.read(8))
    if header != _LIST_MAGIC:
        raise MXNetError(f"{fname}: not a valid NDArray file")
    (count,) = struct.unpack("<Q", f.read(8))
    arrays = [_load_one(f) for _ in range(count)]
    (ncount,) = struct.unpack("<Q", f.read(8))
    names = []
    for _ in range(ncount):
        (nlen,) = struct.unpack("<Q", f.read(8))
        names.append(f.read(nlen).decode())
    if names:
        if len(names) != len(arrays):
            raise MXNetError(f"{fname}: name/array count mismatch")
        return dict(zip(names, arrays))
    return arrays


# ---------------------------------------------------------------------------
# one function per registered op (the reference's generated mx.nd namespace)
# ---------------------------------------------------------------------------
def _make_ndarray_function(opdef, func_name):
    def generic_op(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        arrays = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
        raw = {k: v for k, v in kwargs.items() if not isinstance(v, NDArray)}
        params = opdef.parse_params(raw)
        pos = list(args)
        inputs = []
        names = opdef.arg_names(params) + opdef.aux_names(params)
        for nm in names:
            if nm in arrays:
                inputs.append(arrays.pop(nm))
            elif pos:
                inputs.append(pos.pop(0))
            else:
                raise MXNetError(f"{func_name}: missing input {nm!r}")
        if pos or arrays:
            raise MXNetError(f"{func_name}: unexpected inputs")
        outputs, new_aux = opdef.apply([i._data for i in inputs], params,
                                       OpMode(is_train=False))
        n_args = len(opdef.arg_names(params))
        for handle, value in zip(inputs[n_args:], new_aux):
            if value is not handle._data:
                handle._data.copy_(value)
        arg_names = opdef.arg_names(params)
        for in_name, out_idx in opdef.mutate:
            inputs[arg_names.index(in_name)]._data.copy_(outputs[out_idx])
        vis = outputs[:opdef.num_visible_outputs(params)]
        if out is not None:
            outs = out if isinstance(out, (list, tuple)) else [out]
            for handle, value in zip(outs, vis):
                handle._data.copy_(value)
            return out
        res = [NDArray(o) for o in vis]
        return res[0] if len(res) == 1 else res

    generic_op.__name__ = func_name
    generic_op.__doc__ = opdef.doc or f"{func_name} (op {opdef.name})"
    return generic_op


def _init_ops():
    module = sys.modules[__name__]
    for name in _reg.list_ops():
        if not hasattr(module, name):
            setattr(module, name, _make_ndarray_function(_reg.get(name), name))


_init_ops()
