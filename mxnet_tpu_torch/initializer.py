"""Weight initializers.

A copy of ``mxnet_tpu/initializer.py`` (reference
``python/mxnet/initializer.py``): the registry, ``InitDesc`` and the
name-pattern dispatch (``*_weight`` -> weight init, ``*_bias``/``*_gamma``/
``*_beta``/``moving_*`` -> defaults), ``Zero``, ``One``, ``Constant``,
``Uniform``, ``Normal``, ``Xavier``, ``MSRAPrelu``, ``Load`` and ``Mixed``.
Random values come from :mod:`mxnet_tpu_torch.random` (one seeded
``torch.Generator`` per device) and are written into the array on its own
device. ``Orthogonal`` and the bilinear ``upsampling`` rule are not yet
ported.
"""

from __future__ import annotations

import json
import re

import numpy as np

from .base import MXNetError
from .ndarray import NDArray
from . import random as _random

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Name + attrs descriptor handed to initializers (reference InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer with the reference's name-pattern dispatch."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        if not isinstance(arr, NDArray):
            raise TypeError("arr must be NDArray")
        attrs = getattr(desc, "attrs", {})
        if attrs.get("__init__"):
            klass, kwargs = json.loads(attrs["__init__"])
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("upsampling"):
            self._init_bilinear(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    # --- default rules ----------------------------------------------------
    def _init_bilinear(self, desc, _arr):
        raise MXNetError(f"{desc}: the bilinear upsampling initializer is "
                         "not yet ported to mxnet_tpu_torch")

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override _init_weight")

    def _init_default(self, name, arr):
        raise ValueError(
            f"Unknown initialization pattern for {name}. Default initialization "
            "is now limited to _weight/_bias/_gamma/_beta/moving_* suffixes; "
            "use mx.sym.Variable(init=...) to set initialization explicitly."
        )

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _random.uniform(-self.scale, self.scale, out=arr)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _random.normal(0.0, self.sigma, out=arr)


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(
            rnd_type=rnd_type, factor_type=factor_type, magnitude=magnitude
        )
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError(
                f"Xavier initializer cannot be applied to vector {name}"
            )
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = 1.0
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _random.uniform(-scale, scale, out=arr)
        elif self.rnd_type == "gaussian":
            _random.normal(0.0, scale, out=arr)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Load:
    """Init from a dict of arrays, falling back to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load

            param = nd_load(param)
        self.param = {
            (k[4:] if k.startswith("arg:") or k.startswith("aux:") else k): v
            for k, v in param.items()
        }
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if tuple(self.param[name].shape) != tuple(arr.shape):
                raise ValueError(
                    f"Parameter {name} cannot be initialized from loading. "
                    f"Shape mismatch, target {arr.shape} vs loaded "
                    f"{self.param[name].shape}"
                )
            arr[:] = self.param[name]
        else:
            if self.default_init is None:
                raise ValueError(
                    f"Cannot Initialize {name}. Not found in loaded param and "
                    "no default initializer provided."
                )
            self.default_init(name, arr)


@register
class Mixed:
    """Pattern-dispatch between multiple initializers."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            f"Parameter name {name} did not match any pattern. Consider "
            'adding a ".*" pattern at the end with default Initializer.'
        )


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)
