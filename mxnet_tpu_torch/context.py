"""Device contexts.

Reference: ``include/mxnet/base.h:101-318`` (``Context{kCPU,kGPU,...}``) and
``python/mxnet/context.py``. Here a Context names a ``torch.device``:
``gpu(i)`` is the i-th CUDA device and ``cpu()`` the host. Unlike
``mxnet_tpu``, whose default context is ``cpu(0)``, the port's default
is ``gpu(0)``: its entry points run on the card unless the caller asks for
the CPU. Resolving a ``gpu`` context on a machine without one raises
:class:`MXNetError` — nothing carries on silently on the CPU.
``cpu_pinned()`` is page-locked host memory, from which a copy to the card
runs asynchronously: arrays made on it or copied to it are pinned
(``Tensor.pin_memory``), and resolving it on a machine without a card
raises :class:`MXNetError` as ``gpu`` does.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError


class Context:
    """A device context. Thread-local default stack like the reference."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise MXNetError(f"unknown device type {device_type!r}")
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (
            isinstance(other, Context)
            and self.device_typeid == other.device_typeid
            and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __str__(self):
        return self.__repr__()

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @property
    def pinned(self):
        """True for ``cpu_pinned``: arrays on it are page-locked."""
        return self.device_type == "cpu_pinned"

    def torch_device(self):
        """The ``torch.device`` this context names. A ``gpu`` context
        raises :class:`MXNetError` when CUDA is absent or the id is out of
        range, and ``cpu_pinned`` when CUDA is absent (page-locked memory
        is CUDA's)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if self.pinned:
            if n == 0:
                raise MXNetError(
                    f"{self} requested but no CUDA device is visible: "
                    "page-locked host memory needs a card")
            return torch.device("cpu")
        if self.device_id >= n:
            raise MXNetError(
                f"{self} requested but {n} CUDA device(s) are visible")
        return torch.device("cuda", self.device_id)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def current_context():
    if not hasattr(Context._default_ctx, "value"):
        Context._default_ctx.value = Context("gpu", 0)
    return Context._default_ctx.value


def num_gpus():
    """Number of visible CUDA devices."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def context_of(device):
    """The Context naming a ``torch.device``."""
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)
