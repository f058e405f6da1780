"""Seeded random sampling for initializers and imperative use.

Counterpart of ``mxnet_tpu/random.py`` (``mx.random.seed`` and the
samplers the initializers call). The JAX package splits one threefry key
chain; here every device has its own explicit ``torch.Generator``, created
from the global seed on first use, so ``seed(n)`` makes sampling
deterministic per device. The streams cannot equal JAX's: parity tests
carry weights across with numpy, never through these samplers.
"""

from __future__ import annotations

import threading

import torch

from .context import current_context
from .ndarray import NDArray
from .ops.registry import torch_dtype

_state = threading.local()
_DEFAULT_SEED = 0


def seed(seed_state):
    """Seed every device's generator (reference ``mx.random.seed``)."""
    _state.seed = int(seed_state)
    _state.gens = {}


def generator(device):
    """The ``torch.Generator`` of ``device`` (a ``torch.device``)."""
    if not hasattr(_state, "gens"):
        seed(_DEFAULT_SEED)
    key = str(device)
    gen = _state.gens.get(key)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(_state.seed)
        _state.gens[key] = gen
    return gen


def _sample(fill, shape, ctx, dtype, out):
    if out is not None:
        t = out._data
        fill(t, generator(t.device))
        return out
    if isinstance(shape, int):
        shape = (shape,)
    device = (ctx or current_context()).torch_device()
    t = torch.empty(tuple(shape), dtype=torch_dtype(dtype), device=device)
    fill(t, generator(device))
    return NDArray(t)


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, dtype=None, out=None):
    """Samples of U[low, high) on ``ctx`` (default: the current context)."""
    return _sample(lambda t, g: t.uniform_(low, high, generator=g), shape,
                   ctx, dtype, out)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, dtype=None, out=None):
    """Samples of N(loc, scale^2) on ``ctx`` (default: the current context)."""
    return _sample(lambda t, g: t.normal_(loc, scale, generator=g), shape,
                   ctx, dtype, out)
