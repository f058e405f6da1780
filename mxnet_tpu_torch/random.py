"""Seeded random sampling for initializers and imperative use, and the key
chain of the random ops.

Counterpart of ``mxnet_tpu/random.py`` (``mx.random.seed``, ``next_key``,
``get_state``/``set_state`` and the samplers the initializers call). Two
sources, both reset by :func:`seed`:

* a counter-based key chain: :func:`next_key` returns the 64-bit key
  ``splitmix64(splitmix64(seed) + counter)`` and advances the counter. Each
  executor takes one key at bind, and each imperative call of a random op
  (``Dropout``) one key per call; the ``dropout`` kernel draws its bits
  from that key by Philox4x32-10 (``kernels/dropout.py``). The JAX package
  splits a threefry key instead, so the keys, and the bits drawn from them,
  cannot equal JAX's;
* one explicit ``torch.Generator`` per device, created from the seed on
  first use, for the samplers.

The streams cannot equal JAX's: parity tests carry weights and masks
across with numpy, never through these sources.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError
from .context import current_context
from .ndarray import NDArray
from .ops.registry import torch_dtype

_state = threading.local()
_DEFAULT_SEED = 0
_M64 = (1 << 64) - 1


def _splitmix64(x):
    """The splitmix64 finaliser of ``x + golden ratio`` (a bijection of
    64-bit integers)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def seed(seed_state):
    """Seed the key chain and every device's generator (reference
    ``mx.random.seed``)."""
    _state.seed = int(seed_state) & _M64
    _state.counter = 0
    _state.gens = {}


def _ensure():
    if not hasattr(_state, "gens"):
        seed(_DEFAULT_SEED)


def next_key():
    """A fresh 64-bit key from the ``(seed, counter)`` chain."""
    _ensure()
    _state.counter += 1
    return _splitmix64((_splitmix64(_state.seed) + _state.counter) & _M64)


def generator(device):
    """The ``torch.Generator`` of ``device`` (a ``torch.device``)."""
    _ensure()
    key = str(device)
    gen = _state.gens.get(key)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(_state.seed)
        _state.gens[key] = gen
    return gen


def get_state():
    """The chain and every device generator's state as one list of ints
    (JSON-serializable, for checkpoint manifests): ``[seed, counter,
    number of generators]``, then per generator its device name's length
    and characters and its state's length and bytes."""
    _ensure()
    out = [_state.seed, _state.counter, len(_state.gens)]
    for name, gen in sorted(_state.gens.items()):
        raw = gen.get_state().tolist()
        out += [len(name), *map(ord, name), len(raw), *raw]
    return out


def set_state(state):
    """Restore what :func:`get_state` captured (checkpoint resume)."""
    state = [int(v) for v in state]
    try:
        seed_, counter, n = state[:3]
        gens, pos = {}, 3
        for _ in range(n):
            length = state[pos]
            name = "".join(map(chr, state[pos + 1:pos + 1 + length]))
            pos += 1 + length
            length = state[pos]
            raw = torch.tensor(state[pos + 1:pos + 1 + length],
                               dtype=torch.uint8)
            pos += 1 + length
            gen = torch.Generator(device=torch.device(name))
            gen.set_state(raw)
            gens[name] = gen
    except (ValueError, IndexError, RuntimeError) as e:
        raise MXNetError(f"random.set_state: not a state of get_state: "
                         f"{e}") from e
    _state.seed, _state.counter, _state.gens = seed_, counter, gens


def _sample(fill, shape, ctx, dtype, out):
    if out is not None:
        t = out._data
        fill(t, generator(t.device))
        return out
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx or current_context()
    device = ctx.torch_device()
    t = torch.empty(tuple(shape), dtype=torch_dtype(dtype), device=device,
                    pin_memory=ctx.pinned)
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
