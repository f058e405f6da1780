"""KVStore — the key-value store of the training scripts, on one process.

Counterpart of ``mxnet_tpu/kvstore.py`` (reference ``include/mxnet/
kvstore.h`` and ``src/kvstore/``, ``KVStore::Create`` in kvstore.cc:16-44)
for the in-process store: ``local``, ``local_update_cpu``,
``local_allreduce_cpu``, ``local_allreduce_device``, ``device`` and
``nccl``. ``push`` merges (sums) a pushed list of values and, once
``set_optimizer`` was called, applies the optimizer to the stored weight
(``Module``'s ``update_on_kvstore`` path); ``pull`` copies the stored value
out. A stored value stays on the device of the value given to ``init``.

The multi-process stores (``dist_*``) are ``ROADMAP.md`` queue 1 item 7,
and ``row_sparse_pull`` item 13: both raise :class:`MXNetError`.
"""

from __future__ import annotations

from . import telemetry as _tm
from .base import MXNetError


def _key_str(key):
    return str(key)


def _nbytes(v):
    """Payload size of one pushed or pulled value."""
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return int(v.size) * v.dtype.itemsize


_IO_COUNTERS = {
    "push": (_tm.counter("kvstore.push"), _tm.counter("kvstore.push_bytes")),
    "pull": (_tm.counter("kvstore.pull"), _tm.counter("kvstore.pull_bytes")),
}


def _count_io(op, keys, values):
    """Count a push or pull against the kvstore telemetry counters."""
    count, nbytes = _IO_COUNTERS[op]
    count.inc(len(keys))
    nbytes.inc(sum(_nbytes(v) for v in values))


def _merge_pushed(v):
    """One pushed value (an NDArray, or a list of per-device NDArrays) as
    one new array: a list is summed left to right, as the reference's
    ``CommDevice::Reduce`` sums the devices' copies."""
    if isinstance(v, (list, tuple)):
        merged = v[0].copy()
        for x in v[1:]:
            merged += x
        return merged
    return v.copy()


class KVStore:
    """In-process key-value store (the local and device types)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    # --- identity ------------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # --- data plane ----------------------------------------------------
    def init(self, key, value):
        """Store a copy of each value (the first of a per-device list), on
        that value's device."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            vv = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = vv.copy()

    def push(self, key, value, priority=0):
        """Merge each pushed value; with an updater set, apply it to the
        stored weight in place, else store the merged value."""
        keys, values = _key_value(key, value)
        _count_io("push", keys, values)
        for k, v in zip(keys, values):
            merged = _merge_pushed(v)
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            if self._updater is not None:
                self._updater(_updater_key(k), merged, self._store[k])
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0):
        """Copy each stored value into ``out`` (an NDArray, or a list of
        them per key)."""
        if out is None:
            raise MXNetError("pull needs out")
        keys, outs = _key_value(key, out)
        _count_io("pull", keys, outs)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            src = self._store[k]
            for x in (o if isinstance(o, (list, tuple)) else [o]):
                src.copyto(x)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull: sparse storage is not yet ported "
                         "to mxnet_tpu_torch (ROADMAP.md queue 1 item 13)")

    # --- optimizer plane ----------------------------------------------
    def set_optimizer(self, optimizer):
        """Apply ``optimizer`` at every push from now on."""
        from .optimizer import get_updater

        self._optimizer = optimizer
        self._set_updater(get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    set_updater = _set_updater

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("save_optimizer_states: the store has no "
                             "optimizer (call set_optimizer)")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("load_optimizer_states: the store has no "
                             "optimizer (call set_optimizer)")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def broadcast_ints(self, values):
        """Rank 0's integer vector; one process is trivially in
        agreement."""
        return [int(v) for v in values]

    # --- cluster plane -------------------------------------------------
    def barrier(self):
        """One process: nothing to wait for."""


_KNOWN = frozenset({
    "local", "local_update_cpu", "local_allreduce_cpu",
    "local_allreduce_device", "device", "nccl",
    "dist_sync", "dist_sync_device", "dist_device_sync",
    "dist_async", "dist_device_async",
})


def create(name="local"):
    """Create a KVStore (reference ``mx.kv.create``): the name is matched
    case-insensitively, ``dist`` is an alias of ``dist_sync``, and a name
    outside the known set raises ValueError."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name == "dist":
        name = "dist_sync"
    if name not in _KNOWN:
        raise ValueError(
            f"Unknown KVStore type '{name}' (accepted: {sorted(_KNOWN)}, "
            "plus 'dist' as an alias for dist_sync; matching is "
            "case-insensitive)"
        )
    if "dist" in name:
        raise MXNetError(
            f"kvstore {name!r}: multi-process stores are not yet ported to "
            "mxnet_tpu_torch (ROADMAP.md queue 1 item 7)")
    return KVStore(name)


def _key_value(keys, vals):
    if isinstance(keys, (tuple, list)):
        if len(keys) != len(vals):
            raise MXNetError(f"{len(keys)} keys but {len(vals)} values")
        return [_key_str(k) for k in keys], list(vals)
    return [_key_str(keys)], [vals]


def _updater_key(k):
    try:
        return int(k)
    except ValueError:
        return k


__all__ = ["KVStore", "create"]
