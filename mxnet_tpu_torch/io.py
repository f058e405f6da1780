"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (reference ``python/mxnet/io.py``) for
what ``Module.fit`` consumes: ``DataDesc``, ``DataBatch``, the ``DataIter``
base, ``NDArrayIter`` over in-memory arrays, ``MNISTIter`` over idx files,
and the prefetchers ``PrefetchingIter`` and ``DevicePrefetchIter``. Batches
are placed on the iterator's ``ctx``, the current context (``gpu(0)``)
unless the caller asks for another.

Device prefetch: a thread pulls the wrapped iterator, its batches made in
page-locked host memory (``cpu_pinned``), and copies each dense array to
its device with ``non_blocking=True`` on a side CUDA stream, then records
an event. The consumer's stream waits on that event when the batch is
taken, and each copy is marked as used on that stream
(``Tensor.record_stream``), so the caching allocator cannot hand its memory
to a later batch while a step still reads it. A pinned source is not
reused before its copy ends: torch's pinned-memory allocator records an
event at each asynchronous copy and reuses the block only after it. The
side stream is never made current for the consumer's thread, so every
kernel wrapper keeps launching on the consumer's stream. The retrying and
RecordIO iterators are not yet ported (``ROADMAP.md`` queue 1 items 3b
and 6).
"""

from __future__ import annotations

import gzip
import os
import queue as _queue
import struct
import threading
import time as _time
from collections import namedtuple

import numpy as np
import torch

from . import telemetry as _telemetry
from .base import MXNetError, np_dtype
from .context import Context, cpu_pinned, current_context
from .ndarray import NDArray, _pinned_copy, array

_PF_BATCHES = _telemetry.counter("io.prefetch.batches")
_PF_DEPTH = _telemetry.gauge("io.prefetch.queue_depth")
_PF_STALL = _telemetry.histogram("io.prefetch.producer_stall_us")
_PF_WAIT = _telemetry.histogram("io.prefetch.consumer_wait_us")


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data descriptor with dtype/layout (reference io.DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = np_dtype(dtype)
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (reference ``DataIter``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(
                data=self.getdata(), label=self.getlabel(),
                pad=self.getpad(), index=self.getindex(),
            )
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalise input data to a list of (name, numpy array) (reference)."""
    if data is None and not allow_empty:
        raise MXNetError("NDArrayIter: data is required")
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise MXNetError("NDArrayIter: data is an empty list")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError(
            "Input must be NDArray, numpy.ndarray, a list of them or dict "
            "with them as values"
        )
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference ``NDArrayIter``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        # device the produced batches are placed on (None: the current
        # context at the time a batch is made)
        self.ctx = ctx

        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [
            DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
            for k, v in self.data
        ]

    @property
    def provide_label(self):
        return [
            DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
            for k, v in self.label
        ]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(
                data=self.getdata(), label=self.getlabel(),
                pad=self.getpad(), index=None,
            )
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise MXNetError("DataIter needs reset.")
        if self.cursor + self.batch_size <= self.num_data:
            return [
                array(x[1][self.cursor:self.cursor + self.batch_size],
                      ctx=self.ctx)
                for x in data_source
            ]
        pad = self.batch_size - self.num_data + self.cursor
        return [
            array(np.concatenate((x[1][self.cursor:], x[1][:pad]), axis=0),
                  ctx=self.ctx)
            for x in data_source
        ]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class MNISTIter(NDArrayIter):
    """MNIST idx-format reader (reference ``iter_mnist.cc``).

    Reads ``train-images-idx3-ubyte`` and its labels, raw or ``.gz``;
    ``flat`` gives (N, 784) in place of (N, 1, 28, 28), scaled to [0, 1];
    ``num_parts``/``part_index`` take every ``num_parts``-th sample from
    ``part_index`` (data-parallel sharding); ``shuffle`` permutes by
    ``seed``; the last partial batch is discarded. Batches are placed on
    ``ctx`` as ``NDArrayIter`` places them.
    """

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False, num_parts=1,
                 part_index=0, ctx=None, **kwargs):
        imgs = self._read_idx(image)
        labels = self._read_idx(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1).astype(np.float32) / 255.0
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1],
                                imgs.shape[2]).astype(np.float32) / 255.0
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            labels = labels[part_index::num_parts]
        if shuffle:
            perm = np.random.RandomState(seed).permutation(imgs.shape[0])
            imgs, labels = imgs[perm], labels[perm]
        super().__init__(
            data=imgs, label=labels.astype(np.float32),
            batch_size=batch_size, shuffle=False, last_batch_handle="discard",
            ctx=ctx,
        )

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path = path + ".gz"
            opener = gzip.open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = np.frombuffer(f.read(), dtype=np.uint8)
            return data.reshape(dims)


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def _as_device(placement):
    """The ``torch.device`` of a placement: a Context (a ``gpu`` one
    raises MXNetError without a card) or anything ``torch.device`` takes."""
    if isinstance(placement, Context):
        return placement.torch_device()
    return torch.device(placement)


def _host_context(devices):
    """The context a prefetch thread makes batches in: page-locked host
    memory when some batch goes to a card (``devices``: the staging
    placements, None for none), else the creating thread's current context
    (what the wrapped iterator would use unwrapped)."""
    if any(d is not None and d.type == "cuda" for d in devices):
        return cpu_pinned()
    return current_context()


class _Staged:
    """The copies of one staged batch, for its consumer: (device, event)
    for each side stream, recorded after its copies; the copies; and their
    pinned sources (held until the consumer takes the batch)."""

    __slots__ = ("events", "copies", "sources")

    def __init__(self):
        self.events, self.copies, self.sources = [], [], []


def _stage_databatch(batch, shardings, device, ddesc, ldesc, streams):
    """Copy a DataBatch's dense arrays to their devices (input name ->
    ``shardings``, else ``device``; None leaves an array where it is). A
    host array bound for a card is copied from page-locked memory with
    ``non_blocking=True`` on that card's side stream in ``streams``, and
    each stream records an event after its copies; arrays already in place
    pass through. Mutates and returns ``batch``, marked ``staged``."""
    staged = _Staged()
    used = {}

    def place(a, dst):
        if isinstance(a, np.ndarray):
            a = array(a, ctx=Context("cpu"))
        if dst is None or not isinstance(a, NDArray) or a._data.device == dst:
            return a
        t = a._data
        if dst.type != "cuda" or t.device.type != "cpu":
            return NDArray(t.to(dst))
        if not t.is_pinned():
            t = _pinned_copy(t)
        stream = streams.get(dst)
        if stream is None:
            stream = streams[dst] = torch.cuda.Stream(dst)
        with torch.cuda.stream(stream):
            out = t.to(dst, non_blocking=True)
        used[dst] = stream
        staged.copies.append(out)
        staged.sources.append(t)
        return NDArray(out)

    def stage_list(arrs, descs):
        out = []
        for i, a in enumerate(arrs or []):
            name = descs[i].name if descs and i < len(descs) else None
            out.append(place(a, shardings.get(name, device)))
        return out

    batch.data = stage_list(batch.data, ddesc)
    if batch.label is not None:
        batch.label = stage_list(batch.label, ldesc)
    for dst, stream in used.items():
        event = torch.cuda.Event()
        event.record(stream)
        staged.events.append((dst, event))
    batch._staged = staged if staged.copies else None
    batch.staged = True
    return batch


def _take_staged(batch):
    """Make the current streams wait for ``batch``'s copies and mark each
    copy as used on its device's current stream. Enqueues waits only: no
    host synchronisation."""
    staged = getattr(batch, "_staged", None)
    if staged is None:
        return batch
    for dst, event in staged.events:
        torch.cuda.current_stream(dst).wait_event(event)
    for copy in staged.copies:
        copy.record_stream(torch.cuda.current_stream(copy.device))
    batch._staged = None
    return batch


class _PrefetchError:
    """Carrier for an exception raised inside the staging thread."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


_EPOCH_END = object()


class PrefetchingIter(DataIter):
    """Background prefetch over one or more iterators, one thread each
    (reference ``PrefetchingIter`` / C++ ``PrefetcherIter``): the batches
    of the iterators are joined into one.

    ``shardings`` (input name -> Context) or ``context`` additionally
    stage each prefetched batch's dense arrays on the device from the
    prefetch thread, as ``DevicePrefetchIter`` does.
    """

    def __init__(self, iters, rename_data=None, rename_label=None,
                 shardings=None, context=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        if self.n_iter == 0:
            raise MXNetError("PrefetchingIter needs at least one iterator")
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.shardings = {n: _as_device(p)
                          for n, p in (shardings or {}).items()}
        self._stage_device = (_as_device(context) if context is not None
                              else None)
        self._streams = {}
        host = _host_context([*self.shardings.values(), self._stage_device])
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self.prefetch_err = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            Context._default_ctx.value = host
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    batch = self.iters[i].next()
                    if self.shardings or self._stage_device is not None:
                        batch = self._stage_batch(batch, self.iters[i])
                    self.next_batch[i] = batch
                except StopIteration:
                    self.next_batch[i] = None
                except BaseException as exc:
                    # delivered to the consumer, which raises it: dying
                    # here without data_ready would hang iter_next
                    self.prefetch_err[i] = exc
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True)
            for i in range(self.n_iter)
        ]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()

    def _stage_batch(self, batch, it):
        return _stage_databatch(
            batch, self.shardings, self._stage_device,
            batch.provide_data or it.provide_data,
            batch.provide_label or it.provide_label, self._streams,
        )

    def _renamed(self, kind, renames):
        if renames is None:
            return sum([getattr(i, kind) for i in self.iters], [])
        return sum(
            [
                [
                    DataDesc(r[x.name], x.shape, x.dtype)
                    if isinstance(x, DataDesc) else DataDesc(*x)
                    for x in getattr(i, kind)
                ]
                for r, i in zip(renames, self.iters)
            ],
            [],
        )

    @property
    def provide_data(self):
        return self._renamed("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._renamed("provide_label", self.rename_label)

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        for i, exc in enumerate(self.prefetch_err):
            if exc is not None:
                self.prefetch_err[i] = None
                raise exc
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError(
                    "Number of entry mismatches between iterators")
            return False
        if any(b is None or b.pad != self.next_batch[0].pad
               for b in self.next_batch):
            raise MXNetError("Number of entry mismatches between iterators")
        for b in self.next_batch:
            _take_staged(b)
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad,
            self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label,
        )
        if all(getattr(b, "staged", False) for b in self.next_batch):
            self.current_batch.staged = True
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class DevicePrefetchIter(DataIter):
    """Stage batch N+1 on the device while batch N computes (reference
    ``DevicePrefetchIter``, the analogue of MXNet's ``iter_prefetcher.h``
    double buffering). ``Module.fit`` wraps its data iterator in one
    (``MXNET_DEVICE_PREFETCH``, depth ``MXNET_PREFETCH_DEPTH``).

    A thread pulls ``data_iter`` and stages each batch as the module
    docstring says: ``shardings`` maps an input name to its Context (or
    ``torch.device``), ``context`` places the other inputs; an input with
    neither stays where the iterator made it. Up to ``depth`` staged
    batches wait in a queue. Order, ``pad``, ``index``, ``bucket_key`` and
    the batches' own ``provide_data``/``provide_label`` are those of the
    wrapped iterator, and an exception it raises reaches the consumer.
    """

    def __init__(self, data_iter, shardings=None, context=None, depth=2):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self.data_iter = data_iter
        self.shardings = {n: _as_device(p)
                          for n, p in (shardings or {}).items()}
        self._device = _as_device(context) if context is not None else None
        self._host = _host_context([*self.shardings.values(), self._device])
        self._streams = {}
        self.depth = max(1, int(depth))
        self.current_batch = None
        self._queue = None
        self._abort = None
        self._thread = None
        self._exhausted = False
        self._start()

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    # -- staging thread ------------------------------------------------
    def _start(self):
        self._queue = _queue.Queue(maxsize=self.depth)
        self._abort = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._abort), daemon=True
        )
        self._thread.start()

    def set_depth(self, depth):
        """Change the staging queue's bound at run time: a producer
        blocked on a full queue is woken to re-read it, so a live thread
        adopts it without a restart; a smaller bound takes effect as the
        consumer drains."""
        self.depth = max(1, int(depth))
        q = self._queue
        if q is not None:
            with q.mutex:
                q.maxsize = self.depth
                q.not_full.notify_all()
        return self.depth

    def _worker(self, q, abort):
        Context._default_ctx.value = self._host
        while not abort.is_set():
            try:
                batch = self.data_iter.next()
            except StopIteration:
                self._put(q, abort, _EPOCH_END)
                return
            except BaseException as exc:  # re-raised by the consumer
                self._put(q, abort, _PrefetchError(exc))
                return
            try:
                self._stage(batch)
            except BaseException as exc:  # re-raised by the consumer
                self._put(q, abort, _PrefetchError(exc))
                return
            if not self._put(q, abort, batch):
                return
            _PF_BATCHES.inc()

    @staticmethod
    def _put(q, abort, item):
        t0 = None
        while not abort.is_set():
            try:
                q.put(item, timeout=0.05)
                if t0 is not None:
                    _PF_STALL.observe((_time.perf_counter_ns() - t0) // 1000)
                return True
            except _queue.Full:
                if t0 is None:
                    t0 = _time.perf_counter_ns()
        return False

    def _stage(self, batch):
        return _stage_databatch(
            batch, self.shardings, self._device,
            batch.provide_data or self.provide_data,
            batch.provide_label or self.provide_label, self._streams,
        )

    def _shutdown(self):
        if self._thread is None:
            return
        self._abort.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except _queue.Empty:
                self._thread.join(timeout=0.05)
        self._thread = None

    def close(self):
        """Stop the staging thread (the wrapped iterator keeps its
        position; call its reset() for a clean state)."""
        self._shutdown()
        self._queue = None

    def __del__(self):
        try:
            self._shutdown()
        except Exception:  # interpreter teardown: nothing left to stop
            pass

    # -- iterator surface ----------------------------------------------
    def reset(self):
        self._shutdown()
        self.data_iter.reset()
        self._exhausted = False
        self._start()

    def iter_next(self):
        if self._queue is None:
            raise MXNetError("DevicePrefetchIter used after close()")
        if self._exhausted:
            return False
        _PF_DEPTH.set(self._queue.qsize())
        t0 = _time.perf_counter_ns()
        item = self._queue.get()
        _PF_WAIT.observe((_time.perf_counter_ns() - t0) // 1000)
        if item is _EPOCH_END:
            self.current_batch = None
            self._exhausted = True
            return False
        if isinstance(item, _PrefetchError):
            self.current_batch = None
            self._exhausted = True
            raise item.exc
        self.current_batch = _take_staged(item)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad
