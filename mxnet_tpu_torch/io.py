"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (reference ``python/mxnet/io.py``) for
what ``Module.fit`` consumes: ``DataDesc``, ``DataBatch``, the ``DataIter``
base and ``NDArrayIter`` over in-memory arrays. Batches are placed on the
iterator's ``ctx``, the current context (``gpu(0)``) unless the caller
asks for another. The prefetching, retrying and RecordIO iterators are not
yet ported (``ROADMAP.md`` queue 1 items 3 and 6).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

from .base import MXNetError, np_dtype
from .ndarray import NDArray, array


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
