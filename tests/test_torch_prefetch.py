"""Device prefetch of the PyTorch port held against the JAX package, on the
CPU.

``io.DevicePrefetchIter`` and ``io.PrefetchingIter`` over an
``NDArrayIter`` with a ragged last batch (pad mode): the same batches,
``pad`` and ``index`` as the reference's wrappers over the same data, bit
for bit, over two epochs; ``reset`` in the middle of an epoch; an
exception raised by the wrapped iterator reaching the consumer (and the
wrapper done after it); ``set_depth`` on a live thread; batches made in
the thread follow the creating thread's context. ``Module.fit`` wraps its
iterator by default (``MXNET_DEVICE_PREFETCH``, depth
``MXNET_PREFETCH_DEPTH``) and gives bit-identical weights with prefetch on
and off; ``score`` wraps a full, fresh pass only. ``cpu_pinned`` raises on
a machine without a card (page-locked memory is CUDA's), where the
reference maps it to the host.
"""

import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError

CPU = pmx.cpu()
N, BATCH = 11, 4  # three batches, the last padded by one


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, 3, 2)).astype(np.float32),
            rng.integers(0, 5, N).astype(np.float32))


def _nd_iter(pkg, x, y):
    kw = {"ctx": CPU} if pkg is pmx else {}
    return pkg.io.NDArrayIter(x, y, batch_size=BATCH, **kw)


def _indexed(pkg, x, y):
    """An iterator whose batches carry ``index`` (NDArrayIter's are None)."""

    class Indexed(pkg.io.DataIter):
        def __init__(self):
            super().__init__(BATCH)
            self.inner = _nd_iter(pkg, x, y)
            self.provide_data = self.inner.provide_data
            self.provide_label = self.inner.provide_label
            self.count = 0

        def reset(self):
            self.inner.reset()
            self.count = 0

        def next(self):
            b = self.inner.next()
            b.index = np.arange(self.count, self.count + BATCH) % N
            self.count += BATCH
            return b

    return Indexed()


def _wrap(pkg, kind, it):
    if kind == "device":
        ctx = CPU if pkg is pmx else jmx.cpu()
        return pkg.io.DevicePrefetchIter(it, context=ctx)
    return pkg.io.PrefetchingIter(it)


def _epoch(it):
    return [([a.asnumpy() for a in b.data + b.label], b.pad,
             None if b.index is None else list(b.index)) for b in it]


@pytest.mark.parametrize("kind", ["device", "prefetching"])
@pytest.mark.parametrize("source", [_nd_iter, _indexed])
def test_batches_pad_and_index_match_reference(kind, source):
    x, y = _data()
    epochs = []
    for pkg in (jmx, pmx):
        it = _wrap(pkg, kind, source(pkg, x, y))
        first = _epoch(it)
        it.reset()
        epochs.append((first, _epoch(it), it))
    (jfirst, jsecond, _), (pfirst, psecond, pit) = epochs
    assert [b[1] for b in pfirst] == [0, 0, 1]
    for got, want in ((pfirst, jfirst), (psecond, jsecond),
                      (psecond, pfirst)):
        assert len(got) == len(want) == 3
        for (ga, gp, gi), (wa, wp, wi) in zip(got, want):
            assert gp == wp and gi == wi
            for g, w in zip(ga, wa):
                np.testing.assert_array_equal(g, w)
    assert pit.provide_data == _nd_iter(pmx, x, y).provide_data
    if kind == "device":
        pit.close()


def test_reset_mid_epoch_restarts_the_pass():
    x, y = _data()
    it = pmx.io.DevicePrefetchIter(_nd_iter(pmx, x, y), context=CPU)
    head = it.next().data[0].asnumpy()
    it.reset()
    again = _epoch(it)
    assert len(again) == 3
    np.testing.assert_array_equal(again[0][0][0], head)
    it.close()
    with pytest.raises(MXNetError, match="after close"):
        it.next()


class _Failing(pmx.io.DataIter):
    def __init__(self, fail_at):
        super().__init__(BATCH)
        self.fail_at, self.count = fail_at, 0
        self.provide_data = [pmx.io.DataDesc("data", (BATCH, 2))]
        self.provide_label = []

    def next(self):
        self.count += 1
        if self.count == self.fail_at:
            raise KeyError("source failed")
        return pmx.io.DataBatch([pmx.nd.zeros((BATCH, 2), ctx=CPU)], [],
                                pad=0)

    def reset(self):
        self.count = 0


@pytest.mark.parametrize("kind", ["device", "prefetching"])
def test_worker_exception_reaches_the_consumer(kind):
    it = _wrap(pmx, kind, _Failing(fail_at=3))
    it.next()
    it.next()
    with pytest.raises(KeyError, match="source failed"):
        it.next()
    if kind == "device":
        assert not it.iter_next()  # the wrapper is done for this epoch
        it.close()


def test_set_depth_on_a_live_thread():
    x, y = np.zeros((64, 2), np.float32), np.zeros(64, np.float32)
    it = pmx.io.DevicePrefetchIter(
        pmx.io.NDArrayIter(x, y, batch_size=1, ctx=CPU), context=CPU,
        depth=1)
    assert it.set_depth(5) == 5 and it._queue.maxsize == 5
    deadline = time.monotonic() + 120  # a loaded host schedules it late
    while it._queue.qsize() < 5 and time.monotonic() < deadline:
        time.sleep(0.01)  # the producer fills the grown queue
    assert it._queue.qsize() == 5
    assert it.set_depth(0) == 1
    assert len(_epoch(it)) == 64
    it.close()


def test_thread_follows_the_creating_context():
    """An ``NDArrayIter`` without ``ctx`` places its batches on the current
    context; the prefetch thread takes the context of the thread that made
    the wrapper, so under ``with cpu()`` the batches land on the CPU (the
    default, ``gpu(0)``, would raise here)."""
    x, y = _data()
    with pmx.cpu():
        it = pmx.io.DevicePrefetchIter(pmx.io.NDArrayIter(x, y, BATCH))
        pre = pmx.io.PrefetchingIter(pmx.io.NDArrayIter(x, y, BATCH))
    for wrapper in (it, pre):
        assert all(a.context == CPU for b in wrapper for a in b.data)
    it.close()


def test_cpu_pinned_needs_a_card():
    ctx = pmx.cpu_pinned()
    assert ctx.pinned and not pmx.cpu().pinned and str(ctx) == "cpu_pinned(0)"
    if torch.cuda.is_available():
        a = pmx.nd.array(np.ones(3), ctx=ctx)
        assert a._data.is_pinned()
        return
    for make in (lambda: pmx.nd.array(np.ones(3), ctx=ctx),
                 lambda: pmx.nd.zeros((3,), ctx=ctx),
                 lambda: pmx.nd.ones((2,), ctx=CPU).copyto(ctx),
                 lambda: pmx.random.uniform(shape=(2,), ctx=ctx)):
        with pytest.raises(MXNetError, match="page-locked"):
            make()
    # a prefetcher bound for the host stages nothing and pins nothing
    x, y = _data()
    it = pmx.io.DevicePrefetchIter(_nd_iter(pmx, x, y), context=CPU)
    assert not any(a._data.is_pinned() for b in it for a in b.data)
    it.close()


# --- fit and score ---------------------------------------------------------

def _net():
    with pmx.NameManager():
        data = pmx.sym.Variable("data")
        fc = pmx.sym.FullyConnected(pmx.sym.Flatten(data), num_hidden=5,
                                    name="fc")
        return pmx.sym.SoftmaxOutput(fc, name="softmax")


def _spy(monkeypatch):
    """Record every DevicePrefetchIter made from here on."""
    made = []

    class Spy(pmx.io.DevicePrefetchIter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(pmx.io, "DevicePrefetchIter", Spy)
    return Spy, made


def _fit(monkeypatch, prefetch, wrapped):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", prefetch)
    monkeypatch.setenv("MXNET_PREFETCH_DEPTH", "3")
    x, y = _data(1)
    rng = np.random.default_rng(2)
    args = {"fc_weight": pmx.nd.array(rng.standard_normal((5, 6)), ctx=CPU),
            "fc_bias": pmx.nd.zeros((5,), ctx=CPU)}
    mod = pmx.mod.Module(_net(), context=CPU)
    train, val = _nd_iter(pmx, x, y), _nd_iter(pmx, x, y)
    spy, made = _spy(monkeypatch)
    given = spy(train, context=CPU) if wrapped else train
    mod.fit(given, eval_data=val, num_epoch=3,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=args)
    by_fit = [m for m in made if m.data_iter is train and m is not given]
    assert len(by_fit) == (prefetch == "1" and not wrapped)
    assert all(m._queue is None for m in by_fit)  # closed by fit
    assert all(m.depth == 3 for m in by_fit)
    # score wrapped every full pass over the validation data (3 epochs)
    scored = [m for m in made if m.data_iter is val]
    assert len(scored) == (3 if prefetch == "1" else 0)
    if wrapped:
        given.close()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, mod, val


def test_fit_weights_are_bit_identical_with_prefetch_on_and_off(
        monkeypatch):
    on, mod, val = _fit(monkeypatch, "1", False)
    off, _mod, _val = _fit(monkeypatch, "0", False)
    pre, _mod, _val = _fit(monkeypatch, "1", True)
    for k in off:
        np.testing.assert_array_equal(on[k], off[k])
        np.testing.assert_array_equal(pre[k], off[k])
    # a score of part of the data stays unwrapped: the caller's iterator
    # stands where an unwrapped pass leaves it
    _spy_type, made = _spy(monkeypatch)
    mod.score(val, "acc", num_batch=1)
    assert made == [] and val.cursor == BATCH


def test_fit_prefetch_needs_a_module_with_one_device(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "1")
    mod = pmx.mod.Module(_net(), context=CPU)
    it = _nd_iter(pmx, *_data())
    assert mod.input_shardings is None
    assert mod._wrap_device_prefetch(it) is it  # not bound yet
    mod.bind(it.provide_data, it.provide_label)
    assert mod.input_shardings == {"data": CPU, "softmax_label": CPU}
    wrapped = mod._wrap_device_prefetch(it)
    assert isinstance(wrapped, pmx.io.DevicePrefetchIter)
    assert wrapped.depth == 2  # MXNET_PREFETCH_DEPTH 0: the default
    assert mod._wrap_device_prefetch(wrapped) is wrapped
    wrapped.close()
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    assert mod._wrap_device_prefetch(it) is it
