"""``fit`` under training windows, the window scheduler, the rest of the
executor and legacy ``.params`` records, held against the JAX package.

- ``Module.fit`` with ``MXNET_TRAIN_WINDOW`` at 2 and at ``auto`` and
  ``MXNET_DISPATCH_DEPTH`` at 1 and 2, in both packages on the CPU from
  the same weights (``mx.nd.save`` by the JAX package, ``mx.nd.load`` by
  both) over the same batches: the final parameters and BatchNorm
  statistics, the epoch metric, the batch-end callbacks' ``nbatch`` and
  the ``fit.*`` gauges. ``auto`` picks K from host timings, which differ
  between the packages, so both packages' ``choose_train_window`` are
  pinned to one value for this comparison; the probe around it is each
  package's own.
- ``choose_train_window`` and ``choose_dispatch_depth`` over a grid of
  inputs, exactly; ``TrainWindowScheduler`` fed the same telemetry in both
  packages decides the same K and depth.
- ``Executor.debug_str``, ``partial_forward``, ``set_monitor_callback``
  (with and without ``monitor_all``) and ``reshape``.
- A V0 file of the layout of the reference's ``legacy_ndarray.v0`` fixture
  (six ``arange(128)`` float32 arrays), and a V1 file, loaded by both
  packages.

Tolerances, float32 on both sides with sums in other orders: rtol 1e-4 /
atol 1e-5 on parameters and statistics after 24 SGD steps, 1e-6 on the
epoch accuracy (a share of 8-sample batches), 1e-5 on the monitored and
partial outputs of one forward.
"""

import math
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import aot as jaot
from mxnet_tpu import telemetry as jtm

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import aot as paot
from mxnet_tpu_torch import telemetry as ptm
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-4, atol=1e-5)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
N, BATCH, EPOCHS = 96, 8, 2


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    # the JAX fit loop stages batches on a thread by default
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")


def _sym(pkg):
    d = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(d, num_hidden=16, name="fc1")
    h = pkg.sym.Activation(pkg.sym.BatchNorm(h, name="bn1"), act_type="relu",
                           name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(.params file written by the JAX package, x, y)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 20)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    sym = _sym(jmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH, 20))
    save = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n not in ("data", "softmax_label"):
            save[f"arg:{n}"] = jmx.nd.array(
                rng.uniform(-0.5, 0.5, s).astype(np.float32))
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        save[f"aux:{n}"] = jmx.nd.array(
            (np.ones if n.endswith("_var") else np.zeros)(s, np.float32))
    path = str(tmp_path_factory.mktemp("fit") / "init.params")
    jmx.nd.save(path, save)
    return path, x, y


def _fit(pkg, path, x, y):
    """``fit`` of two epochs; (final state, epoch accuracies, callback
    nbatch values, gauges)."""
    kw = {"ctx": pkg.cpu()} if pkg is pmx else {}
    tm = ptm if pkg is pmx else jtm
    tm.reset()
    loaded = pkg.nd.load(path)
    mod = pkg.mod.Module(_sym(pkg), context=pkg.cpu())
    calls, accs = [], []
    metric = pkg.metric.Accuracy()
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH, **kw),
            num_epoch=EPOCHS, eval_metric=metric,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k[4:]: v for k, v in loaded.items()
                        if k.startswith("arg:")},
            aux_params={k[4:]: v for k, v in loaded.items()
                        if k.startswith("aux:")},
            batch_end_callback=lambda p: calls.append(p.nbatch),
            epoch_end_callback=lambda *_a: accs.append(metric.get()[1]))
    args, auxs = mod.get_params()
    state = {k: v.asnumpy() for k, v in {**args, **auxs}.items()}
    gauges = {g: tm.gauge(g).value for g in (
        "fit.train_window_k", "fit.dispatch_depth")}
    return state, accs, calls, gauges


@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("window", ["2", "auto"])
def test_fit_under_windows_matches_reference(data, monkeypatch, window,
                                             depth):
    path, x, y = data
    monkeypatch.setenv("MXNET_TRAIN_WINDOW", window)
    monkeypatch.setenv("MXNET_DISPATCH_DEPTH", depth)
    if window == "auto":
        # the probe's timings are each package's own: pin the choice
        for mod in (paot, jaot):
            monkeypatch.setattr(mod, "choose_train_window",
                                lambda *a, **k: 3)
    got = _fit(pmx, path, x, y)
    want = _fit(jmx, path, x, y)
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, err_msg=k, **TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert got[2] == want[2]
    assert got[3] == want[3]
    k = 2 if window == "2" else 3
    assert got[3] == {"fit.train_window_k": k,
                      "fit.dispatch_depth": int(depth)}
    # windows trained on every batch: the weights are the per-batch fit's
    monkeypatch.delenv("MXNET_TRAIN_WINDOW")
    serial = _fit(pmx, path, x, y)
    for key, v in serial[0].items():
        np.testing.assert_array_equal(got[0][key], v, err_msg=key)
    assert serial[2] == list(range(N // BATCH)) * EPOCHS


def test_fit_window_gauges_in_flight_and_prefetch_depth(data, monkeypatch):
    """Two windows in flight at most, the prefetcher grown to K x depth +
    1, and the rollback guard capping the depth at 1."""
    path, x, y = data
    monkeypatch.setenv("MXNET_TRAIN_WINDOW", "2")
    monkeypatch.setenv("MXNET_DISPATCH_DEPTH", "2")
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "1")
    seen, depths = [], []
    orig = pmx.io.DevicePrefetchIter.set_depth

    def set_depth(self, depth):
        depths.append(depth)
        return orig(self, depth)

    monkeypatch.setattr(pmx.io.DevicePrefetchIter, "set_depth", set_depth)
    mod = pmx.mod.Module(_sym(pmx), context=pmx.cpu())
    ptm.reset()
    mod.fit(pmx.io.NDArrayIter(x, y, batch_size=BATCH, ctx=pmx.cpu()),
            num_epoch=1, initializer=pmx.init.Xavier(),
            batch_end_callback=lambda p: seen.append(
                ptm.gauge("fit.windows_in_flight").value))
    assert depths == [5]
    assert max(seen) == 2 and ptm.gauge("fit.windows_in_flight").value == 0
    assert ptm.histogram("fit.window").count == N // BATCH // 2
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "rollback")
    mod = pmx.mod.Module(_sym(pmx), context=pmx.cpu())
    mod.fit(pmx.io.NDArrayIter(x, y, batch_size=BATCH, ctx=pmx.cpu()),
            num_epoch=1, initializer=pmx.init.Xavier())
    assert ptm.gauge("fit.dispatch_depth").value == 1
    assert ptm.gauge("fit.train_window_k").value == 2


def test_window_choosers_match_reference():
    grid = [0.0, 1.0, 7.5, 30.0, 120.0, 999.0, 5000.0]
    for d in grid:
        for r in grid:
            for max_k in (4, 32):
                for budget in (0.1, 0.2, 0.3):
                    assert paot.choose_train_window(d, r, max_k, budget) == \
                        jaot.choose_train_window(d, r, max_k, budget)
            for max_depth in (2, 4):
                assert paot.choose_dispatch_depth(d, r, max_depth) == \
                    jaot.choose_dispatch_depth(d, r, max_depth)


@pytest.mark.parametrize("setting,depth", [
    ("auto", "auto"), ("auto", "3"), ("4", "auto"), ("8", "1")])
def test_scheduler_fed_the_same_telemetry(monkeypatch, setting, depth):
    monkeypatch.setenv("MXNET_TRAIN_WINDOW", setting)
    monkeypatch.setenv("MXNET_DISPATCH_DEPTH", depth)
    # per step: dispatch, data wait, metric, callback in microseconds
    profile = [(900, 40, 20, 5), (1100, 35, 25, 5), (1000, 50, 15, 5)]
    decisions = {}
    for aot, tm in ((paot, ptm), (jaot, jtm)):
        tm.reset()
        sched = aot.TrainWindowScheduler.from_env(object.__new__(
            type("M", (), {"train_window": lambda *a: None})))
        ks = []
        for step in range(14):
            k = sched.next_k()
            ks.append(k)
            for name, us in zip(sched._PHASES, profile[step % 3]):
                tm.histogram(name).observe(us)
            sched.observe(1)
        if step == 13 and setting == "auto":
            sched.cap_depth("test")
        decisions[aot] = (ks, sched.k, sched.depth, sched.depth_cap_reason,
                          tm.gauge("fit.train_window_k").value,
                          tm.gauge("fit.dispatch_depth").value)
    assert decisions[paot] == decisions[jaot]
    assert paot.TrainWindowScheduler.from_env(object()) is None


def test_scheduler_settings_match_reference(monkeypatch):
    for raw in ("", "0", "1", "off", "auto", "AUTO", "3", "x", "-2"):
        monkeypatch.setenv("MXNET_TRAIN_WINDOW", raw)
        assert paot.train_window_setting() == jaot.train_window_setting()
    for raw in ("", "auto", "1", "4", "0", "x"):
        monkeypatch.setenv("MXNET_DISPATCH_DEPTH", raw)
        assert paot.dispatch_depth_setting() == jaot.dispatch_depth_setting()


# --- the rest of the executor ------------------------------------------

def _executor(pkg, path, batch=BATCH):
    loaded = pkg.nd.load(path)
    exe = _sym(pkg).simple_bind(pkg.cpu(), grad_req="write",
                                data=(batch, 20), softmax_label=(batch,))
    exe.copy_params_from({k[4:]: v for k, v in loaded.items()
                          if k.startswith("arg:")},
                         {k[4:]: v for k, v in loaded.items()
                          if k.startswith("aux:")})
    return exe


def test_debug_str_matches_reference(data):
    path = data[0]
    got = _executor(pmx, path).debug_str().splitlines()
    want = _executor(jmx, path).debug_str().splitlines()
    assert got[0] == want[0]
    assert got[1] == "ctx: cpu(0)  mode: eager"
    assert got[2:] == want[2:]


@pytest.mark.parametrize("is_train", [False, True])
def test_partial_forward_matches_reference(data, is_train):
    path, x, _y = data
    pe, je = _executor(pmx, path), _executor(jmx, path)
    aux_before = {k: v.asnumpy() for k, v in pe.aux_dict.items()}
    n_ops = sum(not n.is_variable for n in pe.graph.topo)
    for k in range(1, n_ops + 1):
        got = pe.partial_forward(is_train=is_train, num_nodes=k,
                                 data=pmx.nd.array(x[:BATCH], ctx=pmx.cpu()))
        want = je.partial_forward(is_train=is_train, num_nodes=k,
                                  data=jmx.nd.array(x[:BATCH]))
        np.testing.assert_allclose(got[0].asnumpy(),
                                   np.asarray(want[0].asnumpy()),
                                   err_msg=str(k), **FWD_TOL)
    for k, v in aux_before.items():  # read, never written
        np.testing.assert_array_equal(pe.aux_dict[k].asnumpy(), v)


@pytest.mark.parametrize("monitor_all", [False, True])
def test_monitor_callback_matches_reference(data, monitor_all):
    path, x, y = data
    seen = {}
    for pkg in (pmx, jmx):
        exe = _executor(pkg, path)
        got = seen[pkg] = []
        exe.set_monitor_callback(
            lambda name, arr, got=got: got.append((name, np.asarray(
                arr.asnumpy()))), monitor_all=monitor_all)
        kw = {"ctx": pkg.cpu()} if pkg is pmx else {}
        exe.forward(is_train=False, data=pkg.nd.array(x[:BATCH], **kw),
                    softmax_label=pkg.nd.array(y[:BATCH], **kw))
        exe.outputs[0].asnumpy()
    assert [n for n, _ in seen[pmx]] == [n for n, _ in seen[jmx]]
    for (name, got), (_n, want) in zip(seen[pmx], seen[jmx]):
        np.testing.assert_allclose(got, want, err_msg=name, **FWD_TOL)
    assert "bn1_output" in [n for n, _ in seen[pmx]]
    assert ("fc1_weight" in [n for n, _ in seen[pmx]]) == monitor_all


def test_monitor_steps_run_unfused_and_serial(data):
    """Under a monitor the graph runs op by op (the BatchNorm and its ReLU
    apart) and a module's window takes the serial steps."""
    path, x, y = data
    exe = _executor(pmx, path)
    plain = exe.forward(is_train=False,
                        data=pmx.nd.array(x[:BATCH], ctx=pmx.cpu()))
    names = []
    exe.set_monitor_callback(lambda n, a: names.append(n))
    assert "interpret(monitor)" in exe.debug_str()
    mon = exe.forward(is_train=False)
    np.testing.assert_allclose(mon[0].asnumpy(), plain[0].asnumpy(),
                               **FWD_TOL)
    assert names == ["fc1_output", "bn1_output", "relu1_output",
                     "fc2_output", "softmax_output"]
    exe.set_monitor_callback(None)
    assert "mode: eager" in exe.debug_str()


def test_reshape_matches_reference(data):
    path, x, _y = data
    outs = {}
    for pkg in (pmx, jmx):
        exe = _executor(pkg, path)
        with pytest.raises(pkg.base.MXNetError):
            exe.reshape(data=(4, 20))  # the label's shape changes too
        small = exe.reshape(partial_shaping=True, data=(4, 20))
        assert small.arg_dict["data"].shape == (4, 20)
        assert small.arg_dict["softmax_label"].shape == (4,)
        # the parameters are shared, not copied
        assert small.arg_dict["fc1_weight"] is exe.arg_dict["fc1_weight"]
        assert small.aux_dict["bn1_moving_var"] is \
            exe.aux_dict["bn1_moving_var"]
        assert small.grad_dict["fc1_weight"] is exe.grad_dict["fc1_weight"]
        kw = {"ctx": pkg.cpu()} if pkg is pmx else {}
        small.forward(is_train=False, data=pkg.nd.array(x[:4], **kw))
        big = exe.reshape(allow_up_sizing=True, data=(16, 20),
                          softmax_label=(16,))
        big.forward(is_train=False, data=pkg.nd.array(x[:16], **kw))
        outs[pkg] = (small.outputs[0].asnumpy(), big.outputs[0].asnumpy())
    for got, want in zip(outs[pmx], outs[jmx]):
        np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


def test_bucketing_compile_warms_each_bucket():
    sym_gen, states = pmx.models.lstm_lm_sym_gen(
        num_hidden=8, num_layers=1, num_embed=8, vocab_size=20)
    mod = pmx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                  state_names=states, context=pmx.cpu())
    mod.bind(data_shapes=[("data", (2, 8))],
             label_shapes=[("softmax_label", (2, 8))])
    mod.init_params(initializer=pmx.init.Xavier())
    got = mod.compile(buckets=[(4, [("data", (2, 4))],
                                [("softmax_label", (2, 4))])])
    assert got == {8: ["forward"], 4: ["forward"]}
    assert mod._curr_bucket_key == 8


# --- legacy .params records ----------------------------------------------

def _legacy_file(path, version):
    """Six ``arange(128)`` float32 arrays in the reference's legacy layout
    (``ndarray.cc`` LegacyLoad): V0, whose first word is the rank and whose
    dims are uint32, as in ``legacy_ndarray.v0``; or V1, the V1 magic and
    an int64 shape."""
    values = np.arange(128, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", 0x112, 0))
        f.write(struct.pack("<Q", 6))
        for _ in range(6):
            if version == 0:
                f.write(struct.pack("<I", 1))
                f.write(struct.pack("<I", 128))
            else:
                f.write(struct.pack("<I", 0xF993FAC8))
                f.write(struct.pack("<I", 1))
                f.write(struct.pack("<q", 128))
            f.write(struct.pack("<ii", 1, 0))  # Context: kCPU, 0
            f.write(struct.pack("<i", 0))  # float32
            f.write(values.tobytes())
        f.write(struct.pack("<Q", 0))
    return values


@pytest.mark.parametrize("version", [0, 1])
def test_legacy_records_load_in_both_packages(tmp_path, version):
    path = str(tmp_path / f"legacy.v{version}")
    values = _legacy_file(path, version)
    got, want = pmx.nd.load(path), jmx.nd.load(path)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape == (128,)
        assert g.context == pmx.cpu()
        np.testing.assert_array_equal(g.asnumpy(), values)
        np.testing.assert_array_equal(g.asnumpy(), np.asarray(w.asnumpy()))
    # the port writes them back as V2 records the JAX package reads
    pmx.nd.save(str(tmp_path / "v2.params"), got)
    again = jmx.nd.load(str(tmp_path / "v2.params"))
    assert all(np.array_equal(np.asarray(a.asnumpy()), values)
               for a in again)
    assert math.isclose(float(got[5].asnumpy().sum()), float(values.sum()))


def test_unpublished_gradient_keeps_metadata():
    from mxnet_tpu_torch.executor import _Unpublished
    import torch

    t = torch.zeros(3, 4, dtype=torch.float32)
    arr = pmx.nd.NDArray(_Unpublished("w", t))
    assert arr.shape == (3, 4) and arr.size == 12 and arr.ndim == 2
    assert arr.context == pmx.cpu()
    with pytest.raises(MXNetError, match="not published"):
        arr.asnumpy()
