"""Training windows of the PyTorch port held against the JAX package.

The port's counterparts of the cases of ``tests/test_train_window.py``:
``Module.train_window`` (K steps per call; K eager steps on the kernels'
plain versions here) and ``Executor.fused_train_update(n_steps=K)`` on a
small MLP with BatchNorm (data (8, 32), FC 16, ReLU, BatchNorm, FC 10,
SoftmaxOutput), a conv + BatchNorm net of two layers, and
``BucketingModule.train_window`` over a bucketed LSTM of hidden 16 with
two buckets. Inputs come from numpy with a seed, and the weights cross
from the JAX package to the port through ``mx.nd.save``/``mx.nd.load``.

Every window is held bit for bit to the port's own serial loop of
``forward_backward`` + ``update`` on the same batches: a window runs the
same launches in the same order, so nothing may differ. Against the JAX
package's window (float32 on both sides, the sums taken in other orders)
the tolerance is rtol 1e-4 / atol 1e-5 on parameters, optimizer states
and BatchNorm statistics after up to five steps, SGD and Adam alike
(``ADAM_TOL`` says why Adam needs that atol). The random-generator case
runs in the port alone:
the two packages' generators give different numbers from one seed.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (the submodule, for jmx.models)

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import Executor

TOL = dict(rtol=1e-4, atol=1e-5)
# Adam divides each gradient by its own running magnitude: an ulp of
# difference in a gradient near 0 moves that weight's update by up to
# ~1e-4 of the learning rate (0.01) a step
ADAM_TOL = dict(rtol=1e-4, atol=1e-5)
SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    # the JAX fit loop stages batches on a thread by default
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")


def _mlp(pkg):
    d = pkg.sym.Variable("data")
    label = pkg.sym.Variable("softmax_label")
    h = pkg.sym.FullyConnected(d, num_hidden=16, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.BatchNorm(h, name="bn1")
    h = pkg.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return pkg.sym.SoftmaxOutput(h, label=label, name="softmax")


def _conv(pkg):
    d = pkg.sym.Variable("data")
    label = pkg.sym.Variable("softmax_label")
    h = pkg.sym.Convolution(d, num_filter=4, kernel=(3, 3), pad=(1, 1),
                            name="conv1")
    h = pkg.sym.Activation(pkg.sym.BatchNorm(h, name="bn1"), act_type="relu")
    h = pkg.sym.Convolution(h, num_filter=4, kernel=(3, 3), pad=(1, 1),
                            name="conv2")
    h = pkg.sym.Activation(pkg.sym.BatchNorm(h, name="bn2"), act_type="relu")
    h = pkg.sym.FullyConnected(pkg.sym.Flatten(h), num_hidden=10, name="fc")
    return pkg.sym.SoftmaxOutput(h, label=label, name="softmax")


NETS = {"mlp": (_mlp, (8, 32)), "conv": (_conv, (8, 2, 6, 6))}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """``{net: .params file}``: numpy weights from a seed, written by the
    JAX package's ``nd.save``."""
    out = {}
    for net, (sym_fn, shape) in NETS.items():
        sym = sym_fn(jmx)
        arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
        rng = np.random.default_rng(0)
        save = {}
        for n, s in zip(sym.list_arguments(), arg_shapes):
            if n not in ("data", "softmax_label"):
                save[f"arg:{n}"] = jmx.nd.array(
                    rng.uniform(-0.5, 0.5, s).astype(np.float32))
        for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
            lo = 0.5 if n.endswith("_var") else -0.1
            save[f"aux:{n}"] = jmx.nd.array(
                rng.uniform(lo, lo + 1.0, s).astype(np.float32))
        path = str(tmp_path_factory.mktemp("w") / f"{net}.params")
        jmx.nd.save(path, save)
        out[net] = path
    return out


def _module(pkg, path, net="mlp", opt="sgd", opt_params=None,
            grad_req="write", dtype=None):
    sym_fn, shape = NETS[net]
    m = pkg.mod.Module(sym_fn(pkg), context=pkg.cpu())
    desc = (("data", shape, dtype),) if dtype else (("data", shape),)
    m.bind(data_shapes=[pkg.io.DataDesc(*d) for d in desc],
           label_shapes=[pkg.io.DataDesc("softmax_label", shape[:1])],
           grad_req=grad_req)
    loaded = pkg.nd.load(path)
    m.init_params(arg_params={k[4:]: v for k, v in loaded.items()
                              if k.startswith("arg:")},
                  aux_params={k[4:]: v for k, v in loaded.items()
                              if k.startswith("aux:")})
    m.init_optimizer(optimizer=opt, optimizer_params=dict(opt_params or SGD))
    return m


def _batches(pkg, n=4, seed=3, net="mlp"):
    shape = NETS[net][1]
    rng = np.random.RandomState(seed)
    kw = {"ctx": pkg.cpu()} if pkg is pmx else {}
    return [pkg.io.DataBatch(
        data=[pkg.nd.array(rng.randn(*shape).astype(np.float32), **kw)],
        label=[pkg.nd.array(rng.randint(0, 10, shape[:1]).astype(
            np.float32), **kw)]) for _ in range(n)]


def _state(m):
    """Parameters, BatchNorm statistics and optimizer states as numpy."""
    args, auxs = m.get_params()
    out = {f"arg:{k}": v.asnumpy() for k, v in args.items()}
    out.update({f"aux:{k}": v.asnumpy() for k, v in auxs.items()})
    for i, st in m._updater.states.items():
        for j, a in enumerate(st if isinstance(st, tuple) else (st,)):
            if a is not None:
                out[f"state:{i}:{j}"] = np.asarray(a.asnumpy())
    return out


def _same(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _close(got, want, **tol):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **(tol or TOL))


def _serial(m, batches):
    for b in batches:
        m.forward_backward(b)
        m.update()


class _Spy:
    """The ``n_steps`` of every ``fused_train_update`` call of one
    package's executor (proves a window ran fused)."""

    def __init__(self, monkeypatch, cls):
        self.calls = []
        orig = cls.fused_train_update

        def spy(exe, *a, **kw):
            self.calls.append(kw.get("n_steps", 1))
            return orig(exe, *a, **kw)

        monkeypatch.setattr(cls, "fused_train_update", spy)


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_stacked_batches_window_matches_serial(weights, net, monkeypatch):
    ref = _module(pmx, weights[net], net)
    _serial(ref, _batches(pmx, net=net))
    spy = _Spy(monkeypatch, Executor)
    win = _module(pmx, weights[net], net)
    boundary = win.train_window(None, batches=_batches(pmx, net=net))
    assert spy.calls == [4], "the window fell back to serial steps"
    assert boundary.n_steps == 4
    _same(_state(win), _state(ref))
    np.testing.assert_array_equal(boundary.outputs[0].asnumpy(),
                                  ref.get_outputs()[0].asnumpy())
    jwin = _module(jmx, weights[net], net)
    jwin.train_window(None, batches=_batches(jmx, net=net))
    _close(_state(win), _state(jwin))


def test_same_batch_window_matches_serial_and_outputs(weights, monkeypatch):
    b = _batches(pmx, 1)
    ref = _module(pmx, weights["mlp"])
    _serial(ref, b * 5)
    spy = _Spy(monkeypatch, Executor)
    win = _module(pmx, weights["mlp"])
    win.train_window(b[0], n_steps=5)
    assert spy.calls == [5]
    _same(_state(win), _state(ref))
    np.testing.assert_array_equal(win.get_outputs()[0].asnumpy(),
                                  ref.get_outputs()[0].asnumpy())
    jwin = _module(jmx, weights["mlp"])
    jwin.train_window(_batches(jmx, 1)[0], n_steps=5)
    _close(_state(win), _state(jwin))
    np.testing.assert_allclose(win.get_outputs()[0].asnumpy(),
                               jwin.get_outputs()[0].asnumpy(), **TOL)


def test_window_advances_update_count_and_t(weights, monkeypatch):
    seen = []
    orig = pmx.optimizer.Adam.torch_apply

    def spy(self, weights_, grads, states, lrs, wds, ts, **kw):
        seen.append(list(ts))
        return orig(self, weights_, grads, states, lrs, wds, ts, **kw)

    monkeypatch.setattr(pmx.optimizer.Adam, "torch_apply", spy)
    opt = {"learning_rate": 0.01}
    m = _module(pmx, weights["mlp"], opt="adam", opt_params=opt)
    b = _batches(pmx, 1)[0]
    m.train_window(b, n_steps=3)
    assert m._optimizer.num_update == 3
    assert set(m._optimizer._index_update_count.values()) == {3}
    # Adam's bias correction takes each step's own count
    assert [set(ts) for ts in seen] == [{1}, {2}, {3}]
    m.forward_backward(b)
    m.update()  # a following single step continues the count
    assert m._optimizer.num_update == 4 and seen[-1][0] == 4
    jm = _module(jmx, weights["mlp"], opt="adam", opt_params=opt)
    jb = _batches(jmx, 1)[0]
    jm.train_window(jb, n_steps=3)
    jm.forward_backward(jb)
    jm.update()
    assert jm._optimizer.num_update == 4
    _close(_state(m), _state(jm), **ADAM_TOL)


def test_window_momentum_optimizer_state_advances(weights):
    ref = _module(pmx, weights["mlp"])
    _serial(ref, _batches(pmx, 3, seed=11))
    win = _module(pmx, weights["mlp"])
    win.train_window(None, batches=_batches(pmx, 3, seed=11))
    assert set(ref._updater.states) == set(win._updater.states)
    for k, st in ref._updater.states.items():
        np.testing.assert_array_equal(win._updater.states[k].asnumpy(),
                                      st.asnumpy())
    jwin = _module(jmx, weights["mlp"])
    jwin.train_window(None, batches=_batches(jmx, 3, seed=11))
    for k, st in jwin._updater.states.items():
        np.testing.assert_allclose(win._updater.states[k].asnumpy(),
                                   np.asarray(st.asnumpy()), **TOL)


def test_window_falls_back_without_torch_apply(weights, monkeypatch):
    bs = _batches(pmx, 2)
    monkeypatch.setattr(pmx.optimizer.SGD, "torch_apply", None)
    ref = _module(pmx, weights["mlp"])
    _serial(ref, bs)
    spy = _Spy(monkeypatch, Executor)
    win = _module(pmx, weights["mlp"])
    win.train_window(None, batches=bs)
    assert spy.calls == []  # nothing fused: the serial fallback
    _same(_state(win), _state(ref))


def test_window_rng_stream_continues_into_serial_steps(monkeypatch):
    """A window of 3 and 2 serial steps draw the same random slopes (an
    ``rrelu`` in training) as 5 serial steps: each step of a window takes
    the generator's next values."""

    def make():
        d = pmx.sym.Variable("data")
        h = pmx.sym.FullyConnected(d, num_hidden=16, name="fc1")
        h = pmx.sym.LeakyReLU(h, act_type="rrelu", name="rr")
        h = pmx.sym.FullyConnected(h, num_hidden=10, name="fc2")
        sym = pmx.sym.SoftmaxOutput(h, name="softmax")
        m = pmx.mod.Module(sym, context=pmx.cpu())
        m.bind(data_shapes=[("data", (8, 32))],
               label_shapes=[("softmax_label", (8,))])
        m.init_params(initializer=pmx.init.Xavier(), force_init=True)
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1})
        return m

    b = _batches(pmx, 1)[0]
    pmx.random.seed(13)
    ref = make()
    _serial(ref, [b] * 5)
    pmx.random.seed(13)
    win = make()
    spy = _Spy(monkeypatch, Executor)
    win.train_window(b, n_steps=3)
    _serial(win, [b] * 2)
    assert spy.calls == [3, 1, 1]
    _same(_state(win), _state(ref))
    pmx.random.seed(13)
    replay = make()
    replay.train_window(b, n_steps=5)
    _same(_state(replay), _state(ref))


def test_window_stacks_cast_to_bound_dtype(weights, monkeypatch):
    """float32 batches fed to a bfloat16-bound input are cast on the
    device as a serial feed casts them."""
    ref = _module(pmx, weights["mlp"], dtype="bfloat16")
    _serial(ref, _batches(pmx, 3))
    spy = _Spy(monkeypatch, Executor)
    win = _module(pmx, weights["mlp"], dtype="bfloat16")
    win.train_window(None, batches=_batches(pmx, 3))
    assert spy.calls == [3]
    exe = win._exec_group._exec
    assert exe.arg_dict["data"].dtype == np.dtype("bfloat16") or \
        str(exe.arg_dict["data"].dtype) == "bfloat16"
    _same(_state(win), _state(ref))
    # the last step's input is the last batch cast as the JAX package
    # casts it
    last = _batches(jmx, 3)[-1].data[0].astype("bfloat16").asnumpy()
    np.testing.assert_array_equal(
        exe.arg_dict["data"].asnumpy().astype(np.float32),
        np.asarray(last).astype(np.float32))


def test_window_hyper_tape_starts_at_first_step(weights, monkeypatch):
    """``fused_train_update`` gets the window's first step's counts and
    rates (lr 0.4 before the schedule halves it), in both packages."""
    seen = {}
    for pkg, cls in ((pmx, Executor), (jmx, jmx.executor.Executor)):
        orig = cls.fused_train_update

        def spy(exe, names, fn, states, lrs, wds, ts, *a, _o=orig,
                _p=pkg, **kw):
            seen[_p] = (list(ts), list(lrs))
            return _o(exe, names, fn, states, lrs, wds, ts, *a, **kw)

        monkeypatch.setattr(cls, "fused_train_update", spy)
        m = _module(pkg, weights["mlp"], opt_params={
            "learning_rate": 0.4, "momentum": 0.9,
            "lr_scheduler": pkg.lr_scheduler.FactorScheduler(step=2,
                                                             factor=0.5)})
        m.train_window(_batches(pkg, 1)[0], n_steps=4)
        assert m._optimizer.num_update == 4  # the count lands on the end
    for ts, lrs in seen.values():
        assert set(ts) == {1}
        assert all(abs(lr - 0.4) < 1e-9 for lr in lrs)
    assert len(seen[pmx][0]) == len(seen[jmx][0])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_window_grad_add_falls_back_serial(weights, monkeypatch, pkg):
    p, cls = (pmx, Executor) if pkg == "port" else (
        jmx, jmx.executor.Executor)
    m = _module(p, weights["mlp"], grad_req="add")
    spy = _Spy(monkeypatch, cls)
    m.train_window(_batches(p, 1)[0], n_steps=3)
    assert spy.calls == [1, 1, 1]  # serial single steps


def test_grad_add_fallback_matches_reference(weights):
    m = _module(pmx, weights["mlp"], grad_req="add")
    m.train_window(None, batches=_batches(pmx, 3))
    jm = _module(jmx, weights["mlp"], grad_req="add")
    jm.train_window(None, batches=_batches(jmx, 3))
    _close(_state(m), _state(jm))


def test_window_unbound_label_and_empty_batches():
    """A label the symbol does not bind is dropped, as the serial feed
    drops it; an empty ``batches`` is a no-op."""
    results = []
    for pkg in (pmx, jmx):
        d = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(d, num_hidden=4, name="fc")
        out = pkg.sym.MakeLoss(h * h, name="loss")
        kw = {"ctx": pkg.cpu()} if pkg is pmx else {}
        m = pkg.mod.Module(out, context=pkg.cpu(), label_names=None)
        m.bind(data_shapes=[("data", (4, 8))], label_shapes=None)
        rng = np.random.RandomState(0)
        m.init_params(arg_params={
            "fc_weight": pkg.nd.array(rng.randn(4, 8).astype(np.float32),
                                      **kw),
            "fc_bias": pkg.nd.array(np.zeros(4, np.float32), **kw)})
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.01})
        assert m.train_window(None, batches=[]) is None
        bs = [pkg.io.DataBatch(
            data=[pkg.nd.array(rng.randn(4, 8).astype(np.float32), **kw)],
            label=[pkg.nd.array(rng.randn(4).astype(np.float32), **kw)])
            for _ in range(3)]
        m.train_window(None, batches=bs)
        results.append(m.get_params()[0]["fc_weight"].asnumpy())
    np.testing.assert_allclose(results[0], results[1], **TOL)


def _pending(pkg, path, grad_req="write", head_grads=False):
    """A module after one training forward and backward, its executor
    and its updater."""
    m = _module(pkg, path, grad_req=grad_req)
    b = _batches(pkg, 1)[0]
    if grad_req == "add":
        m.forward_backward(b)
        m.update()
    m.forward(b, is_train=True)
    if head_grads:
        m.backward(out_grads=[pkg.nd.ones((8, 10), **(
            {"ctx": pkg.cpu()} if pkg is pmx else {}))])
    else:
        m.backward()
    return m, m._exec_group._exec, m._updater


@pytest.mark.parametrize("case", ["add", "head_grads", "shape", "name",
                                  "stacks_single"])
def test_window_executor_rejections(weights, case):
    """The executor refuses what a window cannot run, in both packages."""
    for pkg in (pmx, jmx):
        m, exe, updater = _pending(pkg, weights["mlp"],
                                   grad_req="add" if case == "add"
                                   else "write",
                                   head_grads=case == "head_grads")
        kw = {"n_steps": 4}
        zeros = (lambda s: pkg.nd.zeros(s, ctx=pkg.cpu())) if pkg is pmx \
            else pkg.nd.zeros
        if case == "shape":
            kw["data_stacks"] = {"data": zeros((4, 9, 32))}
        elif case == "name":
            kw["data_stacks"] = {"nope": zeros((4, 8, 32))}
        elif case == "stacks_single":
            kw = {"n_steps": 1, "data_stacks": {"data": zeros((1, 8, 32))}}
        counts = m._optimizer._index_update_count
        before = {k: v for k, v in counts.items() if v}
        with pytest.raises(pkg.base.MXNetError):
            m._exec_group.update_fused(m._optimizer, updater, **kw)
        # the counts roll back for a retried or imperative update
        assert {k: v for k, v in counts.items() if v} == before


def test_window_checkpoint_resume_across_packages(weights, tmp_path):
    """A checkpoint with optimizer states written after a window resumes
    exactly in the port and within the tolerance in the JAX package:
    window(3) + save, then window(2), against load + window(2)."""
    b = _batches(pmx, 1, seed=17)[0]
    prefix = str(tmp_path / "winck")
    m1 = _module(pmx, weights["mlp"])
    m1.train_window(b, n_steps=3)
    m1.save_checkpoint(prefix, 3, save_optimizer_states=True)
    m1.train_window(b, n_steps=2)
    for pkg in (pmx, jmx):
        sym, args, auxs = pkg.model.load_checkpoint(prefix, 3)
        m2 = pkg.mod.Module(sym, context=pkg.cpu())
        m2.bind(data_shapes=[("data", (8, 32))],
                label_shapes=[("softmax_label", (8,))])
        m2.set_params(args, auxs)
        m2.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        with pkg.cpu():  # the states load on the current context
            m2.load_optimizer_states(prefix + "-0003.states")
        m2.train_window(_batches(pkg, 1, seed=17)[0], n_steps=2)
        a1, x1 = m1.get_params()
        a2, x2 = m2.get_params()
        for got, want in ((a2, a1), (x2, x1)):
            for k, v in want.items():
                if pkg is pmx:
                    np.testing.assert_array_equal(got[k].asnumpy(),
                                                  v.asnumpy(), err_msg=k)
                else:
                    np.testing.assert_allclose(got[k].asnumpy(), v.asnumpy(),
                                               err_msg=k, **TOL)


def test_window_publish_grads_false_same_params_grads_raise(weights,
                                                            monkeypatch):
    spy = _Spy(monkeypatch, Executor)
    m_pub = _module(pmx, weights["mlp"])
    m_lazy = _module(pmx, weights["mlp"])
    b_pub = m_pub.train_window(None, batches=_batches(pmx, 3, seed=5))
    b_lazy = m_lazy.train_window(None, batches=_batches(pmx, 3, seed=5),
                                 publish_grads=False)
    assert spy.calls == [3, 3]
    _same(_state(m_lazy), _state(m_pub))
    np.testing.assert_array_equal(b_pub.outputs[0].asnumpy(),
                                  b_lazy.outputs[0].asnumpy())
    assert "fc1_weight" in b_pub.grads()
    with pytest.raises(MXNetError, match="publish_grads"):
        b_lazy.grads()
    exe = m_lazy._exec_group._exec
    with pytest.raises(MXNetError, match="not published"):
        exe.grad_dict["fc1_weight"].asnumpy()
    g = exe.grad_dict["fc1_weight"]
    assert g.shape == exe.arg_dict["fc1_weight"].shape
    assert g.dtype == exe.arg_dict["fc1_weight"].dtype
    # the published gradients are the JAX package's last step's
    jm = _module(jmx, weights["mlp"])
    jb = jm.train_window(None, batches=_batches(jmx, 3, seed=5))
    np.testing.assert_allclose(b_pub.grads()["fc1_weight"].asnumpy(),
                               jb.grads()["fc1_weight"].asnumpy(),
                               rtol=1e-4, atol=1e-4)
    # the next publishing step heals the handles
    m_lazy.forward_backward(_batches(pmx, 1)[0])
    m_lazy.update()
    assert np.isfinite(exe.grad_dict["fc1_weight"].asnumpy()).all()


def test_window_boundary_wait_and_serial_fallback(weights, monkeypatch):
    bs = _batches(pmx, 2, seed=8)
    m = _module(pmx, weights["mlp"])
    b = m.train_window(None, batches=bs, publish_grads=False)
    assert b.wait() is b and b.n_steps == 2
    assert m.train_window(None, batches=[]) is None
    m2 = _module(pmx, weights["mlp"])
    m2._optimizer.torch_apply = None
    spy = _Spy(monkeypatch, Executor)
    b2 = m2.train_window(None, batches=bs, publish_grads=False)
    assert spy.calls == [] and b2.n_steps == 2 and b2.wait() is b2
    with pytest.raises(MXNetError, match="publish_grads"):
        b2.grads()
    exe2 = m2._exec_group._exec
    assert np.isfinite(exe2.grad_dict["fc1_weight"].asnumpy()).all()
    b3 = m2.train_window(None, batches=bs)
    got = b3.grads()["fc1_weight"].asnumpy()
    np.testing.assert_array_equal(got, exe2.grad_dict["fc1_weight"].asnumpy())
    # by value: a later step does not change the boundary's gradients
    m2.forward_backward(bs[0])
    m2.update()
    np.testing.assert_array_equal(b3.grads()["fc1_weight"].asnumpy(), got)


def test_window_guard_skips_only_the_nonfinite_step(weights, monkeypatch):
    """Under ``MXNET_NONFINITE_GUARD=skip`` a NaN batch at step 2 of a
    window of 4 skips that step alone (weights, momenta and BatchNorm
    statistics kept), as the serial loop and the JAX package's window do;
    exactly one skip is counted."""
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "skip")
    states = {}
    for pkg, how in ((pmx, "serial"), (pmx, "window"), (jmx, "window")):
        bs = _batches(pkg, 4, seed=21)
        bad = np.array(bs[1].data[0].asnumpy())
        bad[0, 0] = np.nan
        bs[1].data[0] = pkg.nd.array(
            bad, **({"ctx": pkg.cpu()} if pkg is pmx else {}))
        m = _module(pkg, weights["mlp"])
        if how == "serial":
            _serial(m, bs)
        else:
            m.train_window(None, batches=bs)
        assert m.nonfinite_stats() == (1, 0)
        states[pkg, how] = _state(m)
    _same(states[pmx, "window"], states[pmx, "serial"])
    _close(states[pmx, "window"], states[jmx, "window"])


# --- BucketingModule.train_window --------------------------------------
VOCAB, HIDDEN, LSTM_BATCH, BUCKETS = 30, 16, 4, (4, 8)


def _lstm_module(pkg, path):
    sym_gen, states = pkg.models.lstm_lm_sym_gen(
        num_hidden=HIDDEN, num_layers=1, num_embed=HIDDEN, vocab_size=VOCAB)
    m = pkg.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                state_names=states, context=pkg.cpu())
    shapes = [("data", (LSTM_BATCH, 8))]
    m.bind(data_shapes=shapes,
           label_shapes=[("softmax_label", (LSTM_BATCH, 8))])
    loaded = pkg.nd.load(path)
    m.init_params(arg_params=loaded)
    m.init_optimizer(optimizer="adam",
                     optimizer_params={"learning_rate": 0.01})
    return m


def _lstm_batches(pkg):
    """A mixed-bucket chunk: 8, 4, 8, 4, 4 (the last group is bucket 4)."""
    rng = np.random.RandomState(2)
    kw = {"ctx": pkg.cpu()} if pkg is pmx else {}
    out = []
    for t in (8, 4, 8, 4, 4):
        x = rng.randint(1, VOCAB, (LSTM_BATCH, t)).astype(np.float32)
        y = rng.randint(1, VOCAB, (LSTM_BATCH, t)).astype(np.float32)
        out.append(pkg.io.DataBatch(
            [pkg.nd.array(x, **kw)], [pkg.nd.array(y, **kw)], bucket_key=t,
            provide_data=[pkg.io.DataDesc("data", (LSTM_BATCH, t))],
            provide_label=[pkg.io.DataDesc("softmax_label",
                                           (LSTM_BATCH, t))]))
    return out


@pytest.fixture(scope="module")
def lstm_weights(tmp_path_factory):
    sym_gen, states = jmx.models.lstm_lm_sym_gen(
        num_hidden=HIDDEN, num_layers=1, num_embed=HIDDEN, vocab_size=VOCAB)
    sym = sym_gen(8)[0]
    shapes = {"data": (LSTM_BATCH, 8), "softmax_label": (LSTM_BATCH, 8)}
    shapes.update({n: (LSTM_BATCH, HIDDEN) for n in states})
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.default_rng(1)
    save = {n: jmx.nd.array(rng.uniform(-0.3, 0.3, s).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    path = str(tmp_path_factory.mktemp("lstm") / "lstm.params")
    jmx.nd.save(path, save)
    return path


def _lstm_state(m):
    arg, _aux = m.get_params()
    out = {k: v.asnumpy() for k, v in arg.items()}
    mod = m._curr_module
    for i, (mean, var) in mod._updater.states.items():
        out[f"{i}/mean"] = np.asarray(mean.asnumpy())
        out[f"{i}/var"] = np.asarray(var.asnumpy())
    return out


def test_bucketing_window_over_a_mixed_chunk(lstm_weights, monkeypatch):
    """The chunk runs as one window per bucket, the group of the chunk's
    last batch last: bit for bit the port's serial steps in that order,
    and within the tolerance the JAX package's window."""
    chunk = _lstm_batches(pmx)
    ref = _lstm_module(pmx, lstm_weights)
    order = [b for b in chunk if b.bucket_key == 8] + \
        [b for b in chunk if b.bucket_key == 4]
    for b in order:
        ref.forward_backward(b)
        ref.update()
    spy = _Spy(monkeypatch, Executor)
    win = _lstm_module(pmx, lstm_weights)
    boundary = win.train_window(None, batches=chunk)
    assert spy.calls == [2, 3]
    assert boundary.n_steps == 5 and len(boundary.outputs) == 2
    assert win._curr_module is win._buckets[4]
    assert win._curr_module._optimizer._index_update_count[0] == 5
    _same(_lstm_state(win), _lstm_state(ref))
    np.testing.assert_array_equal(boundary.outputs[-1].asnumpy(),
                                  ref.get_outputs()[0].asnumpy())
    jwin = _lstm_module(jmx, lstm_weights)
    jwin.train_window(None, batches=_lstm_batches(jmx))
    _close(_lstm_state(win), _lstm_state(jwin), **ADAM_TOL)
