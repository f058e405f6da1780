"""The training slice of the PyTorch port held against the JAX package.

A narrow bottleneck ResNet with the ImageNet stem (the 7x7/2 conv, the
max-pool, 14 BatchNorm+ReLU pairs, SoftmaxOutput) is trained by both
packages on the CPU from the same parameters, made by numpy from a seed:
one executor step (``simple_bind``, ``forward(is_train=True)``,
``backward``, ``fused_train_update`` with SGD-momentum), and two epochs of
``Module.fit`` over an ``NDArrayIter``, comparing the per-batch metric
values and, at each epoch end, the parameters, momenta and BatchNorm
statistics. Also: the non-finite guard skips a poisoned batch on both
executors, checkpoints written by either package load in the other byte
for byte, and the training entry points default to the card.

Tolerances, float32 on both sides with the convolutions and the channel
sums of BatchNorm taken in different orders, absolute parts scaled by the
array's largest magnitude (at least 1): one step rtol 1e-4 / atol 1e-5
(outputs, gradients, parameters, momenta, statistics); after six steps of
momentum SGD rtol 1e-3 / atol 1e-4 on parameters and state, and 1e-4
absolute on the per-batch metric values.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models.resnet import resnet as jax_resnet

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import sgd_mom_multi as sgd_mod
from mxnet_tpu_torch.models.resnet import resnet as torch_resnet

NARROW = dict(units=[1, 1, 1, 1], num_stages=4,
              filter_list=[8, 16, 32, 64, 128], image_shape=(3, 40, 40),
              num_classes=10)
BATCH = 4
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_TOL = dict(rtol=1e-3, atol=1e-4)
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    # the JAX fit loop stages batches on a thread by default; the
    # comparison does not need it and the suite keeps no thread alive
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")


@pytest.fixture(scope="module")
def model():
    """(jax symbol, port symbol, numpy args, numpy auxs, images, labels)."""
    with jmx.name.NameManager():
        jsym = jax_resnet(**NARROW)
    with pmx.NameManager():
        psym = torch_resnet(**NARROW)
    shape = (BATCH,) + NARROW["image_shape"]
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=shape)
    rng = np.random.default_rng(0)
    args, auxs = {}, {}
    for name, s in zip(jsym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            args[name] = (rng.standard_normal(s) *
                          np.sqrt(2.0 / np.prod(s[1:]))).astype(np.float32)
        elif name.endswith("_gamma"):
            args[name] = rng.uniform(0.5, 1.5, s).astype(np.float32)
        else:
            args[name] = rng.uniform(-0.2, 0.2, s).astype(np.float32)
    for name, s in zip(jsym.list_auxiliary_states(), aux_shapes):
        lo, hi = (0.5, 2.0) if name.endswith("_var") else (-0.2, 0.2)
        auxs[name] = rng.uniform(lo, hi, s).astype(np.float32)
    x = rng.standard_normal((3 * BATCH,) + NARROW["image_shape"]).astype(
        np.float32)
    y = rng.integers(0, 10, 3 * BATCH).astype(np.float32)
    return jsym, psym, args, auxs, x, y


def _nd(pkg, d):
    if pkg is pmx:
        return {k: pmx.nd.array(v, ctx=pmx.cpu()) for k, v in d.items()}
    return {k: jmx.nd.array(v) for k, v in d.items()}


def _close(got, want, tol, what):
    """allclose with atol scaled by the array's largest magnitude (at
    least 1): a gradient summed over many terms carries an absolute error
    that grows with the array's scale, not with each element's."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


def test_executor_step_and_guard_match_reference(model, monkeypatch):
    """One step of simple_bind + forward/backward + fused_train_update, then
    a poisoned batch under MXNET_NONFINITE_GUARD=skip: the guard keeps the
    parameters, momenta and BatchNorm statistics and counts (1, 1)."""
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "skip")
    jsym, psym, args, auxs, x, y = model
    shapes = {"data": (BATCH,) + NARROW["image_shape"],
              "softmax_label": (BATCH,)}
    names = sorted(args)
    bad = x[:BATCH].copy()
    bad[1, 0, 3, 3] = np.nan
    hyper = ([0.05] * len(names), [1e-4] * len(names), [1] * len(names))
    results = []
    for pkg, sym, ctx in ((jmx, jsym, jmx.cpu()), (pmx, psym, pmx.cpu())):
        exe = sym.simple_bind(ctx, grad_req="write", **shapes)
        exe.copy_params_from(_nd(pkg, args), _nd(pkg, auxs))
        opt = pkg.optimizer.SGD(momentum=0.9, rescale_grad=1.0 / BATCH,
                                learning_rate=0.05, wd=1e-4)
        states = [pkg.nd.zeros(args[n].shape, ctx=ctx) for n in names]
        if pkg is jmx:
            states = [s._data for s in states]

        def step(data, states, exe=exe, opt=opt, pkg=pkg):
            exe.forward(is_train=True, data=data, softmax_label=y[:BATCH])
            exe.backward()
            if pkg is jmx:
                return exe.fused_train_update(
                    names, lambda i, w, g, s, lr, wd, t, rng: opt.jax_apply(
                        w, g, s, lr, wd, t, rng), states, *hyper,
                    cache_token="sgd")
            return exe.fused_train_update(names, opt.torch_apply, states,
                                          *hyper)

        def snapshot(states, exe=exe):
            return ({n: exe.arg_dict[n].asnumpy() for n in names},
                    dict(zip(names, (np.array(s._data if
                                              isinstance(s, pkg.nd.NDArray)
                                              else s) for s in states))),
                    {n: exe.aux_dict[n].asnumpy() for n in auxs})

        states = step(x[:BATCH], states)
        # read after the update: the reference publishes the gradients
        # from its fused step
        grads = {n: exe.grad_dict[n].asnumpy() for n in names}
        clean = snapshot(states)
        results.append((exe.outputs[0].asnumpy(), grads) + clean)
        assert exe.nonfinite_guard_stats() == (0, 0)
        states = step(bad, states)
        assert exe.nonfinite_guard_stats() == (1, 1), pkg.__name__
        for before, after in zip(clean, snapshot(states)):
            for n in before:
                np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    (jo, jg, jp, jm, ja), (po, pg, pp, pm, pa) = results
    _close(po, jo, STEP_TOL, "probabilities")
    for n in names:
        _close(pg[n], jg[n], STEP_TOL, f"grad {n}")
        _close(pp[n], jp[n], STEP_TOL, f"param {n}")
        _close(pm[n], jm[n], STEP_TOL, f"momentum {n}")
    for n in auxs:
        _close(pa[n], ja[n], STEP_TOL, f"aux {n}")


def test_grad_req_add_accumulates_like_reference():
    """grad_req='add' sums the gradients of successive backwards into the
    bound arrays; explicit head gradients drive a non-loss head."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 6)).astype(np.float32)
    xs = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2)]
    head = rng.standard_normal((4, 5)).astype(np.float32)
    got = []
    for pkg, ctx in ((jmx, jmx.cpu()), (pmx, pmx.cpu())):
        data = pkg.sym.Variable("data")
        out = pkg.sym.FullyConnected(data, num_hidden=5, no_bias=True,
                                     name="fc")
        exe = out.simple_bind(ctx, grad_req={"fc_weight": "add"},
                              data=(4, 6))
        exe.copy_params_from({"fc_weight": pkg.nd.array(w, ctx=ctx)})
        for x in xs:
            exe.forward(is_train=True, data=x)
            exe.backward([pkg.nd.array(head, ctx=ctx)])
        got.append(exe.grad_dict["fc_weight"].asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], head.T @ (xs[0] + xs[1]), rtol=1e-5,
                               atol=1e-5)


def test_imperative_update_path_matches_fused(monkeypatch):
    """MXNET_EXEC_BULK_EXEC_TRAIN=0 takes the per-parameter Updater path
    (nd.sgd_mom_update); it trains to the same parameters as the fused
    one-launch update."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.integers(0, 3, 16).astype(np.float32)
    with pmx.NameManager():
        net = pmx.sym.Variable("data")
        net = pmx.sym.FullyConnected(net, num_hidden=6, name="fc1")
        net = pmx.sym.BatchNorm(net, fix_gamma=False, name="bn")
        net = pmx.sym.Activation(net, act_type="relu")
        net = pmx.sym.FullyConnected(net, num_hidden=3, name="fc2")
        net = pmx.sym.SoftmaxOutput(net, name="softmax")
    params = []
    for bulk in ("1", "0"):
        monkeypatch.setenv("MXNET_EXEC_BULK_EXEC_TRAIN", bulk)
        pmx.random.seed(7)
        mod = pmx.mod.Module(net, context=pmx.cpu())
        mod.fit(pmx.io.NDArrayIter(x, y, batch_size=4, ctx=pmx.cpu()),
                num_epoch=2, initializer=pmx.init.Xavier(),
                optimizer_params={**OPT, "clip_gradient": 0.5})
        params.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in params[0]:
        np.testing.assert_allclose(params[1][k], params[0][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _fit(pkg, sym, args, auxs, x, y, ctx, num_epoch=2):
    """Module.fit; returns per-batch metric values and per-epoch state."""
    kwargs = {"ctx": ctx} if pkg is pmx else {}
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, **kwargs)
    mod = pkg.mod.Module(sym, context=ctx)
    batches, epochs = [], []

    def on_batch(param):
        batches.append([v for _n, v in param.eval_metric.get_name_value()])

    def on_epoch(epoch, _sym, arg, aux):
        states = mod._updater.states
        idx = dict(enumerate(mod._exec_group.param_names))
        epochs.append((
            {k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()},
            {idx[i]: s.asnumpy() for i, s in states.items()}))

    mod.fit(it, num_epoch=num_epoch, eval_metric=["acc", "ce"],
            optimizer="sgd", optimizer_params=OPT,
            arg_params=_nd(pkg, args), aux_params=_nd(pkg, auxs),
            batch_end_callback=on_batch, epoch_end_callback=on_epoch)
    return batches, epochs, mod


def test_module_fit_tracks_reference_batch_by_batch(model):
    jsym, psym, args, auxs, x, y = model
    jb, je, _ = _fit(jmx, jsym, args, auxs, x, y, jmx.cpu())
    before = sgd_mod.LAUNCHES.value
    pb, pe, _ = _fit(pmx, psym, args, auxs, x, y, pmx.cpu())
    assert sgd_mod.LAUNCHES.value == before  # the CPU takes plain versions
    assert len(pb) == len(jb) == 6 and len(pe) == len(je) == 2
    np.testing.assert_allclose(np.array(pb), np.array(jb), rtol=0, atol=1e-4)
    for (pa, px, ps), (ja, jx, js) in zip(pe, je):
        for d_p, d_j in ((pa, ja), (px, jx), (ps, js)):
            assert d_p.keys() == d_j.keys()
            for k in d_p:
                _close(d_p[k], d_j[k], FIT_TOL, k)


def test_checkpoints_load_across_packages_byte_for_byte(model, tmp_path):
    jsym, psym, args, auxs, x, y = model
    _b, _e, pmod = _fit(pmx, psym, args, auxs, x, y, pmx.cpu(), num_epoch=1)
    pmod.save_checkpoint(str(tmp_path / "port"), 1)
    sym, arg, aux = jmx.model.load_checkpoint(str(tmp_path / "port"), 1)
    jmx.model.save_checkpoint(str(tmp_path / "jax"), 1, sym, arg, aux)
    assert (tmp_path / "jax-0001.params").read_bytes() == \
        (tmp_path / "port-0001.params").read_bytes()
    assert sym.tojson() == psym.tojson()
    # and the reverse: the reference writes, the port reads and re-writes
    psym2, parg, paux = pmx.model.load_checkpoint(str(tmp_path / "jax"), 1)
    pmx.model.save_checkpoint(str(tmp_path / "again"), 2, psym2, parg, paux)
    assert (tmp_path / "again-0002.params").read_bytes() == \
        (tmp_path / "jax-0001.params").read_bytes()
    loaded = pmx.mod.Module.load(str(tmp_path / "jax"), 1,
                                 context=pmx.cpu())
    loaded.bind(data_shapes=[("data", (BATCH,) + NARROW["image_shape"])],
                label_shapes=[("softmax_label", (BATCH,))])
    got_arg, _ = loaded.get_params()
    for k, v in arg.items():
        np.testing.assert_array_equal(got_arg[k].asnumpy(), v.asnumpy())


def test_training_entry_points_default_to_the_card(model):
    _jsym, psym, _args, _auxs, x, y = model
    shapes = {"data": (BATCH,) + NARROW["image_shape"],
              "softmax_label": (BATCH,)}
    w = pmx.nd.zeros((3, 4), ctx=pmx.cpu())
    assert pmx.optimizer.SGD(momentum=0.9).create_state(0, w).context == \
        pmx.cpu()  # the state lives next to its weight
    if torch.cuda.is_available():
        assert pmx.current_context() == pmx.gpu(0)
        exe = psym.simple_bind(grad_req="write", **shapes)
        assert exe.arg_dict["data"].context == pmx.gpu(0)
        it = pmx.io.NDArrayIter(x, y, batch_size=BATCH)
        assert next(iter(it)).data[0].context == pmx.gpu(0)
        return
    with pytest.raises(MXNetError):
        psym.simple_bind(grad_req="write", **shapes)
    with pytest.raises(MXNetError):
        pmx.mod.Module(psym).bind(data_shapes=[("data", shapes["data"])],
                                  label_shapes=[("softmax_label", (BATCH,))])
    with pytest.raises(MXNetError):
        next(iter(pmx.io.NDArrayIter(x, y, batch_size=BATCH)))
    with pytest.raises(MXNetError):
        pmx.random.uniform(shape=(2,))
    # the CPU works when asked for
    exe = psym.simple_bind(pmx.cpu(), grad_req="write", **shapes)
    assert exe.arg_dict["data"].context == pmx.cpu()


def test_unported_training_options_raise(model, monkeypatch):
    _jsym, psym, args, auxs, x, y = model
    it = pmx.io.NDArrayIter(x, y, batch_size=BATCH, ctx=pmx.cpu())
    mod = pmx.mod.Module(psym, context=pmx.cpu())
    with pytest.raises(MXNetError, match="not yet ported"):
        mod.fit(it, num_epoch=1, checkpoint="/nonexistent")
    # training windows are ported now: fit trains under them, and a
    # window, like a single step, needs a backward first
    monkeypatch.setenv("MXNET_TRAIN_WINDOW", "4")
    mod.fit(it, num_epoch=1, arg_params=_nd(pmx, args),
            aux_params=_nd(pmx, auxs))
    monkeypatch.delenv("MXNET_TRAIN_WINDOW")
    exe = psym.simple_bind(pmx.cpu(), grad_req="write",
                           data=(BATCH,) + NARROW["image_shape"],
                           softmax_label=(BATCH,))
    with pytest.raises(MXNetError, match="requires a backward"):
        exe.fused_train_update([], None, [], [], [], [], n_steps=4)
    with pytest.raises(MXNetError, match="several devices"):
        pmx.mod.Module(psym, context=[pmx.cpu(0), pmx.cpu(1)]).bind(
            data_shapes=[("data", (BATCH,) + NARROW["image_shape"])])
