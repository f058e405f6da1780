"""The SSD training slice of the PyTorch port held against the JAX package.

Both packages build SSD-VGG16's training symbol
(``models.ssd.get_symbol_train``); its JSON and inferred shapes agree at
300 and 64 pixels. A small SSD training graph (the 3-conv trunk of
``tests/test_torch_ssd_slice.py`` under ``multibox_layer``, with the
channel ``L2Normalization`` x 20, and the training tail of
``get_symbol_train``: ``MultiBoxTarget``, ``SoftmaxOutput``, the smooth-L1
loc loss under ``MakeLoss``, the zero-scaled ``cls_label`` and
``MultiBoxDetection`` heads) takes two SGD steps (lr 0.002, momentum 0.9,
wd 5e-4) in a JAX ``Module`` and in the port's ``Module`` on the CPU, from
the same weights made by numpy from a seed; after each step the four
outputs, every gradient and every parameter are compared. Then a short
``Module.fit`` with the ``Loss`` metric, batch by batch.

Tolerances, float32 on both sides with the convolutions summed in other
orders: outputs, gradients and parameters rtol 1e-4, atol 1e-5 of the
array's largest magnitude (at least 1). ``cls_target`` (the ``cls_label``
head) is held exactly in every image whose reference has no near tie at
the mining boundary: the background logits of its last kept negative and
its first dropped one within 1e-4 of each other relatively (or a
candidate's best IoU within 1e-5 of the 0.5 thresholds); rounding could
move such a boundary. Each step requires at least one image to be held so.
The detections' id column is compared where both sides keep the anchor,
the rest of every row within the tolerance.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu.ops import defs_contrib as jcontrib

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.executor import _Graph
from mxnet_tpu_torch.kernels import l2norm_channel as l2_mod
from mxnet_tpu_torch.kernels import multibox_target as target_mod
from mxnet_tpu_torch.models import ssd as pssd

import jax.numpy as jnp

TOL = dict(rtol=1e-4, atol=1e-5)
TIE_RTOL = 1e-4
BATCH, OBJECTS, SAMPLE = 4, 4, (3, 32, 32)
OPT = {"learning_rate": 0.002, "momentum": 0.9, "wd": 5e-4}
HEADS = ("cls_prob", "loc_loss", "cls_label", "det_out")


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")


def _small_ssd_train(mx, ssd, num_classes=2):
    """The small SSD trunk and heads with ``get_symbol_train``'s tail."""
    s = mx.sym
    body = s.Variable("data")
    feats = []
    for i, nf in enumerate((8, 16, 32)):
        body = s.Activation(
            s.Convolution(body, num_filter=nf, kernel=(3, 3),
                          stride=(2, 2), pad=(1, 1), name=f"trunk_{i}"),
            act_type="relu")
        feats.append(body)
    first = s.L2Normalization(feats[-2], mode="channel",
                              name="trunk_norm") * 20.0
    loc_preds, cls_preds, anchors = ssd.multibox_layer(
        [first, feats[-1]], num_classes, sizes=[(0.2, 0.272), (0.54, 0.619)],
        ratios=[(1, 2, 0.5), (1, 2, 0.5, 3, 1.0 / 3)])
    tmp = s.MultiBoxTarget(
        anchors, s.Variable("label"), cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3, minimum_negative_samples=0,
        negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2),
        name="multibox_target")
    cls_prob = s.SoftmaxOutput(cls_preds, tmp[2], ignore_label=-1,
                               use_ignore=True, multi_output=True,
                               normalization="valid", name="cls_prob")
    loc_loss_ = s.smooth_l1(tmp[1] * (loc_preds - tmp[0]), scalar=1.0,
                            name="loc_loss_")
    loc_loss = s.MakeLoss(loc_loss_, grad_scale=1.0, normalization="valid",
                          name="loc_loss")
    cls_label = s.MakeLoss(tmp[2], grad_scale=0.0, name="cls_label")
    det = s.MultiBoxDetection(cls_prob, loc_preds, anchors, name="detection",
                              nms_threshold=0.45, force_suppress=False,
                              variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400)
    det = s.MakeLoss(det, grad_scale=0.0, name="det_out")
    return s.Group([cls_prob, loc_loss, cls_label, det])


def _labels(rng, n, num_classes=2):
    """(n, OBJECTS, 5) labels: 1..3 objects an image, -1 padded."""
    y = np.full((n, OBJECTS, 5), -1.0, np.float32)
    for i in range(n):
        for j in range(rng.integers(1, 4)):
            x1, y1 = rng.uniform(0, 0.5, 2)
            w, h = rng.uniform(0.2, 0.5, 2)
            y[i, j] = [rng.integers(0, num_classes), x1, y1,
                       min(1.0, x1 + w), min(1.0, y1 + h)]
    return y


@pytest.fixture(scope="module")
def model():
    """(jax symbol, port symbol, numpy weights, images, labels)."""
    with jmx.name.NameManager():
        jsym = _small_ssd_train(jmx, jssd)
    with pmx.NameManager():
        psym = _small_ssd_train(pmx, pssd)
    arg_shapes, _, _ = jsym.infer_shape(data=(BATCH,) + SAMPLE,
                                        label=(BATCH, OBJECTS, 5))
    rng = np.random.default_rng(3)
    args = {}
    for name, shape in zip(jsym.list_arguments(), arg_shapes):
        if name in ("data", "label"):
            continue
        if name.endswith("_weight"):
            std = (0.01 if "_pred_conv_" in name
                   else np.sqrt(2.0 / np.prod(shape[1:])))
            args[name] = (rng.standard_normal(shape) * std).astype(np.float32)
        else:
            args[name] = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    x = rng.standard_normal((3 * BATCH,) + SAMPLE).astype(np.float32)
    y = _labels(rng, 3 * BATCH)
    return jsym, psym, args, x, y


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale, err_msg=what)


def _nd(pkg, d, ctx):
    return {k: pkg.nd.array(v, ctx=ctx) for k, v in d.items()}


# --- the symbol ------------------------------------------------------------
@pytest.mark.parametrize("data_shape, batch", [(300, 32), (64, 2)])
def test_training_symbol_json_and_shapes_match_reference(data_shape, batch):
    with jmx.name.NameManager():
        jsym = jssd.get_symbol_train(num_classes=20, data_shape=data_shape)
    with pmx.NameManager():
        psym = pssd.get_symbol_train(num_classes=20, data_shape=data_shape)
    assert psym.tojson() == jsym.tojson()
    shapes = {"data": (batch, 3, data_shape, data_shape),
              "label": (batch, 16, 5)}
    assert psym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    assert psym.list_arguments() == jsym.list_arguments()
    assert psym.list_outputs() == [f"{h}_output" for h in HEADS]
    again = pmx.symbol.fromjson(jsym.tojson())
    assert again.tojson() == jsym.tojson()
    if data_shape == 300:
        _, out, _ = psym.infer_shape(**shapes)
        assert out == [(32, 21, 8096), (32, 32384), (32, 8096),
                       (32, 8096, 6)]


def test_training_graph_takes_the_l2norm_route_only():
    """The ``* 20`` route fires in the training graph (its backward is the
    kernel's); the detection route does not (``cls_prob`` is a
    SoftmaxOutput); the anchors are held as a constant of the shapes."""
    with pmx.NameManager():
        graph = _Graph(pssd.get_symbol_train(num_classes=20, data_shape=64))
    assert len(graph.l2norm) == 1 and not graph.detection
    priors = [n for n in graph.topo
              if not n.is_variable and n.op.name == "MultiBoxPrior"]
    assert priors and {id(n) for n in priors} == graph._shape_consts


# --- two SGD steps, Module against Module -----------------------------------
def _module(pkg, sym, args, ctx):
    mod = pkg.mod.Module(sym, data_names=("data",), label_names=("label",),
                         context=ctx)
    mod.bind(data_shapes=[("data", (BATCH,) + SAMPLE)],
             label_shapes=[("label", (BATCH, OBJECTS, 5))])
    mod.init_params(arg_params=_nd(pkg, args, ctx), aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return mod


def _mining_tie_free(bg_logits, label, anchors, cls_target):
    """Per image: True when the reference's mining boundary has no near
    tie (see the module docstring)."""
    free = []
    for b in range(label.shape[0]):
        valid = label[b, :, 0] >= 0
        iou = np.asarray(jcontrib._iou_matrix(jnp.asarray(anchors),
                                              jnp.asarray(label[b, :, 1:5])))
        best = np.where(valid[None], iou, -1.0).max(1)
        near_thr = np.abs(best - 0.5) <= 1e-5
        bg = bg_logits[b]
        kept, dropped = bg[cls_target[b] == 0], bg[cls_target[b] == -1]
        tie = False
        if kept.size and dropped.size:
            lo, hi = kept.max(), dropped.min()
            tie = hi - lo <= TIE_RTOL * max(abs(lo), abs(hi))
        free.append(not tie and not near_thr.any())
    return free


def _reference_heads(jsym, params, x):
    """The reference's class predictions (its mining keys are channel 0;
    the one 3-D ``transpose`` output of the graph) and anchors for the
    batch ``x`` at ``params``."""
    internals = jsym.get_internals()
    names = [n for n in internals.list_outputs() if n.startswith("transpose")]
    heads = jmx.sym.Group([internals[n] for n in names]
                          + [internals["multibox_anchors_output"]])
    pred = jmx.predictor.Predictor(
        heads, {f"arg:{k}": jmx.nd.array(v) for k, v in params.items()},
        {"data": x.shape})
    pred.forward(data=x)
    (cls_preds,) = [pred.get_output(i) for i in range(len(names))
                    if pred.get_output(i).ndim == 3]
    return cls_preds, pred.get_output(len(names))[0]


def test_two_sgd_steps_match_reference(model):
    jsym, psym, args, x, y = model
    sides = {}
    for pkg, sym, ctx in ((jmx, jsym, jmx.cpu()), (pmx, psym, pmx.cpu())):
        mod = _module(pkg, sym, args, ctx)
        steps = []
        for k in range(2):
            sl = slice(k * BATCH, (k + 1) * BATCH)
            before = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
            batch = pkg.io.DataBatch(data=[pkg.nd.array(x[sl], ctx=ctx)],
                                     label=[pkg.nd.array(y[sl], ctx=ctx)])
            mod.forward_backward(batch)
            mod.update()
            exe = mod._exec_group._exec
            steps.append({
                "before": before,
                "outputs": [o.asnumpy() for o in mod.get_outputs()],
                # read after the update: the reference publishes the
                # gradients from its fused step
                "grads": {n: exe.grad_dict[n].asnumpy() for n in args},
                "params": {n: v.asnumpy()
                           for n, v in mod.get_params()[0].items()},
            })
        sides[pkg.__name__] = steps
    for k in range(2):
        j, p = sides["mxnet_tpu"][k], sides["mxnet_tpu_torch"][k]
        jo, po = j["outputs"], p["outputs"]
        _close(po[0], jo[0], f"step {k + 1} cls_prob")
        _close(po[1], jo[1], f"step {k + 1} loc_loss")
        # the detections: scores and boxes everywhere, ids where both keep
        _close(po[3][..., 1:], jo[3][..., 1:], f"step {k + 1} det_out")
        both = (po[3][..., 0] >= 0) & (jo[3][..., 0] >= 0)
        assert both.any()
        np.testing.assert_array_equal(po[3][..., 0][both], jo[3][..., 0][both])
        assert all(np.abs(j["grads"][n]).max() > 0 for n in args)
        for n in args:
            _close(p["grads"][n], j["grads"][n], f"step {k + 1} grad {n}")
            _close(p["params"][n], j["params"][n], f"step {k + 1} param {n}")
        # cls_target exactly, in every image without a near tie
        sl = slice(k * BATCH, (k + 1) * BATCH)
        cls_preds, anchors = _reference_heads(jsym, j["before"], x[sl])
        free = _mining_tie_free(cls_preds[:, 0, :], y[sl], anchors, jo[2])
        assert any(free), "no image without a near tie: nothing held exactly"
        for b, ok in enumerate(free):
            if ok:
                np.testing.assert_array_equal(po[2][b], jo[2][b])
        assert (jo[2] > 0).any() and (jo[2] == 0).any() and \
            (jo[2] == -1).any()
    # the CPU path took the plain versions
    assert not (target_mod.LAUNCHES.value or l2_mod.BWD_LAUNCHES.value)


def _fit(pkg, sym, args, x, y, ctx):
    kwargs = {"ctx": ctx} if pkg is pmx else {}
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, label_name="label",
                            **kwargs)
    mod = pkg.mod.Module(sym, data_names=("data",), label_names=("label",),
                         context=ctx)
    values = []
    mod.fit(it, num_epoch=1, eval_metric=pkg.metric.Loss(name="ssd_loss"),
            optimizer="sgd", optimizer_params=OPT,
            arg_params=_nd(pkg, args, ctx),
            batch_end_callback=lambda p: values.append(
                p.eval_metric.get_name_value()))
    return values, {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def test_module_fit_with_loss_metric_tracks_reference(model):
    """Three steps of ``Module.fit`` with ``Loss(name="ssd_loss")``: the
    metric's value after every batch, and the parameters at the end."""
    jsym, psym, args, x, y = model
    jv, jp = _fit(jmx, jsym, args, x, y, jmx.cpu())
    pv, pp = _fit(pmx, psym, args, x, y, pmx.cpu())
    assert len(pv) == len(jv) == 3
    for (pname, pval), (jname, jval) in zip((v[0] for v in pv),
                                            (v[0] for v in jv)):
        assert pname == jname == "ssd_loss"
        np.testing.assert_allclose(pval, jval, rtol=1e-4)
    for n in jp:
        _close(pp[n], jp[n], f"param {n}")
