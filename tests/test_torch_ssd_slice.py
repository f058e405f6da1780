"""The SSD serving slice of the PyTorch port held against the JAX package.

Both packages build the SSD-VGG16 inference symbol
(``models.ssd.get_symbol``); its JSON and inferred shapes agree at 300 and
64 pixels. Two models are served on the CPU with the same weights, made by
numpy from a seed (the JAX side through its own ``mx.nd``, the port's
through ``params_from_numpy``): a small SSD (a 3-conv trunk under
``multibox_layer``, then ``SoftmaxActivation`` and ``MultiBoxDetection``)
and ``get_symbol(num_classes=3, data_shape=64)``, at batch 2, by the JAX
``Predictor`` and by the port's ``Predictor`` and ``ModelServer``.

Tolerance and the near-tie rule: the score and the four box coordinates of
every anchor agree to rtol 1e-4 / atol 1e-6 (float32 on both sides, the
convolutions summed in other orders, ``exp`` an ulp apart). The id column
(class, or -1 where NMS dropped the anchor) is held exactly in every image
that has no near tie on the reference's side: no two boxes that could
suppress each other (valid, same class, IoU above the threshold) whose
scores lie within 1e-4 of each other relatively, and no valid box whose two
best foreground probabilities do. There the greedy order is the same on
both sides, so every keep decision must be; each test requires at least
one image to be held so. The port's ``ModelServer`` answers exactly as its
``Predictor`` does at the same batch size.

Also: the two executor routes (``SoftmaxActivation`` -> ``MultiBoxDetection``
and ``L2Normalization`` -> ``_mul_scalar``) fire on the SSD graph and
neither fires when its intermediate has an outside consumer, with the same
answers either way; the unported training symbol raises.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu.ops import defs_contrib as jcontrib

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import l2norm_channel as l2_mod
from mxnet_tpu_torch.kernels import multibox_decode as dec_mod
from mxnet_tpu_torch.kernels import nms as nms_mod
from mxnet_tpu_torch.models import ssd as pssd
from mxnet_tpu_torch.serving import ModelServer, ServingConfig

TOL = dict(rtol=1e-4, atol=1e-6)
TIE_RTOL = 1e-4
BATCH = 2
HEADS = ("cls_prob_output", "multibox_loc_pred_output",
         "multibox_anchors_output")


def _small_ssd(mx, ssd, num_classes=2, with_norm=True):
    """A 3-conv trunk under ``multibox_layer`` (as
    ``tests/test_whole_zoo_fastpath.py`` builds the training head), with a
    channel L2Normalization x 20 on the first scale as SSD-300 has, then the
    inference tail of ``get_symbol``."""
    s = mx.sym
    body = s.Variable("data")
    feats = []
    for i, nf in enumerate((8, 16, 32)):
        body = s.Activation(
            s.Convolution(body, num_filter=nf, kernel=(3, 3),
                          stride=(2, 2), pad=(1, 1), name=f"trunk_{i}"),
            act_type="relu")
        feats.append(body)
    first = feats[-2]
    if with_norm:
        first = s.L2Normalization(first, mode="channel",
                                  name="trunk_norm") * 20.0
    loc_preds, cls_preds, anchors = ssd.multibox_layer(
        [first, feats[-1]], num_classes, sizes=[(0.2, 0.272), (0.54, 0.619)],
        ratios=[(1, 2, 0.5), (1, 2, 0.5, 3, 1.0 / 3)])
    cls_prob = s.SoftmaxActivation(cls_preds, mode="channel",
                                   name="cls_prob")
    return s.MultiBoxDetection(cls_prob, loc_preds, anchors,
                               name="detection", nms_threshold=0.45,
                               variances=(0.1, 0.1, 0.2, 0.2))


MODELS = {
    "small": (lambda mx, ssd: _small_ssd(mx, ssd), (3, 32, 32)),
    "ssd64": (lambda mx, ssd: ssd.get_symbol(num_classes=3, data_shape=64),
              (3, 64, 64)),
}


def _build(name):
    make, sample = MODELS[name]
    with jmx.name.NameManager():
        jsym = make(jmx, jssd)
    with pmx.NameManager():
        psym = make(pmx, pssd)
    return jsym, psym, sample


def _weights(jsym, sample, seed):
    """From numpy: He-normal trunk weights, N(0, 0.01) weights for the
    multibox heads (the usual init of detection heads; He-normal heads
    behind the x20 normalization saturate the softmax, and every score
    then ties at 1.0), small biases."""
    arg_shapes, _, _ = jsym.infer_shape(data=(1,) + sample)
    rng = np.random.default_rng(seed)
    args = {}
    for name, shape in zip(jsym.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("_weight"):
            std = (0.01 if "_pred_conv_" in name
                   else np.sqrt(2.0 / np.prod(shape[1:])))
            args[name] = (rng.standard_normal(shape) * std).astype(np.float32)
        else:
            args[name] = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    return args


def _jax_params(args):
    return {f"arg:{k}": jmx.nd.array(v) for k, v in args.items()}


def _torch_params(args):
    a, _ = pmx.convert.params_from_numpy(args, {}, "cpu")
    return {f"arg:{k}": v for k, v in a.items()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def served(request):
    """(name, port symbol, numpy weights, images, the JAX Predictor's
    answers, the JAX head tensors)."""
    jsym, psym, sample = _build(request.param)
    args = _weights(jsym, sample, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (BATCH,) + sample).astype(np.float32)
    jpred = jmx.predictor.Predictor(jsym, _jax_params(args),
                                    {"data": x.shape})
    jpred.forward(data=x)
    want = jpred.get_output(0)
    internals = jsym.get_internals()
    heads = jmx.sym.Group([internals[h] for h in HEADS])
    hpred = jmx.predictor.Predictor(heads, _jax_params(args),
                                    {"data": x.shape})
    hpred.forward(data=x)
    head = [hpred.get_output(i) for i in range(3)]
    return request.param, psym, args, x, want, head


def _tie_free_images(head, params):
    """Per image: True when the reference's head has no near tie (see the
    module docstring), so its keep decisions cannot move with rounding."""
    cls_prob, loc, anchors = head
    free = []
    for b in range(cls_prob.shape[0]):
        fg = cls_prob[b, 1:]
        score, cls_id = fg.max(0), fg.argmax(0)
        top2 = np.sort(fg, axis=0)[-2:]
        valid = score > np.float32(params["threshold"])
        boxes = np.asarray(jcontrib._decode_boxes(
            jnp.asarray(loc[b].reshape(-1, 4)), jnp.asarray(anchors[0]),
            params["variances"], True))
        iou = np.asarray(jcontrib._iou_matrix(jnp.asarray(boxes),
                                              jnp.asarray(boxes)))
        interact = ((iou > np.float32(params["nms_threshold"]))
                    & (cls_id[:, None] == cls_id[None, :])
                    & valid[:, None] & valid[None, :])
        np.fill_diagonal(interact, False)
        gap = np.abs(score[:, None] - score[None, :])
        near = gap <= TIE_RTOL * np.maximum(score[:, None], score[None, :])
        cls_tie = valid & (top2[1] - top2[0] <= TIE_RTOL * top2[1])
        free.append(not (interact & near).any() and not cls_tie.any())
    return free


def _check_answers(got, want, head):
    assert got.shape == want.shape and got.shape[-1] == 6
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], **TOL)
    free = _tie_free_images(head, {"threshold": 0.01, "nms_threshold": 0.45,
                                   "variances": (0.1, 0.1, 0.2, 0.2)})
    assert any(free), "no image without a near tie: nothing held exactly"
    for b, ok in enumerate(free):
        if ok:
            np.testing.assert_array_equal(got[b, :, 0], want[b, :, 0])
    return free


def _port_predictor(psym, args, shape):
    return pmx.predictor.Predictor(psym, _torch_params(args),
                                   {"data": shape}, dev_type="cpu")


# --- the symbol ------------------------------------------------------------
@pytest.mark.parametrize("data_shape, batch", [(300, 8), (64, 2)])
def test_symbol_json_and_shapes_match_reference(data_shape, batch):
    with jmx.name.NameManager():
        jsym = jssd.get_symbol(num_classes=20, data_shape=data_shape)
    with pmx.NameManager():
        psym = pssd.get_symbol(num_classes=20, data_shape=data_shape)
    assert psym.tojson() == jsym.tojson()
    shape = (batch, 3, data_shape, data_shape)
    assert psym.infer_shape(data=shape) == jsym.infer_shape(data=shape)
    assert psym.list_arguments() == jsym.list_arguments()
    # and the port reads the reference's JSON back to the same graph
    again = pmx.symbol.fromjson(jsym.tojson())
    assert again.tojson() == jsym.tojson()
    if data_shape == 300:
        _, out, _ = psym.infer_shape(data=shape)
        assert out == [(8, 8096, 6)]


def test_training_symbol_is_not_yet_ported():
    with pytest.raises(MXNetError, match="SSD training"):
        pssd.get_symbol_train(num_classes=20)


# --- Predictor and ModelServer --------------------------------------------
def test_predictor_matches_reference(served):
    name, psym, args, x, want, head = served
    before = (nms_mod.LAUNCHES.value, dec_mod.LAUNCHES.value,
              l2_mod.LAUNCHES.value)
    pred = _port_predictor(psym, args, x.shape)
    got = pred.run(data=x)[0]
    _check_answers(got, want, head)
    kept = (got[..., 0] >= 0).sum(1)
    assert (kept > 0).all() and (kept < got.shape[1]).all()
    graph = pred._exec.graph
    assert len(graph.detection) == 1 and len(graph.l2norm) == 1
    # on the CPU the kernel wrappers took their plain versions
    assert (nms_mod.LAUNCHES.value, dec_mod.LAUNCHES.value,
            l2_mod.LAUNCHES.value) == before


def test_model_server_answers_as_the_predictor(served):
    name, psym, args, x, want, head = served
    ref = _port_predictor(psym, args, x.shape).run(data=x)[0]
    srv = ModelServer(psym, _torch_params(args), {"data": x.shape[1:]},
                      config=ServingConfig(buckets=(BATCH,),
                                           max_delay_ms=200),
                      dev_type="cpu")
    try:
        srv.start()
        futs = [srv.submit(x[i]) for i in range(BATCH)]
        got = np.stack([f.result(timeout=120)[0] for f in futs])
    finally:
        srv.close()
    # a graph without BatchNorm passes the server's fold untouched
    assert json.loads(srv._symbol.tojson()) == json.loads(psym.tojson())
    np.testing.assert_array_equal(got, ref)
    _check_answers(got, want, head)


# --- the executor's routes ------------------------------------------------
def _outputs_of(sym, args, x, names):
    internals = sym.get_internals()
    group = pmx.sym.Group([sym] + [internals[n] for n in names])
    pred = _port_predictor(group, args, x.shape)
    return pred, pred.run(data=x)


def test_routes_do_not_fire_when_an_intermediate_escapes(served):
    """With the softmax (or the normalization) also a graph output, its
    route stays off and the graph runs as written, to the same answer."""
    name, psym, args, x, _want, _head = served
    routed = _port_predictor(psym, args, x.shape).run(data=x)[0]
    norm = "trunk_norm_output" if name == "small" else "conv4_3_norm_output"
    pred, outs = _outputs_of(psym, args, x, ["cls_prob_output"])
    assert (len(pred._exec.graph.detection),
            len(pred._exec.graph.l2norm)) == (0, 1)
    np.testing.assert_array_equal(outs[0], routed)
    pred, outs = _outputs_of(psym, args, x, [norm])
    assert (len(pred._exec.graph.detection),
            len(pred._exec.graph.l2norm)) == (1, 0)
    np.testing.assert_array_equal(outs[0], routed)


def test_l2norm_route_needs_a_mul_scalar_consumer():
    with pmx.NameManager():
        sym = _small_ssd(pmx, pssd, with_norm=False)
    graph = pmx.executor._Graph(sym)
    assert len(graph.detection) == 1 and not graph.l2norm
