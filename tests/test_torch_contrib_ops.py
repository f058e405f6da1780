"""The SSD path's ops in the PyTorch port against the JAX package, on the CPU.

Each case makes its inputs with numpy from a seed and runs the JAX op (on
XLA:CPU) and the port's op (on CPU tensors, where the kernel wrappers take
their plain versions) with the same parsed parameters; shape inference is
compared too. Covered: ``transpose``, ``L2Normalization`` (3 modes),
``SoftmaxActivation`` (2 modes), ``MultiBoxPrior``, ``MultiBoxDetection``
and the registration of ``MultiBoxTarget``; then the kernels' plain
versions directly against the reference's ``_iou_matrix``,
``_decode_boxes`` and ``_nms_keep``; and, as in
``tests/test_torch_parity_limits.py``, three faulty NMS versions that these
inputs must catch.

Tolerances, float32 on both sides:

* ``transpose``, ``MultiBoxPrior``, IoU and every keep decision: exact (the
  same operations in the same order);
* ``L2Normalization``, ``SoftmaxActivation``: rtol 1e-6 / atol 1e-6 (the
  sums run in another order, exponentials may differ by an ulp);
* decoded boxes: rtol 1e-6 / atol 1e-7 — XLA:CPU's ``exp`` and torch's
  differ by one ulp on about one value in ten. ``MultiBoxDetection``'s
  scores are the maximum of the given probabilities and are exact.

The keep column of ``MultiBoxDetection`` is held exactly. The inputs
include boxes on a 1/16 grid whose IoUs sit exactly at the threshold, tied
scores, scores exactly at the validity threshold and an image with no
valid box; their offsets are 0 there, so the decoded boxes are the anchors
on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import defs_contrib as jcontrib
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import l2norm_channel as l2_mod
from mxnet_tpu_torch.kernels import multibox_decode as dec_mod
from mxnet_tpu_torch.kernels import nms as nms_mod
from mxnet_tpu_torch.ops import defs_contrib as pcontrib
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

CLOSE = dict(rtol=1e-6, atol=1e-6)
BOX_TOL = dict(rtol=1e-6, atol=1e-7)
VAR = (0.1, 0.1, 0.2, 0.2)


def _run_both(op_name, raw_params, inputs):
    jop, pop = jreg.get(op_name), preg.get(op_name)
    jparams = jop.parse_params(raw_params)
    pparams = pop.parse_params(raw_params)
    jouts, _ = jop.apply([jnp.asarray(x) for x in inputs], jparams,
                         JOpMode(is_train=False))
    pouts, _ = pop.apply([torch.from_numpy(x.copy()) for x in inputs],
                         pparams, POpMode(is_train=False))
    shapes = [tuple(x.shape) for x in inputs]
    assert pop.infer_shape(shapes, pparams) == jop.infer_shape(shapes, jparams)
    return [np.asarray(o) for o in jouts], [o.numpy() for o in pouts]


# --- transpose, L2Normalization, SoftmaxActivation ------------------------
@pytest.mark.parametrize("shape, axes", [
    ((2, 3, 4, 5), (0, 2, 3, 1)), ((2, 7, 5), (0, 2, 1)),
    ((2, 3, 4), ()), ((3, 4), (1, 0)), ((5,), ()),
])
def test_transpose(shape, axes):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    raw = {"axes": axes} if axes else {}
    (j,), (p,) = _run_both("transpose", raw, [x])
    np.testing.assert_array_equal(p, j)
    t = torch.from_numpy(x)
    out, _ = preg.get("transpose").apply(
        [t], preg.get("transpose").parse_params(raw), POpMode())
    assert out[0].data_ptr() == t.data_ptr()  # a view, as the op promises


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
@pytest.mark.parametrize("shape", [(2, 5, 3, 4), (3, 7, 6), (4, 9)])
def test_l2_normalization(mode, shape):
    if mode == "spatial" and len(shape) == 2:
        shape = (4, 9, 1)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    (j,), (p,) = _run_both("L2Normalization", {"mode": mode}, [x])
    np.testing.assert_allclose(p, j, **CLOSE)


def test_l2_normalization_adds_eps_inside_the_sqrt():
    """``x / sqrt(sum + eps)``, not ``x / max(norm, eps)``: an all-zero
    channel column stays 0 and a tiny one is scaled by the eps."""
    x = np.zeros((1, 3, 2, 2), np.float32)
    x[0, :, 0, 1] = 1e-6
    (j,), (p,) = _run_both("L2Normalization",
                           {"mode": "channel", "eps": 1e-10}, [x])
    np.testing.assert_allclose(p, j, **CLOSE)
    assert p[0, 0, 0, 0] == 0.0 and 0 < p[0, 0, 0, 1] < 0.1


@pytest.mark.parametrize("mode, shape", [
    ("channel", (2, 21, 30)), ("channel", (2, 5, 3, 4)),
    ("instance", (3, 10)), ("instance", (2, 4, 3, 3)),
])
def test_softmax_activation(mode, shape):
    x = 3 * np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    (j,), (p,) = _run_both("SoftmaxActivation", {"mode": mode}, [x])
    np.testing.assert_allclose(p, j, **CLOSE)


# --- MultiBoxPrior ----------------------------------------------------------
@pytest.mark.parametrize("raw, hw", [
    ({}, (4, 6)),
    ({"sizes": (0.1, 0.141), "ratios": (1, 2, 0.5)}, (38, 38)),
    ({"sizes": (0.2, 0.272), "ratios": (1, 2, 0.5, 3, 1.0 / 3)}, (5, 7)),
    ({"sizes": (0.88, 0.961), "ratios": (1, 2, 0.5), "clip": True}, (1, 1)),
    ({"sizes": (0.3,), "ratios": (1.0, 2.0), "steps": (0.25, 0.125),
      "offsets": (0.0, 0.25)}, (3, 5)),
    ({"sizes": "(0.5, 0.7)", "ratios": "[1, 3]", "clip": "1"}, (6, 2)),
])
def test_multibox_prior(raw, hw):
    x = np.zeros((2, 3) + hw, np.float32)
    (j,), (p,) = _run_both("MultiBoxPrior", raw, [x])
    np.testing.assert_array_equal(p, j)


def test_multibox_prior_is_held_by_its_bound_graph(monkeypatch):
    """The op computes fresh anchors on every call; a bound graph computes
    them once and holds them, unless they are one of its outputs."""
    op = preg.get("MultiBoxPrior")
    params = op.parse_params({"sizes": (0.2, 0.3)})
    a = op.apply([torch.zeros(1, 3, 5, 5)], params, POpMode())[0][0]
    b = op.apply([torch.ones(2, 3, 5, 5)], params, POpMode())[0][0]
    assert a is not b and torch.equal(a, b)

    calls = []
    real = pcontrib.multibox_prior

    def counted(*args, device="cpu"):
        if torch.device(device).type != "meta":
            calls.append(args)
        return real(*args, device=device)

    monkeypatch.setattr(pcontrib, "multibox_prior", counted)
    anchors = pmx.sym.MultiBoxPrior(pmx.sym.Variable("data"),
                                    sizes=(0.2, 0.3))
    for sym, held in ((pmx.sym.Flatten(anchors), True), (anchors, False)):
        calls.clear()
        exe = sym.simple_bind(pmx.cpu(), grad_req="null", data=(1, 3, 5, 5))
        outs = [exe.forward()[0] for _ in range(2)]
        outs.append(exe.forward(is_train=True)[0])
        assert len(calls) == (1 if held else 3)
        assert len(exe.graph._const_vals) == (1 if held else 0)
        for o in outs:
            np.testing.assert_array_equal(o.asnumpy().reshape(-1),
                                          a.numpy().reshape(-1))


def test_multibox_target_is_registered_and_raises():
    jop, pop = jreg.get("MultiBoxTarget"), preg.get("MultiBoxTarget")
    assert ({k: v.default for k, v in pop.param_schema.items()}
            == {k: v.default for k, v in jop.param_schema.items()})
    assert preg.get("_contrib_MultiBoxTarget") is pop
    with pytest.raises(MXNetError, match="SSD training"):
        pop.apply([torch.zeros(1, 4, 4), torch.zeros(1, 2, 5),
                   torch.zeros(1, 3, 4)], pop.parse_params({}), POpMode())


# --- MultiBoxDetection ------------------------------------------------------
def _random_image(rng, c1, a):
    """Continuous probabilities, offsets and anchors."""
    prob = rng.uniform(0, 1, (c1, a)).astype(np.float32)
    prob /= prob.sum(0, keepdims=True)
    loc = rng.normal(0, 1, (4 * a,)).astype(np.float32)
    lo = rng.uniform(0, 0.8, (a, 2))
    anchors = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (a, 2))], 1)
    return prob, loc, anchors.astype(np.float32)


def _grid_image(rng, c1, a, levels=(0.25, 0.5, 0.75)):
    """Clustered boxes on a 1/16 grid (many IoUs exactly 1/2, 1/4, 1/3),
    scores from three levels (ties), a few exactly at the 0.01 threshold,
    offsets 0 (the decoded box is the anchor, exactly)."""
    x1 = rng.integers(0, 6, (a, 2)) / 16
    wh = rng.integers(1, 5, (a, 2)) / 16
    anchors = np.concatenate([x1, x1 + wh], 1).astype(np.float32)
    prob = np.full((c1, a), 0.001, np.float32)
    cls = rng.integers(0, c1 - 1, a)
    score = np.asarray(levels, np.float32)[rng.integers(0, len(levels), a)]
    score[::9] = np.float32(0.01)  # exactly at the threshold: not valid
    prob[1 + cls, np.arange(a)] = score
    return prob, np.zeros(4 * a, np.float32), anchors


def _invalid_image(rng, c1, a):
    """No valid box: every foreground probability at or below 0.01."""
    prob, loc, anchors = _random_image(rng, c1, a)
    prob[1:] = rng.uniform(0, 0.01, (c1 - 1, a)).astype(np.float32)
    prob[1:, ::3] = np.float32(0.01)
    return prob, loc, anchors


def _detection_inputs(seed, c1=4, a=96):
    """Three images that share one anchor set per call (as the op takes
    it): random continuous, grid-clustered with ties, all invalid."""
    rng = np.random.default_rng(seed)
    grid_p, grid_l, grid_a = _grid_image(rng, c1, a)
    rand_p, rand_l, _ = _random_image(rng, c1, a)
    inv_p, inv_l, _ = _invalid_image(rng, c1, a)
    cls_prob = np.stack([grid_p, rand_p, inv_p])
    loc = np.stack([grid_l, rand_l, inv_l])
    return cls_prob, loc, grid_a[None]


DETECTION_PARAMS = [
    {},
    {"nms_threshold": 0.25},
    {"nms_threshold": 0.5, "force_suppress": True},
    {"threshold": 0.3, "clip": False},
    {"nms_threshold": 0.45, "variances": (0.2, 0.1, 0.3, 0.25),
     "nms_topk": 400},
    {"nms_threshold": 0.5, "force_suppress": True, "clip": False,
     "threshold": 0.5, "background_id": 2},
]


def _check_detection(j, p):
    assert p.shape == j.shape and p.dtype == j.dtype
    np.testing.assert_array_equal(p[..., 0], j[..., 0])  # id, keep
    np.testing.assert_array_equal(p[..., 1], j[..., 1])  # score
    np.testing.assert_allclose(p[..., 2:], j[..., 2:], **BOX_TOL)


_JAX_DETECTIONS = {}


def _both_detections(raw, seed):
    """The JAX op's output (kept for the fault test) and the port's."""
    ins = list(_detection_inputs(seed))
    key = (repr(raw), seed)
    if key not in _JAX_DETECTIONS:
        (j,), (p,) = _run_both("MultiBoxDetection", raw, ins)
        _JAX_DETECTIONS[key] = j
        return j, p
    pop = preg.get("MultiBoxDetection")
    (p,), _ = pop.apply([torch.from_numpy(x) for x in ins],
                        pop.parse_params(raw), POpMode())
    return _JAX_DETECTIONS[key], p.numpy()


@pytest.mark.parametrize("raw", DETECTION_PARAMS)
@pytest.mark.parametrize("seed", [0, 1])
def test_multibox_detection(raw, seed):
    j, p = _both_detections(raw, seed)
    _check_detection(j, p)
    kept = (p[..., 0] >= 0).sum(1)
    assert kept[2] == 0 and 0 < kept[0] < p.shape[1]


def test_multibox_detection_on_grid_boxes_sees_iou_at_the_threshold():
    """The grid image has suppressing pairs exactly at IoU 1/2 and 1/4, so
    a ``>=`` would change the result (see the fault test below)."""
    cls_prob, _loc, anchors = _detection_inputs(0)
    boxes = torch.from_numpy(anchors[0])
    iou = nms_mod.iou_matrix(boxes, boxes).numpy()
    assert (iou == 0.5).sum() > 0 and (iou == 0.25).sum() > 0


# --- the plain versions against the reference's own functions --------------
def test_iou_matrix_matches_reference():
    rng = np.random.default_rng(3)
    _p, _l, a = _random_image(rng, 3, 50)
    g = _grid_image(rng, 3, 40)[2]
    want = np.asarray(jcontrib._iou_matrix(jnp.asarray(a), jnp.asarray(g)))
    got = nms_mod.iou_matrix(torch.from_numpy(a), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("variances", [VAR, (0.2, 0.1, 0.3, 0.25)])
def test_decode_boxes_matches_reference(clip, variances):
    rng = np.random.default_rng(4)
    _p, loc, anchors = _random_image(rng, 3, 200)
    loc = (2 * loc).reshape(200, 4)
    want = np.asarray(jcontrib._decode_boxes(
        jnp.asarray(loc), jnp.asarray(anchors), variances, clip))
    got = dec_mod.decode_boxes(torch.from_numpy(loc),
                               torch.from_numpy(anchors), variances, clip)
    np.testing.assert_allclose(got.numpy(), want, **BOX_TOL)


@pytest.mark.parametrize("softmax", [True, False])
def test_multibox_decode_plain_matches_reference(softmax):
    """Scores within rounding; class ids exact wherever the two best
    foreground probabilities are further apart than that."""
    rng = np.random.default_rng(5)
    cls = rng.normal(0, 2, (2, 21, 300)).astype(np.float32)
    loc = rng.normal(0, 1, (2, 1200)).astype(np.float32)
    anchors = _random_image(rng, 3, 300)[2][None]
    prob = jnp.asarray(cls)
    if softmax:
        prob = np.asarray(jreg.get("SoftmaxActivation").apply(
            [prob], {"mode": "channel"}, JOpMode())[0][0])
    else:
        prob = np.abs(cls) / np.abs(cls).sum(1, keepdims=True)
        cls = prob
    fg = np.asarray(prob)[:, 1:]
    want_score, want_id = fg.max(1), fg.argmax(1)
    want_boxes = np.stack([np.asarray(jcontrib._decode_boxes(
        jnp.asarray(loc[b].reshape(300, 4)), jnp.asarray(anchors[0]), VAR,
        True)) for b in range(2)])
    boxes, score, cls_id = dec_mod.multibox_decode_plain(
        torch.from_numpy(cls), torch.from_numpy(loc),
        torch.from_numpy(anchors), VAR, True, softmax)
    np.testing.assert_allclose(score.numpy(), want_score, **CLOSE)
    np.testing.assert_allclose(boxes.numpy(), want_boxes, **BOX_TOL)
    top2 = np.sort(fg, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-6
    assert clear.mean() > 0.99 and cls_id.dtype == torch.int32
    np.testing.assert_array_equal(cls_id.numpy()[clear], want_id[clear])


def _reference_keep(boxes, scores, valid, thr, force, cls_ids):
    return np.asarray(jcontrib._nms_keep(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr,
        force, jnp.asarray(cls_ids)))


def _nms_cases():
    """(boxes, scores, cls ids) per case: grid boxes with tied scores, the
    same with all scores equal, and continuous boxes."""
    rng, a = np.random.default_rng(6), 96
    cases = []
    for _ in range(2):
        prob, _loc, boxes = _grid_image(rng, 4, a)
        cases.append((boxes, prob[1:].max(0), prob[1:].argmax(0)))
    _p, _l, boxes = _grid_image(rng, 4, a)
    cases.append((boxes, np.full(a, 0.5, np.float32), rng.integers(0, 2, a)))
    _p, _l, boxes = _random_image(rng, 3, a)
    cases.append((boxes, rng.uniform(0, 1, a).astype(np.float32),
                  rng.integers(0, 3, a)))
    return cases


@pytest.mark.parametrize("thr", [0.5, 0.25, 0.45])
@pytest.mark.parametrize("force", [False, True])
def test_nms_keep_plain_matches_reference(thr, force):
    for boxes, scores, cls_ids in _nms_cases():
        valid = scores > np.float32(0.01)
        want = _reference_keep(boxes, scores, valid, thr, force, cls_ids)
        got = nms_mod.nms_keep_plain(
            torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(valid), thr, force, torch.from_numpy(cls_ids))
        np.testing.assert_array_equal(got.numpy(), want)


def test_nms_plain_rows_match_the_reference_rows():
    """The plain version of the kernel pair, fed the decoded inputs and the
    stable order, gives the reference's (n, A, 6) rows."""
    cls_prob, loc, anchors = _detection_inputs(7)
    jop = jreg.get("MultiBoxDetection")
    want = np.asarray(jop.apply([jnp.asarray(x) for x in
                                 (cls_prob, loc, anchors)],
                                jop.parse_params({}), JOpMode())[0][0])
    boxes, score, cls_id = dec_mod.multibox_decode_plain(
        torch.from_numpy(cls_prob), torch.from_numpy(loc),
        torch.from_numpy(anchors), VAR, True, False)
    order = torch.argsort(-score, dim=1, stable=True)
    got = nms_mod.nms_plain(boxes, score, cls_id, order, 0.01, 0.5, False)
    _check_detection(want, got.numpy())
    meta = nms_mod.nms(boxes.to("meta"), score.to("meta"), cls_id.to("meta"),
                       order.to("meta"), 0.01, 0.5, False)
    assert meta.shape == got.shape and meta.device.type == "meta"


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    before = (nms_mod.LAUNCHES.value, dec_mod.LAUNCHES.value,
              l2_mod.LAUNCHES.value)
    test_multibox_detection({}, 0)
    test_l2_normalization("channel", (2, 5, 3, 4))
    assert (nms_mod.LAUNCHES.value, dec_mod.LAUNCHES.value,
            l2_mod.LAUNCHES.value) == before


# --- the inputs see a faulty NMS ---------------------------------------------
def _faulty_keep_sorted(fault):
    """``keep_sorted`` with one fault: ``>=`` for ``>``, suppression across
    classes, or suppression by boxes that were themselves suppressed."""

    def keep_sorted(boxes_o, valid_o, cls_o, nms_threshold, force):
        iou = nms_mod.iou_matrix(boxes_o, boxes_o)
        thr = torch.tensor(nms_threshold, dtype=boxes_o.dtype)
        sup = iou >= thr if fault == ">=" else iou > thr
        if not force and fault != "cross-class":
            sup &= cls_o[:, None] == cls_o[None, :]
        keep = valid_o.clone()
        for i in range(1, boxes_o.shape[0]):
            by = valid_o[:i] if fault == "suppressed-suppress" else keep[:i]
            keep[i] &= ~torch.any(sup[i, :i] & by)
        return keep

    return keep_sorted


@pytest.mark.parametrize("fault", [">=", "cross-class",
                                   "suppressed-suppress"])
def test_detection_inputs_see_a_faulty_nms(monkeypatch, fault):
    """Each fault changes the keep column of some case above, so the exact
    comparison would fail; the true plain version passes the same cases."""
    caught = 0
    monkeypatch.setattr(nms_mod, "keep_sorted", _faulty_keep_sorted(fault))
    for raw in DETECTION_PARAMS:
        for seed in (0, 1):
            j, p = _both_detections(raw, seed)
            caught += int((p[..., 0] != j[..., 0]).any())
    assert caught > 0
