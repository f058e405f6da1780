"""The SSD training path's ops in the PyTorch port against the JAX package,
on the CPU.

Each case makes its inputs with numpy from a seed and runs the JAX op (on
XLA:CPU) and the port's op (on CPU tensors, where the kernel wrappers take
their plain versions) with the same parsed parameters. Covered:
``MultiBoxTarget`` on random boxes and on the edge cases of its matching
and mining (padded rows, an image without objects, two objects sharing a
best anchor, a padded row after an object whose best anchor is anchor 0,
IoUs exactly at the threshold, tied and signed-zero background logits at
the mining boundary, mining off, a minimum of negatives); ``smooth_l1``
and ``MakeLoss`` (normalizations ``null``, ``batch``, ``valid``, and
``grad_scale=0``) forward and backward against ``jax.vjp``;
``elemwise_sub`` and its aliases; the channel ``L2Normalization``
backward (the op at scale 1, and the ``* 20`` route's autograd Function)
against ``jax.vjp``; the ``Loss`` metric.

Tolerances, float32 on both sides:

* ``MultiBoxTarget``: ``cls_target`` and ``loc_target_mask`` exact (the
  same comparisons on the same IoUs; the mining order is a stable sort of
  the same keys), ``loc_target`` rtol 1e-5 / atol 1e-6 (a division or a
  log may round an ulp apart);
* ``smooth_l1``, ``MakeLoss``, ``elemwise_sub``: exact forward; gradients
  rtol 1e-6 / atol 1e-7;
* the L2 normalization backward: rtol 1e-5 of each value plus 1e-6 of the
  largest (the channel sums run in another order);
* ``Loss``: rtol 1e-6 (float64 accumulation on the port's side).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import defs_contrib as jcontrib
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.kernels import l2norm_channel as l2_mod
from mxnet_tpu_torch.kernels import multibox_target as target_mod
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

LOC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-6, atol=1e-7)


# --- MultiBoxTarget ---------------------------------------------------------
def _targets_both(anchors, label, cls_pred, raw):
    """(JAX outputs, port outputs) of MultiBoxTarget, as numpy."""
    jop, pop = jreg.get("MultiBoxTarget"), preg.get("MultiBoxTarget")
    jouts, _ = jop.apply([jnp.asarray(anchors), jnp.asarray(label),
                          jnp.asarray(cls_pred)], jop.parse_params(raw),
                         JOpMode(is_train=True))
    ins = [torch.from_numpy(t.copy()) for t in (anchors, label, cls_pred)]
    pouts, _ = pop.apply(ins, pop.parse_params(raw), POpMode(is_train=True))
    return [np.asarray(o) for o in jouts], [o.numpy() for o in pouts]


def _check_targets(j, p):
    (jl, jm, jc), (pl, pm, pc) = j, p
    assert pl.shape == jl.shape and pm.shape == jm.shape and pc.shape == jc.shape
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, **LOC_TOL)


def _chip_smoke():
    """chip_smoke.py, whose edge inputs of MultiBoxTarget (``mbt_case``)
    the card checks the kernel on too."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CASES = CS.MBT_CASES
_case = CS.mbt_case


@pytest.mark.parametrize("name", CASES)
def test_multibox_target_matches_reference(name):
    anc, label, cls_pred, raw = _case(name)
    j, p = _targets_both(anc, label, cls_pred, raw)
    _check_targets(j, p)
    cls_t = j[2]
    assert (cls_t > 0).any(), "no matched anchor: the case tests nothing"
    if raw["negative_mining_ratio"] > 0:
        assert (cls_t == 0).any() and (cls_t == -1).any()
    else:
        assert not (cls_t == -1).any()


def test_multibox_target_cases_reach_their_edges():
    """The edge cases are really there on the reference's side: IoUs of
    exactly 0.5, ties among the kept and dropped negatives, and signed
    zeros among the candidates' keys."""
    anc, label, _, _ = _case("grid: IoU at the threshold, shared best "
                             "anchors")
    iou = np.asarray(jcontrib._iou_matrix(jnp.asarray(anc[0]),
                                          jnp.asarray(label[0, :, 1:5])))
    assert (iou == np.float32(0.5)).any()
    anc, label, cls_pred, raw = _case("tied and signed-zero logits at the "
                                      "mining boundary")
    (_, _, cls_t), _ = _targets_both(anc, label, cls_pred, raw)
    bg = cls_pred[:, 0, :]
    for b in range(cls_t.shape[0]):
        kept, dropped = bg[b][cls_t[b] == 0], bg[b][cls_t[b] == -1]
        assert np.intersect1d(kept, dropped).size, "no tie at the boundary"
    assert np.signbit(bg[cls_t == 0]).any() and \
        (bg[cls_t == 0] == 0).any()


def test_multibox_target_last_write_clears_a_forced_match():
    """An object whose best anchor is anchor 0 (IoU 0.44, below the
    threshold), then a padded row: the padded row's best anchor is also
    anchor 0, and its write (False) comes last, so anchor 0 is left
    unmatched in the reference; the port does the same. With the rows
    swapped anchor 0 is matched."""
    anc, label, cls_pred, raw = _case(
        "a padded row after an object whose best anchor is anchor 0")
    j, p = _targets_both(anc, label, cls_pred, raw)
    _check_targets(j, p)
    assert j[2][0, 0] == 0 and j[2][1, 0] == 3
    assert (j[2][:, 1:] == 0).all()


def test_multibox_target_plain_matches_the_op_on_a_strided_view():
    """The training symbol hands MultiBoxTarget the class-major transposed
    view of the class predictions; the plain version reads it as given."""
    anc, label, cls_pred, raw = _case("random")
    params = preg.get("MultiBoxTarget").parse_params(raw)
    view = torch.from_numpy(np.ascontiguousarray(
        cls_pred.transpose(0, 2, 1))).transpose(1, 2)
    got = target_mod.multibox_target(
        torch.from_numpy(anc), torch.from_numpy(label), view,
        *[params[k] for k in ("overlap_threshold", "ignore_label",
                              "negative_mining_ratio",
                              "negative_mining_thresh",
                              "minimum_negative_samples", "variances")])
    want, _ = _targets_both(anc, label, cls_pred, raw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **LOC_TOL)


def test_multibox_target_registration_and_shapes():
    jop, pop = jreg.get("MultiBoxTarget"), preg.get("MultiBoxTarget")
    assert ({k: v.default for k, v in pop.param_schema.items()}
            == {k: v.default for k, v in jop.param_schema.items()})
    for alias in ("_contrib_MultiBoxTarget", "multibox_target"):
        assert preg.get(alias) is pop
    shapes = [(1, 300, 4), (3, 6, 5), (3, 6, 300)]
    params = pop.parse_params(CS.MBT_PARAMS)
    assert pop.infer_shape(shapes, params) == jop.infer_shape(
        shapes, jop.parse_params(CS.MBT_PARAMS))


# --- smooth_l1, MakeLoss, elemwise_sub -----------------------------------
def _vjp_both(op_name, raw, x, g):
    """(JAX output, JAX input gradient, port output, port gradient) of a
    one-input op in training mode with head gradient ``g``."""
    jop, pop = jreg.get(op_name), preg.get(op_name)
    jparams = jop.parse_params(raw)

    def f(v):
        outs, _ = jop.apply([v], jparams, JOpMode(is_train=True))
        return outs[0] if isinstance(outs, (list, tuple)) else outs

    jout, vjp = jax.vjp(f, jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    pouts, _ = pop.apply([t], pop.parse_params(raw), POpMode(is_train=True))
    (pgrad,) = torch.autograd.grad(pouts[0], [t], torch.from_numpy(g))
    return (np.asarray(jout), np.asarray(jgrad), pouts[0].detach().numpy(),
            pgrad.numpy())


@pytest.mark.parametrize("scalar", [1.0, 2.0, 0.5])
def test_smooth_l1_matches_reference(scalar):
    rng = np.random.default_rng(int(scalar * 10))
    x = (rng.standard_normal((4, 40)) * 2).astype(np.float32)
    x[0, :4] = [0.0, 1.0, -1.0, 1.0 / scalar ** 2]  # at the branch point
    g = rng.standard_normal(x.shape).astype(np.float32)
    jo, jg, po, pg = _vjp_both("smooth_l1", {"scalar": scalar}, x, g)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_allclose(pg, jg, **GRAD_TOL)


@pytest.mark.parametrize("raw", [
    {}, {"normalization": "batch", "grad_scale": 2.0},
    {"normalization": "valid"},
    {"normalization": "valid", "valid_thresh": 0.5, "grad_scale": 3.0},
    {"grad_scale": 0.0}])
def test_make_loss_matches_reference(raw):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    x[x < -0.5] = 0.0
    g = rng.standard_normal(x.shape).astype(np.float32)  # ignored
    jo, jg, po, pg = _vjp_both("MakeLoss", raw, x, g)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_allclose(pg, jg, **GRAD_TOL)
    assert preg.get("make_loss") is preg.get("MakeLoss")
    assert preg.get("MakeLoss").is_loss


@pytest.mark.parametrize("name", ["elemwise_sub", "_minus", "_Minus",
                                  "broadcast_sub", "broadcast_minus"])
def test_elemwise_sub_and_aliases(name):
    jop, pop = jreg.get(name), preg.get(name)
    assert pop.name == jop.name
    assert (pop.name == "_minus") == (name in ("elemwise_sub", "_minus",
                                               "_Minus"))
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4) if "broadcast" not in name
                            else (1, 4)).astype(np.float32)
    jout, _ = jop.apply([jnp.asarray(a), jnp.asarray(b)], {}, JOpMode())
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    pout, _ = pop.apply([ta, tb], {}, POpMode(is_train=True))
    np.testing.assert_array_equal(pout[0].detach().numpy(),
                                  np.asarray(jout[0]))
    ga, gb = torch.autograd.grad(pout[0].sum(), [ta, tb])
    np.testing.assert_array_equal(ga.numpy(), np.ones_like(a))
    np.testing.assert_array_equal(gb.numpy(), -np.ones_like(a).sum(
        0, keepdims=True) if "broadcast" in name else -np.ones_like(a))


def test_symbol_minus_builds_elemwise_sub():
    with pmx.NameManager():
        a, b = pmx.sym.Variable("a"), pmx.sym.Variable("b")
        out = a - b
    with jmx.name.NameManager():
        ja, jb = jmx.sym.Variable("a"), jmx.sym.Variable("b")
        jout = ja - jb
    assert out.tojson() == jout.tojson()
    exe = out.simple_bind(pmx.cpu(), a=(2, 3), b=(2, 3))
    exe.forward(a=np.ones((2, 3), np.float32), b=np.full((2, 3), 3.0,
                                                          np.float32))
    np.testing.assert_array_equal(exe.outputs[0].asnumpy(),
                                  np.full((2, 3), -2.0, np.float32))


# --- the channel L2 normalization backward --------------------------------
def _l2_close(got, want):
    np.testing.assert_allclose(got, want, rtol=l2_mod.BWD_RTOL,
                               atol=l2_mod.BWD_ATOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 8, 5, 7), (3, 5), (1, 64, 3, 3)])
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_l2norm_channel_backward_matches_reference(shape, scale):
    """The op (scale 1) and the ``* 20`` route's Function against
    ``jax.vjp`` of the reference's formula followed by ``* scale``."""
    rng = np.random.default_rng(len(shape) + int(scale))
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jop = jreg.get("L2Normalization")
    jparams = jop.parse_params({"mode": "channel"})

    def f(v):
        outs, _ = jop.apply([v], jparams, JOpMode(is_train=True))
        y = outs[0] if isinstance(outs, (list, tuple)) else outs
        return y * scale if scale != 1.0 else y

    jy, vjp = jax.vjp(f, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    if scale == 1.0:
        pop = preg.get("L2Normalization")
        outs, _ = pop.apply([t], pop.parse_params({"mode": "channel"}),
                            POpMode(is_train=True))
        y = outs[0]
    else:
        y = l2_mod.L2NormChannelFn.apply(t, jparams["eps"], scale)
    (pg,) = torch.autograd.grad(y, [t], torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-6, atol=1e-6 * scale)
    _l2_close(pg.numpy(), np.asarray(jg))
    # and the plain version on its own
    _l2_close(l2_mod.l2norm_channel_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(g), jparams["eps"],
        scale).numpy(), np.asarray(jg))


def test_l2norm_channel_backward_takes_the_plain_version_on_the_cpu():
    before = (l2_mod.LAUNCHES.value, l2_mod.BWD_LAUNCHES.value)
    x = torch.randn(2, 4, 3, 3, requires_grad=True)
    l2_mod.L2NormChannelFn.apply(x, 1e-10, 20.0).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert (l2_mod.LAUNCHES.value, l2_mod.BWD_LAUNCHES.value) == before


# --- the Loss metric -------------------------------------------------------
def test_loss_metric_matches_reference():
    rng = np.random.default_rng(9)
    batches = [[rng.standard_normal(s).astype(np.float32)
                for s in ((2, 3, 5), (2, 20), (2, 5), (2, 5, 6))]
               for _ in range(3)]
    label = [np.zeros((2, 4, 5), np.float32)]
    jm = jmx.metric.Loss(name="ssd_loss")
    pm_dev, pm_host = pmx.metric.create("loss", name="ssd_loss"), \
        pmx.metric.Loss(name="ssd_loss")
    for preds in batches:
        jm.update([jmx.nd.array(label[0])],
                  [jmx.nd.array(p) for p in preds])
        pm_dev.device_update([pmx.nd.array(label[0], ctx=pmx.cpu())],
                             [pmx.nd.array(p, ctx=pmx.cpu()) for p in preds])
        pm_host.update([pmx.nd.array(label[0], ctx=pmx.cpu())],
                       [pmx.nd.array(p, ctx=pmx.cpu()) for p in preds])
    want = jm.get()
    for m in (pm_dev, pm_host):
        name, value = m.get()
        assert name == want[0] == "ssd_loss"
        np.testing.assert_allclose(value, want[1], rtol=1e-6)
