"""Training forward and backward of the PyTorch port's ops, held against
the JAX package.

Each case makes its inputs with numpy from a seed, runs the JAX op under
``jax.vjp`` (``is_train=True``, on XLA:CPU) and the port's op under
``torch.autograd`` on CPU tensors — where the kernel wrappers take their
plain versions — and compares outputs, input gradients and the BatchNorm
moving statistics after the step. Head gradients are random, so a
backward that should ignore its head gradient (SoftmaxOutput) shows it.

Tolerances, float32 on both sides: elementwise ops, pooling and the
SoftmaxOutput backward rtol 1e-6 / atol 1e-6; FullyConnected and
Convolution rtol 1e-5 / atol 1e-5 (contractions summed in another
order); BatchNorm outputs and gradients rtol 1e-5 / atol 1e-5 and its
statistics rtol 1e-5 / atol 1e-6 (channel sums in another order, rsqrt an
ulp apart), plus, under anchor stress, the float32 cancellation of the
anchored variance (``8 * 2**-23 * dmean**2``); the SGD updates 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.kernels import bn_act_bwd as bwd_mod
from mxnet_tpu_torch.kernels import bn_stats as stats_mod
from mxnet_tpu_torch.kernels import sgd_mom_multi as sgd_mod
from mxnet_tpu_torch.kernels import softmax_output_bwd as sob_mod
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.defs_nn import batch_norm as pbatch_norm
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

EXACT = dict(rtol=1e-6, atol=1e-6)
DOT_TOL = dict(rtol=1e-5, atol=1e-5)
BN_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _vjp_both(op_name, raw, inputs, n_wrt, head_seed=0, relu=False):
    """Outputs and the gradients of the first ``n_wrt`` inputs, through
    both packages, for a random head gradient on output 0; also the aux
    inputs after the step (BatchNorm's moving statistics)."""
    jop, pop = jreg.get(op_name), preg.get(op_name)
    jparams, pparams = jop.parse_params(raw), pop.parse_params(raw)

    def jfn(*wrt):
        outs, new_aux = jop.apply(list(wrt) + [jnp.asarray(x) for x in
                                               inputs[n_wrt:]],
                                  jparams, JOpMode(is_train=True))
        out = jax.nn.relu(outs[0]) if relu else outs[0]
        return out, new_aux

    jout, vjp, jaux = jax.vjp(jfn, *[jnp.asarray(x) for x in inputs[:n_wrt]],
                              has_aux=True)
    head = np.random.default_rng(head_seed).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(head))

    pins = [torch.from_numpy(x.copy()) for x in inputs]
    for t in pins[:n_wrt]:
        t.requires_grad_(True)
    mode = POpMode(is_train=True)
    if op_name == "BatchNorm":
        pouts, _ = pbatch_norm(pins, pparams, mode,
                               slope=0.0 if relu else None)
    else:
        pouts, _ = pop.apply(pins, pparams, mode)
    pgrads = torch.autograd.grad(pouts[0], pins[:n_wrt],
                                 grad_outputs=torch.from_numpy(head))
    return ((np.asarray(jout), [np.asarray(g) for g in jgrads],
             [np.asarray(a) for a in jaux]),
            (pouts[0].detach().numpy(), [g.numpy() for g in pgrads],
             [t.numpy() for t in pins[n_wrt:]]))


def _compare(j, p, tol, aux_tol=STAT_TOL):
    (jout, jgrads, jaux), (pout, pgrads, paux) = j, p
    np.testing.assert_allclose(pout, jout, **tol)
    for jg, pg in zip(jgrads, pgrads):
        assert pg.shape == jg.shape
        np.testing.assert_allclose(pg, jg, **tol)
    return jaux, paux


# -- BatchNorm ----------------------------------------------------------------
def _bn_inputs(shape, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    c = shape[1]
    return [(rng.standard_normal(shape) + offset).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),     # gamma
            rng.uniform(-0.5, 0.5, c).astype(np.float32),    # beta
            rng.uniform(-0.3, 0.3, c).astype(np.float32),    # moving_mean
            rng.uniform(0.5, 2.0, c).astype(np.float32)]     # moving_var


@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 4), (2, 5, 7, 7)])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batchnorm_train_matches_reference(shape, fix_gamma, relu,
                                           use_global_stats):
    raw = {"eps": 2e-5, "momentum": 0.9, "fix_gamma": fix_gamma,
           "use_global_stats": use_global_stats}
    j, p = _vjp_both("BatchNorm", raw, _bn_inputs(shape, sum(shape)), 3,
                     relu=relu)
    jaux, paux = _compare(j, p, BN_TOL)
    for ja, pa in zip(jaux, paux):  # moving statistics after the step
        np.testing.assert_allclose(pa, ja, **STAT_TOL)
    if fix_gamma:
        assert not p[1][1].any()  # dgamma is 0 under fix_gamma


def test_batchnorm_anchor_stress_first_step():
    """moving_mean = 0 (the first step) on data with |mean| >> std: the
    anchored variance loses digits to cancellation on both sides alike."""
    x, gamma, beta, _mm, mv = _bn_inputs((8, 3, 4, 4), 5, offset=30.0)
    x = x * np.float32(0.5)
    ins = [x, gamma, beta, np.zeros(3, np.float32), mv]
    raw = {"eps": 2e-5, "momentum": 0.9, "fix_gamma": False}
    j, p = _vjp_both("BatchNorm", raw, ins, 3, relu=True)
    # |mean - anchor| ~ 15, std 0.5: the variance carries a relative error
    # up to 8 * 2**-23 * 15**2 / 0.5**2 (~9e-4) on each side
    cancel = 8 * 2.0 ** -23 * 15.0 ** 2
    jaux, paux = _compare(j, p, dict(rtol=cancel / 0.25, atol=1e-4))
    np.testing.assert_allclose(paux[0], jaux[0], **STAT_TOL)
    np.testing.assert_allclose(paux[1], jaux[1], rtol=1e-5,
                               atol=1e-6 + cancel)


def test_batchnorm_clamp_edge_matches_jax_vjp():
    """Channels whose anchored variance reads below 0 (clamped: the
    variance term of the gradient vanishes) and exactly 0 (jax.vjp halves
    it) while x - mean is not 0. Two elements per channel, so both
    packages add the same two numbers; the zero channel (1024, 1024.25)
    is exact in float32 — its x - mean, and the reference's derivative of
    the variance, carry no rounding — so the halved term is compared
    beyond noise."""
    a = np.array([[999.99054, 1024.0, 0.3, 1000.00867],
                  [999.9925, 1024.25, -1.2, 999.99713]], np.float32)
    x = a.reshape(2, 4, 1, 1)
    ins = [x, np.float32([1.0, 0.7, 1.3, 0.9]), np.zeros(4, np.float32),
           np.zeros(4, np.float32), np.ones(4, np.float32)]
    _m, var, kvar = stats_mod.bn_stats_plain(
        torch.from_numpy(x), torch.zeros(4), torch.ones(4), 0.9)
    assert kvar.tolist() == [0.0, 0.5, 1.0, 0.0] and var[0] == var[1] == 0
    raw = {"eps": 2e-5, "momentum": 0.9, "fix_gamma": False}
    j, p = _vjp_both("BatchNorm", raw, ins, 3)
    # at var = 0 the reference's derivative chain (rsqrt' at eps ~ 5.6e6)
    # rounds to ~1e-4 relative; the clamp factor moves dx by a factor of 2
    # (0.5 against 1) or hundreds (against 0), which rtol 2e-3 still pins
    _compare(j, p, dict(rtol=2e-3, atol=1e-4))


def test_bn_stats_plain_matches_reference_statistics():
    x, gamma, beta, mm, mv = _bn_inputs((5, 6, 3, 3), 3, offset=2.0)
    jop = jreg.get("BatchNorm")
    outs, new_aux = jop.apply([jnp.asarray(v) for v in (x, gamma, beta, mm,
                                                        mv)],
                              jop.parse_params({"momentum": 0.8}),
                              JOpMode(is_train=True))
    pmm, pmv = torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy())
    before = stats_mod.LAUNCHES.value
    mean, var, _k = stats_mod.bn_stats(torch.from_numpy(x), pmm, pmv, 0.8)
    assert stats_mod.LAUNCHES.value == before  # the plain version
    for got, want in ((mean, outs[1]), (var, outs[2]), (pmm, new_aux[0]),
                      (pmv, new_aux[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STAT_TOL)


def test_bn_act_bwd_plain_counts_nothing():
    dy, x = torch.ones(2, 3, 2, 2), torch.zeros(2, 3, 2, 2)
    before = bwd_mod.LAUNCHES.value
    dx, dgamma, dbeta = bwd_mod.bn_act_bwd(dy, torch.relu(x), x,
                                           torch.zeros(3), torch.ones(3),
                                           torch.ones(3), torch.ones(3),
                                           1e-5, False, 0.0)
    assert bwd_mod.LAUNCHES.value == before
    assert not dx.any() and not dbeta.any()  # the ReLU masked every element


# -- SoftmaxOutput --------------------------------------------------------------
@pytest.mark.parametrize("raw, shape", [
    ({}, (4, 7)),
    ({"normalization": "batch", "grad_scale": 0.5}, (4, 7)),
    ({"normalization": "valid", "use_ignore": True, "ignore_label": 2},
     (6, 5)),
    ({"use_ignore": True, "ignore_label": 0}, (6, 5)),
    ({"multi_output": True, "normalization": "valid"}, (2, 4, 3, 3)),
    ({"preserve_shape": True, "grad_scale": 2.0}, (2, 3, 5)),
])
def test_softmax_output_backward_matches_reference(raw, shape):
    rng = np.random.default_rng(len(shape) + len(raw))
    data = rng.standard_normal(shape).astype(np.float32) * 3
    multi = raw.get("multi_output")
    classes = shape[1] if multi else shape[-1]
    lshape = (shape[0],) + shape[2:] if multi else shape[:-1]
    label = rng.integers(0, classes, lshape).astype(np.float32)
    before = sob_mod.LAUNCHES.value
    j, p = _vjp_both("SoftmaxOutput", raw, [data, label], 1, head_seed=7)
    _compare(j, p, EXACT)
    assert sob_mod.LAUNCHES.value == before


# -- the other ops of the path -------------------------------------------------
@pytest.mark.parametrize("op_name, raw, shapes, tol", [
    ("FullyConnected", {"num_hidden": 5}, [(3, 4, 2), (5, 8), (5,)], DOT_TOL),
    ("FullyConnected", {"num_hidden": 5, "no_bias": True, "flatten": False},
     [(3, 2, 4), (5, 4)], DOT_TOL),
    ("Convolution", {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1),
                     "stride": (2, 2), "no_bias": True},
     [(2, 3, 9, 9), (4, 3, 3, 3)], DOT_TOL),
    ("Convolution", {"kernel": (1, 1), "num_filter": 6},
     [(2, 4, 5, 5), (6, 4, 1, 1), (6,)], DOT_TOL),
    ("Convolution", {"kernel": (7, 7), "num_filter": 4, "pad": (3, 3),
                     "stride": (2, 2), "no_bias": True},
     [(2, 3, 16, 16), (4, 3, 7, 7)], DOT_TOL),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pool_type": "max"}, [(2, 3, 9, 9)], EXACT),
    ("Pooling", {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg",
                 "pooling_convention": "full"}, [(2, 3, 7, 7)], EXACT),
    ("Pooling", {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
     [(2, 5, 7, 7)], EXACT),
    ("Activation", {"act_type": "relu"}, [(3, 8)], EXACT),
    ("Activation", {"act_type": "sigmoid"}, [(3, 8)], EXACT),
    ("Activation", {"act_type": "tanh"}, [(3, 8)], EXACT),
    ("Activation", {"act_type": "softrelu"}, [(3, 8)], EXACT),
    ("_plus", {}, [(2, 3, 4), (2, 3, 4)], EXACT),
    ("Flatten", {}, [(2, 3, 4)], EXACT),
    ("identity", {}, [(2, 3)], EXACT),
])
def test_op_backward_matches_reference(op_name, raw, shapes, tol):
    rng = np.random.default_rng(len(shapes) * 7 + sum(map(len, shapes)))
    ins = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    j, p = _vjp_both(op_name, raw, ins, len(ins), head_seed=3)
    _compare(j, p, tol)


def test_max_pool_ties_after_relu_are_masked_by_the_relu():
    """After a ReLU a pooling window holds several zeros; which of them the
    max's backward picks is each library's choice, but the ReLU's backward
    masks every zero, so the gradient of the input agrees exactly."""
    x = np.random.default_rng(4).standard_normal((2, 3, 8, 8)).astype(
        np.float32) - 1.0
    head = np.random.default_rng(5).standard_normal((2, 3, 4, 4)).astype(
        np.float32)
    raw = {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}
    jpool, ppool = jreg.get("Pooling"), preg.get("Pooling")

    def jfn(v):
        return jpool.apply([jax.nn.relu(v)], jpool.parse_params(raw),
                           JOpMode(is_train=True))[0][0]

    _out, vjp = jax.vjp(jfn, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(head))[0])
    t = torch.from_numpy(x).requires_grad_(True)
    out = ppool.apply([torch.relu(t)], ppool.parse_params(raw),
                      POpMode(is_train=True))[0][0]
    got = torch.autograd.grad(out, t, torch.from_numpy(head))[0].numpy()
    assert (out.detach().numpy() == 0).sum() > 0  # windows of tied zeros
    np.testing.assert_array_equal(got, want)


# -- SGD --------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    {"lr": 0.1, "momentum": 0.9, "wd": 1e-4, "rescale_grad": 1 / 32},
    {"lr": 0.05, "momentum": 0.9, "wd": 1e-3, "clip_gradient": 0.01},
    {"lr": 0.1, "wd": 1e-4, "clip_gradient": 0.5},
])
def test_sgd_updates_match_reference(kwargs):
    rng = np.random.default_rng(6)
    w, g, m = (rng.standard_normal((5, 7)).astype(np.float32)
               for _ in range(3))
    momentum = "momentum" in kwargs
    op = "sgd_mom_update" if momentum else "sgd_update"
    jw, jm = jmx.nd.array(w), jmx.nd.array(m)
    jargs = (jw, jmx.nd.array(g), jm) if momentum else (jw, jmx.nd.array(g))
    getattr(jmx.nd, op)(*jargs, out=jw, **kwargs)
    cpu = pmx.cpu()
    pw, pm = pmx.nd.array(w, ctx=cpu), pmx.nd.array(m, ctx=cpu)
    pargs = (pw, pmx.nd.array(g, ctx=cpu), pm) if momentum else \
        (pw, pmx.nd.array(g, ctx=cpu))
    getattr(pmx.nd, op)(*pargs, out=pw, **kwargs)
    np.testing.assert_allclose(pw.asnumpy(), jw.asnumpy(), **EXACT)
    if momentum:
        np.testing.assert_allclose(pm.asnumpy(), jm.asnumpy(), **EXACT)


def test_sgd_mom_multi_plain_matches_reference_per_parameter():
    """One multi-tensor step over several tensors against the JAX op
    applied to each, with per-parameter lr and wd."""
    rng = np.random.default_rng(8)
    sizes, lrs, wds = [(3,), (4, 5), (2, 3, 3)], [0.1, 0.2, 0.05], \
        [1e-4, 0.0, 1e-3]
    ws, gs, ms = ([rng.standard_normal(s).astype(np.float32) for s in sizes]
                  for _ in range(3))
    pws = [torch.from_numpy(w.copy()) for w in ws]
    pms = [torch.from_numpy(m.copy()) for m in ms]
    before = sgd_mod.LAUNCHES.value
    sgd_mod.sgd_mom_multi(pws, [torch.from_numpy(g) for g in gs], pms, lrs,
                          wds, 0.9, 0.25, 1.0)
    assert sgd_mod.LAUNCHES.value == before
    for i in range(3):
        jw, jm = jmx.nd.array(ws[i]), jmx.nd.array(ms[i])
        jmx.nd.sgd_mom_update(jw, jmx.nd.array(gs[i]), jm, out=jw, lr=lrs[i],
                              wd=wds[i], momentum=0.9, rescale_grad=0.25,
                              clip_gradient=1.0)
        np.testing.assert_allclose(pws[i].numpy(), jw.asnumpy(), **EXACT)
        np.testing.assert_allclose(pms[i].numpy(), jm.asnumpy(), **EXACT)
