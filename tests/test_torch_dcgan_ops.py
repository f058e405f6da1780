"""The DCGAN path's ops in the PyTorch port, held against the JAX package.

Inputs are made with numpy from a seed; the JAX op runs under ``jax.vjp``
on XLA:CPU, the port's op under ``torch.autograd`` on CPU tensors (where
the kernel wrappers take their plain versions), with one random head
gradient. Cases:

* ``Deconvolution``: stride, pad, adj, dilate, groups and bias, outputs
  and the gradients of data, weight and bias; an ``adj`` that torch
  refuses raises;
* ``LeakyReLU``: ``leaky``, ``elu`` and ``prelu`` (with exact zeros in the
  input, where the gradient is the slope's), ``rrelu`` exactly at
  inference and, in training, by distribution (the slopes come from
  another generator);
* the regression outputs' forward and loss gradients (the head gradient
  ignored, the label's zero);
* the executor's BatchNorm -> LeakyReLU route against the JAX package's
  two separate ops, in training (with pre-activations exactly 0 and a
  constant channel), inference and ``use_global_stats``; a negative slope
  stays unfused; slope 0 (the ReLU route) bit for bit the previous ReLU
  formulas;
* the random samplers' reproducibility, shapes, dtypes and moments;
* ``CustomMetric`` and ``metric.np``.

Tolerances, float32 on both sides: elementwise ops rtol 1e-6 / atol 1e-6;
Deconvolution rtol 1e-5 / atol 1e-5 (contractions summed in another
order); the BatchNorm route rtol 1e-5 / atol 1e-5 and its statistics rtol
1e-5 / atol 1e-6 (channel sums in another order, rsqrt an ulp apart).
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
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

EXACT = dict(rtol=1e-6, atol=1e-6)
DOT_TOL = dict(rtol=1e-5, atol=1e-5)
BN_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = pmx.cpu()


def _vjp_both(op_name, raw, inputs, n_wrt, is_train=True, seed=0):
    """``(jax, port)`` of (output, gradients of the first ``n_wrt``
    inputs) for one random head gradient."""
    jop, pop = jreg.get(op_name), preg.get(op_name)
    jparams, pparams = jop.parse_params(raw), pop.parse_params(raw)
    rest = [jnp.asarray(x) for x in inputs[n_wrt:]]
    key = jax.random.PRNGKey(0) if jop.need_rng else None

    def jfn(*wrt):
        outs, _aux = jop.apply(list(wrt) + rest, jparams,
                               JOpMode(is_train=is_train, rng=key))
        return outs[0]

    jout, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in inputs[:n_wrt]])
    head = np.random.default_rng(seed).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(head))
    pins = [torch.from_numpy(np.array(x)) for x in inputs]
    for t in pins[:n_wrt]:
        t.requires_grad_(True)
    pouts, _aux = pop.apply(pins, pparams, POpMode(is_train=is_train))
    pgrads = torch.autograd.grad(pouts[0], pins[:n_wrt],
                                 grad_outputs=torch.from_numpy(head))
    return ((np.asarray(jout), [np.asarray(g) for g in jgrads]),
            (pouts[0].detach().numpy(), [g.numpy() for g in pgrads]))


def _check(pair, tol):
    (jout, jgrads), (pout, pgrads) = pair
    np.testing.assert_allclose(pout, jout, **tol)
    for pg, jg in zip(pgrads, jgrads):
        np.testing.assert_allclose(pg, jg, **tol)


# --- Deconvolution -----------------------------------------------------------
_DECONV = {
    "dcgan_g1": dict(kernel=(4, 4), num_filter=6, no_bias=True),
    "dcgan_up": dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                     num_filter=5, no_bias=True),
    "adj": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
                num_filter=4),
    "dilate": dict(kernel=(3, 3), dilate=(2, 2), pad=(1, 1), num_filter=3),
    "group": dict(kernel=(3, 3), stride=(2, 2), num_group=2, num_filter=4),
    "bias_odd": dict(kernel=(2, 3), stride=(3, 1), pad=(0, 1), adj=(2, 0),
                     num_filter=2),
}


@pytest.mark.parametrize("case", sorted(_DECONV))
def test_deconvolution_matches_reference(case):
    raw = _DECONV[case]
    rng = np.random.default_rng(1)
    cin = 4
    x = rng.standard_normal((2, cin, 5, 6)).astype(np.float32)
    ng = raw.get("num_group", 1)
    w = rng.standard_normal((cin, raw["num_filter"] // ng)
                            + raw["kernel"]).astype(np.float32)
    inputs = [x, w]
    if not raw.get("no_bias", False):
        inputs.append(rng.standard_normal(raw["num_filter"]).astype(
            np.float32))
    _check(_vjp_both("Deconvolution", raw, inputs, len(inputs)), DOT_TOL)
    shapes = preg.get("Deconvolution").infer_shape(
        [x.shape, None] + ([None] if len(inputs) == 3 else []),
        preg.get("Deconvolution").parse_params(raw))
    jshapes = jreg.get("Deconvolution").infer_shape(
        [x.shape, None] + ([None] if len(inputs) == 3 else []),
        jreg.get("Deconvolution").parse_params(raw))
    assert shapes[:2] == tuple(jshapes[:2])


def test_deconvolution_refuses_large_adj():
    op = preg.get("Deconvolution")
    params = op.parse_params(dict(kernel=(3, 3), stride=(2, 2), adj=(2, 2),
                                  num_filter=2, no_bias=True))
    x = torch.zeros((1, 2, 4, 4))
    w = torch.zeros((2, 2, 3, 3))
    with pytest.raises(MXNetError, match="adj"):
        op.apply([x, w], params, POpMode())


# --- LeakyReLU ---------------------------------------------------------------
def _act_input(shape=(2, 3, 4, 5), seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::7] = 0.0  # exact zeros: the slope's gradient there
    x.reshape(-1)[3::11] = -0.0
    return x


@pytest.mark.parametrize("act,slope", [("leaky", 0.2), ("leaky", 0.25),
                                       ("leaky", -0.1), ("elu", 0.7),
                                       ("elu", 1.0)])
def test_leaky_relu_matches_reference(act, slope):
    raw = dict(act_type=act, slope=slope)
    _check(_vjp_both("LeakyReLU", raw, [_act_input()], 1), EXACT)


def test_prelu_matches_reference():
    gamma = np.array([0.1, -0.3, 0.25], np.float32)
    _check(_vjp_both("LeakyReLU", dict(act_type="prelu"),
                     [_act_input(), gamma], 2), EXACT)


def test_rrelu_inference_matches_reference():
    raw = dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.4)
    _check(_vjp_both("LeakyReLU", raw, [_act_input()], 1, is_train=False),
           EXACT)


def test_rrelu_training_in_distribution():
    op = preg.get("LeakyReLU")
    params = op.parse_params(dict(act_type="rrelu", lower_bound=0.1,
                                  upper_bound=0.4))
    pmx.random.seed(11)
    x = torch.full((200000,), -1.0)
    x[:1000] = 2.0
    (y,), _ = op.apply([x], params, POpMode(is_train=True))
    slopes = -y[1000:]
    assert torch.equal(y[:1000], x[:1000])
    assert float(slopes.min()) >= 0.1 and float(slopes.max()) < 0.4
    # U(0.1, 0.4): mean 0.25, sd 0.0866; the mean of 199000 draws lies
    # within 0.001 of 0.25 at more than 5 sd
    assert abs(float(slopes.mean()) - 0.25) < 1e-3
    assert abs(float(slopes.std()) - 0.3 / 12 ** 0.5) < 1e-3
    pmx.random.seed(11)
    (y2,), _ = op.apply([x], params, POpMode(is_train=True))
    assert torch.equal(y, y2)


# --- regression outputs ------------------------------------------------------
@pytest.mark.parametrize("name", ["LogisticRegressionOutput",
                                  "LinearRegressionOutput",
                                  "MAERegressionOutput"])
@pytest.mark.parametrize("label_shape", ["flat", "same"])
def test_regression_outputs_match_reference(name, label_shape):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((6, 1 if label_shape == "flat" else 3)
                               ).astype(np.float32)
    label = rng.integers(0, 2, (6,) if label_shape == "flat"
                         else (6, 3)).astype(np.float32)
    raw = dict(grad_scale=0.5)
    pair = _vjp_both(name, raw, [data, label], 2)
    _check(pair, EXACT)
    (_jout, (_jd, jl)), (_pout, (_pd, pl)) = pair
    assert not np.any(pl) and not np.any(jl)
    # inference: the transform alone
    pop = preg.get(name)
    (out,), _ = pop.apply([torch.from_numpy(data), torch.from_numpy(label)],
                          pop.parse_params(raw), POpMode(is_train=False))
    np.testing.assert_allclose(out.numpy(), pair[0][0], **EXACT)


# --- the executor's BatchNorm -> LeakyReLU route ----------------------------
def _bn_act_sym(pkg, act, slope, use_global_stats=False):
    data = pkg.sym.Variable("data")
    bn = pkg.sym.BatchNorm(data, name="bn", fix_gamma=False,
                           eps=1e-5 + 1e-12,
                           use_global_stats=use_global_stats)
    if act == "relu":
        return pkg.sym.Activation(bn, name="act", act_type="relu")
    return pkg.sym.LeakyReLU(bn, name="act", act_type="leaky", slope=slope)


def _bn_route_inputs(shape=(4, 3, 5, 5), seed=4):
    """x with a channel whose values make pre-activations exactly 0 (its
    mean is exactly 0 and beta is 0) and a constant channel (variance 0:
    the gradient is scaled by 1 / sqrt(eps) there)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    half = shape[0] // 2
    ints = rng.integers(-2, 3, (half,) + shape[2:]).astype(np.float32)
    x[:half, 0], x[half:, 0] = ints, -ints  # mean exactly 0, zeros in it
    x[:, 1] = 0.75  # a constant channel
    gamma = np.array([1.3, 0.7, -0.9], np.float32)
    beta = np.array([0.0, 0.2, -0.1], np.float32)
    # the anchor of the batch statistics is the moving mean: 0 and 0.75
    # keep channels 0 and 1 exact (their means 0 and 0.75, variance 0)
    mm = np.array([0.0, 0.75, 0.1 * rng.standard_normal()], np.float32)
    mv = rng.random(3).astype(np.float32) + 0.5
    head = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, mm, mv, head


def _run_route(pkg, act, slope, is_train, use_global_stats=False):
    x, gamma, beta, mm, mv, head = _bn_route_inputs()
    assert float(x[:, 0].sum()) == 0.0
    kw = {"ctx": CPU} if pkg is pmx else {}
    sym = _bn_act_sym(pkg, act, slope, use_global_stats)
    exe = sym.simple_bind(pkg.cpu(), grad_req="write", data=x.shape)
    for name, v in (("bn_gamma", gamma), ("bn_beta", beta)):
        exe.arg_dict[name][:] = pkg.nd.array(v, **kw)
    exe.aux_dict["bn_moving_mean"][:] = pkg.nd.array(mm, **kw)
    exe.aux_dict["bn_moving_var"][:] = pkg.nd.array(mv, **kw)
    out = exe.forward(is_train=is_train, data=pkg.nd.array(x, **kw))[0]
    res = {"out": out.asnumpy()}
    if is_train:
        exe.backward([pkg.nd.array(head, **kw)])
        for n in ("data", "bn_gamma", "bn_beta"):
            res[n] = exe.grad_dict[n].asnumpy()
    res["mm"] = exe.aux_dict["bn_moving_mean"].asnumpy()
    res["mv"] = exe.aux_dict["bn_moving_var"].asnumpy()
    return res, exe


@pytest.mark.parametrize("mode", ["train", "infer", "global_stats"])
@pytest.mark.parametrize("act,slope", [("leaky", 0.2), ("leaky", 0.0),
                                       ("relu", 0.0), ("leaky", -0.2)])
def test_bn_leaky_route_matches_reference(mode, act, slope):
    is_train = mode != "infer"
    gs = mode == "global_stats"
    want, _ = _run_route(jmx, act, slope, is_train, gs)
    got, exe = _run_route(pmx, act, slope, is_train, gs)
    fused = exe.graph.fused
    if slope >= 0:
        assert [s for _bn, s in fused.values()] == [slope]
    else:
        assert not fused  # a negative slope flips y's sign: kept apart
    for k in want:
        tol = STAT_TOL if k in ("mm", "mv") else BN_TOL
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _previous_relu_formulas(x, gamma, beta, mean, var, eps, dy):
    """The ReLU route's plain formulas as they read before the slope
    (``bn_act_plain`` and ``bn_act_bwd_plain`` under their ReLU flag)."""
    b = (1, -1, 1, 1)
    inv = torch.rsqrt(var + eps)
    y = torch.relu((x - mean.reshape(b)) * inv.reshape(b)
                   * gamma.reshape(b) + beta.reshape(b))
    d = torch.where(y > 0, dy, 0.0)
    return y, d


def test_slope_zero_is_bit_for_bit_the_relu_route():
    from mxnet_tpu_torch.kernels.bn_act import bn_act
    from mxnet_tpu_torch.kernels.bn_act_bwd import bn_act_bwd, \
        bn_act_bwd_plain

    x, gamma, beta, mm, mv, head = (torch.from_numpy(a) for a in
                                    _bn_route_inputs())
    eps = 1e-5 + 1e-12
    y_old, d_old = _previous_relu_formulas(x, gamma, beta, mm, mv, eps, head)
    y = bn_act(x, mm, mv, gamma, beta, eps, False, 0.0)
    assert torch.equal(y, y_old)
    assert not torch.signbit(y[y == 0]).any()  # +0.0, as the ReLU
    kvar = torch.ones(3)
    got = bn_act_bwd(head, y, x, mm, mv, gamma, kvar, eps, False, 0.0)
    want = bn_act_bwd_plain(head, y, x, mm, mv, gamma, kvar, eps, False)
    want_relu = bn_act_bwd_plain(d_old, None, x, mm, mv, gamma, kvar, eps,
                                 False)
    for g, w in zip(got, want_relu):
        assert torch.equal(g, w)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


# --- random samplers ---------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("random_normal", dict(loc=1.5, scale=2.0)),
    ("normal", dict(loc=-1.0, scale=0.5)),
    ("_random_normal", dict()),
    ("random_uniform", dict(low=-2.0, high=3.0)),
    ("uniform", dict()),
    ("_random_uniform", dict(low=1.0, high=1.5)),
])
def test_random_samplers(name, kw):
    fn = getattr(pmx.nd, name)
    shape = (400, 500)
    pmx.random.seed(5)
    a = fn(shape=shape, ctx=CPU, **kw)
    pmx.random.seed(5)
    b = fn(shape=shape, ctx=CPU, **kw)
    c = fn(shape=shape, ctx=CPU, **kw)
    assert a.shape == shape and a.dtype == np.float32
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert not np.array_equal(b.asnumpy(), c.asnumpy())
    v = a.asnumpy().astype(np.float64)
    if "normal" in name:
        mean, sd = kw.get("loc", 0.0), kw.get("scale", 1.0)
    else:
        lo, hi = kw.get("low", 0.0), kw.get("high", 1.0)
        mean, sd = (lo + hi) / 2, (hi - lo) / 12 ** 0.5
        assert v.min() >= lo and v.max() < hi
    # 200000 draws: the mean within 5 standard errors, the sd within 1 %
    assert abs(v.mean() - mean) < 5 * sd / len(v.reshape(-1)) ** 0.5
    assert abs(v.std() - sd) < 0.01 * sd
    # the JAX package's sampler gives the same shape and dtype
    jout = getattr(jmx.nd, name)(shape=shape, **kw)
    assert jout.shape == shape and jout.dtype == a.dtype


def test_random_sampler_in_a_symbol():
    s = pmx.sym.random_normal(shape=(3, 4), dtype="float32")
    assert s.infer_shape() == ([], [(3, 4)], [])
    pmx.random.seed(9)
    exe = s.simple_bind(CPU)
    out = exe.forward()[0]
    assert out.shape == (3, 4) and out.context == CPU
    assert np.isfinite(out.asnumpy()).all()


# --- CustomMetric ------------------------------------------------------------
def facc(label, pred):
    pred = pred.ravel()
    label = label.ravel()
    return ((pred > 0.5) == label).mean()


def _pair_sum(label, pred):
    return float(np.abs(label - pred).sum()), label.size


@pytest.mark.parametrize("feval,make", [
    (facc, "custom"), (_pair_sum, "custom"), (facc, "np"),
    (lambda label, pred: float(pred.mean()), "custom"),
    (facc, "create")])
def test_custom_metric_matches_reference(feval, make):
    rng = np.random.default_rng(6)
    batches = [(rng.integers(0, 2, (8,)).astype(np.float32),
                rng.random((8, 1)).astype(np.float32)) for _ in range(3)]
    metrics = []
    for pkg in (jmx, pmx):
        kw = {"ctx": CPU} if pkg is pmx else {}
        if make == "np":
            m = pkg.metric.np(feval)
        elif make == "create":
            m = pkg.metric.create(feval)
        else:
            m = pkg.metric.CustomMetric(feval)
        for lab, pred in batches:
            labels, preds = [pkg.nd.array(lab, **kw)], [pkg.nd.array(pred,
                                                                     **kw)]
            if pkg is pmx:
                assert m.device_update(labels, preds) is False
            else:
                m.update(labels, preds)
        metrics.append(m.get())
    (jname, jval), (pname, pval) = metrics
    assert pname == jname
    np.testing.assert_allclose(pval, jval, rtol=1e-12)
