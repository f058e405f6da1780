"""Op-by-op parity of the PyTorch port (``mxnet_tpu_torch.ops``) with the
JAX package (``mxnet_tpu.ops``) at inference.

Each case makes its inputs with numpy from a seed, runs the JAX op (on
XLA:CPU) and the port's op (on CPU tensors, where the kernel wrappers take
their plain versions) with the same parsed parameters, and compares every
output. Shape inference is compared too: the port infers by running the op
body on ``meta`` tensors, the JAX package by ``jax.eval_shape``.

Tolerances, float32 on both sides: elementwise ops and pooling agree to
rtol 1e-6 / atol 1e-6 (the same arithmetic, possibly an FMA apart);
BatchNorm to rtol 1e-5 / atol 1e-6 (rsqrt implementations differ by an
ulp); convolution and FullyConnected to rtol 1e-5 / atol 1e-5 (the
contraction is summed in a different order, and the JAX stem conv goes
through a space-to-depth rewrite).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

EXACT = dict(rtol=1e-6, atol=1e-6)
BN_TOL = dict(rtol=1e-5, atol=1e-6)
DOT_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _check(op_name, raw_params, inputs, tol):
    jouts, pouts = _run_both(op_name, raw_params, inputs)
    assert len(jouts) == len(pouts)
    for j, p in zip(jouts, pouts):
        assert p.shape == j.shape and p.dtype == j.dtype
        np.testing.assert_allclose(p, j, **tol)


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("raw, data_shape", [
    ({"num_hidden": 7}, (3, 4, 2, 2)),
    ({"num_hidden": 5, "no_bias": True}, (4, 6)),
    ({"num_hidden": 3, "flatten": False}, (2, 3, 6)),
])
def test_fully_connected(raw, data_shape):
    rng = np.random.default_rng(1)
    in_dim = (int(np.prod(data_shape[1:])) if raw.get("flatten", True)
              else data_shape[-1])
    ins = [_rand(rng, *data_shape), _rand(rng, raw["num_hidden"], in_dim)]
    if not raw.get("no_bias"):
        ins.append(_rand(rng, raw["num_hidden"]))
    _check("FullyConnected", raw, ins, DOT_TOL)


@pytest.mark.parametrize("raw, data_shape", [
    # the ImageNet stem: 3 channels, 7x7/2 — the JAX op's space-to-depth
    ({"num_filter": 8, "kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
      "no_bias": True}, (2, 3, 20, 20)),
    ({"num_filter": 6, "kernel": (3, 3), "pad": (1, 1)}, (2, 4, 9, 9)),
    ({"num_filter": 8, "kernel": (1, 1), "stride": (2, 2), "no_bias": True},
     (2, 5, 8, 8)),
    ({"num_filter": 6, "kernel": (3, 3), "num_group": 2, "dilate": (2, 2)},
     (1, 4, 10, 10)),
    ({"num_filter": 3, "kernel": (3,), "pad": (1,)}, (2, 2, 11)),
])
def test_convolution(raw, data_shape):
    rng = np.random.default_rng(2)
    cin = data_shape[1] // raw.get("num_group", 1)
    ins = [_rand(rng, *data_shape),
           _rand(rng, raw["num_filter"], cin, *raw["kernel"])]
    if not raw.get("no_bias"):
        ins.append(_rand(rng, raw["num_filter"]))
    _check("Convolution", raw, ins, DOT_TOL)


def test_stem_takes_space_to_depth_in_the_reference():
    """The stem case above must reach ``_space_to_depth_conv`` on the JAX
    side, or its parity would not cover the rewrite."""
    from mxnet_tpu.ops import defs_nn

    called = []
    orig = defs_nn._space_to_depth_conv

    def spy(*a, **k):
        called.append(True)
        return orig(*a, **k)

    defs_nn._space_to_depth_conv = spy
    try:
        test_convolution({"num_filter": 8, "kernel": (7, 7),
                          "stride": (2, 2), "pad": (3, 3), "no_bias": True},
                         (2, 3, 20, 20))
    finally:
        defs_nn._space_to_depth_conv = orig
    assert called


@pytest.mark.parametrize("raw", [
    {"fix_gamma": False, "eps": 2e-5},
    {"fix_gamma": True},
    {"fix_gamma": False, "use_global_stats": True, "output_mean_var": True},
])
@pytest.mark.parametrize("data_shape", [(2, 3, 5, 5), (3, 4, 6)])
def test_batch_norm(raw, data_shape):
    rng = np.random.default_rng(3)
    c = data_shape[1]
    ins = [_rand(rng, *data_shape, lo=-2, hi=2), _rand(rng, c, lo=0.5, hi=1.5),
           _rand(rng, c), _rand(rng, c, lo=-0.3, hi=0.3),
           _rand(rng, c, lo=0.5, hi=2.0)]
    _check("BatchNorm", raw, ins, BN_TOL)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    rng = np.random.default_rng(4)
    _check("Activation", {"act_type": act}, [_rand(rng, 3, 4, 5, lo=-3, hi=3)],
           EXACT)


@pytest.mark.parametrize("raw, data_shape", [
    # the ResNet stem pool: max 3x3/2, pad 1 (padding is -inf)
    ({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
     (2, 3, 9, 9)),
    # the ResNet head: global average
    ({"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
     (2, 4, 7, 7)),
    ({"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg",
      "pooling_convention": "full"}, (1, 2, 5, 5)),
    ({"kernel": (3, 3), "stride": (2, 2), "pool_type": "max",
      "pooling_convention": "full"}, (1, 2, 6, 6)),
    ({"kernel": (2, 2), "pad": (1, 1), "pool_type": "sum"}, (1, 3, 4, 4)),
])
def test_pooling(raw, data_shape):
    rng = np.random.default_rng(5)
    _check("Pooling", raw, [_rand(rng, *data_shape, lo=-3, hi=-1)], EXACT)


@pytest.mark.parametrize("raw, data_shape, label_shape", [
    ({}, (4, 10), (4,)),
    ({}, (2, 3, 2, 2), (2,)),
    ({"multi_output": True}, (2, 5, 3), (2, 3)),
    ({"preserve_shape": True}, (2, 3, 6), (2, 3)),
])
def test_softmax_output(raw, data_shape, label_shape):
    rng = np.random.default_rng(6)
    ins = [_rand(rng, *data_shape, lo=-4, hi=4),
           rng.integers(0, 2, label_shape).astype(np.float32)]
    _check("SoftmaxOutput", raw, ins, EXACT)


@pytest.mark.parametrize("name", ["elemwise_add", "_plus", "_Plus"])
def test_elemwise_add(name):
    rng = np.random.default_rng(7)
    _check(name, {}, [_rand(rng, 2, 3, 4), _rand(rng, 2, 3, 4)], EXACT)


@pytest.mark.parametrize("name", ["identity", "_copy", "Flatten"])
def test_identity_and_flatten(name):
    rng = np.random.default_rng(8)
    _check(name, {}, [_rand(rng, 2, 3, 4, 5)], EXACT)
