"""The port's kernel wrappers against the JAX package.

On the CPU, ``bn_act`` and ``softmax_rows`` take their plain versions
(the tensor lies on the CPU), and those are held against the JAX
BatchNorm (+ ``jax.nn.relu``) and SoftmaxOutput forwards with inputs made
by numpy from a seed; the launch counters stay at 0, because no kernel ran.
Tolerances are float32: rtol 1e-5 / atol 1e-6 for BatchNorm (rsqrt
implementations differ by an ulp), 1e-6 absolute for probabilities.

``tests/test_torch_cuda.py`` holds the kernels against their plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

from mxnet_tpu_torch.kernels import bn_act as bn_mod
from mxnet_tpu_torch.kernels import softmax_rows as sm_mod

BN_TOL = dict(rtol=1e-5, atol=1e-6)


def _bn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    return [rng.uniform(-2, 2, shape).astype(np.float32),
            rng.uniform(-0.3, 0.3, c).astype(np.float32),   # mean
            rng.uniform(0.5, 2.0, c).astype(np.float32),    # var
            rng.uniform(0.5, 1.5, c).astype(np.float32),    # gamma
            rng.uniform(-0.5, 0.5, c).astype(np.float32)]   # beta


def _jax_bn_act(x, mean, var, gamma, beta, eps, fix_gamma, relu):
    op = jreg.get("BatchNorm")
    params = op.parse_params({"eps": eps, "fix_gamma": fix_gamma})
    outs, _ = op.apply([jnp.asarray(a) for a in (x, gamma, beta, mean, var)],
                       params, JOpMode(is_train=False))
    y = jax.nn.relu(outs[0]) if relu else outs[0]
    return np.asarray(y)


@pytest.mark.parametrize("shape", [(2, 8, 7, 7), (3, 5, 4, 4), (1, 3, 5),
                                   (2, 4)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_bn_act_plain_matches_reference(shape, relu, fix_gamma):
    before = bn_mod.LAUNCHES.value
    x, mean, var, gamma, beta = _bn_inputs(shape, seed=sum(shape))
    want = _jax_bn_act(x, mean, var, gamma, beta, 2e-5, fix_gamma, relu)
    got = bn_mod.bn_act(*(torch.from_numpy(a) for a in
                          (x, mean, var, gamma, beta)),
                        2e-5, fix_gamma, 0.0 if relu else None)
    np.testing.assert_allclose(got.numpy(), want, **BN_TOL)
    assert bn_mod.LAUNCHES.value == before  # the plain version never counts


@pytest.mark.parametrize("shape, axis", [((4, 1000), -1), ((7, 1001), -1),
                                         ((2, 5, 3), 1), ((2, 3, 6), -1)])
def test_softmax_plain_matches_reference(shape, axis):
    x = np.random.default_rng(11).uniform(-6, 6, shape).astype(np.float32)
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=axis))
    before = sm_mod.LAUNCHES.value
    got = sm_mod.softmax(torch.from_numpy(x), axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert sm_mod.LAUNCHES.value == before  # the plain version never counts


def test_softmax_output_reaches_softmax_rows(monkeypatch):
    """SoftmaxOutput's three layouts all go through ``softmax_rows``."""
    from mxnet_tpu_torch.ops import registry as preg
    from mxnet_tpu_torch.ops.registry import OpMode

    seen = []
    orig = sm_mod.softmax_rows

    def spy(x):
        seen.append(tuple(x.shape))
        return orig(x)

    monkeypatch.setattr(sm_mod, "softmax_rows", spy)
    op = preg.get("SoftmaxOutput")
    x = torch.zeros(2, 5, 3)
    for raw in ({}, {"multi_output": True}, {"preserve_shape": True}):
        op.apply([x, torch.zeros(2)], op.parse_params(raw), OpMode())
    assert seen == [(2, 15), (6, 5), (10, 3)]
