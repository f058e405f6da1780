"""The fused ``RNN`` op of the PyTorch port held against the JAX package.

``mx.sym.RNN``'s body runs in both packages on the same inputs, made with
numpy from a seed: the JAX op under ``jax.vjp`` (jitted, its ``lax.scan``
on XLA:CPU), the port's op under ``torch.autograd`` on CPU tensors (the
cell kernels' plain versions), for all four modes, one and two layers,
one and two directions, ``state_outputs`` on and off, at T <= 6, with
random head gradients on the visible outputs; then the gradients of
``data``, ``parameters``, ``state`` and ``state_cell``. Also the parameter
blob's size and the shape fill-in, the symbol JSON, and dropout between
layers in training, which draws its masks from the op's ``OpMode.rng``
(its parity and gradients are in ``tests/test_torch_dropout.py``).

Tolerances, float32 on both sides: rtol 1e-4 / atol 1e-5, because the
error of each step's products and activations compounds over the steps
and layers.
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
from mxnet_tpu_torch.ops.defs_rnn import _rnn_param_size
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

TOL = dict(rtol=1e-4, atol=1e-5)
HIDDEN = 5

# (mode, layers, bidirectional, state_outputs, T, N, C): every mode, 1 and
# 2 layers, both directions and state_outputs on and off
CASES = [("lstm", 2, True, True, 4, 3, 6), ("gru", 2, True, False, 4, 3, 6),
         ("gru", 1, False, True, 6, 2, 4), ("rnn_tanh", 1, True, False, 4, 2, 3),
         ("rnn_relu", 2, False, True, 5, 3, 4)]


def _inputs(mode, layers, bidir, t, n, c, seed):
    rng = np.random.default_rng(seed)
    dirs = 2 if bidir else 1
    size = _rnn_param_size(mode, layers, bidir, c, HIDDEN)
    ins = [rng.standard_normal((t, n, c)), rng.uniform(-0.4, 0.4, size),
           rng.standard_normal((layers * dirs, n, HIDDEN))]
    if mode == "lstm":
        ins.append(rng.standard_normal((layers * dirs, n, HIDDEN)))
    return [a.astype(np.float32) for a in ins], rng


@pytest.mark.parametrize("mode, layers, bidir, state_outputs, t, n, c",
                         CASES)
def test_rnn_op_matches_reference(mode, layers, bidir, state_outputs, t, n,
                                  c):
    raw = {"mode": mode, "state_size": HIDDEN, "num_layers": layers,
           "bidirectional": bidir, "state_outputs": state_outputs}
    ins, rng = _inputs(mode, layers, bidir, t, n, c, seed=len(mode) + t)
    jop, pop = jreg.get("RNN"), preg.get("RNN")
    jparams, pparams = jop.parse_params(raw), pop.parse_params(raw)
    key = jax.random.PRNGKey(0)

    def jfn(*args):
        outs, _aux = jop.apply(list(args), jparams,
                               JOpMode(is_train=True, rng=key))
        return tuple(outs)

    shapes = jax.eval_shape(jfn, *[jnp.asarray(a) for a in ins])
    nvis = pop.num_visible_outputs(pparams)
    assert nvis == jop.num_visible_outputs(jparams)
    # head gradients on the visible outputs; the others take none
    heads = [rng.standard_normal(s.shape).astype(np.float32) if i < nvis
             else np.zeros(s.shape, np.float32) for i, s in enumerate(shapes)]

    @jax.jit
    def forward_backward(args, cts):
        outs, vjp = jax.vjp(jfn, *args)
        return outs, vjp(cts)

    jouts, jgrads = forward_backward(tuple(jnp.asarray(a) for a in ins),
                                     tuple(jnp.asarray(h) for h in heads))
    pins = [torch.from_numpy(a.copy()).requires_grad_(True) for a in ins]
    pouts, _aux = pop.apply(pins, pparams, POpMode(is_train=True))
    pgrads = torch.autograd.grad(
        pouts[:nvis], pins, [torch.from_numpy(h) for h in heads[:nvis]])
    assert len(pouts) == len(jouts)
    for jo, po in zip(jouts, pouts):
        assert tuple(po.shape) == jo.shape
        np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo), **TOL)
    for name, jg, pg in zip(("data", "parameters", "state", "state_cell"),
                            jgrads, pgrads):
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), err_msg=name,
                                   **TOL)
    # inference (no graph recorded) gives the training forward's outputs
    with torch.inference_mode():
        iouts, _ = pop.apply([torch.from_numpy(a) for a in ins], pparams,
                             POpMode(is_train=False))
    for io, po in zip(iouts, pouts):
        np.testing.assert_array_equal(io.numpy(), po.detach().numpy())


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_param_size_shape_fill_and_json_match(mode):
    for layers, bidir, state_outputs in ((1, False, False), (3, True, True)):
        syms = []
        for pkg in (jmx, pmx):
            with pkg.name.NameManager():
                syms.append(pkg.sym.RNN(
                    pkg.sym.Variable("data"), mode=mode, state_size=HIDDEN,
                    num_layers=layers, bidirectional=bidir,
                    state_outputs=state_outputs, name="rnn"))
        jsym, psym = syms
        assert psym.tojson() == jsym.tojson()
        assert psym.list_arguments() == jsym.list_arguments()
        assert psym.list_outputs() == jsym.list_outputs()
        assert psym.infer_shape(data=(7, 3, 4)) == jsym.infer_shape(
            data=(7, 3, 4))
        size = psym.infer_shape(data=(7, 3, 4))[0][1]
        assert size == (_rnn_param_size(mode, layers, bidir, 4, HIDDEN),)
    assert pmx.sym.rnn is not None  # the alias


def test_rnn_dropout_between_layers_raises_naming_its_roadmap_item():
    ins, _rng = _inputs("gru", 2, False, 3, 2, 4, seed=1)
    pop = preg.get("RNN")
    params = pop.parse_params({"mode": "gru", "state_size": HIDDEN,
                               "num_layers": 2, "p": 0.5})
    tensors = [torch.from_numpy(a) for a in ins]
    # dropout between layers is ported: a training call draws its masks
    # from OpMode.rng and raises only without one
    with pytest.raises(MXNetError, match="OpMode.rng"):
        pop.apply(tensors, params, POpMode(is_train=True))
    train, _ = pop.apply(tensors, params,
                         POpMode(is_train=True, rng=(12345, 1, 0)))
    # at inference the reference applies no dropout, nor after the last
    # layer
    infer, _ = pop.apply(tensors, params, POpMode(is_train=False))
    assert not torch.allclose(train[0], infer[0])
    one = pop.parse_params({"mode": "gru", "state_size": HIDDEN,
                            "num_layers": 1, "p": 0.5})
    pop.apply([torch.from_numpy(_inputs("gru", 1, False, 3, 2, 4, 1)[0][k])
               for k in range(3)], one, POpMode(is_train=True))
