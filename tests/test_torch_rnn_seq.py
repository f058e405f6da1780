"""The ``RNN`` op's rnn_tanh and rnn_relu modes on the sequence entry
(``rnn_seq``: every step of a layer, both directions, in one call) held
against the JAX package, and the sequence wrapper's plain version and
refusals.

Inputs are made with numpy from a seed: ``mx.sym.RNN`` with 2 layers, one
and two directions, a non-zero initial state, T = 1 and T = 5, N = 3, H = 7,
input width 4, state_outputs on and head gradients N(0, 0.25) on both
outputs (so that no gradient passes a few units, where float32's ulp would
pass the 1e-6 floor and measure the order of the sums instead).
The JAX op runs under ``jax.vjp`` (its ``lax.scan`` on XLA:CPU), the port's
under ``torch.autograd`` on CPU tensors, where ``rnn_seq`` takes its plain
version (a loop of ``rnn_cell_plain``) and ``RNNSeqFn``'s backward steps
back through ``rnn_cell_bwd``'s plain version and forms ``dWh`` as one
product over the steps. Outputs, final states and the gradients of data,
parameters and state, at rtol 1e-5 / atol 1e-6 (float32 on both sides:
``tanh`` and the products' sums of two libraries differ by an ulp or so a
step). ``rnn_seq_plain`` equals T calls of ``rnn_cell_plain`` bit for bit.
The card wrapper's refusals run on stand-ins that report a CUDA device
(``_OnCard``), which the wrapper checks before any launch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import rnn_cell as rnn_mod
from mxnet_tpu_torch.ops import defs_rnn
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.defs_rnn import _rnn_param_size
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

TOL = dict(rtol=1e-5, atol=1e-6)
HIDDEN, BATCH, WIDTH, LAYERS = 7, 3, 4, 2


def _inputs(mode, bidir, steps, seed, hidden=HIDDEN, layers=LAYERS,
            batch=BATCH, lim=0.5):
    rng = np.random.default_rng(seed)
    dirs = 2 if bidir else 1
    size = _rnn_param_size(mode, layers, bidir, WIDTH, hidden)
    ins = [rng.standard_normal((steps, batch, WIDTH)),
           rng.uniform(-lim, lim, size),
           rng.standard_normal((layers * dirs, batch, hidden))]
    return [a.astype(np.float32) for a in ins], rng


def _hold_against_the_reference(mode, bidir, steps, seed, regime,
                                hidden=HIDDEN, layers=LAYERS, batch=BATCH,
                                lim=0.5, head=0.5):
    """The JAX op under ``jax.vjp`` and the port's under autograd on the
    same inputs: outputs, final states and every gradient at ``TOL``, the
    layers counted in ``regime`` ("seq" or "step"), and the inference
    forward equal to the training one."""
    raw = {"mode": mode, "state_size": hidden, "num_layers": layers,
           "bidirectional": bidir, "state_outputs": True}
    ins, rng = _inputs(mode, bidir, steps, seed, hidden, layers, batch, lim)
    jop, pop = jreg.get("RNN"), preg.get("RNN")
    jparams, pparams = jop.parse_params(raw), pop.parse_params(raw)

    def jfn(*args):
        outs, _aux = jop.apply(list(args), jparams,
                               JOpMode(is_train=True,
                                       rng=jax.random.PRNGKey(0)))
        return tuple(outs)

    shapes = jax.eval_shape(jfn, *[jnp.asarray(a) for a in ins])
    heads = [(head * rng.standard_normal(s.shape)).astype(np.float32)
             for s in shapes]
    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in ins])
    jgrads = vjp(tuple(jnp.asarray(h) for h in heads))

    before = (tm.counter("rnn_op.seq_layers").value,
              tm.counter("rnn_op.step_layers").value)
    pins = [torch.from_numpy(a.copy()).requires_grad_(True) for a in ins]
    pouts, _aux = pop.apply(pins, pparams, POpMode(is_train=True))
    assert (tm.counter("rnn_op.seq_layers").value - before[0],
            tm.counter("rnn_op.step_layers").value - before[1]) == (
                (layers, 0) if regime == "seq" else (0, layers))
    pgrads = torch.autograd.grad(pouts, pins,
                                 [torch.from_numpy(h) for h in heads])
    for what, jo, po in zip(("output", "final state"), jouts, pouts):
        assert tuple(po.shape) == jo.shape
        np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo),
                                   err_msg=what, **TOL)
    for name, jg, pg in zip(("data", "parameters", "state"), jgrads,
                            pgrads):
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), err_msg=name,
                                   **TOL)
    with torch.inference_mode():
        iouts, _ = pop.apply([torch.from_numpy(a) for a in ins], pparams,
                             POpMode(is_train=False))
    for io, po in zip(iouts, pouts):
        np.testing.assert_array_equal(io.numpy(), po.detach().numpy())


@pytest.mark.parametrize("mode", ["rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("steps", [1, 5])
def test_rnn_modes_on_the_sequence_entry_match_the_reference(mode, bidir,
                                                             steps):
    _hold_against_the_reference(mode, bidir, steps, seed=steps + 2 * bidir,
                                regime="seq")


@pytest.mark.parametrize("bidir", [False, True])
def test_wide_rnn_layer_steps_a_launch_and_matches_the_reference(bidir):
    """Past ``SEQ_MAX_HIDDEN`` the op trains a layer one cell step at a
    time (``RNNCellFn``), held against the JAX op like the sequence
    regime: one layer, T = 3, N = 2, parameters U(-0.03, 0.03) (about
    1 / sqrt(H)), head gradients N(0, 0.01). At N(0, 0.25) the largest
    parameter gradients reach ~8, and where the T * N = 6 products behind
    an element of ``dWh`` cancel, both sides' float32 rounding (JAX's as
    far from a float64 run of the port as the port's float32 is) passes
    the 1e-6 floor; the gradients are linear in the heads, so the smaller
    heads keep that floor at about ten ulps of the terms."""
    _hold_against_the_reference("rnn_tanh", bidir, 3, seed=11 + bidir,
                                regime="step",
                                hidden=rnn_mod.SEQ_MAX_HIDDEN + 1, layers=1,
                                batch=2, lim=0.03, head=0.1)


def _seq_inputs(steps, dirs, hidden=HIDDEN, rows=BATCH, bias=True, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    xis = [t(steps, rows, hidden) for _ in range(dirs)]
    ws = [t(hidden, hidden, scale=hidden ** -0.5) for _ in range(dirs)]
    bs = [t(hidden, scale=0.3) if bias else None for _ in range(dirs)]
    h0s = [t(rows, hidden, scale=0.5) for _ in range(dirs)]
    return xis, ws, bs, h0s


@pytest.mark.parametrize("act", ["tanh", "relu"])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_sequence_is_the_cell_steps_bit_for_bit(act, dirs, bias):
    xis, ws, bs, h0s = _seq_inputs(6, dirs, bias=bias, seed=dirs)
    ys = rnn_mod.rnn_seq_plain(xis, ws, bs, h0s, act)
    assert ys.shape == (dirs, 6, BATCH, HIDDEN)
    for d in range(dirs):
        h = h0s[d]
        for t in (range(5, -1, -1) if d == 1 else range(6)):
            h = rnn_mod.rnn_cell_plain(xis[d][t], h, ws[d], bs[d], act)
            assert torch.equal(ys[d, t], h)
    # on CPU tensors the wrapper is the plain version and launches nothing
    n0 = rnn_mod.SEQ_LAUNCHES.value
    assert torch.equal(rnn_mod.rnn_seq(xis, ws, bs, h0s, act), ys)
    assert rnn_mod.SEQ_LAUNCHES.value == n0


def test_sequence_on_meta_gives_the_shape():
    xis, ws, bs, h0s = _seq_inputs(4, 2)
    meta = [[t.to("meta") for t in ts] for ts in (xis, ws, bs, h0s)]
    ys = rnn_mod.rnn_seq(*meta, act="relu")
    assert ys.device.type == "meta" and ys.shape == (2, 4, BATCH, HIDDEN)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0: what the card wrapper checks
    before any launch."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def _refusal_args(case, plain):
    """The four lists (i2h, weight, bias, h0) of stand-ins on the card, with
    ``case``'s fault."""
    xis, ws, bs, h0s = ([_on_card(t) for t in ts] for ts in plain)
    if case == "h0 on the CPU":
        h0s[1] = plain[3][1]
    elif case == "weight on the CPU":
        ws[0] = plain[1][0]
    elif case == "i2h non-contiguous":
        xis[0] = _on_card(plain[0][0].transpose(0, 1).contiguous()
                          ).transpose(0, 1)
    elif case == "float64":
        xis, ws, bs, h0s = ([_on_card(t.double()) for t in ts]
                            for ts in plain)
    elif case == "weight not square":
        ws[1] = _on_card(torch.zeros(HIDDEN, HIDDEN + 1))
    elif case == "bias of another width":
        bs[0] = _on_card(torch.zeros(HIDDEN + 1))
    else:  # three directions
        xis, ws, bs, h0s = (ts + ts[:1] for ts in (xis, ws, bs, h0s))
    return xis, ws, bs, h0s


_REFUSALS = {"h0 on the CPU": "h0\\[1\\] must be a contiguous float32",
             "weight on the CPU": "weight\\[0\\] must be a contiguous",
             "i2h non-contiguous": "i2h\\[0\\] must be a contiguous",
             "float64": "i2h\\[0\\] must be a contiguous float32",
             "weight not square": "weight\\[1\\] must be a contiguous",
             "bias of another width": "bias\\[0\\] must be a contiguous",
             "three directions": "one or two directions"}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_card_wrapper_refuses_what_the_kernel_does_not_take(case):
    plain = _seq_inputs(3, 2)
    with pytest.raises(MXNetError, match=_REFUSALS[case]):
        rnn_mod.rnn_seq(*_refusal_args(case, plain))
    with pytest.raises(MXNetError, match="act must be 'tanh' or 'relu'"):
        rnn_mod.rnn_seq(*_refusal_args("h0 on the CPU", plain),
                        act="sigmoid")


def test_card_wrapper_refuses_a_layer_past_the_shape_limit():
    wide = rnn_mod.SEQ_MAX_HIDDEN + 1
    args = [[_on_card(t) for t in ts]
            for ts in _seq_inputs(1, 1, hidden=wide, rows=1)]
    with pytest.raises(MXNetError, match="past the sequence kernel's 928"):
        rnn_mod.rnn_seq(*args)


@pytest.mark.parametrize("hidden, regime", [(rnn_mod.SEQ_MAX_HIDDEN, "seq"),
                                            (rnn_mod.SEQ_MAX_HIDDEN + 1,
                                             "step")])
def test_op_picks_its_regime_from_the_shape(monkeypatch, hidden, regime):
    """Up to ``SEQ_MAX_HIDDEN`` a layer is one sequence call; past it the
    op runs one cell step a launch, counted apart."""
    calls = {"seq": 0, "cell": 0}
    seq, cell = defs_rnn.rnn_seq, defs_rnn.rnn_cell

    def counted(key, real):
        def run(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return run

    monkeypatch.setattr(defs_rnn, "rnn_seq", counted("seq", seq))
    monkeypatch.setattr(defs_rnn, "rnn_cell", counted("cell", cell))
    steps = 2
    pop = preg.get("RNN")
    params = pop.parse_params({"mode": "rnn_tanh", "state_size": hidden,
                               "num_layers": 1})
    rng = np.random.default_rng(hidden)
    ins = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((steps, 1, 3)),
        rng.uniform(-0.03, 0.03, _rnn_param_size("rnn_tanh", 1, False, 3,
                                                 hidden)),
        rng.standard_normal((1, 1, hidden)))]
    before = {k: tm.counter(f"rnn_op.{k}_layers").value
              for k in ("seq", "step")}
    with torch.no_grad():
        (out, state), _aux = pop.apply(ins, params, POpMode(is_train=False))
    got = {k: tm.counter(f"rnn_op.{k}_layers").value - before[k]
           for k in ("seq", "step")}
    assert got == {"seq": regime == "seq", "step": regime == "step"}
    assert calls == ({"seq": 1, "cell": 0} if regime == "seq"
                     else {"seq": 0, "cell": steps})
    # either way the same recurrence
    wi, wh, bi, bh = defs_rnn._slice_rnn_params(ins[1], "rnn_tanh", 1, False,
                                                3, hidden)[0][0]
    xi = torch.addmm(bi, ins[0].reshape(steps, 3), wi.t()).view(steps, 1, -1)
    want = rnn_mod.rnn_seq_plain([xi], [wh], [bh], [ins[2][0]])[0]
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(state[0].numpy(), want[-1].numpy(), **TOL)
