"""The fused vanilla-RNN step of the PyTorch port — ``rnn_cell``/
``rnn_cell_bwd`` with the recurrent product inside, the executor's route
that hands them the h2h ``FullyConnected``, and the ``RNN`` op's rnn_tanh
and rnn_relu modes — held against the JAX package.

Inputs are made with numpy from a seed at N, H = 1, 4 and 3, 37, for tanh
and relu. The plain step (``RNNCellFn`` on CPU tensors: ``F.linear``, the
activation and its VJP) runs against the reference's own ``RNNCell``
graph under the JAX executor, with an identity ``i2h`` weight and a zero
i2h bias (so the input projection passes the step's input through exactly)
and a random h2h weight and bias: ``next_h``, ``di2h``, ``dh_prev``,
``dWh`` and ``dbh``, from a random and a zero state; and against
``jax.vjp`` of the RNN op's scan body (``act(xg + h @ Wh.T + bh)``), with
pre-activations exactly 0 where relu's derivative is taken as
``jax.nn.relu``'s, 0. The route: L*T fused steps on a 2-layer unroll, each
with its h2h FC among the members; op by op for a sigmoid activation, an
h2h output with another reader and an h2h FC of ``flatten=False``; the
same training step routed and op by op. The card wrappers' refusals run on
stand-ins that report a CUDA device (``_OnCard``), which the wrapper checks
before any launch.

Tolerance, float32 on both sides: rtol 1e-5 / atol 1e-6 (``TOL``), as for
the GRU step of ``tests/test_torch_gru_step.py`` (``tanh`` and the
products' sums of two libraries may differ by an ulp); the routed and
op-by-op steps of one package, rtol 1e-6 / atol 1e-7 (the same plain
functions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _Graph
from mxnet_tpu_torch.kernels import rnn_cell as rnn_mod
from mxnet_tpu_torch.ops import defs_rnn

TOL = dict(rtol=1e-5, atol=1e-6)
SAME = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(1, 4), (3, 37)]
ACTS = ["tanh", "relu"]
HIDDEN, BATCH = 8, 3


def _randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _step_inputs(n, hidden, h_zero=False):
    x = _randn(n, hidden, seed=n + 6, scale=2.0)
    h = (np.zeros((n, hidden), np.float32) if h_zero
         else _randn(n, hidden, seed=n + 7))
    w = _randn(hidden, hidden, seed=n + 8, scale=0.5)
    b = _randn(hidden, seed=n + 9, scale=0.5)
    head = _randn(n, hidden, seed=n + 10)
    return x, h, w, b, head


def _cell_sym(pkg, hidden, act):
    """One step of the package's own ``RNNCell`` over ``x`` and ``h``."""
    cell = pkg.rnn.RNNCell(hidden, activation=act, prefix="cell_")
    out, _states = cell(pkg.sym.Variable("x"), [pkg.sym.Variable("h")])
    return out


def _bind_step(pkg, ctx, sym, x, h, w, b, head):
    """One training forward and backward of a one-step RNN symbol over
    ``x`` (through an identity i2h FC) and state ``h``: the output and the
    gradients of ``x``, ``h``, the h2h weight and bias; and the
    executor."""
    hidden = h.shape[1]
    want = ["x", "h", "cell_h2h_weight", "cell_h2h_bias"]
    exe = sym.simple_bind(ctx, grad_req={a: "write" for a in want},
                          x=x.shape, h=h.shape)
    vals = {"x": x, "h": h, "cell_h2h_weight": w, "cell_h2h_bias": b,
            "cell_i2h_weight": np.eye(hidden, dtype=np.float32),
            "cell_i2h_bias": np.zeros(hidden, np.float32)}
    for k, v in vals.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward([pkg.nd.array(head, ctx=ctx)])
    return ([exe.outputs[0].asnumpy()]
            + [exe.grad_dict[k].asnumpy() for k in want], exe)


def _fn_step(x, h, w, b, head, act):
    """``RNNCellFn`` on CPU tensors (the plain versions): the output and
    the gradients of the input projection, the state, the weight and the
    bias."""
    t = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, h, w, b)]
    next_h = rnn_mod.RNNCellFn.apply(*t, act)
    next_h.backward(torch.from_numpy(head))
    return [next_h.detach().numpy()] + [a.grad.numpy() for a in t]


@pytest.mark.parametrize("n, hidden", SHAPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("h_zero", [False, True])
def test_fused_step_matches_reference_cell(n, hidden, act, h_zero):
    """The plain step against the reference's ``RNNCell`` graph: next_h,
    di2h, dh_prev, dWh and dbh; the wrappers called directly; and the
    port's own RNNCell graph, routed through the same step."""
    x, h, w, b, head = _step_inputs(n, hidden, h_zero)
    want, _ = _bind_step(jmx, jmx.cpu(), _cell_sym(jmx, hidden, act), x, h, w,
                         b, head)
    before = (rnn_mod.LAUNCHES.value, rnn_mod.BWD_LAUNCHES.value)
    for got, wv, what in zip(_fn_step(x, h, w, b, head, act), want,
                             ("next_h", "di2h", "dh_prev", "dWh", "dbh")):
        np.testing.assert_allclose(got, wv, err_msg=what, **TOL)
    t = torch.from_numpy
    nh, saved = rnn_mod.rnn_cell(t(x), t(h), t(w), t(b), act)
    assert saved is nh
    da, dh_prev = rnn_mod.rnn_cell_bwd(t(head), nh, t(h), t(w), act)
    for got, wv in ((nh, want[0]), (da, want[1]), (dh_prev, want[2]),
                    (da.t() @ t(h), want[3]), (da.sum(0), want[4])):
        np.testing.assert_allclose(got.numpy(), wv, **TOL)
    inf_h, none = rnn_mod.rnn_cell(t(x), t(h), t(w), t(b), act, save=False)
    assert none is None
    np.testing.assert_array_equal(inf_h.numpy(), nh.numpy())
    # no kernel launched on the CPU
    assert (rnn_mod.LAUNCHES.value, rnn_mod.BWD_LAUNCHES.value) == before
    pgot, pexe = _bind_step(pmx, pmx.cpu(), _cell_sym(pmx, hidden, act), x,
                            h, w, b, head)
    (step,) = pexe.graph.rnn.values()
    assert step.act == act
    assert any(m.name == "cell_t0_h2h" for m in step.members)
    for got, wv in zip(pgot, want):
        np.testing.assert_allclose(got, wv, **TOL)


@pytest.fixture(scope="module")
def op_body_vjp():
    """``jax.vjp`` of the RNN op's scan body (mxnet_tpu/ops/defs_rnn.py
    rnn_tanh/rnn_relu), jitted once per activation."""
    def make(act):
        fn = jax.nn.relu if act == "relu" else jnp.tanh

        @jax.jit
        def run(xg, hp, wh, bh, ct):
            out, vjp = jax.vjp(lambda *a: fn(a[0] + a[1] @ a[2].T + a[3]),
                               xg, hp, wh, bh)
            return (out,) + vjp(ct)
        return run
    return {act: make(act) for act in ACTS}


@pytest.mark.parametrize("n, hidden", SHAPES)
@pytest.mark.parametrize("act", ACTS)
def test_plain_step_matches_the_op_body_vjp_with_exact_zeros(
        op_body_vjp, n, hidden, act):
    """From the zero state with a zero bias the pre-activation is ``xg``
    exactly: a third of its entries are set to 0.0, where relu's derivative
    is jax.nn.relu's, 0; the gradient of the weight is then 0 exactly."""
    x, _h, w, _b, head = _step_inputs(n, hidden)
    x.reshape(-1)[::3] = 0.0
    h = np.zeros((n, hidden), np.float32)
    b = np.zeros(hidden, np.float32)
    want = [np.asarray(a) for a in op_body_vjp[act](x, h, w, b, head)]
    got = _fn_step(x, h, w, b, head, act)
    for g, wv, what in zip(got, want,
                           ("next_h", "dxg", "dh_prev", "dWh", "dbh")):
        np.testing.assert_allclose(g, wv, err_msg=what, **TOL)
    if act == "relu":
        zeros = x == 0.0
        assert (got[0][zeros] == 0).all() and (got[1][zeros] == 0).all()
        assert (want[1][zeros] == 0).all()
    assert not got[3].any() and not want[3].any()


def _stack(pkg, act="tanh", layers=2):
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(pkg.rnn.RNNCell(HIDDEN, activation=act,
                                  prefix=f"rnn_l{i}_"))
    return stack


@pytest.mark.parametrize("seq_len", [1, 3])
@pytest.mark.parametrize("act", ACTS)
def test_route_fires_LT_times_with_the_h2h_fc_among_its_members(seq_len,
                                                                 act):
    out, _ = _stack(pmx, act).unroll(seq_len,
                                     inputs=pmx.sym.Variable("data"),
                                     merge_outputs=True)
    graph = _Graph(out)
    assert len(graph.rnn) == 2 * seq_len
    for step in graph.rnn.values():
        fcs = [m for m in step.members if m.op.name == "FullyConnected"]
        assert len(fcs) == 1 and fcs[0].name.endswith("_h2h")
        assert step.act == act
        assert len(step.inputs) == 4  # i2h, h_prev, weight, bias
        assert step.inputs[0][0].name.endswith("_i2h")
        assert step.inputs[1:] == fcs[0].inputs


def _written_sym(pkg, hidden, act="tanh", flatten=True):
    """One step written out as ``RNNCell.__call__`` builds it, with the
    activation and the h2h FC's ``flatten`` given."""
    S = pkg.sym
    x, h = S.Variable("x"), S.Variable("h")
    i2h = S.FullyConnected(x, weight=S.Variable("i2h_weight"),
                           bias=S.Variable("i2h_bias"), num_hidden=hidden,
                           name="i2h")
    h2h = S.FullyConnected(h, weight=S.Variable("h2h_weight"),
                           bias=S.Variable("h2h_bias"), num_hidden=hidden,
                           flatten=flatten, name="h2h")
    return S.Activation(i2h + h2h, act_type=act, name="out")


def test_route_stays_off_for_other_chains():
    assert len(_Graph(_written_sym(pmx, 4)).rnn) == 1
    assert len(_Graph(_written_sym(pmx, 4, "relu")).rnn) == 1
    for act in ("sigmoid", "softrelu"):
        assert not _Graph(_written_sym(pmx, 4, act)).rnn
    assert not _Graph(_written_sym(pmx, 4, flatten=False)).rnn
    # the h2h product or the sum read by another head
    written = _written_sym(pmx, 4)
    plus = next(n for n in written.get_internals().list_outputs()
                if n.startswith(("plus", "_plus")))
    for inner in ("h2h_output", plus):
        assert not _Graph(pmx.sym.Group(
            [written, written.get_internals()[inner]])).rnn
    # the i2h output may have other readers: it is an input of the step
    assert len(_Graph(pmx.sym.Group(
        [written, written.get_internals()["i2h_output"]])).rnn) == 1


def _train_step(sym, shapes, dtypes=None):
    exe = sym.simple_bind(pmx.cpu(), grad_req="write", type_dict=dtypes,
                          **shapes)
    for k in sorted(exe.arg_dict):
        exe.arg_dict[k][:] = np.random.default_rng(len(k)).uniform(
            -0.5, 0.5, exe.arg_dict[k].shape)
    exe.forward(is_train=True)
    heads = [pmx.nd.array(np.random.default_rng(4).standard_normal(
        exe.outputs[0].shape), ctx=pmx.cpu(), dtype=exe.outputs[0].dtype)]
    heads += [pmx.nd.zeros(o.shape, ctx=pmx.cpu(), dtype=o.dtype)
              for o in exe.outputs[1:]]
    exe.backward(heads)
    return [exe.outputs[0].asnumpy()] + [exe.grad_dict[k].asnumpy()
                                         for k in sorted(exe.grad_dict)]


@pytest.mark.parametrize("act", ACTS)
def test_routed_and_op_by_op_steps_agree_when_the_product_escapes(act):
    """The same training step of a 2-layer stack with every step fused and
    with one step's h2h product exposed (that step then runs op by op, the
    FC's backward by autograd)."""
    out, _ = _stack(pmx, act).unroll(3, inputs=pmx.sym.Variable("data"),
                                     merge_outputs=True)
    exposed = pmx.sym.Group([out, out.get_internals()[
        "rnn_l0_t2_h2h_output"]])
    assert len(_Graph(exposed).rnn) == 5
    shapes = {"data": (BATCH, 3, 5), "rnn_l0_begin_state_0": (BATCH, HIDDEN),
              "rnn_l1_begin_state_0": (BATCH, HIDDEN)}
    fused, plain = _train_step(out, shapes), _train_step(exposed, shapes)
    assert len(fused) == len(plain) == 12  # output and 11 gradients
    for got, want in zip(plain, fused):
        np.testing.assert_allclose(got, want, **SAME)


@pytest.mark.parametrize("state", ["float64", "float32"])
def test_route_casts_the_h2h_parameters_to_the_state_dtype(state):
    """Float64 inputs with float32 parameters, and a float64 or a float32
    state: the FC casts its parameters to the state's dtype, and the routed
    step, forward and backward, matches the op-by-op graph."""
    routed = _written_sym(pmx, 6)
    exposed = pmx.sym.Group([routed, routed.get_internals()["h2h_output"]])
    assert len(_Graph(routed).rnn) == 1 and not _Graph(exposed).rnn
    types = {"x": "float64", "h": state}
    types.update({k: "float32" for k in ("i2h_weight", "i2h_bias",
                                         "h2h_weight", "h2h_bias")})
    shapes = {"x": (5, 6), "h": (5, 6)}
    outs = [_train_step(sym, shapes, types) for sym in (routed, exposed)]
    assert outs[0][0].dtype == np.float64 and len(outs[0]) == 7
    for got, want in zip(*outs):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **SAME)


def test_matched_chain_over_another_width_runs_as_written():
    """``tanh(FC(x) + FC(y))`` with ``y`` of another width than the output
    matches the chain but is no recurrent step: it runs as written, forward
    and backward."""
    routed = _written_sym(pmx, 6)
    exposed = pmx.sym.Group([routed, routed.get_internals()["h2h_output"]])
    assert len(_Graph(routed).rnn) == 1
    shapes = {"x": (5, 3), "h": (5, 4)}
    for got, want in zip(_train_step(routed, shapes),
                         _train_step(exposed, shapes)):
        np.testing.assert_allclose(got, want, **SAME)


@pytest.mark.parametrize("mode", ["rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_runs_one_cell_step_each_way(monkeypatch, mode,
                                            bidirectional):
    """The RNN op's rnn modes run each layer, both directions, as one
    sequence call in training (``RNNSeqFn``) and at inference
    (``rnn_seq``), call no cell step forward (``RNNCellFn``,
    ``rnn_cell``), and step back L*D*T times (``rnn_cell_bwd``); the
    inference outputs are the training forward's."""
    calls = {"fwd": 0, "bwd": 0, "inf": 0, "cell_fwd": 0, "cell_inf": 0}
    fn_apply, seq, bwd = (rnn_mod.RNNSeqFn.apply, defs_rnn.rnn_seq,
                          rnn_mod.rnn_cell_bwd)
    cell_apply, cell = rnn_mod.RNNCellFn.apply, defs_rnn.rnn_cell

    def counted(key, real):
        def run(*a, **k):
            # shape inference at bind runs the op on meta tensors (rnn_seq
            # takes lists of them)
            flat = [u for t in a for u in (t if isinstance(t, list) else [t])]
            if not any(isinstance(t, torch.Tensor) and t.is_meta
                       for t in flat):
                calls[key] += 1
            return real(*a, **k)
        return run

    monkeypatch.setattr(rnn_mod.RNNSeqFn, "apply", counted("fwd", fn_apply))
    monkeypatch.setattr(defs_rnn, "rnn_seq", counted("inf", seq))
    monkeypatch.setattr(rnn_mod, "rnn_cell_bwd", counted("bwd", bwd))
    monkeypatch.setattr(rnn_mod.RNNCellFn, "apply",
                        counted("cell_fwd", cell_apply))
    monkeypatch.setattr(defs_rnn, "rnn_cell", counted("cell_inf", cell))
    steps, layers = 4, 2
    dirs = 2 if bidirectional else 1
    sym = pmx.sym.RNN(pmx.sym.Variable("data"), mode=mode, state_size=5,
                      num_layers=layers, bidirectional=bidirectional,
                      state_outputs=True, name="rnn")
    exe = sym.simple_bind(pmx.cpu(), grad_req="write", data=(steps, 3, 4))
    for name, arr in exe.arg_dict.items():
        arr[:] = np.random.default_rng(len(name)).uniform(-0.5, 0.5,
                                                          arr.shape)
    exe.forward(is_train=True)
    exe.backward([pmx.nd.ones(o.shape, ctx=pmx.cpu()) for o in exe.outputs])
    train_out = [o.asnumpy() for o in exe.outputs]
    exe.forward(is_train=False)
    assert calls == {"fwd": layers, "bwd": layers * dirs * steps,
                     "inf": layers, "cell_fwd": 0, "cell_inf": 0}
    for got, ref in zip(exe.outputs, train_out):
        np.testing.assert_array_equal(got.asnumpy(), ref)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0: what the card wrappers check
    before any launch."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


def _on_card(a):
    return torch.Tensor._make_subclass(_OnCard, torch.from_numpy(a))


_REFUSALS = ["h_prev on the CPU", "weight on the CPU", "bias on the CPU",
             "i2h row-strided", "weight transposed", "i2h float64",
             "weight not square"]


@pytest.mark.parametrize("case", _REFUSALS)
def test_card_wrappers_refuse_mixed_devices_and_non_contiguous(case):
    n, hidden = 5, 6
    x, h, w, b, head = _step_inputs(n, hidden)
    args = {"i2h": _on_card(x), "h_prev": _on_card(h), "weight": _on_card(w),
            "bias": _on_card(b)}
    name = case.split()[0]
    if case.endswith("on the CPU"):
        args[name] = torch.from_numpy({"h_prev": h, "weight": w,
                                       "bias": b}[name])
    elif case == "i2h row-strided":
        args[name] = _on_card(np.concatenate([x, x], 1))[:, :hidden]
    elif case == "weight transposed":
        args[name] = _on_card(np.ascontiguousarray(w.T)).t()
    elif case == "weight not square":
        args[name] = _on_card(np.zeros((hidden, hidden + 1), np.float32))
    else:
        args[name] = _on_card(x.astype(np.float64))
    with pytest.raises(MXNetError, match=f"rnn_cell: {name} must be a "
                       "contiguous float32"):
        rnn_mod.rnn_cell(**args)
    # the backward: the same refusal for its state and weight
    if name in ("h_prev", "weight"):
        with pytest.raises(MXNetError, match=f"rnn_cell_bwd: {name} must be "
                           "a contiguous float32"):
            rnn_mod.rnn_cell_bwd(_on_card(head), _on_card(h),
                                 args["h_prev"], args["weight"])


def test_card_wrappers_refuse_a_cpu_gradient_and_other_activations():
    n, hidden = 5, 6
    x, h, w, b, head = _step_inputs(n, hidden)
    with pytest.raises(MXNetError, match="rnn_cell_bwd: dnext_h must be"):
        rnn_mod.rnn_cell_bwd(torch.from_numpy(head), _on_card(h),
                             _on_card(h), _on_card(w))
    with pytest.raises(MXNetError, match="next_h must be"):
        rnn_mod.rnn_cell_bwd(None, _on_card(h[0]), _on_card(h), _on_card(w))
    for where in (torch.from_numpy, _on_card):
        with pytest.raises(MXNetError, match="act must be 'tanh' or 'relu'"):
            rnn_mod.rnn_cell(where(x), where(h), where(w), where(b),
                             "sigmoid")
        with pytest.raises(MXNetError, match="act must be 'tanh' or 'relu'"):
            rnn_mod.rnn_cell_bwd(where(head), where(h), where(h), where(w),
                                 "softrelu")


def test_plain_step_on_meta_gives_the_shapes():
    n, hidden = 5, 6
    meta = {k: torch.empty(s, device="meta") for k, s in (
        ("i2h", (n, hidden)), ("h_prev", (n, hidden)),
        ("weight", (hidden, hidden)), ("bias", (hidden,)))}
    for act in ACTS:
        nh, saved = rnn_mod.rnn_cell(**meta, act=act)
        assert nh.shape == (n, hidden) and saved is nh
        grads = rnn_mod.rnn_cell_bwd(None, nh, meta["h_prev"],
                                     meta["weight"], act)
        assert [g.shape for g in grads] == [(n, hidden), (n, hidden)]
