"""The fused GRU step of the PyTorch port — ``gru_cell``/``gru_cell_bwd``
with the recurrent product inside, and the executor's route that hands
them the h2h ``FullyConnected`` — held against the JAX package.

Inputs are made with numpy from a seed at N, H = 5, 6 and 7, 13. The
plain step (``GRUCellFn`` on CPU tensors: ``F.linear``, the gate chain and
its VJP) runs against the reference's own ``GRUCell`` graph under the JAX
executor, with an identity ``i2h`` weight and a zero i2h bias (so the
input projection passes the gate inputs through exactly) and a random
h2h weight and bias: ``next_h``, ``di2h``, the whole ``dh_prev``, ``dWh``
and ``dbh``, from a random and a zero state. A bias of None runs against
the same step written out with an h2h FC of ``no_bias=True``. The route:
2T fused steps on a 2-layer unroll, each with its h2h FC among the
members; op by op when the h2h output has another reader or the FC reads
another state than the ``_minus``; the same training step routed and op
by op. The card wrappers' refusals run on stand-ins that report a CUDA
device (``_OnCard``), which the wrapper checks before any launch.

Tolerance, float32 on both sides: rtol 1e-5 / atol 1e-6 (``TOL``), as for
the cell of ``tests/test_torch_gru_slice.py`` (``exp``, ``tanh`` and the
products' sums of two libraries may differ by an ulp); the routed and
op-by-op steps of a float64 graph with float32 parameters, rtol 1e-6 /
atol 1e-7 (the same plain functions, float32 products where the state is
float32).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _Graph
from mxnet_tpu_torch.kernels import gru_cell as gru_mod

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(5, 6), (7, 13)]
HIDDEN, BATCH = 16, 4


def _randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _step_inputs(n, hidden, h_zero=False):
    x = _randn(n, 3 * hidden, seed=n + 6, scale=2.0)
    h = (np.zeros((n, hidden), np.float32) if h_zero
         else _randn(n, hidden, seed=n + 7))
    w = _randn(3 * hidden, hidden, seed=n + 8, scale=0.5)
    b = _randn(3 * hidden, seed=n + 9, scale=0.5)
    head = _randn(n, hidden, seed=n + 10)
    return x, h, w, b, head


def _bind_step(pkg, ctx, sym, x, h, w, b, head):
    """One training forward and backward of a one-step GRU symbol over
    ``x`` (through an identity i2h FC) and state ``h``: the output and the
    gradients of ``x``, ``h``, the h2h weight and (given) bias; and the
    executor."""
    hidden = h.shape[1]
    args = sym.list_arguments()
    wname = next(a for a in args if a.endswith("h2h_weight"))
    bname = next((a for a in args if a.endswith("h2h_bias")), None)
    want = ["x", "h", wname] + ([bname] if bname else [])
    exe = sym.simple_bind(ctx, grad_req={a: "write" for a in want},
                          x=x.shape, h=h.shape)
    vals = {"x": x, "h": h, wname: w}
    if bname:
        vals[bname] = b
    for a in args:
        if a.endswith("i2h_weight"):
            vals[a] = np.eye(3 * hidden, dtype=np.float32)
        elif a.endswith("i2h_bias"):
            vals[a] = np.zeros(3 * hidden, np.float32)
    for k, v in vals.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward([pkg.nd.array(head, ctx=ctx)])
    return ([exe.outputs[0].asnumpy()]
            + [exe.grad_dict[k].asnumpy() for k in want], exe)


def _cell_sym(pkg, hidden):
    """One step of the package's own ``GRUCell`` over ``x`` and ``h``."""
    cell = pkg.rnn.GRUCell(hidden, prefix="cell_")
    out, _states = cell(pkg.sym.Variable("x"), [pkg.sym.Variable("h")])
    return out


def _written_sym(pkg, hidden, no_bias=False, h2h_data=None):
    """One step written out as ``GRUCell.__call__`` builds it, the h2h FC
    with or without a bias and over ``h2h_data`` (default the state
    ``h``)."""
    S = pkg.sym
    x, h = S.Variable("x"), S.Variable("h")
    i2h = S.FullyConnected(x, weight=S.Variable("i2h_weight"),
                           bias=S.Variable("i2h_bias"),
                           num_hidden=3 * hidden, name="i2h")
    extra = {"no_bias": True} if no_bias else {"bias": S.Variable("h2h_bias")}
    h2h = S.FullyConnected(h if h2h_data is None else h2h_data,
                           weight=S.Variable("h2h_weight"),
                           num_hidden=3 * hidden, name="h2h", **extra)
    i_r, i_z, i_o = S.SliceChannel(i2h, num_outputs=3, name="i2h_slice")
    h_r, h_z, h_o = S.SliceChannel(h2h, num_outputs=3, name="h2h_slice")
    r = S.Activation(i_r + h_r, act_type="sigmoid", name="r_act")
    z = S.Activation(i_z + h_z, act_type="sigmoid", name="z_act")
    o = S.Activation(i_o + r * h_o, act_type="tanh", name="h_act")
    return o + z * (h - o)


def _fn_step(x, h, w, b, head):
    """``GRUCellFn`` on CPU tensors (the plain versions): the output and
    the gradients of the gate inputs, the state, the weight and the bias
    (when given)."""
    t = [torch.from_numpy(a.copy()).requires_grad_(True)
         for a in (x, h, w) + ((b,) if b is not None else ())]
    next_h = gru_mod.GRUCellFn.apply(*t[:3], t[3] if b is not None else None)
    next_h.backward(torch.from_numpy(head))
    return [next_h.detach().numpy()] + [a.grad.numpy() for a in t]


@pytest.mark.parametrize("n, hidden", SHAPES)
@pytest.mark.parametrize("h_zero", [False, True])
def test_fused_step_matches_reference_cell(n, hidden, h_zero):
    """The plain step against the reference's ``GRUCell`` graph: next_h,
    di2h, the whole dh_prev, dWh and dbh; the wrappers called directly;
    and the port's own GRUCell graph, routed through the same step."""
    x, h, w, b, head = _step_inputs(n, hidden, h_zero)
    want, _ = _bind_step(jmx, jmx.cpu(), _cell_sym(jmx, hidden), x, h, w, b,
                         head)
    before = (gru_mod.LAUNCHES.value, gru_mod.BWD_LAUNCHES.value)
    for got, wv, what in zip(_fn_step(x, h, w, b, head), want,
                             ("next_h", "di2h", "dh_prev", "dWh", "dbh")):
        np.testing.assert_allclose(got, wv, err_msg=what, **TOL)
    # the wrappers directly: next_h, the saved planes, di2h and the whole
    # dh_prev
    t = torch.from_numpy
    nh, saved = gru_mod.gru_cell(t(x), t(h), t(w), t(b))
    assert saved.shape == (4, n, hidden)
    np.testing.assert_allclose(saved[3].numpy(), (h @ w.T + b)[:, 2 * hidden:],
                               **TOL)
    di2h, dh2h, dh_prev = gru_mod.gru_cell_bwd(t(head), saved, t(h), t(w))
    for got, wv in ((nh, want[0]), (di2h, want[1]), (dh_prev, want[2]),
                    (dh2h.t() @ t(h), want[3]), (dh2h.sum(0), want[4])):
        np.testing.assert_allclose(got.numpy(), wv, **TOL)
    inf_h, none = gru_mod.gru_cell(t(x), t(h), t(w), t(b), save=False)
    assert none is None
    np.testing.assert_array_equal(inf_h.numpy(), nh.numpy())
    assert (gru_mod.LAUNCHES.value, gru_mod.BWD_LAUNCHES.value) == before
    pgot, pexe = _bind_step(pmx, pmx.cpu(), _cell_sym(pmx, hidden), x, h, w,
                            b, head)
    (step,) = pexe.graph.gru.values()
    assert any(m.name == "cell_t0_h2h" for m in step.members)
    for got, wv in zip(pgot, want):
        np.testing.assert_allclose(got, wv, **TOL)


@pytest.mark.parametrize("n, hidden", SHAPES)
def test_step_without_bias_matches_fc_with_no_bias(n, hidden):
    """A bias of None against the step written out with an h2h FC of
    ``no_bias=True`` in the reference; the port routes that graph too,
    with three inputs."""
    x, h, w, _b, head = _step_inputs(n, hidden)
    want, _ = _bind_step(jmx, jmx.cpu(), _written_sym(jmx, hidden, True), x,
                         h, w, None, head)
    assert len(want) == 4  # no bias gradient
    for got, wv in zip(_fn_step(x, h, w, None, head), want):
        np.testing.assert_allclose(got, wv, **TOL)
    pgot, pexe = _bind_step(pmx, pmx.cpu(), _written_sym(pmx, hidden, True),
                            x, h, w, None, head)
    (step,) = pexe.graph.gru.values()
    assert len(step.inputs) == 3
    for got, wv in zip(pgot, want):
        np.testing.assert_allclose(got, wv, **TOL)


def test_plain_step_on_the_zero_state_is_the_input_gates_alone():
    """From h_prev = 0 with no bias the product is 0: next_h = (1 - z) * o
    of the input gates alone, and dh_prev is the product's part only."""
    n, hidden = 7, 13
    x, _h, w, _b, head = _step_inputs(n, hidden)
    t = torch.from_numpy
    zero = torch.zeros(n, hidden)
    nh, saved = gru_mod.gru_cell(t(x), zero, t(w))
    xr, xz, xo = np.split(x.astype(np.float64), 3, axis=1)
    z, o = 1 / (1 + np.exp(-xz)), np.tanh(xo)
    np.testing.assert_allclose(nh.numpy(), (1 - z) * o, **TOL)
    assert not saved[3].any()
    _di2h, dh2h, dh_prev = gru_mod.gru_cell_bwd(t(head), saved, zero, t(w))
    np.testing.assert_allclose(dh_prev.numpy(), (dh2h @ t(w)).numpy()
                               + saved[1].numpy() * head, **TOL)


def _stack(pkg, layers=2):
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(pkg.rnn.GRUCell(HIDDEN, prefix=f"gru_l{i}_"))
    return stack


@pytest.mark.parametrize("seq_len", [1, 3])
def test_route_fires_2T_times_with_the_h2h_fc_among_its_members(seq_len):
    out, _ = _stack(pmx).unroll(seq_len, inputs=pmx.sym.Variable("data"),
                                merge_outputs=True)
    graph = _Graph(out)
    assert len(graph.gru) == 2 * seq_len
    for step in graph.gru.values():
        fcs = [m for m in step.members if m.op.name == "FullyConnected"]
        assert len(fcs) == 1 and fcs[0].name.endswith("_h2h")
        assert len(step.inputs) == 4  # i2h, h_prev, weight, bias
        assert step.inputs[1] == fcs[0].inputs[0]
        assert step.inputs[2:] == fcs[0].inputs[1:]


def test_route_runs_op_by_op_when_the_product_escapes_or_reads_another_state():
    out, _ = _stack(pmx).unroll(3, inputs=pmx.sym.Variable("data"),
                                merge_outputs=True)
    # the h2h product read by another head keeps its step op by op
    graph = _Graph(pmx.sym.Group([out, out.get_internals()[
        "gru_l1_t1_h2h_output"]]))
    assert len(graph.gru) == 5
    assert "gru_l1_t1_h2h" not in {m.name for st in graph.gru.values()
                                   for m in st.members}
    # an h2h FC over another state than the one the _minus reads
    other = _written_sym(pmx, 4, h2h_data=pmx.sym.Variable("h_other"))
    assert not _Graph(other).gru
    assert len(_Graph(_written_sym(pmx, 4)).gru) == 1


def _train_step(sym, shapes):
    exe = sym.simple_bind(pmx.cpu(), grad_req="write", **shapes)
    for k in sorted(exe.arg_dict):
        exe.arg_dict[k][:] = np.random.default_rng(len(k)).uniform(
            -0.5, 0.5, exe.arg_dict[k].shape).astype(np.float32)
    exe.forward(is_train=True)
    heads = [pmx.nd.array(np.random.default_rng(4).standard_normal(
        exe.outputs[0].shape).astype(np.float32), ctx=pmx.cpu())]
    heads += [pmx.nd.zeros(o.shape, ctx=pmx.cpu()) for o in exe.outputs[1:]]
    exe.backward(heads)
    return [exe.outputs[0].asnumpy()] + [exe.grad_dict[k].asnumpy()
                                         for k in sorted(exe.grad_dict)]


def test_routed_and_op_by_op_steps_agree_when_the_product_escapes():
    """The same training step of a 2-layer stack with every step fused and
    with one step's h2h product exposed (that step then runs op by op, the
    FC's backward by autograd)."""
    out, _ = _stack(pmx).unroll(3, inputs=pmx.sym.Variable("data"),
                                merge_outputs=True)
    exposed = pmx.sym.Group([out, out.get_internals()[
        "gru_l0_t2_h2h_output"]])
    assert len(_Graph(exposed).gru) == 5
    shapes = {"data": (BATCH, 3, 5), "gru_l0_begin_state_0": (BATCH, HIDDEN),
              "gru_l1_begin_state_0": (BATCH, HIDDEN)}
    fused, plain = _train_step(out, shapes), _train_step(exposed, shapes)
    assert len(fused) == len(plain) == 12  # output and 11 gradients
    for got, want in zip(plain, fused):
        np.testing.assert_allclose(got, want, **TOL)


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
             "h_prev row-strided", "weight transposed", "i2h float64"]


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
    elif case == "h_prev row-strided":
        args[name] = _on_card(np.concatenate([h, h], 1))[:, :hidden]
    elif case == "weight transposed":
        args[name] = _on_card(np.ascontiguousarray(w.T.reshape(
            hidden, 3 * hidden))).t()
    else:
        args[name] = _on_card(x.astype(np.float64))
    with pytest.raises(MXNetError, match=f"gru_cell: {name} must be a "
                       "contiguous float32"):
        gru_mod.gru_cell(**args)
    # the backward: the same refusal for its state and weight
    saved = _on_card(np.zeros((4, n, hidden), np.float32))
    if name in ("h_prev", "weight"):
        with pytest.raises(MXNetError, match=f"gru_cell_bwd: {name} must be "
                           "a contiguous float32"):
            gru_mod.gru_cell_bwd(_on_card(head), saved, args["h_prev"],
                                 args["weight"])


def test_card_wrapper_refuses_a_cpu_gradient():
    n, hidden = 5, 6
    x, h, w, _b, head = _step_inputs(n, hidden)
    saved = _on_card(np.zeros((4, n, hidden), np.float32))
    with pytest.raises(MXNetError, match="gru_cell_bwd: dnext_h must be"):
        gru_mod.gru_cell_bwd(torch.from_numpy(head), saved, _on_card(h),
                             _on_card(w))
    with pytest.raises(MXNetError, match="saved planes must be"):
        gru_mod.gru_cell_bwd(None, _on_card(np.zeros((n, 3 * hidden),
                                                     np.float32)),
                             _on_card(h), _on_card(w))


def test_plain_step_on_meta_gives_the_shapes():
    n, hidden = 5, 6
    meta = {k: torch.empty(s, device="meta") for k, s in (
        ("i2h", (n, 3 * hidden)), ("h_prev", (n, hidden)),
        ("weight", (3 * hidden, hidden)), ("bias", (3 * hidden,)))}
    nh, saved = gru_mod.gru_cell(**meta)
    assert nh.shape == (n, hidden) and saved.shape == (4, n, hidden)
    grads = gru_mod.gru_cell_bwd(None, saved, meta["h_prev"],
                                 meta["weight"])
    assert [g.shape for g in grads] == [(n, 3 * hidden), (n, 3 * hidden),
                                        (n, hidden)]


@pytest.mark.parametrize("state", ["float64", "float32"])
def test_route_casts_the_h2h_parameters_to_the_state_dtype(state):
    """Float64 gate inputs with float32 parameters, and a float64 or a
    float32 state (a float32 begin state in a float64 model): the FC casts
    its parameters to the state's dtype, and the routed step, forward and
    backward, matches the op-by-op graph."""
    n, hidden = 5, 6
    x, h, w, b, head = _step_inputs(n, hidden)
    outs = []
    routed = _written_sym(pmx, hidden)
    exposed = pmx.sym.Group([routed, routed.get_internals()["h2h_output"]])
    assert len(_Graph(routed).gru) == 1 and not _Graph(exposed).gru
    for sym in (routed, exposed):
        types = {"x": "float64", "h": state}
        types.update({k: "float32" for k in ("i2h_weight", "i2h_bias",
                                             "h2h_weight", "h2h_bias")})
        exe = sym.simple_bind(pmx.cpu(), grad_req="write", x=(n, 3 * hidden),
                              h=(n, hidden), type_dict=types)
        assert exe.arg_dict["h2h_weight"].dtype == np.float32
        for k, v in {"x": x, "h": h, "h2h_weight": w, "h2h_bias": b,
                     "i2h_weight": np.eye(3 * hidden, dtype=np.float32),
                     "i2h_bias": np.zeros(3 * hidden, np.float32)}.items():
            exe.arg_dict[k][:] = v
        exe.forward(is_train=True)
        heads = [pmx.nd.array(head, ctx=pmx.cpu(), dtype="float64")]
        heads += [pmx.nd.zeros(o.shape, ctx=pmx.cpu(), dtype=o.dtype)
                  for o in exe.outputs[1:]]
        exe.backward(heads)
        outs.append([exe.outputs[0].asnumpy()] + [
            exe.grad_dict[k].asnumpy() for k in sorted(exe.grad_dict)])
    assert outs[0][0].dtype == np.float64
    assert len(outs[0]) == 7
    for got, want in zip(outs[0], outs[1]):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
