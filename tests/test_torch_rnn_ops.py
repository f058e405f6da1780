"""The LSTM-PTB slice's ops, kernels' plain versions, Adam, Perplexity and
``BucketSentenceIter`` of the PyTorch port, held against the JAX package.

Inputs are made with numpy from a seed. Each op runs under ``jax.vjp`` on
XLA:CPU and under ``torch.autograd`` on CPU tensors, with random head
gradients on every output; the LSTM cell's plain versions run against the
reference's own ``LSTMCell`` graph (bound by the JAX executor with identity
``i2h``/``h2h`` weights and zero biases, so that the fully connected
layers pass the gate inputs through exactly); the plain ``adam_multi``
against ``Adam.jax_apply`` over ``_adam_update``.

Tolerances, float32 on both sides: rtol 1e-5 / atol 1e-6 for every op, the
cell and Adam (``exp``, ``tanh`` and ``sqrt`` of two libraries may differ
by an ulp); the perplexity to rtol 1e-6; the iterator's batches exactly.
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
from mxnet_tpu_torch.kernels import adam_multi as adam_mod
from mxnet_tpu_torch.kernels import lstm_cell as lstm_mod
from mxnet_tpu_torch.kernels import sgd_mom_multi as sgd_mod
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

TOL = dict(rtol=1e-5, atol=1e-6)


def _vjp_both(op_name, raw, inputs, n_wrt):
    """Outputs and the gradients of the first ``n_wrt`` inputs through both
    packages, for random head gradients on every output."""
    jop, pop = jreg.get(op_name), preg.get(op_name)
    jparams, pparams = jop.parse_params(raw), pop.parse_params(raw)
    rest = [jnp.asarray(x) for x in inputs[n_wrt:]]

    def jfn(*wrt):
        outs, _aux = jop.apply(list(wrt) + rest, jparams,
                               JOpMode(is_train=True))
        return tuple(outs)

    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in inputs[:n_wrt]])
    rng = np.random.default_rng(len(inputs))
    heads = [rng.standard_normal(o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(h) for h in heads)) if n_wrt else ()

    pins = [torch.from_numpy(np.array(x)) for x in inputs]
    for t in pins[:n_wrt]:
        t.requires_grad_(True)
    pouts, _aux = pop.apply(pins, pparams, POpMode(is_train=True))
    pgrads = torch.autograd.grad(
        pouts, pins[:n_wrt], grad_outputs=[torch.from_numpy(h)
                                           for h in heads]) if n_wrt else ()
    assert len(pouts) == len(jouts)
    for jo, po in zip(jouts, pouts):
        assert po.shape == jo.shape and po.dtype == getattr(torch, str(
            jo.dtype))
        np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo),
                                   **TOL)
    for jg, pg in zip(jgrads, pgrads):
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), **TOL)


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_mul_and_its_aliases_match_reference():
    _vjp_both("_mul", {}, [_randn(3, 4), _randn(3, 4, seed=1)], 2)
    for alias in ("elemwise_mul", "_Mul"):
        assert preg.get(alias) is preg.get("_mul")
    assert pmx.sym.elemwise_mul(pmx.sym.Variable("a"), pmx.sym.Variable(
        "b"), name="m").tojson() == jmx.sym.elemwise_mul(
        jmx.sym.Variable("a"), jmx.sym.Variable("b"), name="m").tojson()


SCALAR_OPS = ["_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_power_scalar",
              "_rpower_scalar", "_maximum_scalar", "_minimum_scalar",
              "_mod_scalar", "_rmod_scalar", "_hypot_scalar"]


@pytest.mark.parametrize("op_name", SCALAR_OPS)
def test_scalar_ops_match_reference(op_name):
    x = np.random.default_rng(2).uniform(0.5, 2.0, (4, 5)).astype(
        np.float32)
    _vjp_both(op_name, {"scalar": 1.5}, [x], 1)


@pytest.mark.parametrize("op_name", ["_equal_scalar", "_not_equal_scalar",
                                     "_greater_scalar",
                                     "_greater_equal_scalar",
                                     "_lesser_scalar", "_lesser_equal_scalar"])
def test_scalar_comparisons_match_reference(op_name):
    x = np.array([[0.5, 1.0, 1.5], [2.0, 1.0, -1.0]], np.float32)
    _vjp_both(op_name, {"scalar": 1.0}, [x], 0)


def test_forget_bias_symbol_matches_reference():
    """``sym + 1.0`` builds the reference's ``_plus_scalar`` node."""
    with pmx.NameManager():
        got = (pmx.sym.Variable("x") + 1.0).tojson()
    with jmx.name.NameManager():
        assert got == (jmx.sym.Variable("x") + 1.0).tojson()
    assert '"_plus_scalar"' in got


@pytest.mark.parametrize("shape, target, reverse", [
    ((2, 3, 4), (0, -1), False), ((2, 3, 4), (-1, 4), False),
    ((2, 3, 4), (-2,), False), ((2, 3, 4), (-3, 4), False),
    ((2, 3, 4), (0, -4, 1, 3, 4), False), ((6, 4), (-4, 2, -1, 0), False),
    ((2, 3, 4), (0, -1), True), ((32, 8, 200), (-1, 200), False),
    ((32, 8), (-1,), False)])
def test_reshape_special_codes_match_reference(shape, target, reverse):
    _vjp_both("Reshape", {"shape": target, "reverse": reverse},
              [_randn(*shape)], 1)


@pytest.mark.parametrize("raw, shape", [
    ({"num_outputs": 4}, (5, 8)),
    ({"num_outputs": 3, "axis": 1, "squeeze_axis": True}, (2, 3, 4)),
    ({"num_outputs": 2, "axis": 0}, (4, 3)),
    ({"num_outputs": 8, "axis": 1, "squeeze_axis": True}, (4, 8, 6))])
def test_slice_channel_matches_reference(raw, shape):
    _vjp_both("SliceChannel", raw, [_randn(*shape)], 1)


@pytest.mark.parametrize("dim", [0, 1])
def test_concat_matches_reference(dim):
    ins = [_randn(2, 3, 4, seed=s) for s in range(3)]
    _vjp_both("Concat", {"num_args": 3, "dim": dim}, ins, 3)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_expand_dims_matches_reference(axis):
    _vjp_both("expand_dims", {"axis": axis}, [_randn(3, 4)], 1)


def test_embedding_matches_reference():
    """A gather with a dense weight gradient; repeated ids sum, ids out of
    range clip to the ends."""
    data = np.array([[0, 3, 3, 9], [12, -2, 5, 3]], np.float32)
    weight = _randn(10, 6, seed=4)
    raw = {"input_dim": 10, "output_dim": 6}
    jop, pop = jreg.get("Embedding"), preg.get("Embedding")

    def jfn(w):
        return jop.apply([jnp.asarray(data), w], jop.parse_params(raw),
                         JOpMode(is_train=True))[0][0]

    jout, vjp = jax.vjp(jfn, jnp.asarray(weight))
    head = _randn(*jout.shape, seed=5)
    (jgrad,) = vjp(jnp.asarray(head))
    w = torch.from_numpy(weight.copy()).requires_grad_(True)
    (pout,), _ = pop.apply([torch.from_numpy(data), w],
                           pop.parse_params(raw), POpMode(is_train=True))
    (pgrad,) = torch.autograd.grad(pout, [w], torch.from_numpy(head))
    np.testing.assert_array_equal(pout.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad), **TOL)
    _args, outs, _aux = pmx.sym.Embedding(
        pmx.sym.Variable("d"), input_dim=10, output_dim=6,
        name="e").infer_shape(d=(2, 4))
    assert outs == [(2, 4, 6)]


# -- the LSTM cell ------------------------------------------------------------
def _cell_graph(pkg, hidden, forget_bias):
    """The package's own LSTMCell step over gate inputs ``x`` and ``h``
    (``(N, 4H)`` each; the step's fully connected layers get identity
    weights) and state ``c``: heads ``next_h`` and ``next_c``."""
    cell = pkg.rnn.LSTMCell(hidden, prefix="cell_", forget_bias=forget_bias)
    out, (next_h, next_c) = cell(pkg.sym.Variable("x"),
                                 [pkg.sym.Variable("h"),
                                  pkg.sym.Variable("c")])
    assert out is next_h
    return pkg.sym.Group([next_h, next_c])


def _cell_step(pkg, ctx, hidden, forget_bias, i2h, h2h, c, heads):
    """Outputs and the gradients of ``x``, ``h`` and ``c`` of one bound
    step of :func:`_cell_graph`."""
    n = i2h.shape[0]
    sym = _cell_graph(pkg, hidden, forget_bias)
    exe = sym.simple_bind(ctx, grad_req={"x": "write", "h": "write",
                                         "c": "write"},
                          x=(n, 4 * hidden), h=(n, 4 * hidden),
                          c=(n, hidden))
    eye = np.eye(4 * hidden, dtype=np.float32)
    zero = np.zeros(4 * hidden, np.float32)
    vals = {"x": i2h, "h": h2h, "c": c, "cell_i2h_weight": eye,
            "cell_h2h_weight": eye, "cell_i2h_bias": zero,
            "cell_h2h_bias": zero}
    for k, v in vals.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward([pkg.nd.array(h, ctx=ctx) for h in heads])
    return ([o.asnumpy() for o in exe.outputs],
            [exe.grad_dict[k].asnumpy() for k in ("x", "h", "c")], exe)


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
@pytest.mark.parametrize("last_step", [False, True])
def test_lstm_cell_plain_matches_reference_cell(forget_bias, last_step):
    """The plain ``lstm_cell``/``lstm_cell_bwd`` against the reference's
    ``LSTMCell`` graph, with and without the forget bias; ``last_step``:
    ``next_c`` has no consumer (the port's backward gets None)."""
    n, hidden = 5, 6
    i2h, h2h = _randn(n, 4 * hidden, seed=6) * 2, _randn(n, 4 * hidden,
                                                         seed=7) * 2
    c, dh, dc = (_randn(n, hidden, seed=s) for s in (8, 9, 10))
    if last_step:
        dc = np.zeros_like(dc)
    jouts, jgrads, _ = _cell_step(jmx, jmx.cpu(), hidden, forget_bias, i2h,
                                  h2h, c, [dh, dc])
    t = torch.from_numpy
    before = (lstm_mod.LAUNCHES.value, lstm_mod.BWD_LAUNCHES.value)
    next_h, next_c, act = lstm_mod.lstm_cell(t(i2h), t(h2h), t(c),
                                             forget_bias)
    dgates, dc_prev = lstm_mod.lstm_cell_bwd(
        t(dh), None if last_step else t(dc), act, t(c), next_c)
    assert (lstm_mod.LAUNCHES.value, lstm_mod.BWD_LAUNCHES.value) == before
    np.testing.assert_allclose(next_h.numpy(), jouts[0], **TOL)
    np.testing.assert_allclose(next_c.numpy(), jouts[1], **TOL)
    np.testing.assert_allclose(dgates.numpy(), jgrads[0], **TOL)
    np.testing.assert_allclose(dgates.numpy(), jgrads[1], **TOL)
    np.testing.assert_allclose(dc_prev.numpy(), jgrads[2], **TOL)
    # the port's own LSTMCell graph, routed through the same step
    pouts, pgrads, pexe = _cell_step(pmx, pmx.cpu(), hidden, forget_bias,
                                     i2h, h2h, c, [dh, dc])
    assert len(pexe.graph.lstm) == 1
    for got, want in zip(pouts + pgrads, jouts + jgrads):
        np.testing.assert_allclose(got, want, **TOL)


# -- Adam -----------------------------------------------------------------------
@pytest.mark.parametrize("wd, clip", [(0.0, None), (1e-3, 0.05),
                                      (0.1, None)])
def test_adam_multi_plain_matches_reference_jax_apply(wd, clip):
    """Three fused steps: the port's ``Adam.torch_apply`` (one plain
    ``adam_multi`` call over every parameter) against ``Adam.jax_apply``
    per parameter, with the float32 bias correction, wd and clip."""
    rng = np.random.default_rng(11)
    shapes = [(7, 5), (5,), (40,)]
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=0.01, wd=wd, clip_gradient=clip,
              rescale_grad=0.25)
    jopt, popt = jmx.optimizer.Adam(**kw), pmx.optimizer.Adam(**kw)
    jw = [jnp.asarray(w) for w in ws]
    jst = [(jnp.zeros(s, jnp.float32), jnp.zeros(s, jnp.float32))
           for s in shapes]
    pw = [torch.from_numpy(w.copy()) for w in ws]
    pst = [popt.create_state(i, pmx.nd.array(w, ctx=pmx.cpu()))
           for i, w in enumerate(ws)]
    wds = [wd, 0.0, wd]
    before = adam_mod.LAUNCHES.value
    for t in (1, 2, 3):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        for i in range(len(shapes)):
            jw[i], jst[i] = jopt.jax_apply(jw[i], jnp.asarray(gs[i]), jst[i],
                                           jnp.float32(0.01), wds[i],
                                           jnp.asarray(t, jnp.int32), None)
        popt.torch_apply(pw, [torch.from_numpy(g) for g in gs], pst,
                         [0.01] * 3, wds, [t] * 3)
    assert adam_mod.LAUNCHES.value == before  # the CPU takes plain versions
    for i in range(len(shapes)):
        np.testing.assert_allclose(pw[i].numpy(), np.asarray(jw[i]), **TOL)
        for k in range(2):
            np.testing.assert_allclose(pst[i][k].asnumpy(),
                                       np.asarray(jst[i][k]), **TOL)


def test_adam_multi_plain_guard_skips_a_non_finite_step():
    """Under the guard a NaN gradient leaves weights, means, variances and
    the restore pairs' targets as they were and counts [1, 1]; the next
    finite step updates and resets the consecutive count."""
    rng = np.random.default_rng(15)
    ws, ms, vs = ([torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)) for n in (5, 9)] for _ in range(3))
    vs = [v.abs() for v in vs]
    gs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          for n in (5, 9)]
    aux, snap = torch.ones(4), torch.zeros(4)
    guard = sgd_mod.Guard(torch.zeros(2, dtype=torch.int32), [(aux, snap)])
    before = [t.clone() for t in ws + ms + vs]
    gs[1][3] = float("nan")
    args = ([1e-3] * 2, [0.0] * 2, 0.9, 0.999, 1e-8, 1.0, -1.0)
    adam_mod.adam_multi(ws, gs, ms, vs, *args, guard=guard)
    assert guard.counters.tolist() == [1, 1] and torch.equal(aux, snap)
    for got, want in zip(ws + ms + vs, before):
        assert torch.equal(got, want)
    gs[1][3] = 0.0
    aux.fill_(2.0)
    adam_mod.adam_multi(ws, gs, ms, vs, *args, guard=guard)
    assert guard.counters.tolist() == [1, 0] and bool((aux == 2).all())
    assert not torch.equal(ws[1], before[1])


def test_adam_update_op_and_imperative_path_match_reference():
    """``nd.adam_update`` writes the weight and both states, and
    ``Adam.update`` (the per-parameter path, bias correction in double)
    tracks the reference's over three steps."""
    rng = np.random.default_rng(12)
    w0 = rng.standard_normal((6, 4)).astype(np.float32)
    out = {}
    for pkg in (jmx, pmx):
        kw = {"ctx": pmx.cpu()} if pkg is pmx else {}
        opt = pkg.optimizer.Adam(learning_rate=0.02, wd=1e-3,
                                 clip_gradient=0.3)
        w = pkg.nd.array(w0, **kw)
        state = opt.create_state(0, w)
        grng = np.random.default_rng(13)
        for _ in range(3):
            opt.update(0, w, pkg.nd.array(grng.standard_normal(
                (6, 4)).astype(np.float32), **kw), state)
        out[pkg] = [w.asnumpy(), state[0].asnumpy(), state[1].asnumpy()]
    for got, want in zip(out[pmx], out[jmx]):
        np.testing.assert_allclose(got, want, **TOL)


# -- Perplexity ---------------------------------------------------------------
@pytest.mark.parametrize("ignore_label", [0, None])
def test_perplexity_matches_reference(ignore_label):
    rng = np.random.default_rng(14)
    batches = []
    for n in (3, 5):
        logits = rng.standard_normal((n * 4, 9)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        label = rng.integers(0, 9, (n, 4)).astype(np.float32)
        label[0, :2] = 0
        batches.append((label, probs.astype(np.float32)))
    values = {}
    for pkg in (jmx, pmx):
        kw = {"ctx": pmx.cpu()} if pkg is pmx else {}
        for path in ("update", "device_update"):
            m = pkg.metric.Perplexity(ignore_label)
            for label, probs in batches:
                getattr(m, path)([pkg.nd.array(label, **kw)],
                                 [pkg.nd.array(probs, **kw)])
            values[pkg.__name__, path] = m.get()
    want = values["mxnet_tpu", "update"]
    for key, (name, value) in values.items():
        assert name == "Perplexity"
        np.testing.assert_allclose(value, want[1], rtol=1e-6, err_msg=key)
    assert isinstance(pmx.metric.create("perplexity", ignore_label=0),
                      pmx.metric.Perplexity)


# -- BucketSentenceIter -------------------------------------------------------
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_bucket_sentence_iter_matches_reference_batch_for_batch(layout):
    rng = np.random.RandomState(15)
    sents = [list(rng.randint(1, 30, rng.choice([3, 4, 7, 8, 12])))
             for _ in range(90)]
    kw = dict(batch_size=4, buckets=[4, 8], invalid_label=0, seed=3,
              layout=layout)
    jit = jmx.rnn.BucketSentenceIter(sents, **kw)
    pit = pmx.rnn.BucketSentenceIter(sents, ctx=pmx.cpu(), **kw)
    assert pit.default_bucket_key == jit.default_bucket_key == 8
    assert [tuple(d) for d in pit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for _epoch in range(2):
        jb, pb = list(jit), list(pit)
        assert len(pb) == len(jb) > 5
        for j, p in zip(jb, pb):
            assert p.bucket_key == j.bucket_key
            assert p.provide_data[0].shape == j.provide_data[0].shape
            np.testing.assert_array_equal(p.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(p.label[0].asnumpy(),
                                          j.label[0].asnumpy())
            assert p.data[0].context == pmx.cpu()
        jit.reset()
        pit.reset()
    enc_p = pmx.rnn.encode_sentences([["a", "b"], ["b", "c"]],
                                     invalid_label=0, start_label=1)
    enc_j = jmx.rnn.encode_sentences([["a", "b"], ["b", "c"]],
                                     invalid_label=0, start_label=1)
    assert enc_p == enc_j


@pytest.mark.parametrize("cell", ["dropout", "zoneout"])
def test_dropout_and_zoneout_cells_unroll_and_match_reference(cell):
    """DropoutCell and ZoneoutCell build now that ``Dropout``,
    ``ones_like``, ``zeros_like`` and ``where`` are ported. Unrolled at
    inference, where no bit is drawn (so each is its LSTM stack), they give
    the reference's outputs; a training forward and backward gives finite
    input gradients in both packages, whose masks differ. Their training
    forms are held to the reference, fed the port's masks, in
    ``tests/test_torch_dropout.py``."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 3, 5)).astype(np.float32)
    head = rng.standard_normal((2, 3, 4)).astype(np.float32)
    shapes = {"l0_i2h_weight": (16, 5), "l0_h2h_weight": (16, 4),
              "l0_i2h_bias": (16,), "l0_h2h_bias": (16,)}
    if cell == "dropout":
        shapes.update({"l1_i2h_weight": (16, 4), "l1_h2h_weight": (16, 4),
                       "l1_i2h_bias": (16,), "l1_h2h_bias": (16,)})
    weights = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
               for k, s in shapes.items()}
    got = []
    for pkg, ctx in ((jmx, jmx.cpu()), (pmx, pmx.cpu())):
        stack = pkg.rnn.SequentialRNNCell()
        if cell == "dropout":
            stack.add(pkg.rnn.LSTMCell(4, prefix="l0_"))
            stack.add(pkg.rnn.DropoutCell(0.5, prefix="d0_"))
            stack.add(pkg.rnn.LSTMCell(4, prefix="l1_"))
        else:
            stack.add(pkg.rnn.ZoneoutCell(pkg.rnn.LSTMCell(4, prefix="l0_"),
                                          zoneout_outputs=0.5,
                                          zoneout_states=0.3))
        outs, _ = stack.unroll(3, inputs=pkg.sym.Variable("data"),
                               merge_outputs=True)
        states = {n: (2, 4) for n in outs.list_arguments()
                  if "begin_state" in n}
        exe = outs.simple_bind(ctx, grad_req={"data": "write"},
                               data=x.shape, **states)
        exe.copy_params_from({k: pkg.nd.array(v, ctx=ctx)
                              for k, v in weights.items()},
                             allow_extra_params=True)
        exe.forward(is_train=False, data=x)
        out = exe.outputs[0].asnumpy()
        exe.forward(is_train=True, data=x)
        exe.backward([pkg.nd.array(head, ctx=ctx)])
        got.append((out, exe.grad_dict["data"].asnumpy()))
    (jo, jg), (po, pg) = got
    np.testing.assert_allclose(po, jo, **TOL)
    assert np.isfinite(pg).all() and np.isfinite(jg).all()


def test_gru_cell_unrolls_and_matches_reference():
    """With ``elemwise_sub`` ported, an unrolled GRUCell (op by op, no
    kernel yet) gives the reference's outputs and input gradients."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 3, 5)).astype(np.float32)
    head = rng.standard_normal((2, 3, 4)).astype(np.float32)
    weights = {"g_i2h_weight": (12, 5), "g_h2h_weight": (12, 4),
               "g_i2h_bias": (12,), "g_h2h_bias": (12,)}
    weights = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
               for k, s in weights.items()}
    got = []
    for pkg, ctx in ((jmx, jmx.cpu()), (pmx, pmx.cpu())):
        cell = pkg.rnn.GRUCell(4, prefix="g_")
        outs, _ = cell.unroll(3, inputs=pkg.sym.Variable("data"),
                              merge_outputs=True)
        exe = outs.simple_bind(ctx, grad_req={"data": "write"},
                               data=x.shape, g_begin_state_0=(2, 4))
        exe.copy_params_from({k: pkg.nd.array(v, ctx=ctx)
                              for k, v in weights.items()},
                             allow_extra_params=True)
        exe.forward(is_train=True, data=x)
        exe.backward([pkg.nd.array(head, ctx=ctx)])
        got.append((exe.outputs[0].asnumpy(),
                    exe.grad_dict["data"].asnumpy()))
    (jo, jg), (po, pg) = got
    np.testing.assert_allclose(po, jo, **TOL)
    np.testing.assert_allclose(pg, jg, **TOL)
