"""The GRU slice of the PyTorch port held against the JAX package:
RMSProp (plain and centred), the GRU cell kernels' plain versions, the
executor's GRU route, a bucketed GRU language model trained by
``BucketingModule.fit``, and RMSProp's states carried across.

Inputs are made with numpy from a seed. ``rmsprop_update`` and
``rmspropalex_update`` run in both packages' ``mx.nd``; the port's
``RMSProp.torch_apply`` (one plain ``rmsprop_multi`` call over every
parameter) runs against ``RMSProp.jax_apply`` per parameter over three
steps; the plain ``gru_cell``/``gru_cell_bwd`` (through ``GRUCellFn``) run
against the reference's own ``GRUCell`` graph under the JAX executor, with
an identity ``i2h`` weight and zero biases (so the input projection passes
the gate inputs through exactly) and a random ``h2h`` weight. The language
model is ``chip_smoke.gru_lm_sym_gen`` (the card's model, here at
vocabulary 50, hidden and embedding 16, 2 layers, buckets 4 and 8, batch
4), trained three steps by centred RMSProp with wd in both packages from
the same parameters over the same ``BucketSentenceIter`` batches. The
reference updates there through its per-parameter ``rmspropalex_update``
(``MXNET_EXEC_BULK_EXEC_TRAIN=0``), whose arithmetic ``jax_apply`` shares
(held above): compiling its fused step for each bucket would cost more
time than both files may take on one core.

Tolerances, float32 on both sides: rtol 1e-5 / atol 1e-6 for the ops, a
fused step and the cell (``exp``, ``tanh`` and ``sqrt`` of two libraries
may differ by an ulp); per-step perplexity rtol 1e-5; parameters and
RMSProp states after three steps rtol 1e-4 / atol 1e-6 (RMSProp divides
each gradient by its own magnitude, so an ulp of difference in a small
gradient moves its first update by up to ~1e-6 relative); states read
back from a ``.states`` file exactly.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.executor import _Graph
from mxnet_tpu_torch.kernels import gru_cell as gru_mod
from mxnet_tpu_torch.kernels import rmsprop_multi as rms_mod
from mxnet_tpu_torch.kernels import sgd_mom_multi as sgd_mod

TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-4, atol=1e-6)
VOCAB, HIDDEN, BATCH, BUCKETS = 50, 16, 4, [4, 8]
FIT_OPT = {"learning_rate": 0.01, "centered": True, "wd": 1e-4}


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    return _chip_smoke()


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    # the JAX fit loop stages batches on a thread by default
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")


def _randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


# -- RMSProp ------------------------------------------------------------------
RMS_CASES = [(False, 0.0, -1.0, -1.0), (False, 1e-2, 0.05, 0.3),
             (True, 0.0, -1.0, -1.0), (True, 1e-2, 0.05, 0.3)]


@pytest.mark.parametrize("centered, wd, clip, clip_w", RMS_CASES)
def test_rmsprop_update_ops_match_reference(centered, wd, clip, clip_w):
    """``nd.rmsprop_update``/``nd.rmspropalex_update`` with ``out=weight``
    write the weight and every state as the reference's ops do, the op
    defaults (gamma1 0.95) included."""
    shape = (6, 7)
    w, g = _randn(*shape, seed=1), _randn(*shape, seed=2)
    n = np.abs(_randn(*shape, seed=3, scale=0.1))
    states = [n] + ([_randn(*shape, seed=4, scale=0.01),
                     _randn(*shape, seed=5, scale=0.01)] if centered else [])
    if centered:
        states[0] = states[0] + states[1] ** 2
    kw = dict(lr=0.01, wd=wd, rescale_grad=0.5, clip_gradient=clip,
              clip_weights=clip_w)
    op = "rmspropalex_update" if centered else "rmsprop_update"
    got = []
    for pkg, extra in ((jmx, {}), (pmx, {"ctx": pmx.cpu()})):
        arrays = [pkg.nd.array(a, **extra) for a in [w, g] + states]
        getattr(pkg.nd, op)(*arrays, out=arrays[0], **kw)
        got.append([a.asnumpy() for a in arrays[:1] + arrays[2:]])
    for p, j in zip(*reversed(got)):
        np.testing.assert_allclose(p, j, **TOL)


@pytest.mark.parametrize("centered, wd, clip, clip_w", RMS_CASES)
def test_rmsprop_torch_apply_matches_reference_jax_apply(centered, wd, clip,
                                                          clip_w):
    """Three fused steps: ``RMSProp.torch_apply`` (one plain
    ``rmsprop_multi`` call) against ``RMSProp.jax_apply`` per parameter."""
    rng = np.random.default_rng(11)
    shapes = [(7, 5), (5,), (40,)]
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=0.01, wd=wd, rescale_grad=0.25, gamma2=0.8,
              clip_gradient=clip if clip >= 0 else None, centered=centered,
              clip_weights=clip_w if clip_w > 0 else None)
    jopt, popt = jmx.optimizer.RMSProp(**kw), pmx.optimizer.RMSProp(**kw)
    jw = [jnp.asarray(w) for w in ws]
    jst = [tuple(jnp.zeros(s, jnp.float32)
                 for _ in range(3 if centered else 1)) for s in shapes]
    pw = [torch.from_numpy(w.copy()) for w in ws]
    pst = [popt.create_state(i, pmx.nd.array(w, ctx=pmx.cpu()))
           for i, w in enumerate(ws)]
    wds = [wd, 0.0, wd]
    before = rms_mod.LAUNCHES.value
    for t in (1, 2, 3):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        for i in range(len(shapes)):
            jw[i], jst[i] = jopt.jax_apply(jw[i], jnp.asarray(gs[i]), jst[i],
                                           jnp.float32(0.01), wds[i], t, None)
        popt.torch_apply(pw, [torch.from_numpy(g) for g in gs], pst,
                         [0.01] * 3, wds, [t] * 3)
        for i in range(len(shapes)):
            np.testing.assert_allclose(pw[i].numpy(), np.asarray(jw[i]),
                                       **TOL)
            for got, want in zip(pst[i], jst[i]):
                np.testing.assert_allclose(got.asnumpy(), np.asarray(want),
                                           **TOL)
    assert rms_mod.LAUNCHES.value == before  # the CPU takes plain versions


@pytest.mark.parametrize("centered", [False, True])
def test_rmsprop_guard_skips_a_non_finite_step(centered):
    """Under the guard a NaN gradient leaves weights, every state and the
    restore pairs' targets as they were and counts [1, 1]; the next finite
    step updates and resets the consecutive count."""
    rng = np.random.default_rng(15)

    def tensors(scale=1.0):
        return [torch.from_numpy((scale * rng.standard_normal(n)).astype(
            np.float32)) for n in (5, 9)]

    ws, gs, ns = tensors(), tensors(), [t.abs() for t in tensors()]
    gms, dls = (tensors(0.01), tensors(0.01)) if centered else (None, None)
    if centered:
        ns = [n + g * g for n, g in zip(ns, gms)]
    aux, snap = torch.ones(4), torch.zeros(4)
    guard = sgd_mod.Guard(torch.zeros(2, dtype=torch.int32), [(aux, snap)])
    states = ws + ns + (gms + dls if centered else [])
    before = [t.clone() for t in states]
    gs[1][3] = float("nan")
    args = ([1e-3] * 2, [0.0] * 2, 0.9, 1e-8, 1.0, -1.0, -1.0, gms, dls)
    rms_mod.rmsprop_multi(ws, gs, ns, *args, guard=guard)
    assert guard.counters.tolist() == [1, 1] and torch.equal(aux, snap)
    for got, want in zip(states, before):
        assert torch.equal(got, want)
    gs[1][3] = 0.0
    aux.fill_(2.0)
    rms_mod.rmsprop_multi(ws, gs, ns, *args, guard=guard)
    assert guard.counters.tolist() == [1, 0] and bool((aux == 2).all())
    assert not torch.equal(ws[1], before[1])


def test_rmsprop_is_created_by_name_with_the_reference_defaults():
    for pkg in (jmx, pmx):
        ctx = {"ctx": pmx.cpu()} if pkg is pmx else {}
        for centered in (False, True):
            opt = pkg.optimizer.create("rmsprop", centered=centered)
            assert type(opt).__name__ == "RMSProp"
            assert (opt.lr, opt.gamma1, opt.gamma2, opt.epsilon,
                    opt.clip_weights) == (0.001, 0.9, 0.9, 1e-8, None)
            st = opt.create_state(0, pkg.nd.zeros((3, 2), **ctx))
            assert len(st) == (3 if centered else 1)
            assert all(s.shape == (3, 2) for s in st)


# -- the GRU cell -------------------------------------------------------------
def _cell_step(pkg, ctx, hidden, x, h, w_h2h, head):
    """Output and the gradients of ``x`` (the gate inputs, through an
    identity i2h) and ``h`` of one bound step of the package's own
    ``GRUCell``; and the executor."""
    cell = pkg.rnn.GRUCell(hidden, prefix="cell_")
    out, _states = cell(pkg.sym.Variable("x"), [pkg.sym.Variable("h")])
    n = x.shape[0]
    exe = out.simple_bind(ctx, grad_req={"x": "write", "h": "write"},
                          x=(n, 3 * hidden), h=(n, hidden))
    vals = {"x": x, "h": h, "cell_i2h_weight": np.eye(3 * hidden,
                                                      dtype=np.float32),
            "cell_h2h_weight": w_h2h,
            "cell_i2h_bias": np.zeros(3 * hidden, np.float32),
            "cell_h2h_bias": np.zeros(3 * hidden, np.float32)}
    for k, v in vals.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward([pkg.nd.array(head, ctx=ctx)])
    return ([exe.outputs[0].asnumpy()]
            + [exe.grad_dict[k].asnumpy() for k in ("x", "h")], exe)


@pytest.mark.parametrize("h_zero", [False, True])
def test_gru_cell_plain_matches_reference_cell(h_zero):
    """The plain ``gru_cell``/``gru_cell_bwd`` (through ``GRUCellFn``, the
    h2h product inside the step) against the reference's ``GRUCell``
    graph, from a zero and a random previous state; and the port's own
    GRUCell graph, routed through the same step."""
    n, hidden = 5, 6
    x = _randn(n, 3 * hidden, seed=6, scale=2.0)
    h = np.zeros((n, hidden), np.float32) if h_zero else _randn(n, hidden,
                                                                seed=7)
    w = _randn(3 * hidden, hidden, seed=8, scale=0.5)
    head = _randn(n, hidden, seed=9)
    want, _ = _cell_step(jmx, jmx.cpu(), hidden, x, h, w, head)
    before = (gru_mod.LAUNCHES.value, gru_mod.BWD_LAUNCHES.value)
    tx, th, tw = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (x, h, w))
    next_h = gru_mod.GRUCellFn.apply(tx, th, tw, torch.zeros(3 * hidden))
    next_h.backward(torch.from_numpy(head))
    got = [next_h.detach().numpy(), tx.grad.numpy(), th.grad.numpy()]
    assert (gru_mod.LAUNCHES.value, gru_mod.BWD_LAUNCHES.value) == before
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g, wv, **TOL)
    # the plain pair directly: next_h, the saved planes, di2h and the
    # whole dh_prev
    t = torch.from_numpy
    nh, saved = gru_mod.gru_cell(t(x), t(h), t(w))
    di2h, _dh2h, dh_prev = gru_mod.gru_cell_bwd(t(head), saved, t(h), t(w))
    np.testing.assert_allclose(nh.numpy(), want[0], **TOL)
    np.testing.assert_allclose(di2h.numpy(), want[1], **TOL)
    np.testing.assert_allclose(dh_prev.numpy(), want[2], **TOL)
    pgot, pexe = _cell_step(pmx, pmx.cpu(), hidden, x, h, w, head)
    assert len(pexe.graph.gru) == 1
    for g, wv in zip(pgot, want):
        np.testing.assert_allclose(g, wv, **TOL)


def _stack(pkg, layers=2):
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(pkg.rnn.GRUCell(HIDDEN, prefix=f"gru_l{i}_"))
    return stack


def test_gru_route_fires_per_cell_step_and_not_when_an_intermediate_escapes():
    for seq_len in (1, 3):
        out, _ = _stack(pmx).unroll(seq_len, inputs=pmx.sym.Variable("data"),
                                    merge_outputs=True)
        assert len(_Graph(out).gru) == 2 * seq_len
    out, _ = _stack(pmx).unroll(3, inputs=pmx.sym.Variable("data"),
                                merge_outputs=True)
    internals = out.get_internals()
    # a gate, the tanh candidate or a slice another head reads keeps its
    # step op by op
    for name in ("gru_l0_t0_r_act_output", "gru_l1_t1_h_act_output",
                 "gru_l0_t2_i2h_slice_output1"):
        graph = _Graph(pmx.sym.Group([out, internals[name]]))
        assert len(graph.gru) == 5, name
    # an LSTM graph has no GRU step, and a GRU graph no LSTM step
    assert not _Graph(out).lstm


def test_routed_and_op_by_op_steps_agree():
    """The same training step of a 2-layer stack with every cell fused and
    with one cell's reset gate exposed (that cell then runs op by op)."""
    out, _ = _stack(pmx).unroll(3, inputs=pmx.sym.Variable("data"),
                                merge_outputs=True)
    exposed = pmx.sym.Group([out, out.get_internals()[
        "gru_l1_t2_r_act_output"]])
    rng = np.random.default_rng(4)
    shapes = {"data": (BATCH, 3, 5), "gru_l0_begin_state_0": (BATCH, HIDDEN),
              "gru_l1_begin_state_0": (BATCH, HIDDEN)}
    results = []
    for sym in (out, exposed):
        exe = sym.simple_bind(pmx.cpu(), grad_req="write", **shapes)
        for k in sorted(exe.arg_dict):
            exe.arg_dict[k][:] = np.random.default_rng(len(k)).uniform(
                -0.5, 0.5, exe.arg_dict[k].shape).astype(np.float32)
        exe.forward(is_train=True)
        head = rng.standard_normal(exe.outputs[0].shape).astype(np.float32)
        rng = np.random.default_rng(4)
        heads = [pmx.nd.array(head, ctx=pmx.cpu())]
        if sym is exposed:
            heads.append(pmx.nd.zeros(exe.outputs[1].shape, ctx=pmx.cpu()))
        exe.backward(heads)
        results.append([exe.outputs[0].asnumpy()] + [
            exe.grad_dict[k].asnumpy() for k in sorted(exe.grad_dict)])
    assert len(_Graph(exposed).gru) == 5
    for got, want in zip(results[1], results[0]):
        np.testing.assert_allclose(got, want, **TOL)


# -- the GRU language model ---------------------------------------------------
def _sentences():
    """Eight sentences for bucket 4 and four for bucket 8: three batches."""
    rng = np.random.RandomState(0)
    lengths = [3, 4, 2, 4, 4, 3, 4, 4, 7, 8, 6, 8]
    return [[int(v) for v in rng.randint(1, VOCAB, n)] for n in lengths]


def _sym_gen(cs, pkg):
    return cs.gru_lm_sym_gen(pkg, num_hidden=HIDDEN, num_layers=2,
                             num_embed=HIDDEN, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def params(cs):
    sym_gen, states = _sym_gen(cs, jmx)
    sym = sym_gen(8)[0]
    shapes = {"data": (BATCH, 8), "softmax_label": (BATCH, 8)}
    shapes.update({n: (BATCH, HIDDEN) for n in states})
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.default_rng(1)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _fit(cs, pkg, args):
    """Three steps of BucketingModule.fit with centred RMSProp; per step
    (bucket, perplexity of the batch), and the module."""
    kw = {"ctx": pmx.cpu()} if pkg is pmx else {}
    it = pkg.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                    invalid_label=0, **kw)
    sym_gen, states = _sym_gen(cs, pkg)
    mod = pkg.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  state_names=states, context=pkg.cpu())
    steps = []

    def on_batch(param):
        batch = param.locals["data_batch"]
        m = pkg.metric.Perplexity(0)
        m.update(batch.label, mod.get_outputs())
        steps.append((batch.bucket_key, m.get()[1]))

    mod.fit(it, eval_metric=pkg.metric.Perplexity(0), optimizer="rmsprop",
            optimizer_params=FIT_OPT,
            arg_params={k: pkg.nd.array(v, **kw) for k, v in args.items()},
            num_epoch=1, batch_end_callback=on_batch)
    return steps, mod


def _reference_env(mp):
    # the JAX fit loop stages batches on a thread by default; the
    # per-parameter update path compiles no fused step
    mp.setenv("MXNET_DEVICE_PREFETCH", "0")
    mp.setenv("MXNET_EXEC_BULK_EXEC_TRAIN", "0")


@pytest.fixture(scope="module")
def jax_fit(cs, params):
    """The reference's three steps (per-step readings, module)."""
    mp = pytest.MonkeyPatch()
    _reference_env(mp)
    try:
        return _fit(cs, jmx, params)
    finally:
        mp.undo()


def _state(mod):
    arg, _aux = mod.get_params()
    module = mod._curr_module if hasattr(mod, "_curr_module") else mod
    idx = dict(enumerate(module._exec_group.param_names))
    out = {k: v.asnumpy() for k, v in arg.items()}
    for i, st in module._updater.states.items():
        for kind, a in zip(("n", "g", "delta"), st):
            out[f"{idx[i]}/{kind}"] = np.asarray(a.asnumpy())
    return out


def test_bucketing_fit_tracks_reference_step_by_step(cs, params, jax_fit):
    jsteps, jmod = jax_fit
    before = (gru_mod.LAUNCHES.value, rms_mod.LAUNCHES.value)
    psteps, pmod = _fit(cs, pmx, params)
    assert (gru_mod.LAUNCHES.value, rms_mod.LAUNCHES.value) == before
    assert [b for b, _ in psteps] == [b for b, _ in jsteps]
    assert sorted(b for b, _ in psteps) == [4, 4, 8]
    np.testing.assert_allclose([v for _, v in psteps],
                               [v for _, v in jsteps], rtol=1e-5)
    got, want = _state(pmod), _state(jmod)
    assert got.keys() == want.keys() and len(got) == 44
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT_TOL)
    for key, bucket in pmod._buckets.items():
        assert len(bucket._exec_group._exec.graph.gru) == 2 * key


def test_rmsprop_states_carry_across_packages(cs, params, jax_fit,
                                              tmp_path, monkeypatch):
    """A ``.states`` file the reference's ``Module.save_optimizer_states``
    wrote after centred RMSProp steps loads into the port's
    ``Module.load_optimizer_states`` with the parameters carried by
    ``convert.params_from_numpy``; the next step then matches the
    reference's."""
    _steps, jmod = jax_fit
    jbucket = jmod._buckets[8]
    path = str(tmp_path / "gru.states")
    jbucket.save_optimizer_states(path)
    jarg, _jaux = jmod.get_params()
    sym_gen, states = _sym_gen(cs, pmx)
    mod = pmx.mod.Module(sym_gen(8)[0], state_names=states,
                         context=pmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 8))],
             label_shapes=[("softmax_label", (BATCH, 8))])
    arg, aux = pmx.convert.params_from_numpy(
        {k: v.asnumpy() for k, v in jarg.items()}, {}, pmx.cpu())
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="rmsprop", optimizer_params=FIT_OPT)
    with pmx.cpu():
        mod.load_optimizer_states(path)
    want = {i: [a.asnumpy() for a in st]
            for i, st in jbucket._updater.states.items()}
    assert set(mod._updater.states) == set(want)
    for i, st in mod._updater.states.items():
        assert len(st) == 3
        for a, b in zip(st, want[i]):
            assert a.context == pmx.cpu()
            np.testing.assert_array_equal(a.asnumpy(), b)
    data = np.random.default_rng(5).integers(1, VOCAB, (BATCH, 9))
    x, y = data[:, :8].astype(np.float32), data[:, 1:].astype(np.float32)
    _reference_env(monkeypatch)
    jbucket.forward_backward(jmx.io.DataBatch([jmx.nd.array(x)],
                                              [jmx.nd.array(y)]))
    jbucket.update()
    monkeypatch.delenv("MXNET_EXEC_BULK_EXEC_TRAIN")
    mod.forward_backward(pmx.io.DataBatch([pmx.nd.array(x, ctx=pmx.cpu())],
                                          [pmx.nd.array(y, ctx=pmx.cpu())]))
    mod.update()
    got, want = _state(mod), _state(jbucket)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT_TOL)


def _zero_update_gate(dnext_h, saved, h_prev, weight):
    di2h, dh2h, _dh_prev = _GOOD_BWD(dnext_h, saved, h_prev, weight)
    hidden = h_prev.shape[1]
    di2h, dh2h = di2h.clone(), dh2h.clone()
    di2h[:, hidden:2 * hidden] = 0
    dh2h[:, hidden:2 * hidden] = 0
    direct = 0 if dnext_h is None else saved[1] * dnext_h
    return di2h, dh2h, direct + dh2h @ weight


def _drop_direct_dh(dnext_h, saved, h_prev, weight):
    di2h, dh2h, _dh_prev = _GOOD_BWD(dnext_h, saved, h_prev, weight)
    return di2h, dh2h, dh2h @ weight


def _plain_tanh_grad(ct, t):  # ct * (1 - t): the a * t term dropped
    return ct * (1.0 - t)


_GOOD_BWD = gru_mod.gru_cell_bwd_plain


@pytest.mark.parametrize("fault", ["update_gate", "direct_dh", "tanh_grad"])
def test_chip_smoke_gru_parity_limits_see_a_faulty_cell_backward(
        cs, fault, monkeypatch):
    """``chip_smoke.py``'s GRU parity (its own ``gru_numpy``,
    ``lm_parity_side``, ``lm_parity_step`` and ``parity_diff``, at a
    narrow width on the CPU) holds a correct RMSProp step against one
    whose cell backward is faulty: every fault must move the RMSProp
    state ``n`` beyond ``GRU_PARITY_TOL``."""
    monkeypatch.setattr(cs, "LSTM", {"num_hidden": 24, "num_layers": 2,
                                     "num_embed": 24, "vocab_size": 300})
    monkeypatch.setattr(cs, "LSTM_BATCH", 8)
    with pmx.cpu():
        sym, states, args = cs.gru_numpy(pmx, 3)
        (x, y), _second = cs.lstm_parity_batches(4)

        def step():
            mod = cs.lm_parity_side(pmx, sym, states, args, pmx.cpu(),
                                    "rmsprop", cs.GRU_OPT)
            return cs.lm_parity_step(torch, pmx, mod, x, y, ("n",))

        good = step()
        if fault == "tanh_grad":
            monkeypatch.setattr(gru_mod, "_tanh_grad", _plain_tanh_grad)
        else:
            monkeypatch.setattr(gru_mod, "gru_cell_bwd_plain", {
                "update_gate": _zero_update_gate,
                "direct_dh": _drop_direct_dh}[fault])
        bad = step()
    rel, worst, worst_rel = cs.parity_diff(bad["n"], good["n"])
    print(f"{fault}: RMSProp n {rel:.3g} in norm, worst {worst} "
          f"{worst_rel:.3g}")
    assert rel > 10 * cs.GRU_PARITY_TOL["n"]
    assert cs.parity_diff(bad["loss"], good["loss"])[0] == 0  # forward
