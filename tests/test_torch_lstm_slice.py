"""The LSTM-PTB slice of the PyTorch port held against the JAX package.

A small bucketed LSTM language model (``lstm_lm_sym_gen``: vocabulary 50,
hidden and embedding 16, 2 layers, buckets 4 and 8, batch 4) is trained by
``BucketingModule.fit`` with Adam in both packages on the CPU, from the
same parameters made by numpy from a seed, over the same
``BucketSentenceIter`` batches: three steps, two in bucket 4 and one in
bucket 8. Per step the batch's perplexity, and at the end every parameter
and Adam state, are compared. Also: the executor's LSTM route fires for
every cell step of an unrolled graph and for none whose intermediates
another node reads, every bucket updates the same parameter and Adam-state
storage, the begin states bind at the batch size, the graph JSON and the
parameters carry across packages, checkpoints load in the reference, the
unported options raise, and ``chip_smoke.py``'s LSTM parity
limits see a faulty cell backward.

Tolerances, float32 on both sides: per-step perplexity rtol 1e-5;
parameters and Adam states after three steps rtol 1e-4 / atol 1e-6 (Adam
divides each gradient by its own magnitude, so an ulp of difference in a
small gradient moves its first update by up to ~1e-6 relative).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (the submodule, for jmx.models)

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _Graph
from mxnet_tpu_torch.kernels import adam_multi as adam_mod
from mxnet_tpu_torch.kernels import lstm_cell as lstm_mod

VOCAB, HIDDEN, BATCH, BUCKETS = 50, 16, 4, [4, 8]
FIT_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    # the JAX fit loop stages batches on a thread by default
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")


def _sentences():
    """Eight sentences for bucket 4 and four for bucket 8: three batches."""
    rng = np.random.RandomState(0)
    lengths = [3, 4, 2, 4, 4, 3, 4, 4, 7, 8, 6, 8]
    return [[int(v) for v in rng.randint(1, VOCAB, n)] for n in lengths]


def _sym_gen(pkg):
    return pkg.models.lstm_lm_sym_gen(num_hidden=HIDDEN, num_layers=2,
                                      num_embed=HIDDEN, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def params():
    sym_gen, states = _sym_gen(jmx)
    sym = sym_gen(8)[0]
    shapes = {"data": (BATCH, 8), "softmax_label": (BATCH, 8)}
    shapes.update({n: (BATCH, HIDDEN) for n in states})
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.default_rng(1)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _fit(pkg, args, ctx):
    """Three steps of BucketingModule.fit; per step (bucket, perplexity of
    the batch), and the module."""
    kw = {"ctx": ctx} if pkg is pmx else {}
    it = pkg.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                    invalid_label=0, **kw)
    sym_gen, states = _sym_gen(pkg)
    mod = pkg.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  state_names=states, context=ctx)
    steps = []

    def on_batch(param):
        batch = param.locals["data_batch"]
        m = pkg.metric.Perplexity(0)
        m.update(batch.label, mod.get_outputs())
        steps.append((batch.bucket_key, m.get()[1]))

    mod.fit(it, eval_metric=pkg.metric.Perplexity(0), optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            arg_params={k: pkg.nd.array(v, **kw) for k, v in args.items()},
            num_epoch=1, batch_end_callback=on_batch)
    return steps, mod


@pytest.fixture(scope="module")
def jax_fit(params):
    """The reference's three steps (per-step readings, module)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_DEVICE_PREFETCH", "0")
    try:
        return _fit(jmx, params, jmx.cpu())
    finally:
        mp.undo()


def _state(mod):
    arg, _aux = mod.get_params()
    updater = mod._curr_module._updater
    idx = dict(enumerate(mod._curr_module._exec_group.param_names))
    out = {k: v.asnumpy() for k, v in arg.items()}
    for i, (mean, var) in updater.states.items():
        out[f"{idx[i]}/mean"] = np.asarray(mean.asnumpy())
        out[f"{idx[i]}/var"] = np.asarray(var.asnumpy())
    return out


def test_bucketing_fit_tracks_reference_step_by_step(params, jax_fit):
    jsteps, jmod = jax_fit
    before = (lstm_mod.LAUNCHES.value, adam_mod.LAUNCHES.value)
    psteps, pmod = _fit(pmx, params, pmx.cpu())
    # the CPU takes the plain versions
    assert (lstm_mod.LAUNCHES.value, adam_mod.LAUNCHES.value) == before
    assert [b for b, _ in psteps] == [b for b, _ in jsteps]
    assert sorted(b for b, _ in psteps) == [4, 4, 8]
    np.testing.assert_allclose([v for _, v in psteps],
                               [v for _, v in jsteps], rtol=1e-5)
    got, want = _state(pmod), _state(jmod)
    assert got.keys() == want.keys() and len(got) == 33
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT_TOL)


def test_every_bucket_updates_the_same_storage(params):
    _steps, mod = _fit(pmx, params, pmx.cpu())
    default = mod._buckets[8]
    assert set(mod._buckets) == {4, 8}
    for key, bucket in mod._buckets.items():
        group, dgroup = bucket._exec_group, default._exec_group
        exe, dexe = group._exec, dgroup._exec
        for n in group.param_names:
            assert exe.arg_dict[n]._data.data_ptr() == \
                dexe.arg_dict[n]._data.data_ptr()
            assert exe.grad_dict[n] is dexe.grad_dict[n]
        assert bucket._updater is default._updater
        # the fused update's host table holds the one set of Adam states
        assert [id(s) for s in group._fused_host["states"]] == \
            [id(s) for s in dgroup._fused_host["states"]]
        assert [a._data.data_ptr() for st in group._fused_host["states"]
                for a in st] == [a._data.data_ptr() for st in
                                 default._updater.states.values() for a in st]
        assert len(exe.graph.lstm) == 2 * key
        # the begin states bind at the batch size
        assert [s.shape for s in bucket.get_states()] == [(BATCH, HIDDEN)] * 4


def test_symbol_json_and_params_carry_across_packages(jax_fit):
    """``lstm_lm_sym_gen`` writes the reference's graph JSON node for node,
    and ``convert.params_from_numpy`` carries the reference's parameters
    (the same names, no new layout) into a port module that then computes
    the reference's outputs."""
    for seq_len in (1, 4):
        with jmx.name.NameManager():
            jsym = _sym_gen(jmx)[0](seq_len)[0]
        with pmx.NameManager():
            psym = _sym_gen(pmx)[0](seq_len)[0]
        assert psym.tojson() == jsym.tojson()
    jarg, jaux = jax_fit[1].get_params()
    arg, _aux = pmx.convert.params_from_numpy(
        {k: v.asnumpy() for k, v in jarg.items()}, {}, pmx.cpu())
    states = _sym_gen(pmx)[1]
    outs = []
    data = np.random.default_rng(3).integers(1, VOCAB, (BATCH, 4)).astype(
        np.float32)
    for pkg, mod_args in ((jmx, jarg), (pmx, arg)):
        kw = {"ctx": pmx.cpu()} if pkg is pmx else {}
        mod = pkg.mod.Module(_sym_gen(pkg)[0](4)[0], state_names=states,
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", (BATCH, 4))],
                 label_shapes=[("softmax_label", (BATCH, 4))],
                 for_training=False)
        mod.set_params(mod_args, {})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(data, **kw)],
                                     [pkg.nd.array(data, **kw)]),
                    is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    assert not jaux and set(arg) == set(jarg)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_lstm_route_fires_per_cell_step_and_not_when_an_intermediate_escapes():
    sym_gen, _states = _sym_gen(pmx)
    for seq_len in (1, 4, 8):
        assert len(_Graph(sym_gen(seq_len)[0]).lstm) == 2 * seq_len
    # a forget gate another head reads keeps its step op by op
    sym = sym_gen(3)[0]
    gate = sym.get_internals()["lstm_l1_t1_f_output"]
    graph = _Graph(pmx.sym.Group([sym, gate]))
    assert len(graph.lstm) == 5
    # without a forget bias the chain has no _plus_scalar and still fuses
    cell = pmx.rnn.LSTMCell(HIDDEN, prefix="nb_", forget_bias=0.0)
    out, _ = cell.unroll(3, inputs=pmx.sym.Variable("data"),
                         merge_outputs=True)
    assert len(_Graph(out).lstm) == 3
    assert "_plus_scalar" not in out.tojson()


def test_routed_and_op_by_op_forward_backward_agree(params):
    """The same step with every cell fused and with one cell's forget gate
    exposed (that cell then runs op by op)."""
    sym_gen, states = _sym_gen(pmx)
    sym = sym_gen(4)[0]
    exposed = pmx.sym.Group([sym, sym.get_internals()["lstm_l0_t2_f_output"]])
    rng = np.random.default_rng(2)
    data = rng.integers(1, VOCAB, (BATCH, 4)).astype(np.float32)
    shapes = {"data": (BATCH, 4), "softmax_label": (BATCH, 4)}
    shapes.update({n: (BATCH, HIDDEN) for n in states})
    results = []
    for s in (sym, exposed):
        exe = s.simple_bind(pmx.cpu(), grad_req="write", **shapes)
        for k, v in params.items():
            exe.arg_dict[k][:] = v
        exe.forward(is_train=True, data=data, softmax_label=data)
        # the loss head ignores its head gradient; the exposed gate gets 0
        exe.backward(None if s is sym else
                     [pmx.nd.ones((BATCH * 4, VOCAB), ctx=pmx.cpu()),
                      pmx.nd.zeros((BATCH, HIDDEN), ctx=pmx.cpu())])
        results.append([exe.outputs[0].asnumpy()] +
                       [exe.grad_dict[k].asnumpy() for k in sorted(params)])
    assert len(_Graph(exposed).lstm) == 7
    for got, want in zip(results[1], results[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_states_checkpoint_and_unported_options(params, tmp_path):
    _steps, mod = _fit(pmx, params, pmx.cpu())
    mod.set_states(value=0.5)
    assert all(float(s.asnumpy().min()) == 0.5 for s in mod.get_states())
    mod.set_states(states=[pmx.nd.zeros((BATCH, HIDDEN), ctx=pmx.cpu())] * 4)
    assert all(not s.asnumpy().any() for s in mod.get_states())
    prefix = str(tmp_path / "lstm")
    mod.save_checkpoint(prefix, 1)
    jsym, jarg, _jaux = jmx.model.load_checkpoint(prefix, 1)
    ref = _sym_gen(jmx)[0](8)[0]  # auto-named nodes count differently
    assert jsym.list_arguments() == ref.list_arguments()
    assert [n["op"] for n in json.loads(jsym.tojson())["nodes"]] == \
        [n["op"] for n in json.loads(ref.tojson())["nodes"]]
    got, _aux = mod.get_params()
    assert jarg.keys() == got.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(jarg[k].asnumpy(), v.asnumpy())
    with pytest.raises(MXNetError, match="queue 1 item 2"):
        mod.train_window(None)
    with pytest.raises(MXNetError, match="queue 1 item 2"):
        mod.compile()


def test_the_card_is_the_default_for_the_iterator():
    sents = _sentences()
    if torch.cuda.is_available():
        it = pmx.rnn.BucketSentenceIter(sents, BATCH, buckets=BUCKETS)
        assert next(iter(it)).data[0].context == pmx.gpu(0)
        return
    with pytest.raises(MXNetError):
        pmx.rnn.BucketSentenceIter(sents, BATCH, buckets=BUCKETS)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drop_dnext_c(dnext_h, dnext_c, act, c_prev, next_c):
    return _GOOD_BWD(dnext_h, None, act, c_prev, next_c)


def _zero_forget_gate(dnext_h, dnext_c, act, c_prev, next_c):
    dgates, dc_prev = _GOOD_BWD(dnext_h, dnext_c, act, c_prev, next_c)
    hidden = c_prev.shape[1]
    dgates = dgates.clone()
    dgates[:, hidden:2 * hidden] = 0
    return dgates, dc_prev


def _plain_tanh_grad(ct, t):  # ct * (1 - t): the a * t term dropped
    return ct * (1.0 - t)


_GOOD_BWD = lstm_mod.lstm_cell_bwd_plain


@pytest.mark.parametrize("fault", ["dnext_c", "forget_gate", "tanh_grad"])
def test_chip_smoke_lstm_parity_limits_see_a_faulty_cell_backward(
        fault, monkeypatch):
    """``chip_smoke.py``'s LSTM parity (its own ``lstm_parity_side``,
    ``lstm_parity_step`` and ``parity_diff``, at a narrow width on the CPU)
    holds a correct Adam step against one whose cell backward is faulty:
    every fault must move the Adam means beyond ``LSTM_PARITY_TOL``."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "LSTM", {"num_hidden": 24, "num_layers": 2,
                                     "num_embed": 24, "vocab_size": 300})
    monkeypatch.setattr(cs, "LSTM_BATCH", 8)
    with pmx.cpu():
        sym, states, args = cs.lstm_numpy(pmx, 3)
        (x, y), _second = cs.lstm_parity_batches(4)
        good = cs.lstm_parity_step(torch, pmx, cs.lstm_parity_side(
            pmx, sym, states, args, pmx.cpu()), x, y)
        if fault == "tanh_grad":
            monkeypatch.setattr(lstm_mod, "_tanh_grad", _plain_tanh_grad)
        else:
            monkeypatch.setattr(lstm_mod, "lstm_cell_bwd_plain", {
                "dnext_c": _drop_dnext_c,
                "forget_gate": _zero_forget_gate}[fault])
        bad = cs.lstm_parity_step(torch, pmx, cs.lstm_parity_side(
            pmx, sym, states, args, pmx.cpu()), x, y)
    rel, worst, worst_rel = cs.parity_diff(bad["mean"], good["mean"])
    print(f"{fault}: Adam means {rel:.3g} in norm, worst {worst} "
          f"{worst_rel:.3g}")
    assert rel > 10 * cs.LSTM_PARITY_TOL["mean"]
    assert cs.parity_diff(bad["loss"], good["loss"])[0] == 0  # forward
