"""Sequence-bucketed serving of the PyTorch port held against the JAX
package: ``ModelServer(sym_gen=...)`` with ``ServingConfig(seq_buckets=...)``.

The LSTM language model (``models.lstm_lm_serving_sym_gen``) and the
vanilla-RNN one (``chip_smoke.rnn_lm_serving_sym_gen``, built from
``RNNCell``) at hidden 16, embedding 12, vocabulary 50, two layers, with
weights made by numpy from a seed, are served by both packages on the CPU
over batch buckets (1, 2) and seq buckets (4, 8): the predictor keys, each
answer per request (padded to its seq bucket), the refusals, the
environment variables, ``_coerce`` at ``seq_axis=1``, and the coalescing of
concurrent requests of mixed lengths only within their seq bucket.

Tolerance, float32 on both sides: rtol 1e-5 / atol 1e-6 (``TOL``) on the
logits; the two packages' ``Predictor``s on one LSTM bucket read 1.5e-8
apart (8 recurrent steps of products summed by two libraries).
"""

import importlib.util
import threading
import types
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu.serving import server as jserver

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import ModelServer, ServingConfig
from mxnet_tpu_torch.serving import server as pserver

HIDDEN, EMBED, VOCAB, LAYERS = 16, 12, 50, 2
BUCKETS, SEQ = (1, 2), (4, 8)
TOL = dict(rtol=1e-5, atol=1e-6)
# request lengths: both seq buckets, each batch bucket, the border lengths
LENGTHS = (3, 8, 1, 5, 4, 7)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lstm_gen(pkg):
    return pkg.models.lstm_lm_serving_sym_gen(
        num_hidden=HIDDEN, num_layers=LAYERS, num_embed=EMBED,
        vocab_size=VOCAB)


def _rnn_gen(pkg):
    return _chip_smoke().rnn_lm_serving_sym_gen(
        pkg, num_hidden=HIDDEN, num_layers=LAYERS, num_embed=EMBED,
        vocab_size=VOCAB)


def _params(sym_gen, seed):
    """Numpy parameters of a language model's ``sym_gen``: U(-0.3, 0.3)."""
    sym = sym_gen(4)[0]
    shapes = {"data": (1, 4)}
    shapes.update({n: (1, HIDDEN) for n in sym.list_arguments()
                   if "begin_state" in n})
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _requests(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).astype(np.int32) for n in LENGTHS]


def _servers(gen, buckets, seed):
    """The JAX and the port's servers of one model on the CPU, the same
    weights, started."""
    args = _params(gen(pmx), seed)
    cfg = dict(buckets=buckets, seq_buckets=SEQ, max_delay_ms=1.0)
    jsrv = jserver.ModelServer(
        None, {k: jmx.nd.array(v) for k, v in args.items()},
        {"data": (SEQ[-1],)}, config=jserver.ServingConfig(**cfg),
        input_types={"data": "int32"}, sym_gen=gen(jmx), dev_type="cpu")
    psrv = ModelServer(
        None, pmx.convert.params_from_numpy(args, {}, "cpu")[0],
        {"data": (SEQ[-1],)}, config=ServingConfig(**cfg),
        input_types={"data": "int32"}, sym_gen=gen(pmx), dev_type="cpu")
    return jsrv.start(), psrv.start()


@pytest.fixture(scope="module")
def lstm():
    jsrv, psrv = _servers(_lstm_gen, BUCKETS, 0)
    yield jsrv, psrv
    jsrv.close()
    psrv.close()


def _answers(srv, reqs):
    """Each request alone, in order: its logits and the bucket it ran in."""
    out = []
    for x in reqs:
        fut = srv.submit(x)
        out.append((fut.result(timeout=120)[0], fut.bucket))
    return out


def test_predictor_keys_are_batch_and_seq_bucket_pairs(lstm):
    jsrv, psrv = lstm
    keys = sorted(psrv.replicas[0].predictors)
    assert keys == sorted(jsrv.replicas[0].predictors) == [
        (1, 4), (1, 8), (2, 4), (2, 8)]
    for b, s in keys:
        pred = psrv.predictor((b, s))
        assert pred.input_shapes == {"data": (b, s)}
        assert pred._exec.arg_dict["data"].dtype == np.int32
    assert psrv.stats()["status"] == "ok"


def test_answers_match_reference_padded_to_their_bucket(lstm):
    jsrv, psrv = lstm
    reqs = _requests()
    got, want = _answers(psrv, reqs), _answers(jsrv, reqs)
    for x, (g, gb), (w, wb) in zip(reqs, got, want):
        s = 4 if len(x) <= 4 else 8
        assert gb == wb == (1, s)
        assert g.shape == w.shape == (s, VOCAB)
        np.testing.assert_allclose(g, w, **TOL)
    # padding is the tokens' zero-padding: a request of its bucket's full
    # length with zeros past the end answers the same bits
    x = reqs[0]
    padded = np.concatenate([x, np.zeros(4 - len(x), np.int32)])
    np.testing.assert_array_equal(psrv.predict(padded, timeout=60)[0],
                                  got[0][0])


@pytest.mark.parametrize("length", [0, 9])
def test_lengths_past_the_buckets_are_refused(lstm, length):
    jsrv, psrv = lstm
    x = np.zeros(length, np.int32)
    for srv, err in ((psrv, MXNetError), (jsrv, jmx.base.MXNetError)):
        with pytest.raises(err, match="seq length"):
            srv.submit(x)


def test_sym_gen_and_seq_buckets_need_each_other():
    gen = _lstm_gen(pmx)
    args = pmx.convert.params_from_numpy(_params(gen, 1), {}, "cpu")[0]
    with pytest.raises(MXNetError, match="no seq buckets configured"):
        ModelServer(None, args, {"data": (8,)},
                    config=ServingConfig(buckets=(1,)), sym_gen=gen,
                    dev_type="cpu")
    with pytest.raises(MXNetError, match="no sym_gen given"):
        ModelServer(gen(8)[0], args, {"data": (8,)},
                    config=ServingConfig(buckets=(1,), seq_buckets=(4, 8)),
                    dev_type="cpu")


def _coerce(module, config, sample_shapes, dtypes):
    """``module.ModelServer._coerce`` on a stand-in that holds only what it
    reads: the config, the per-sample shapes and the bound dtypes."""
    stand_in = types.SimpleNamespace(
        config=config, _sample_shapes=sample_shapes,
        _input_names=tuple(sample_shapes), _input_dtypes=dtypes)
    stand_in._seq_shape = lambda shape, n: module.ModelServer._seq_shape(
        stand_in, shape, n)
    return lambda inputs: module.ModelServer._coerce(stand_in, inputs)


def test_env_variables_and_coerce_at_seq_axis_1(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_SEQ_BUCKETS", "16, 4,8")
    monkeypatch.setenv("MXNET_SERVING_SEQ_AXIS", "1")
    pcfg, jcfg = ServingConfig(), jserver.ServingConfig()
    assert pcfg.seq_buckets == jcfg.seq_buckets == (4, 8, 16)
    assert pcfg.seq_axis == jcfg.seq_axis == 1
    # arguments win over the variables; a string, a sequence or empty
    for raw in ("2,6", (6, 2), "", ()):
        got = ServingConfig(seq_buckets=raw, seq_axis=0)
        want = jserver.ServingConfig(seq_buckets=raw, seq_axis=0)
        assert got.seq_buckets == want.seq_buckets
        assert got.seq_axis == want.seq_axis == 0
    monkeypatch.setenv("MXNET_SERVING_SEQ_BUCKETS", "")
    monkeypatch.delenv("MXNET_SERVING_SEQ_AXIS")
    assert ServingConfig().seq_buckets == () and ServingConfig().seq_axis == 0
    # features (3, T) and a mask (1, T): the seq axis is 1 of each; the
    # first input fixes the length
    shapes = {"feat": (3, 8), "mask": (1, 8)}
    dtypes = {"feat": np.dtype(np.float32), "mask": np.dtype(np.int32)}
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((3, 5))
    mask = rng.integers(0, 2, (1, 5))
    res = []
    for mod, cfg, err in (
            (pserver, ServingConfig(seq_buckets=(4, 8), seq_axis=1),
             MXNetError),
            (jserver, jserver.ServingConfig(seq_buckets=(4, 8), seq_axis=1),
             jmx.base.MXNetError)):
        coerce = _coerce(mod, cfg, shapes, dtypes)
        with pytest.raises(err, match="per-sample shape"):
            coerce({"feat": feat, "mask": mask[:, :3]})
        with pytest.raises(err, match="seq length 9"):
            coerce({"feat": rng.standard_normal((3, 9)), "mask": mask})
        with pytest.raises(err, match="rank 2"):
            coerce({"feat": feat[0], "mask": mask})
        res.append(coerce({"feat": feat, "mask": mask}))
    (got, group), (want, wgroup) = res
    assert group == wgroup == 8
    for name in shapes:
        assert got[name].shape == want[name].shape == shapes[name]
        assert got[name].dtype == want[name].dtype == dtypes[name]
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(got["feat"][:, 5:], 0)


def test_concurrent_mixed_lengths_coalesce_within_their_seq_bucket():
    """Six requests of lengths in both seq buckets submitted together,
    interleaved: each batch holds one seq bucket, and every answer is the
    one it gets alone."""
    gen = _lstm_gen(pmx)
    args = pmx.convert.params_from_numpy(_params(gen, 0), {}, "cpu")[0]
    srv = ModelServer(None, args, {"data": (8,)},
                      config=ServingConfig(buckets=(1, 2, 4), seq_buckets=SEQ,
                                           max_delay_ms=200.0),
                      input_types={"data": "int32"}, sym_gen=gen,
                      dev_type="cpu")
    reqs = _requests(7)
    alone = [srv.predictor((1, 4 if len(x) <= 4 else 8)).run(
        data=np.pad(x, (0, (4 if len(x) <= 4 else 8) - len(x)))[None])[0][0]
        for x in reqs]
    with srv:
        barrier = threading.Barrier(len(reqs))
        futs = [None] * len(reqs)

        def send(i):
            barrier.wait()
            futs[i] = srv.submit(reqs[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = [f.result(timeout=120)[0] for f in futs]
        buckets = [f.bucket for f in futs]
    for x, b, g, a in zip(reqs, buckets, got, alone):
        assert b[1] == (4 if len(x) <= 4 else 8)
        np.testing.assert_allclose(g, a, **TOL)
    # both seq buckets served, and requests did share batches
    assert {b[1] for b in buckets} == set(SEQ)
    assert max(b[0] for b in buckets) > 1


def test_rnn_cell_lm_served_the_same_way():
    """The vanilla-RNN language model through both servers: every step of
    the port's graph is one fused ``rnn_cell`` step, and the answers match
    the reference's."""
    jsrv, psrv = _servers(_rnn_gen, (2,), 2)
    try:
        pred = psrv.predictor((2, 8))
        steps = pred._exec.graph.rnn
        assert len(steps) == LAYERS * 8
        assert all(st.act == "tanh" and any(
            m.name.endswith("_h2h") for m in st.members)
            for st in steps.values())
        reqs = _requests(9)[:4]
        got, want = _answers(psrv, reqs), _answers(jsrv, reqs)
        for x, (g, gb), (w, wb) in zip(reqs, got, want):
            assert gb == wb == (2, 4 if len(x) <= 4 else 8)
            np.testing.assert_allclose(g, w, **TOL)
    finally:
        jsrv.close()
        psrv.close()
