"""The serving slice of the PyTorch port held against the JAX package.

A narrow bottleneck ResNet (the ImageNet stem, so the 7x7/2 conv, the
max-pool and the BatchNorms that cannot fold are all on the path) is built
by both packages with the same weights, made by numpy from a seed, and
served by the JAX ``Predictor`` and by the port's ``Predictor`` and
``ModelServer`` on the CPU. Outputs agree to rtol 1e-4 / atol 1e-5: float32
on both sides, with a dozen convolutions summed in different orders.
Also: ``.params`` files are byte-identical in both directions, symbol JSON
round-trips, ``params_from_numpy`` keeps values and dtypes, the port
imports neither ``jax`` nor ``mxnet_tpu``, and its default device is the
card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models.resnet import resnet as jax_resnet

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.resnet import resnet as torch_resnet
from mxnet_tpu_torch.serving import ModelServer, ServingConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
NARROW = dict(units=[1, 1, 1, 1], num_stages=4,
              filter_list=[8, 16, 32, 64, 128], image_shape=(3, 64, 64),
              num_classes=10)
SAMPLE = (3, 64, 64)


def _symbols():
    with jmx.name.NameManager():
        jsym = jax_resnet(**NARROW)
    with pmx.NameManager():
        psym = torch_resnet(**NARROW)
    return jsym, psym


@pytest.fixture(scope="module")
def model():
    """(jax symbol, port symbol, numpy arg params, numpy aux params)."""
    jsym, psym = _symbols()
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=(1,) + SAMPLE)
    rng = np.random.default_rng(0)
    args, auxs = {}, {}
    for name, shape in zip(jsym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            std = np.sqrt(2.0 / np.prod(shape[1:]))
            args[name] = (rng.standard_normal(shape) * std).astype(np.float32)
        elif name.endswith("_gamma"):
            args[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            args[name] = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
    for name, shape in zip(jsym.list_auxiliary_states(), aux_shapes):
        lo, hi = (0.5, 2.0) if name.endswith("_var") else (-0.2, 0.2)
        auxs[name] = rng.uniform(lo, hi, shape).astype(np.float32)
    return jsym, psym, args, auxs


def _jax_params(args, auxs):
    d = {f"arg:{k}": jmx.nd.array(v) for k, v in args.items()}
    d.update({f"aux:{k}": jmx.nd.array(v) for k, v in auxs.items()})
    return d


def _torch_params(args, auxs):
    a, x = pmx.convert.params_from_numpy(args, auxs, "cpu")
    d = {f"arg:{k}": v for k, v in a.items()}
    d.update({f"aux:{k}": v for k, v in x.items()})
    return d


def _images(n, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n,) + SAMPLE).astype(np.float32)


@pytest.mark.parametrize("fold_bn", [True, False])
def test_predictor_matches_reference(model, fold_bn):
    jsym, psym, args, auxs = model
    x = _images(3)
    jpred = jmx.predictor.Predictor(jsym, _jax_params(args, auxs),
                                    {"data": x.shape}, fold_bn=fold_bn)
    jpred.forward(data=x)
    want = jpred.get_output(0)
    ppred = pmx.predictor.Predictor(psym, _torch_params(args, auxs),
                                    {"data": x.shape}, dev_type="cpu",
                                    fold_bn=fold_bn)
    got = ppred.run(data=x)[0]
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, **TOL)
    # with the fold on, the 5 BatchNorms a residual add or the max-pool
    # feeds stay and fuse with their ReLU; with it off all 14 BN+ReLU do
    assert len(ppred._exec.graph.fused) == (5 if fold_bn else 14)


def test_predictor_reshape_and_set_params_match_reference(model):
    """MXPredReshape and a weight swap, on both packages."""
    jsym, psym, args, auxs = model
    x = _images(2, seed=4)
    scaled = {k: (v * 0.5 if k.endswith("_weight") else v)
              for k, v in args.items()}
    jpred = jmx.predictor.Predictor(jsym, _jax_params(args, auxs),
                                    {"data": (1,) + SAMPLE}, fold_bn=False)
    ppred = pmx.predictor.Predictor(psym, _torch_params(args, auxs),
                                    {"data": (1,) + SAMPLE}, dev_type="cpu",
                                    fold_bn=False)
    for pred, nd in ((jpred, jmx.nd), (ppred, None)):
        pred.reshape({"data": x.shape})
        swap = ({k: nd.array(v) for k, v in scaled.items()} if nd
                else pmx.convert.params_from_numpy(scaled, {}, "cpu")[0])
        pred.set_params(swap)
    jpred.forward(data=x)
    got = ppred.run(data=x)[0]
    np.testing.assert_allclose(got, jpred.get_output(0), **TOL)
    with pytest.raises(MXNetError):
        ppred.set_params({"fc1_weight": np.zeros((3, 3), np.float32)},
                         allow_missing=True)


def test_model_server_matches_reference_per_request(model):
    jsym, psym, args, auxs = model
    x = _images(6, seed=2)
    jpred = jmx.predictor.Predictor(jsym, _jax_params(args, auxs),
                                    {"data": (1,) + SAMPLE})
    want = []
    for i in range(6):
        jpred.forward(data=x[i:i + 1])
        want.append(jpred.get_output(0)[0])
    srv = ModelServer(psym, _torch_params(args, auxs), {"data": SAMPLE},
                      config=ServingConfig(buckets=(1, 2, 4), fold_bn=True,
                                           max_delay_ms=20),
                      dev_type="cpu")
    with srv:
        futs = [srv.submit(x[i]) for i in range(6)]
        got = [f.result(timeout=60)[0] for f in futs]
        assert srv.stats()["status"] == "ok"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kwargs", [
    {"mesh": "tp2"}, {"watch_period": 1.0}, {"watch_dir": "/nonexistent"},
    {"max_body_bytes": 1024},
])
def test_unported_serving_options_raise(kwargs):
    with pytest.raises(MXNetError, match="not yet ported"):
        ServingConfig(**kwargs)


def test_unported_server_arguments_raise(model):
    _jsym, psym, args, auxs = model
    params = _torch_params(args, auxs)
    for kwargs, match in (({"variant": "int8"}, "not yet ported"),
                          ({"sym_gen": lambda n: psym},
                           "no seq buckets configured")):
        with pytest.raises(MXNetError, match=match):
            ModelServer(psym, params, {"data": SAMPLE},
                        config=ServingConfig(buckets=(1,)), dev_type="cpu",
                        **kwargs)
    srv = ModelServer(psym, params, {"data": SAMPLE},
                      config=ServingConfig(buckets=(1,)), dev_type="cpu")
    with pytest.raises(MXNetError, match="not yet ported"):
        srv.reload(params)
    srv.close()


_DTYPES = ["float32", "float16", "int32", "int8", "uint8"]


def _arrays():
    rng = np.random.default_rng(3)
    return {f"arg:w_{dt}": (rng.standard_normal((2, 3, 4)) * 50).astype(dt)
            for dt in _DTYPES} | {"aux:scalar": np.float32(1.5).reshape(())}


def test_params_written_by_reference_load_byte_identical(tmp_path):
    arrays = _arrays()
    jpath, ppath = tmp_path / "jax.params", tmp_path / "torch.params"
    jmx.nd.save(str(jpath), {k: jmx.nd.array(v, dtype=v.dtype)
                             for k, v in arrays.items()})
    loaded = pmx.nd.load(str(jpath))
    assert list(loaded) == list(arrays)
    for k, v in arrays.items():
        got = loaded[k].asnumpy()
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v.reshape(got.shape))
        assert loaded[k].context == pmx.cpu()
    pmx.nd.save(str(ppath), loaded)
    assert ppath.read_bytes() == jpath.read_bytes()


def test_params_written_by_port_load_in_reference(tmp_path, model):
    _jsym, _psym, args, auxs = model
    ppath, jpath = tmp_path / "torch.params", tmp_path / "jax.params"
    pmx.nd.save(str(ppath), _torch_params(args, auxs))
    loaded = jmx.nd.load(str(ppath))
    want = {f"arg:{k}": v for k, v in args.items()}
    want.update({f"aux:{k}": v for k, v in auxs.items()})
    assert sorted(loaded) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)
    jmx.nd.save(str(jpath), loaded)
    assert jpath.read_bytes() == ppath.read_bytes()
    assert pmx.nd.load_buffer(ppath.read_bytes()).keys() == loaded.keys()


def test_symbol_json_round_trip():
    jsym, psym = _symbols()
    assert psym.tojson() == jsym.tojson()
    again = pmx.sym.fromjson(jsym.tojson())
    assert again.tojson() == jsym.tojson()
    assert again.list_arguments() == jsym.list_arguments()
    assert again.list_auxiliary_states() == jsym.list_auxiliary_states()
    shapes = {"data": (2,) + SAMPLE}
    assert again.infer_shape(**shapes) == jsym.infer_shape(**shapes)


def test_params_from_numpy_keeps_values_and_dtypes():
    arg = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
           "ids": np.arange(4, dtype=np.int32)}
    aux = {"m": np.ones(3, np.float16)}
    a, x = pmx.convert.params_from_numpy(arg, aux, torch.device("cpu"))
    assert set(a) == {"w", "ids"} and set(x) == {"m"}
    for got, want in ((a["w"], arg["w"]), (a["ids"], arg["ids"]),
                      (x["m"], aux["m"])):
        assert got.context == pmx.cpu() and got.dtype == want.dtype
        np.testing.assert_array_equal(got.asnumpy(), want)


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, mxnet_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_the_card(model):
    _jsym, psym, args, auxs = model
    params = _torch_params(args, auxs)
    if torch.cuda.is_available():
        pred = pmx.predictor.Predictor(psym, params, {"data": (1,) + SAMPLE})
        assert pred.ctx == pmx.gpu(0)
        assert pmx.current_context() == pmx.gpu(0)
        return
    with pytest.raises(MXNetError):
        pmx.predictor.Predictor(psym, params, {"data": (1,) + SAMPLE})
    with pytest.raises(MXNetError):
        ModelServer(psym, params, {"data": SAMPLE},
                    config=ServingConfig(buckets=(1,)))
    with pytest.raises(MXNetError):
        pmx.nd.array([1.0, 2.0])
