"""The PyTorch port's NDArray, environment variables, top-level names and
dtypes, held against the live JAX package.

* NDArray's comparisons, truth value, ``float``/``int``, ``%``, ``**`` and
  ``abs`` give the reference's values and dtypes (0/1 in the array's dtype
  for comparisons; ``%`` is the floor modulo), exactly;
* ``NDArray.reshape`` takes MXNet's shape codes, an int and ``reverse=``;
* every ``MXNET_*`` variable of ``mxnet_tpu/env.py`` (read live) is
  declared in the port with the reference's default, and is honoured,
  documented as accepted and ignored, or raises at its entry point when
  set; ``fit`` and ``ServingConfig`` raise for one such each;
* ``mx.NDArray``, ``mx.Symbol``, ``mx.Variable``, ``mx.cpu_pinned`` and
  ``mx.rnd`` exist in both packages;
* int64 narrows to int32 as in the reference (with its warning where int64
  was asked for), and ``.params`` files load across the packages.
"""

import math
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import env as jenv

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import env as penv
from mxnet_tpu_torch.base import MXNetError

CPU = pmx.cpu()


def _pair(values, dtype):
    arr = np.asarray(values, dtype=dtype)
    return (jmx.nd.array(arr, dtype=dtype),
            pmx.nd.array(arr, ctx=CPU, dtype=dtype))


_A = [1.5, -2.0, 0.0, 3.0, -0.0, 7.25]
_B = [1.5, 2.0, -1.0, 3.0, 0.0, -2.0]
_INT_A = [5, -5, 0, 7, -3, 2]
_INT_B = [3, 3, -2, 7, 4, -3]

_BINARY = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "mod": lambda a, b: a % b, "pow": lambda a, b: a ** b,
}


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("rhs", ["array", "scalar"])
@pytest.mark.parametrize("op", sorted(_BINARY))
def test_ndarray_binary_dunders_match_reference(op, rhs, dtype):
    fn = _BINARY[op]
    a_vals, b_vals = (_A, _B) if dtype == "float32" else (_INT_A, _INT_B)
    if op == "pow":
        a_vals = [abs(v) for v in a_vals]
        b_vals = [abs(v) % 3 for v in b_vals]
    ja, pa = _pair(a_vals, dtype)
    jb, pb = _pair(b_vals, dtype)
    if rhs == "scalar":
        jb = pb = -3 if op == "mod" else 2
    want, got = fn(ja, jb), fn(pa, pb)
    assert isinstance(got, pmx.NDArray)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("case", ["abs", "neg_abs", "bool0", "bool1",
                                  "bool_many", "float", "int", "eq_none",
                                  "ne_none", "hash"])
def test_ndarray_unary_dunders_match_reference(case):
    ja, pa = _pair(_A, "float32")
    if case == "abs":
        np.testing.assert_array_equal(abs(pa).asnumpy(), abs(ja).asnumpy())
    elif case == "neg_abs":
        np.testing.assert_array_equal(abs(-pa).asnumpy(), abs(-ja).asnumpy())
    elif case in ("bool0", "bool1"):
        v = [0.0] if case == "bool0" else [2.0]
        j1, p1 = _pair(v, "float32")
        assert bool(p1) is bool(j1)
    elif case == "bool_many":
        with pytest.raises(ValueError):
            bool(ja)
        with pytest.raises(ValueError):
            bool(pa)
    elif case in ("float", "int"):
        j1, p1 = _pair([-2.75], "float32")
        conv = float if case == "float" else int
        assert conv(p1) == conv(j1)
    elif case == "eq_none":
        assert (pa == None) is (ja == None) is False  # noqa: E711
    elif case == "ne_none":
        assert (pa != None) is (ja != None) is True  # noqa: E711
    else:
        # __eq__ must not make arrays unhashable (the port keys dicts and
        # sets by array)
        assert {pa: 1}[pa] == 1 and pa in {pa}
        assert hash(pa) == object.__hash__(pa)


@pytest.mark.parametrize("name", ["_equal", "_not_equal", "_greater",
                                  "_greater_equal", "_lesser",
                                  "_lesser_equal", "broadcast_equal",
                                  "broadcast_not_equal", "broadcast_greater",
                                  "broadcast_greater_equal",
                                  "broadcast_lesser",
                                  "broadcast_lesser_equal"])
def test_comparison_ops_match_reference(name):
    rng = np.random.default_rng(0)
    a = rng.integers(-2, 3, (3, 4)).astype(np.float32)
    b = rng.integers(-2, 3, (3, 4) if name[0] == "_" else (1, 4)
                     ).astype(np.float32)
    want = getattr(jmx.nd, name)(jmx.nd.array(a), jmx.nd.array(b))
    got = getattr(pmx.nd, name)(pmx.nd.array(a, ctx=CPU),
                                pmx.nd.array(b, ctx=CPU))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("shape,target,reverse", [
    ((2, 3, 4), (0, -1), False),
    ((2, 3, 4), 24, False),
    ((2, 3, 4), (-1,), False),
    ((2, 3, 4), (-2,), False),
    ((2, 3, 4), (0, -3), False),
    ((2, 3, 4), (-3, 0), False),
    ((2, 3, 4), (0, -4, 3, -1, 0), False),
    ((2, 3, 4), (-1, 0), True),
    ((2, 3, 4), (4, 0, -1), False),
])
def test_ndarray_reshape_codes_match_reference(shape, target, reverse):
    x = np.arange(math.prod(shape), dtype=np.float32).reshape(shape)
    kw = {"reverse": True} if reverse else {}
    want = jmx.nd.array(x).reshape(target, **kw)
    got = pmx.nd.array(x, ctx=CPU).reshape(target, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


_REF_VARS = sorted(jenv._CATALOGUE)


def _non_default(var):
    """A setting of ``var`` that parses to something other than its
    default."""
    d = var.default
    if isinstance(d, bool):
        return "0" if d else "1"
    if isinstance(d, (int, float)):
        return str(d + 7)
    return "x" if d != "x" else "y"


@pytest.mark.parametrize("name", _REF_VARS)
def test_env_declares_every_reference_variable(name, monkeypatch):
    assert name in penv._CATALOGUE, f"{name} is not declared in the port"
    ref, var = jenv._CATALOGUE[name], penv._CATALOGUE[name]
    assert var.default == ref.default
    monkeypatch.delenv(name, raising=False)
    assert penv.get(name) == ref.default
    if var.status == "honoured":
        return
    if var.status == "ignored":
        assert "Ignored" in var.doc, var.doc
        monkeypatch.setenv(name, _non_default(var))
        penv.check_unported("fit")
        penv.check_unported("serving")
        return
    assert var.scopes, f"{name} is checked at no entry point"
    monkeypatch.setenv(name, _non_default(var))
    for scope in var.scopes:
        with pytest.raises(MXNetError, match=f"ROADMAP.md queue 1 item "
                           f"{var.status}"):
            penv.check_unported(scope)
    # its default value is not an error
    monkeypatch.setenv(name, str(var.default))
    for scope in var.scopes:
        penv.check_unported(scope)


def _tiny_fit():
    x = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    data = pmx.sym.Variable("data")
    net = pmx.sym.SoftmaxOutput(
        pmx.sym.FullyConnected(data, num_hidden=2, name="fc"), name="softmax")
    mod = pmx.mod.Module(net, context=CPU)
    mod.fit(pmx.io.NDArrayIter(x, y, batch_size=4, ctx=CPU), num_epoch=1)
    return mod


@pytest.mark.parametrize("name,value", [
    ("MXNET_CHECKPOINT_DIR", "/nonexistent/ckpt"),
    ("MXNET_IO_RETRY", "3"),
    ("MXNET_FI_CRASH_AT_BATCH", "2"),
])
def test_fit_refuses_unported_variables(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    with pytest.raises(MXNetError, match=name):
        _tiny_fit()
    monkeypatch.delenv(name)
    _tiny_fit()


def test_serving_refuses_unported_variables(monkeypatch):
    from mxnet_tpu_torch.serving import ServingConfig

    monkeypatch.setenv("MXNET_SERVING_CANARY_PCT", "10")
    with pytest.raises(MXNetError, match="MXNET_SERVING_CANARY_PCT"):
        ServingConfig()


@pytest.mark.parametrize("name", ["NDArray", "Symbol", "Variable",
                                  "cpu_pinned", "rnd"])
def test_top_level_names(name):
    want, got = getattr(jmx, name), getattr(pmx, name)
    if name == "rnd":
        assert got is pmx.random
        assert callable(got.seed) and callable(got.normal)
    elif name == "cpu_pinned":
        assert str(got()) == str(want()) == "cpu_pinned(0)"
    elif name == "Variable":
        assert got("v").list_arguments() == want("v").list_arguments()
    else:
        assert isinstance(got, type) and got.__name__ == want.__name__


def _both(fn):
    """``fn(package)`` for both packages, with the warnings each gave."""
    out = []
    for pkg, kw in ((jmx, {}), (pmx, {"ctx": CPU})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            arr = fn(pkg, kw)
        out.append((arr, [str(x.message) for x in w
                          if issubclass(x.category, UserWarning)]))
    return out


@pytest.mark.parametrize("case", ["numpy_int64", "list_ints",
                                  "numpy_float64", "zeros_int64",
                                  "ones_int64", "array_int64"])
def test_dtype_narrowing_matches_reference(case):
    makers = {
        "numpy_int64": lambda p, kw: p.nd.array(np.arange(3), **kw),
        "list_ints": lambda p, kw: p.nd.array([1, 2, 3], **kw),
        "numpy_float64": lambda p, kw: p.nd.array(np.ones(3), **kw),
        "zeros_int64": lambda p, kw: p.nd.zeros((2,), dtype="int64", **kw),
        "ones_int64": lambda p, kw: p.nd.ones((2,), dtype="int64", **kw),
        "array_int64": lambda p, kw: p.nd.array(np.arange(3), dtype="int64",
                                                **kw),
    }
    (want, jwarn), (got, pwarn) = _both(makers[case])
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    narrowed = [m for m in jwarn if "int64" in m]
    assert bool([m for m in pwarn if "int64" in m]) == bool(narrowed)


def test_float64_on_request_is_a_documented_difference():
    arr = pmx.nd.ones((2,), ctx=CPU, dtype="float64")
    assert arr.dtype == np.float64
    doc = pmx.ndarray.__doc__
    assert "keeps float64 where the caller asks for it" in doc


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_params_files_load_both_ways(direction, tmp_path):
    rng = np.random.default_rng(1)
    values = {"w": rng.standard_normal((3, 2)).astype(np.float32),
              "idx": np.arange(4, dtype=np.int32)}
    path = str(tmp_path / "x.params")
    src, dst = (pmx, jmx) if direction == "port_to_jax" else (jmx, pmx)
    kw = {"ctx": CPU} if src is pmx else {}
    src.nd.save(path, {k: src.nd.array(v, dtype=v.dtype, **kw)
                       for k, v in values.items()})
    loaded = dst.nd.load(path)
    assert set(loaded) == set(values)
    for k, v in values.items():
        assert loaded[k].dtype == v.dtype
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)
