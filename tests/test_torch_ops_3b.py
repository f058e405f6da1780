"""The elementwise, reduce, tensor and softmax ops of the PyTorch port held
against the JAX package, one case per registered name.

Every name the port registers for these ops (the 65 of
``defs_elemwise.py``, 17 of ``defs_reduce.py``, 30 of ``defs_tensor.py``
and ``Dropout``/``softmax``/``log_softmax``) is built as a symbol in both
packages from the same parameters and bound by ``simple_bind`` on the CPU:
``list_arguments``, ``list_outputs``, ``infer_shape`` and ``infer_type``
agree, the Symbol JSON written by each package loads in the other, and one
training forward and backward on inputs made with numpy from a seed give
the same outputs and input gradients for random head gradients. The cases
carry the known traps: ``mod``'s sign, ``gamma`` without its sign, half to
even in ``round``/``rint``, ``fix``, ``logical_not``'s dtype, reductions
over ``()``/None/``exclude``/``keepdims``, index outputs in the input's
dtype, ``topk``'s four return types with ties, ``max``/``min`` gradients
at ties, ``norm`` and ``prod`` gradients at zeros, ``dot`` of two vectors,
a 1-D ``where`` condition, ``take``'s clip and wrap, ``slice`` with None
and negative bounds, ``one_hot``'s values and dtype, ``BlockGrad``'s zero
gradient. Then the 14 ``NDArray`` methods.

Tolerances, float32 on both sides: "exact" cases (rounding, comparisons,
selections, indexing, shapes, creation) bit for bit; the others rtol 1e-5
/ atol 1e-6 (two libraries' transcendental functions and sums may differ
by an ulp or two; ``cbrt`` is ``|x| ** (1/3)`` in the port, within that).
"""

import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.ops import registry as preg

TOL = dict(rtol=1e-5, atol=1e-6)


def _n(shape, lo=-2.0, hi=2.0):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def _halves(r):
    base = r.uniform(-3, 3, (3, 4)).astype(np.float32)
    base.flat[:6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return base


def _ties(r):
    x = r.uniform(-1, 1, (3, 5)).astype(np.float32)
    x[0, 1] = x[0, 3] = x[0].max() + 1.0
    x[1, :] = 0.25
    return x


def _zeros_in(r):
    x = r.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    x[0, 1] = 0.0
    x[2, 0] = x[2, 3] = 0.0
    return x


def _index(n, shape):
    return lambda r: r.integers(0, n, shape).astype(np.float32)


# name -> (params, [input makers], indices of inputs with a gradient,
#          exact)
UNARY_DOMAIN = {
    "sqrt": (0.1, 3.0), "rsqrt": (0.1, 3.0), "log": (0.1, 3.0),
    "log10": (0.1, 3.0), "log2": (0.1, 3.0), "log1p": (-0.5, 3.0),
    "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9), "arctanh": (-0.9, 0.9),
    "arccosh": (1.1, 3.0), "gammaln": (0.2, 4.0), "reciprocal": (0.3, 2.0),
    "cbrt": (0.2, 3.0), "rcbrt": (0.2, 3.0), "tan": (-1.2, 1.2),
}
UNARY_EXACT = {"sign", "rint", "round", "ceil", "floor", "trunc", "fix",
               "negative", "logical_not", "abs", "relu"}
UNARY = ["abs", "sign", "rint", "round", "ceil", "floor", "trunc", "fix",
         "square", "sqrt", "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10",
         "log2", "log1p", "expm1", "sin", "cos", "tan", "arcsin", "arccos",
         "arctan", "degrees", "radians", "sinh", "cosh", "tanh", "arcsinh",
         "arccosh", "arctanh", "gamma", "gammaln", "negative", "reciprocal",
         "sigmoid", "relu", "softsign", "erf", "logical_not"]

CASES = {}
for _u in UNARY:
    _lo, _hi = UNARY_DOMAIN.get(_u, (-2.0, 2.0))
    CASES[_u] = ({}, [_n((3, 4), _lo, _hi)], [0], _u in UNARY_EXACT)
CASES["round"] = ({}, [_halves], [0], True)
CASES["rint"] = ({}, [_halves], [0], True)
CASES["fix"] = ({}, [_halves], [0], True)
CASES["logical_not"] = ({}, [lambda r: np.array(
    [[0, 1, -2, 0], [3, 0, 0, 0.5]], np.float32)], [0], True)
# gamma of negative non-integers: the reference drops the sign
CASES["gamma"] = ({}, [lambda r: np.array(
    [[-2.5, -0.5, 0.3, 1.7], [2.5, 3.2, -1.3, 4.1]], np.float32)], [0],
    False)
CASES["cbrt"] = ({}, [lambda r: np.array(
    [[-8.0, -0.3, 0.2, 27.0], [1.5, -2.7, 0.9, 5.0]], np.float32)], [0],
    False)

_BIN = {"plus": (-2, 2), "minus": (-2, 2), "mul": (-2, 2),
        "div": (0.5, 2), "power": (0.5, 2), "maximum": (-2, 2),
        "minimum": (-2, 2), "mod": (-3, 3), "hypot": (-2, 2)}


def _mod_rhs(r):
    x = r.uniform(0.7, 1.9, (3, 4)).astype(np.float32)
    x[0] *= -1  # a negative divisor: jnp.mod takes its sign
    return x


SAME = {"_div": "div", "_Div": "div", "elemwise_div": "div",
        "_power": "power", "_Power": "power", "_maximum": "maximum",
        "_Maximum": "maximum", "_minimum": "minimum", "_Minimum": "minimum",
        "_mod": "mod", "_Mod": "mod"}
for _name, _k in SAME.items():
    _lo, _hi = _BIN[_k]
    _rhs = _mod_rhs if _k == "mod" else _n((3, 4), _lo, _hi)
    CASES[_name] = ({}, [_n((3, 4), _lo if _k != "mod" else -3, _hi), _rhs],
                    [0, 1], False)
BCAST = {"broadcast_add": "plus", "broadcast_plus": "plus",
         "broadcast_mul": "mul", "broadcast_div": "div",
         "broadcast_power": "power", "broadcast_maximum": "maximum",
         "broadcast_minimum": "minimum", "broadcast_mod": "mod",
         "broadcast_hypot": "hypot"}
for _name, _k in BCAST.items():
    _lo, _hi = _BIN[_k]
    if _k == "mod":
        _rhs = lambda r: np.array([[1.3], [-0.9], [2.1]], np.float32)
        _lhs = _n((3, 4), -3, 3)
    else:
        _rhs = _n((3, 1), _lo, _hi)
        _lhs = _n((3, 4), _lo, _hi)
    CASES[_name] = ({}, [_lhs, _rhs], [0, 1], False)
for _name in ("add_n", "ElementWiseSum", "_sum"):
    CASES[_name] = ({"num_args": 3}, [_n((3, 4))] * 3, [0, 1, 2], False)

# reductions
_R = _n((2, 3, 4))
for _name in ("sum", "sum_axis", "mean", "nansum"):
    CASES[_name] = ({"axis": (0, 2), "keepdims": True}, [_R], [0], False)
CASES["sum"] = ({"axis": (1,), "exclude": True}, [_R], [0], False)
CASES["mean"] = ({"axis": ()}, [_R], [0], False)


def _with_nan(r):
    x = r.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    x[1, 2] = np.nan
    return x


CASES["nansum"] = ({"axis": 1}, [_with_nan], [], False)
CASES["nanprod"] = ({"axis": 0}, [_with_nan], [], False)
CASES["prod"] = ({"axis": (0, 1)}, [_zeros_in], [0], False)
for _name in ("max", "max_axis", "min", "min_axis"):
    CASES[_name] = ({"axis": 1}, [_ties], [0], True)
CASES["max"] = ({"axis": None, "keepdims": True}, [_ties], [0], True)
CASES["min"] = ({"axis": (0,), "exclude": True}, [_ties], [0], True)
CASES["norm"] = ({}, [_zeros_in], [0], False)
for _name in ("argmax", "argmin"):
    CASES[_name] = ({"axis": 1, "keepdims": True}, [_ties], [0], True)
CASES["argmin"] = ({}, [_ties], [0], True)
CASES["argmax_channel"] = ({}, [_ties], [0], True)
CASES["topk"] = ({"k": 3, "ret_typ": "both", "axis": 1}, [_ties], [0], True)
CASES["sort"] = ({"axis": 0, "is_ascend": False},
                 [_n((4, 3))], [0], True)
CASES["argsort"] = ({"is_ascend": False}, [_ties], [0], True)

# tensor ops
CASES.update({
    "SwapAxis": ({"dim1": 0, "dim2": 2}, [_R], [0], True),
    "swapaxes": ({"dim1": 1, "dim2": 2}, [_R], [0], True),
    "stack": ({"num_args": 2, "axis": 1}, [_n((3, 4))] * 2, [0, 1], True),
    "dot": ({}, [_n((3, 4)), _n((4, 2, 2))], [0, 1], False),
    "batch_dot": ({"transpose_b": True}, [_n((2, 3, 4)), _n((2, 5, 4))],
                  [0, 1], False),
    "slice": ({"begin": (None, -3), "end": (2, None)}, [_n((3, 5))], [0],
              True),
    "crop": ({"begin": (1, 0), "end": (3, -1)}, [_n((3, 5))], [0], True),
    "slice_axis": ({"axis": 1, "begin": -4, "end": -1}, [_n((3, 5))], [0],
                   True),
    "take": ({"axis": 0, "mode": "clip"},
             [_n((4, 3)), lambda r: np.array([[0, 5], [-2, 3]], np.float32)],
             [0], True),
    "batch_take": ({}, [_n((4, 3)), _index(3, (4,))], [0], True),
    "one_hot": ({"depth": 5, "on_value": 2.5, "off_value": -1.0,
                 "dtype": "float32"},
                [lambda r: np.array([0, 4, 7, -1, 2], np.float32)], [],
                True),
    "pick": ({"axis": 1, "keepdims": True}, [_n((4, 3)), _index(3, (4,))],
             [0], True),
    "gather_nd": ({}, [_n((3, 4)), lambda r: np.array(
        [[0, 2, 1], [3, 0, 3]], np.float32)], [0], True),
    "clip": ({"a_min": -0.5, "a_max": 0.75}, [lambda r: np.array(
        [[-1.0, -0.5, 0.0, 0.75], [0.9, 0.3, -0.2, 2.0]], np.float32)], [0],
        True),
    "repeat": ({"repeats": 2, "axis": 1}, [_n((3, 4))], [0], True),
    "tile": ({"reps": (2, 1, 3)}, [_n((3, 4))], [0], False),
    "reverse": ({"axis": (0, 1)}, [_n((3, 4))], [0], True),
    "flip": ({"axis": (1,)}, [_n((3, 4))], [0], True),
    "where": ({}, [lambda r: np.array([1, 0, 2], np.float32), _n((3, 4)),
                   _n((3, 4))], [1, 2], True),
    "BlockGrad": ({}, [_n((3, 4))], [0], True),
    "stop_gradient": ({}, [_n((3, 4))], [0], True),
    "broadcast_to": ({"shape": (2, 0, 4)}, [_n((1, 3, 4))], [0], False),
    "broadcast_axis": ({"axis": (0, 2), "size": (3, 5)}, [_n((1, 4, 1))],
                       [0], False),
    "broadcast_axes": ({"axis": (1,), "size": (3,)}, [_n((2, 1))], [0],
                       False),
    "zeros_like": ({}, [_n((3, 4))], [0], True),
    "ones_like": ({}, [_n((3, 4))], [0], True),
    "_zeros": ({"shape": (2, 3)}, [], [], True),
    "_ones": ({"shape": (2, 3), "dtype": "float32"}, [], [], True),
    "_full": ({"shape": (3,), "value": 2.5}, [], [], True),
    "_arange": ({"start": 1.0, "stop": 7.0, "step": 2.0, "repeat": 2}, [],
                [], True),
    "Dropout": ({"p": 0.5}, [_n((3, 4))], [0], True),
    "softmax": ({"axis": 0, "temperature": 2.0}, [_n((3, 4))], [0], False),
    "log_softmax": ({}, [_n((3, 4))], [0], False),
})
# where with a full-shape condition; take's wrap mode
CASES_EXTRA = {
    "where-full": ("where", {}, [lambda r: (r.uniform(size=(3, 4)) > 0.5)
                                 .astype(np.float32), _n((3, 4)),
                                 _n((3, 4))], [1, 2], True),
    "take-wrap": ("take", {"axis": 1, "mode": "wrap"},
                  [_n((3, 4)), lambda r: np.array([-1, 5, 2], np.float32)],
                  [0], True),
    "dot-vectors": ("dot", {}, [_n((4,)), _n((4,))], [0, 1], False),
    "dot-transpose": ("dot", {"transpose_a": True},
                      [_n((4, 3)), _n((4, 2))], [0, 1], False),
    "topk-value-ascend": ("topk", {"k": 2, "ret_typ": "value",
                                   "is_ascend": True}, [_ties], [0], True),
    "topk-mask": ("topk", {"k": 2, "ret_typ": "mask", "axis": 0}, [_ties],
                  [0], True),
    "topk-indices-flat": ("topk", {"k": 4, "axis": None}, [_ties], [0],
                          True),
    "sum-empty-exclude": ("sum", {"axis": (), "exclude": True}, [_R], [0],
                          True),
    "prod-all-zero-grad": ("prod", {}, [_zeros_in], [0], False),
    "norm-zero": ("norm", {}, [lambda r: np.zeros((2, 3), np.float32)], [0],
                  True),
    "one_hot-float16": ("one_hot", {"depth": 3, "dtype": "float16"},
                        [lambda r: np.array([0, 2, 1], np.float32)], [],
                        True),
    "slice-none": ("slice", {"begin": (None,), "end": (None,)},
                   [_n((3, 2))], [0], True),
}


def _all_cases():
    out = [pytest.param(name, *CASES[name], id=name) for name in CASES]
    out += [pytest.param(*v, id=k) for k, v in CASES_EXTRA.items()]
    return out


def test_cases_cover_every_new_name():
    """Every name of the reference's three op files (but ``Cast``/``Pad``,
    items 4b and 12) and its three softmax/dropout ops is registered in the
    port, and each of the 115 this slice adds has a case."""
    files = ("defs_elemwise", "defs_reduce", "defs_tensor")
    ref = {n for n, op in jreg._OPS.items()
           if op.fn.__module__.rsplit(".", 1)[-1] in files}
    ref = (ref | {"Dropout", "softmax", "log_softmax"}) - {
        "Cast", "cast", "Pad", "pad"}
    assert not ref - set(preg._OPS), sorted(ref - set(preg._OPS))
    assert set(CASES) <= ref
    assert len(CASES) == 115
    assert len(preg._OPS) == 223


def _sym(pkg, name, params, n_in):
    opdef = preg.get(name)
    names = opdef.arg_names(opdef.parse_params(params))
    assert len(names) == n_in
    ins = [pkg.sym.Variable(n) for n in names]
    return getattr(pkg.sym, name)(*ins, name="op", **params), names


def _run(pkg, sym, names, arrays, grads, heads_seed):
    ctx = pkg.cpu()
    shapes = {n: a.shape for n, a in zip(names, arrays)}
    req = {n: ("write" if i in grads else "null")
           for i, n in enumerate(names)}
    exe = sym.simple_bind(ctx, grad_req=req, **shapes)
    exe.forward(is_train=True, **dict(zip(names, arrays)))
    outs = [o.asnumpy() for o in exe.outputs]
    res = {"outs": outs}
    if grads:
        rng = np.random.default_rng(heads_seed)
        heads = [rng.standard_normal(o.shape).astype(np.float32)
                 for o in outs]
        exe.backward([pkg.nd.array(h, ctx=ctx) for h in heads])
        res["grads"] = [exe.grad_dict[names[i]].asnumpy() for i in grads]
    return res


@pytest.mark.parametrize("name, params, makers, grads, exact",
                         _all_cases())
def test_op_against_reference(name, params, makers, grads, exact):
    rng = np.random.default_rng(abs(hash(name)) % (1 << 31))
    arrays = [m(rng) for m in makers]
    jsym, names = _sym(jmx, name, params, len(arrays))
    psym, _ = _sym(pmx, name, params, len(arrays))
    assert psym.list_arguments() == jsym.list_arguments()
    assert psym.list_outputs() == jsym.list_outputs()
    shapes = {n: a.shape for n, a in zip(names, arrays)}
    assert psym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    types = {n: np.float32 for n in names}
    assert psym.infer_type(**types) == jsym.infer_type(**types)
    # the JSON of each package loads in the other, to the same graph
    pj, jj = json.loads(psym.tojson()), json.loads(jsym.tojson())
    assert pj["nodes"] == jj["nodes"] and pj["heads"] == jj["heads"]
    back = pmx.sym.load_json(jsym.tojson())
    assert json.loads(back.tojson())["nodes"] == pj["nodes"]
    back = jmx.sym.load_json(psym.tojson())
    assert json.loads(back.tojson())["nodes"] == jj["nodes"]

    seed = len(name)
    if name == "Dropout":  # training draws bits of another generator
        want = _run_inference(jmx, jsym, names, arrays)
        got = _run_inference(pmx, psym, names, arrays)
        assert got[0].tobytes() == want[0].tobytes() == arrays[0].tobytes()
        return
    want = _run(jmx, jsym, names, arrays, grads, seed)
    got = _run(pmx, psym, names, arrays, grads, seed)
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape and g.dtype == w.dtype, (key, name)
            if exact:
                np.testing.assert_array_equal(g, w, err_msg=f"{key} {name}")
            else:
                np.testing.assert_allclose(g, w, **TOL,
                                           err_msg=f"{key} {name}")


def _run_inference(pkg, sym, names, arrays):
    exe = sym.simple_bind(pkg.cpu(), grad_req="null",
                          **{n: a.shape for n, a in zip(names, arrays)})
    exe.forward(is_train=False, **dict(zip(names, arrays)))
    return [o.asnumpy() for o in exe.outputs]


METHODS = [
    ("abs", (), {}), ("argmax", (), {"axis": 1}), ("argmin", (), {}),
    ("broadcast_to", ((2, 3, 4),), {}), ("expand_dims", (1,), {}),
    ("flatten", (), {}), ("max", (), {"axis": 0, "keepdims": True}),
    ("mean", (), {"axis": (0, 1)}), ("min", (), {}),
    ("slice", ((0, 1), (2, 4)), {}), ("slice_axis", (1, 1, 3), {}),
    ("to_device", None, {}), ("transpose", ((1, 0),), {}),
    ("wait_to_write", None, {}),
]


@pytest.mark.parametrize("method, args, kwargs", METHODS,
                         ids=[m[0] for m in METHODS])
def test_ndarray_methods_against_reference(method, args, kwargs):
    x = np.random.default_rng(5).uniform(-2, 2, (3, 4)).astype(np.float32)
    x[0, 1] = x[0, 3] = 3.0  # a tie for argmax
    got = []
    for pkg in (jmx, pmx):
        arr = pkg.nd.array(x, ctx=pkg.cpu())
        if args is None:
            res = getattr(arr, method)(*((pkg.cpu(),)
                                          if method == "to_device" else ()))
            res = arr if res is None else res
        else:
            res = getattr(arr, method)(*args, **kwargs)
        got.append(res.asnumpy())
    assert got[0].shape == got[1].shape and got[0].dtype == got[1].dtype
    np.testing.assert_allclose(got[1], got[0], **TOL)
