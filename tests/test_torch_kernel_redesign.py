"""The redesigned ``softmax_rows`` and ``sgd_mom_multi``, held against the
JAX package on the CPU, where the kernel wrappers take their plain
versions.

Inputs come from numpy with a seed. Tolerances, float32 on both sides:
the row softmax 1e-6 absolute and 1e-5 of each probability (the sum runs
in another order; at wide rows most probabilities lie far below 1e-6), SoftmaxOutput's forward and backward rtol 1e-6 / atol 1e-6, the
SGD updates rtol 1e-6 / atol 1e-6 per step (the same operations in the
same order; the tolerance absorbs XLA:CPU's fusion). The launch packing of
``sgd_mom_multi`` is a pure function of the sizes and is checked exactly,
its byte layout against a ``ctypes`` mirror of the C ``Pack``.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import sgd_mom_multi as sgd_mod
from mxnet_tpu_torch.kernels import softmax_rows as sm_mod
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.registry import OpMode as POpMode

SM_ATOL, SM_RTOL = 1e-6, 1e-5
EXACT = dict(rtol=1e-6, atol=1e-6)
# each side of the kernel's regime borders: narrow <= 32 < middle <= 4096
# < wide
BORDER_COLS = [1, 2, 21, 31, 32, 33, 1000, 4096, 4097, 10000]


@pytest.mark.parametrize("cols", BORDER_COLS)
def test_softmax_rows_plain_matches_jax_at_the_regime_borders(cols):
    x = (np.random.default_rng(cols).standard_normal((3, cols)) * 4).astype(
        np.float32)
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    before = sm_mod.LAUNCHES.value
    got = sm_mod.softmax_rows(torch.from_numpy(x))
    assert sm_mod.LAUNCHES.value == before  # the plain version
    plain = sm_mod.softmax_rows_plain(torch.from_numpy(x)).numpy()
    for y in (got.numpy(), plain):
        np.testing.assert_allclose(y, want, rtol=0, atol=SM_ATOL)
        np.testing.assert_allclose(y, want, rtol=SM_RTOL, atol=1e-30)


@pytest.mark.parametrize("a", [5, 37])
def test_softmax_output_on_the_ssd_class_major_view(a, monkeypatch):
    """SSD's head: SoftmaxOutput(multi_output, use_ignore, valid) over the
    (N, 21, A) transposed view of class-last logits, forward and backward
    against ``jax.vjp``. The rows reach ``softmax_rows`` as the logits'
    own storage, with no copy."""
    rng = np.random.default_rng(a)
    n, c = 2, 21
    logits = (rng.standard_normal((n, a, c)) * 3).astype(np.float32)
    label = rng.integers(0, c, (n, a)).astype(np.float32)
    label[rng.uniform(size=label.shape) < 0.5] = -1.0
    head = rng.standard_normal((n, c, a)).astype(np.float32)
    raw = {"multi_output": True, "use_ignore": True, "ignore_label": -1,
           "normalization": "valid"}
    jop, pop = jreg.get("SoftmaxOutput"), preg.get("SoftmaxOutput")

    def jfn(v):
        return jop.apply([v, jnp.asarray(label)], jop.parse_params(raw),
                         JOpMode(is_train=True))[0][0]

    jout, vjp = jax.vjp(jfn, jnp.asarray(logits.transpose(0, 2, 1)))
    jgrad = np.asarray(vjp(jnp.asarray(head))[0])

    seen = []
    rows_fn = sm_mod.softmax_rows

    def recording(x):
        seen.append(x)
        return rows_fn(x)

    monkeypatch.setattr(sm_mod, "softmax_rows", recording)
    t = torch.from_numpy(logits).requires_grad_(True)
    view = t.transpose(1, 2)
    out = pop.apply([view, torch.from_numpy(label)], pop.parse_params(raw),
                    POpMode(is_train=True))[0][0]
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(head))
    assert len(seen) == 1 and tuple(seen[0].shape) == (n * a, c)
    assert seen[0].data_ptr() == t.data_ptr()  # no copy on the way in
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **EXACT)
    np.testing.assert_allclose(grad.numpy().transpose(0, 2, 1), jgrad,
                               **EXACT)


# -- the launch packing of sgd_mom_multi -------------------------------------
def _mirror(cap):
    """A ctypes mirror of the C ``Pack`` of ``cap`` entries
    (csrc/sgd_mom_multi.cu)."""
    class Pack(ctypes.Structure):
        _fields_ = [("p0", ctypes.c_longlong * cap),
                    ("p1", ctypes.c_longlong * cap),
                    ("p2", ctypes.c_longlong * cap),
                    ("numel", ctypes.c_longlong * cap),
                    ("lr", ctypes.c_float * cap),
                    ("wd", ctypes.c_float * cap),
                    ("first", ctypes.c_int * (cap + 1)),
                    ("n_update", ctypes.c_int),
                    ("n_entries", ctypes.c_int)]
    return Pack


@pytest.mark.parametrize("cap", [16, sgd_mod.CAP])
def test_pack_layout_matches_a_mirror_of_the_c_struct(cap):
    offsets, nbytes = sgd_mod.pack_layout(cap)
    mirror = _mirror(cap)
    assert nbytes == ctypes.sizeof(mirror)
    assert offsets == {"ptrs": mirror.p0.offset, "hyper": mirror.lr.offset,
                       "ints": mirror.first.offset}
    assert nbytes <= 32764 - 64  # CUDA's launch-parameter limit


def test_pack_fills_the_fields_the_kernel_reads():
    """A built pack, read back through the C layout: the entries, the
    cumulative chunk counts and the update/restore split."""
    first = [0, 1, 1, 3]
    pk = sgd_mod._Pack(0, 3, first, 2)
    pk.ptrs[0, :3] = [11, 12, 13]
    pk.ptrs[3, :3] = [5, 0, 4097]
    pk.hyper[0, :2] = [0.1, 0.2]
    c = _mirror(sgd_mod.CAP).from_buffer(pk.buf)
    assert list(c.p0[:3]) == [11, 12, 13]
    assert list(c.numel[:3]) == [5, 0, 4097]
    assert list(c.first[:4]) == first
    assert (c.n_update, c.n_entries) == (2, 3)
    assert c.lr[1] == np.float32(0.2)
    assert pk.address == ctypes.addressof(c)


@pytest.mark.parametrize("n, cap, launches", [
    (1, sgd_mod.CAP, 1), (16, 16, 1), (17, 16, 2),
    (155, sgd_mod.CAP, 1), (320, sgd_mod.CAP, 1), (321, sgd_mod.CAP, 2),
    (261, sgd_mod.CAP, 1), (700, sgd_mod.CAP, 3),
])
def test_plan_launches_splits_under_the_parameter_limit(n, cap, launches):
    rng = np.random.default_rng(n)
    sizes = list(rng.integers(0, 100000, n))
    plans = sgd_mod.plan_launches(sizes, n, cap)
    assert len(plans) == launches
    assert [p[:2] for p in plans] == [
        (lo, min(lo + cap, n)) for lo in range(0, n, cap)]
    for lo, hi, first in plans:
        assert hi - lo <= cap and len(first) == hi - lo + 1
        assert first[0] == 0
        assert all(b - a == -(-int(s) // sgd_mod.CHUNK)
                   for a, b, s in zip(first, first[1:], sizes[lo:hi]))


def test_plan_launches_counts_chunks_of_sizes_no_multiple_of_4():
    chunk = sgd_mod.CHUNK
    sizes = [1, 3, 5, chunk - 1, chunk, chunk + 1, 2 * chunk + 3, 0, 7]
    ((lo, hi, first),) = sgd_mod.plan_launches(sizes, 6, chunk=chunk)
    assert (lo, hi) == (0, 9)
    assert first == [0, 1, 2, 3, 4, 5, 7, 10, 10, 11]
    # every chunk of every entry is found once by the kernel's search (the
    # last entry whose first chunk is at or before it)
    owner = [max(e for e in range(len(sizes)) if first[e] <= c)
             for c in range(first[-1])]
    assert owner == [0, 1, 2, 3, 4, 5, 5, 6, 6, 6, 8]


def test_the_cpu_path_packs_and_launches_nothing():
    """On CPU tensors the wrapper takes the plain version: no pack, no
    launch."""
    ws = [torch.ones(5), torch.ones(7)]
    before = (sgd_mod.LAUNCHES.value, sgd_mod.PACK_BUILDS.value)
    cache = {}
    sgd_mod.sgd_mom_multi(ws, [torch.ones(5), torch.ones(7)],
                          [torch.zeros(5), torch.zeros(7)], [0.1, 0.1],
                          [0.0, 0.0], 0.9, 1.0, -1.0, cache=cache)
    assert (sgd_mod.LAUNCHES.value, sgd_mod.PACK_BUILDS.value) == before
    assert cache == {}
    np.testing.assert_allclose(ws[0].numpy(), 0.9)


def test_gradients_must_have_their_weights_shape():
    """A gradient of its weight's size but another shape (``(5, 3)`` for a
    ``(3, 5)`` weight) is refused, as the plain version refuses it; the
    weights' own shapes pass."""
    dev = torch.device("cpu")
    shapes = [torch.Size([3, 5]), torch.Size([7])]
    sgd_mod._check_grads([torch.ones(3, 5), torch.ones(7)], dev, shapes)
    with pytest.raises(MXNetError, match="grads\\[0\\]"):
        sgd_mod._check_grads([torch.ones(5, 3), torch.ones(7)], dev, shapes)
    with pytest.raises(MXNetError, match="grads\\[1\\]"):
        sgd_mod._check_grads([torch.ones(3, 5), torch.ones(1, 7)], dev,
                             shapes)


# -- the single-tensor ops through the registry ------------------------------
@pytest.mark.parametrize("op, kwargs", [
    ("sgd_update", {"lr": 0.1, "wd": 1e-4, "rescale_grad": 1 / 32}),
    ("sgd_update", {"lr": 0.05, "wd": 0.0, "clip_gradient": 0.01}),
    ("sgd_mom_update", {"lr": 0.1, "momentum": 0.9, "wd": 1e-4,
                        "rescale_grad": 1 / 32}),
    ("sgd_mom_update", {"lr": 0.05, "momentum": 0.9, "wd": 1e-3,
                        "clip_gradient": 0.02}),
])
def test_sgd_ops_match_jax_over_several_steps(op, kwargs):
    """Five steps of ``nd.<op>(..., out=weight)`` (the registry's op, the
    multi-tensor kernel's plain version over one parameter) against the
    JAX op, each step from its own gradient; sizes that are no multiple of
    4."""
    rng = np.random.default_rng(len(op) + len(kwargs))
    w = rng.standard_normal((7, 13)).astype(np.float32)
    m = (rng.standard_normal((7, 13)) * 0.1).astype(np.float32)
    momentum = op == "sgd_mom_update"
    cpu = pmx.cpu()
    jw, jm = jmx.nd.array(w), jmx.nd.array(m)
    pw, pm = pmx.nd.array(w, ctx=cpu), pmx.nd.array(m, ctx=cpu)
    assert preg.get(op) is not None
    for step in range(5):
        g = (rng.standard_normal((7, 13)) * (step + 1)).astype(np.float32)
        jargs = (jw, jmx.nd.array(g)) + ((jm,) if momentum else ())
        pargs = (pw, pmx.nd.array(g, ctx=cpu)) + ((pm,) if momentum else ())
        getattr(jmx.nd, op)(*jargs, out=jw, **kwargs)
        getattr(pmx.nd, op)(*pargs, out=pw, **kwargs)
        np.testing.assert_allclose(pw.asnumpy(), jw.asnumpy(), **EXACT)
        if momentum:
            np.testing.assert_allclose(pm.asnumpy(), jm.asnumpy(), **EXACT)
