"""The redesigned ``l2norm_channel_bwd`` and ``softmax_output_bwd`` wrappers
on the CPU, where they take their plain versions: the backward's planner
exactly at each border of its regimes, the kernel's reduction order
modelled in torch against ``l2norm_channel_bwd_plain`` and against
``jax.vjp`` of the JAX package's ``_l2_normalization`` (channel) times the
scale; ``softmax_output_bwd``'s regime choice, its (row, class)
decomposition by magic numbers and the chunk walk checked exhaustively
against ``divmod`` over the index ranges each path reaches and at the
border of the 32-bit regime, the count's semantics, and the plain version
against the JAX package's ``_softmax_output`` VJP at the new edge shapes in
every normalization.

Inputs come from numpy with a seed. Tolerances: the L2 backward's model and
the plain version against each other and against ``jax.vjp`` within
``l2norm_channel.bwd_limit`` (``BWD_RTOL`` 1e-5 of the two terms'
magnitudes at each position plus ``BWD_ATOL`` 1e-6 of the largest value:
the channel sums run in other orders, and the terms cancel where ``g``
lies along ``x``). The decomposition is exact. ``softmax_output_bwd``: the
kernel's model equals the plain version bit for bit in every normalization
(the same float32 operations in the same order, each division correctly
rounded, the count exact below 2**24). The plain version against
``jax.vjp``: bit for bit under 'null' and 'valid', within 2**-23 relative
under 'batch'.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

from mxnet_tpu_torch.kernels import l2norm_channel as l2_mod
from mxnet_tpu_torch.kernels import softmax_output_bwd as sob_mod

EPS = 1e-10  # models/ssd.py's L2Normalization eps
ULP = 2.0 ** -23


# -- l2norm_channel_bwd: the planner ------------------------------------------
def test_bwd_plan_at_the_ssd_shape():
    assert l2_mod.bwd_plan(512) == ("onchip", 32)
    assert l2_mod.ONCHIP_C == 512 == l2_mod.SLICES * max(l2_mod.K_CHOICES)


@pytest.mark.parametrize("c, k", [
    (1, 1), (2, 1), (15, 1), (16, 1), (17, 2), (32, 2), (33, 4), (64, 4),
    (65, 8), (128, 8), (129, 16), (256, 16), (257, 32), (512, 32)])
def test_bwd_plan_at_each_k_border(c, k):
    """k the least compiled choice that covers C in 16 slices, each side of
    every border."""
    assert l2_mod.bwd_plan(c) == ("onchip", k)


@pytest.mark.parametrize("c", [513, 514, 1000, 2 * 512 + 3, 4096])
def test_bwd_plan_past_the_two_pass_border(c):
    """One channel past what 32 registers a thread hold, and beyond: the
    two-pass regime."""
    assert l2_mod.bwd_plan(c) == ("two_pass", 0)


# -- l2norm_channel_bwd: the kernel's order, modelled -------------------------
def _model(x, g, eps, scale):
    """The kernel's arithmetic in float32, one rounding per operation, in
    either regime: the thread of slice y sums x^2 and g*x over channels y,
    y + 16, y + 32, ... in order; the 16 partials are added in slice order;
    then the norm, the two coefficients and dx as
    ``l2norm_channel_bwd.cu`` writes them."""
    n, c = x.shape[:2]
    xs, gs = x.reshape(n, c, -1), g.reshape(n, c, -1)
    s = l2_mod.SLICES
    sxx = torch.zeros(n, s, xs.shape[2])
    sgx = torch.zeros(n, s, xs.shape[2])
    for j in range(-(-c // s)):
        ks = torch.arange(j * s, min(c, (j + 1) * s))
        m = len(ks)
        v, w = xs[:, ks], gs[:, ks]
        sxx[:, :m] = sxx[:, :m] + v * v
        sgx[:, :m] = sgx[:, :m] + w * v
    txx = torch.zeros(n, 1, xs.shape[2])
    tgx = torch.zeros(n, 1, xs.shape[2])
    for y in range(s):
        txx = txx + sxx[:, y:y + 1]
        tgx = tgx + sgx[:, y:y + 1]
    norm = torch.sqrt(txx + torch.tensor(eps, dtype=torch.float32))
    n3 = norm * norm * norm
    sc = torch.tensor(scale, dtype=torch.float32)
    coef = (sc * tgx) / n3
    gsc = sc / norm
    return (gsc * gs - xs * coef).reshape(x.shape)


def _jax_bwd(x, g, scale):
    jop = jreg.get("L2Normalization")
    jparams = jop.parse_params({"mode": "channel", "eps": EPS})

    def f(v):
        outs, _ = jop.apply([v], jparams, JOpMode(is_train=True))
        y = outs[0] if isinstance(outs, (list, tuple)) else outs
        return y * scale if scale != 1.0 else y

    _y, vjp = jax.vjp(f, jnp.asarray(x))
    return torch.from_numpy(np.array(vjp(jnp.asarray(g))[0]))


def _within_limit(got, want, x, g, scale):
    limit = l2_mod.bwd_limit(x, g, EPS, scale, want)
    excess = (got - want).abs() - limit
    assert bool((excess <= 0).all()), float(excess.max())


@pytest.mark.parametrize("shape", [(2, 512, 5, 7), (3, 513, 2, 3),
                                   (2, 21, 4, 4), (5, 1, 3, 3), (3, 17, 1, 1),
                                   (4, 3), (1, 1000, 1, 1), (2, 64, 37, 1)])
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_bwd_model_matches_plain_and_jax(shape, scale):
    """The kernel's order (both regimes') against the plain version and
    ``jax.vjp`` of ``_l2_normalization`` (channel) x ``scale``, at shapes
    of either regime; positions straddle images wherever H*W is no
    multiple of the block's 32 positions."""
    rng = np.random.default_rng(sum(shape) + int(scale))
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    got = _model(tx, tg, EPS, scale)
    plain = l2_mod.l2norm_channel_bwd_plain(tx, tg, EPS, scale)
    want = _jax_bwd(x, g, scale)
    _within_limit(got, plain, tx, tg, scale)
    _within_limit(got, want, tx, tg, scale)
    _within_limit(plain, want, tx, tg, scale)
    # the wrapper takes the plain version on the CPU and launches nothing
    before = l2_mod.BWD_LAUNCHES.value
    assert torch.equal(l2_mod.l2norm_channel_bwd(tx, tg, EPS, scale), plain)
    assert l2_mod.BWD_LAUNCHES.value == before


# -- softmax_output_bwd: the plan and the (row, class) decomposition ----------
def test_plan_regime_borders():
    m21 = sob_mod.magic(21)
    assert sob_mod.plan(259072, 21, 1, True) == ("rows", *m21)
    assert sob_mod.plan(1, sob_mod.INT32_MAX, 1, True).regime == "rows"
    assert sob_mod.plan(2, 2 ** 30, 1, True).regime == "general"
    assert sob_mod.plan(259072, 21, 1, False).regime == "general"
    assert sob_mod.plan(2, 5, 12, True).regime == "general"
    assert sob_mod.plan(4, 21, 1, True).magic == m21[0]


def _quotients(i, d):
    m, s = sob_mod.magic(d)
    assert 0 < m < 2 ** 32 and 0 <= s <= 31 and 2 ** s >= d
    return sob_mod.row_of(i, np.uint64(m), np.uint64(s))


@pytest.mark.parametrize("rows, classes", [(259072, 21), (32, 1000),
                                           (1024, 10000), (4097, 1),
                                           (777, 2), (513, 3)])
def test_magic_division_and_chunk_walk_exhaustively(rows, classes):
    """Every index of each layout: the magic division's quotient is divmod's;
    and the kernel's walk of each 16-byte chunk (the first element's row and
    class by the magic number, then the class counter wrapping into the next
    row) gives divmod's (row, class) for each of its four elements."""
    total = rows * classes
    for lo in range(0, total, 1 << 21):
        i = np.arange(lo, min(total, lo + (1 << 21)), dtype=np.uint64)
        assert np.array_equal(_quotients(i, classes), i // np.uint64(classes))
        first = i[i % 4 == 0]
        row = _quotients(first, classes)
        c = first - row * np.uint64(classes)
        for e in range(4):
            wrap = c == classes
            row, c = row + wrap, np.where(wrap, 0, c)
            idx = first + np.uint64(e)
            inside = idx < total
            want = np.divmod(idx[inside], np.uint64(classes))
            assert np.array_equal(row[inside], want[0])
            assert np.array_equal(c[inside], want[1])
            c = c + np.uint64(1)


@pytest.mark.parametrize("classes", [1, 2, 3, 7, 21, 1000, 10000, 2 ** 16,
                                     2 ** 16 + 1, 46341, 2 ** 31 - 1])
def test_magic_division_at_the_32_bit_border(classes):
    """The last 2**20 indices below 2**31 (and the first, and a stride
    through the whole range): the 32-bit multiply-high division holds up to
    INT32_MAX, the rows regime's last index."""
    top = sob_mod.INT32_MAX + 1
    for i in (np.arange(top - (1 << 20), top, dtype=np.uint64),
              np.arange(0, 1 << 20, dtype=np.uint64),
              np.arange(0, top, 4099, dtype=np.uint64)):
        assert np.array_equal(_quotients(i, classes), i // np.uint64(classes))


# -- softmax_output_bwd: the kernel's semantics, modelled ---------------------
def _kernel_model(p, label, grad_scale, ignore_label, use_ignore,
                  normalization, multi_output):
    """The kernel's arithmetic on the CPU: the integer count of valid labels
    (converted to float32 once), each step rounded once in the reference's
    order."""
    outer, classes, inner = sob_mod._view(p, multi_output)
    p3 = p.reshape(outer, classes, inner)
    lab = label.reshape(outer, 1, inner).to(torch.float32)
    cls = torch.arange(classes).reshape(1, classes, 1)
    inside = (lab > -2147483648.0) & (lab < 2147483648.0)
    onehot = (inside & (lab.to(torch.int64) == cls)).to(torch.float32)
    v = p3 - onehot
    ign = torch.tensor(ignore_label, dtype=torch.float32)
    count = outer * inner
    if use_ignore:
        valid = lab != ign
        v = v * valid.to(torch.float32)
        count = int(valid.sum())  # an integer, exact
    if normalization == "batch":
        v = v / torch.tensor(np.float32(p.shape[0]))
    elif normalization == "valid":
        v = v / torch.tensor(max(np.float32(count), np.float32(1)))
    return (v * torch.tensor(grad_scale, dtype=torch.float32)).reshape(
        p.shape)


def _edge_cases():
    """(name, p shape, multi_output, label rule): C = 1, odd outer counts,
    one row, SSD's class-major view, multi_output with inner > 1, every
    label ignored, labels out of range."""
    return [("c1", (7, 1), False, "random"),
            ("odd outer", (33, 21), False, "random"),
            ("one row", (1, 1000), False, "random"),
            ("power-of-2 outer", (32, 1000), False, "random"),
            ("class-major", (4, 21, 300), True, "ssd"),
            ("inner", (3, 5, 2, 7), True, "random"),
            ("all ignored", (9, 21), False, "ignored"),
            ("out of range", (6, 11), False, "wild")]


def _edge_inputs(shape, multi, rule, seed):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal(shape) * 3).astype(np.float32)
    classes = shape[1] if multi else shape[-1]
    lshape = (shape[0],) + shape[2:] if multi else shape[:-1]
    label = rng.integers(-1, classes, lshape).astype(np.float32)
    if rule == "ssd":
        label[rng.uniform(size=lshape) < 0.9] = -1
    elif rule == "ignored":
        label[...] = -1
    elif rule == "wild":
        label = rng.choice(np.asarray([-1, 0, 2.7, -0.5, 3e9, -3e9, 10, 11],
                                      np.float32), lshape)
    return data, label


NORMS = ["null", "batch", "valid"]


@pytest.mark.parametrize("case", range(len(_edge_cases())))
@pytest.mark.parametrize("normalization", NORMS)
@pytest.mark.parametrize("use_ignore", [True, False])
def test_kernel_model_matches_plain(case, normalization, use_ignore):
    name, shape, multi, rule = _edge_cases()[case]
    data, label = _edge_inputs(shape, multi, rule, case)
    p = torch.softmax(torch.from_numpy(data), 1 if multi else -1)
    if name == "class-major":
        p = p.transpose(1, 2).contiguous().transpose(1, 2)
    lab = torch.from_numpy(label)
    args = (0.5, -1.0, use_ignore, normalization, multi)
    got = _kernel_model(p, lab, *args)
    want = sob_mod.softmax_output_bwd_plain(p, lab, *args)
    assert torch.equal(got, want)
    before = sob_mod.LAUNCHES.value
    assert torch.equal(sob_mod.softmax_output_bwd(p, lab, *args), want)
    assert sob_mod.LAUNCHES.value == before


def test_count_all_ignored_divides_by_one():
    rng = np.random.default_rng(4)
    p = torch.softmax(torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)), -1)
    lab = torch.full((5,), 4.0)
    got = _kernel_model(p, lab, 2.0, 4.0, True, "valid", False)
    assert torch.equal(got, sob_mod.softmax_output_bwd_plain(
        p, lab, 2.0, 4.0, True, "valid", False))
    assert torch.equal(got, torch.zeros_like(p))


def test_count_is_an_exact_integer():
    """The kernel adds the blocks' counts in integers: exact at any size.
    Below 2**24 float32 holds it exactly, so the divisor is the plain
    version's float32 sum of ones; 2**24 + 1 is where float32 stops."""
    labels = 2 ** 24 + 1
    valid = np.ones(labels, np.bool_)
    valid[::3] = False
    blocks = np.array_split(valid, 528)  # one slot per block, any order
    slots = np.asarray([int(b.sum()) for b in blocks], np.uint32)
    count = int(slots.astype(np.uint64)[::-1].sum())
    assert count == int(valid.sum()) == labels - (-(-labels // 3))
    below = valid[:2 ** 24 - 5]
    assert float(np.float32(int(below.sum()))) == torch.from_numpy(
        below.astype(np.float32)).sum().item()
    assert int(np.float32(2 ** 24 + 1)) != 2 ** 24 + 1


# -- softmax_output_bwd_plain against the JAX package -------------------------
def _jax_vjp(data, label, raw):
    jop = jreg.get("SoftmaxOutput")
    params = jop.parse_params(raw)

    def f(d):
        outs, _ = jop.apply([d, jnp.asarray(label)], params,
                            JOpMode(is_train=True))
        return outs[0] if isinstance(outs, (list, tuple)) else outs

    out, vjp = jax.vjp(f, jnp.asarray(data))
    head = np.ones(out.shape, np.float32)
    return np.asarray(out), np.asarray(vjp(jnp.asarray(head))[0])


@pytest.mark.parametrize("case", range(len(_edge_cases())))
@pytest.mark.parametrize("normalization", NORMS)
def test_plain_matches_jax_at_the_edge_shapes(case, normalization):
    """The plain version on the JAX package's own probabilities against
    ``jax.vjp`` of ``_softmax_output``: use_ignore, grad_scale 0.5."""
    name, shape, multi, rule = _edge_cases()[case]
    data, label = _edge_inputs(shape, multi, rule, 100 + case)
    raw = {"normalization": normalization, "use_ignore": True,
           "ignore_label": -1.0, "grad_scale": 0.5, "multi_output": multi}
    out, want = _jax_vjp(data, label, raw)
    p = torch.from_numpy(out.copy())
    if name == "class-major":
        p = p.transpose(1, 2).contiguous().transpose(1, 2)
    got = sob_mod.softmax_output_bwd_plain(
        p, torch.from_numpy(label), 0.5, -1.0, True, normalization,
        multi).numpy()
    if normalization == "batch":
        np.testing.assert_allclose(got, want, rtol=ULP, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
