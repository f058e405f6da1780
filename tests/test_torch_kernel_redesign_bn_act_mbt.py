"""The redesigned ``bn_act`` and ``multibox_target`` wrappers on the CPU,
where they take their plain versions: ``bn_act``'s planner at every path
shape and regime border (each float4 or float unit and each plane covered
exactly once, the multiply-high divisions exact over every index the plan
reaches); ``multibox_target``'s cluster plan (each anchor taken by exactly
one thread of one block); both packed argument structs against the layout
each ``.cu`` states; ``bn_act_plain`` against the JAX package's
``_batch_norm`` followed by ``_leaky_relu`` or the ReLU; and
``multibox_target_plain`` against the JAX package's ``_multibox_target``
on the inputs where a cluster's split of an image could go wrong, with a
model of the kernel's cluster algorithm (block and cluster argmaxes, the
radix select over summed histograms, the index-order scan with the lower
ranks' counts) held to the plain version bit for bit.

Inputs come from numpy with a seed. Tolerances: ``bn_act_plain`` against
the reference rtol 1e-5 / atol 1e-6 (rsqrt and the division by a square
root differ by an ulp); ``chip_smoke.bn_act_parent_order`` (the kernel's
own order, which the card holds it to bit for bit) against ``bn_act_plain``
the same. ``multibox_target_plain`` against the reference: ``cls_target``
and ``loc_target_mask`` exact, ``loc_target`` rtol 1e-5 / atol 1e-6 (a
division or a log may round an ulp apart); the kernel's model against the
plain version exactly.
"""

import importlib.util
import math
import re
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.kernels import _lib
from mxnet_tpu_torch.kernels import bn_act as ba
from mxnet_tpu_torch.kernels import multibox_target as mbt
from mxnet_tpu_torch.kernels.nms import iou_matrix

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mxnet_tpu_torch" / "csrc"
BN_TOL = dict(rtol=1e-5, atol=1e-6)
LOC_TOL = dict(rtol=1e-5, atol=1e-6)


def _chip_smoke():
    """chip_smoke.py: the path shapes and edge inputs the card checks."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _resnet_train_shapes():
    _sym, shapes, _params = CS.resnet50_shapes(pmx, CS.TRAIN_BATCH)
    return sorted(set(shapes))


RESNET_TRAIN = _resnet_train_shapes()
SERVE = [s for s, _k in CS.PATH_BN]
PATH_SHAPES = sorted(set(RESNET_TRAIN + SERVE + CS.DCGAN_D_BN
                         + CS.DCGAN_G_BN))
ODD_SHAPES = [(32, 2048, 7, 7), (1, 3, 7, 7), (2, 3, 5, 5), (1, 5, 4, 4),
              (3, 7, 2, 2), (1, 1, 4), (4, 6), (1, 1)]


# -- bn_act: the planner -------------------------------------------------------
def _hw(shape):
    return math.prod(shape[2:])


def _units(p, shape):
    return math.prod(shape) // p.unit


def test_resnet_and_dcgan_path_shapes_are_the_paths_own():
    assert len(RESNET_TRAIN) == 12 and len(SERVE) == 5
    assert sum(k for _s, k in CS.PATH_BN) == 17
    assert len(CS.DCGAN_D_BN) == 3 and len(CS.DCGAN_G_BN) == 4


@pytest.mark.parametrize("shape", PATH_SHAPES + ODD_SHAPES)
def test_plan_regime_at_the_path_and_odd_shapes(shape):
    """float4 units wherever H*W is a multiple of 4 (every DCGAN shape and
    every ResNet-50 one but 7x7), float units otherwise and on views off
    the 16-byte alignment."""
    hw = _hw(shape)
    p = ba.plan(shape[0], shape[1], hw)
    assert p.regime == ("vec" if hw % 4 == 0 else "scalar")
    assert p.unit == (4 if p.regime == "vec" else 1)
    assert ba.plan(shape[0], shape[1], hw, aligned=False).regime == "scalar"


@pytest.mark.parametrize("shape", PATH_SHAPES + ODD_SHAPES)
def test_plan_covers_every_unit_and_plane_once(shape):
    """The kernel's mapping (unit ``q = (block * threads * UNITS + u *
    threads + t)`` for ``u < UNITS``, ``t < threads``) covers each unit
    exactly once, the last block partly; the magic divisions give each
    unit its plane and each plane its channel exactly as ``//`` and ``%``
    do, so each plane gets exactly H*W / unit units."""
    n, c, hw = shape[0], shape[1], _hw(shape)
    for aligned in (True, False):
        p = ba.plan(n, c, hw, aligned)
        units = _units(p, shape)
        per_block = p.threads * ba.UNITS
        assert p.threads in ba.THREADS
        assert (p.grid - 1) * per_block < units <= p.grid * per_block
        if units > 8_000_000:  # the float-unit plan of a 25.7 M tensor
            continue
        b, u, t = np.meshgrid(np.arange(p.grid, dtype=np.int64),
                              np.arange(ba.UNITS, dtype=np.int64),
                              np.arange(p.threads, dtype=np.int64),
                              indexing="ij")
        q = (b * per_block + u * p.threads + t).ravel()
        q = np.sort(q[q < units])
        np.testing.assert_array_equal(q, np.arange(units))
        d = hw // p.unit
        plane = _lib.quotient(q.astype(np.uint64), np.uint64(p.d_magic),
                            np.uint64(p.d_shift))
        np.testing.assert_array_equal(plane, q // d)
        np.testing.assert_array_equal(np.bincount(plane.astype(np.int64)),
                                      np.full(n * c, d))
        planes = np.arange(n * c, dtype=np.uint64)
        chan = planes - _lib.quotient(planes, np.uint64(p.c_magic),
                                    np.uint64(p.c_shift)) * np.uint64(c)
        np.testing.assert_array_equal(chan, np.arange(n * c) % c)


def test_plan_block_size_borders():
    """256 threads a block while that still gives MIN_BLOCKS blocks, then
    128, then 64; each side of both thresholds, in both regimes."""
    per = [t * ba.UNITS for t in ba.THREADS]
    edge256, edge128 = (ba.MIN_BLOCKS - 1) * per[0], (ba.MIN_BLOCKS - 1) * per[1]
    for units, threads in ((edge256 + 1, 256), (edge256, 128),
                           (edge128 + 1, 128), (edge128, 64), (1, 64)):
        assert ba.plan(1, 1, 4 * units).threads == threads
        assert ba.plan(1, units, 1).threads == threads
        assert ba.plan(1, units, 1).regime == "scalar"
    assert [b for b in CS.bn_act_borders(ba)
            if ba.plan(b[0], b[1], _hw(b)).threads == 256]


def test_plan_wide_past_32_bit_units():
    """2**31 units or more take the wide regime (64-bit indices); the
    vec regime holds up to INT32_MAX float4s."""
    assert ba.plan(1, 1, 4 * ba.INT32_MAX).regime == "vec"
    assert ba.plan(1, 1, 4 * ba.INT32_MAX + 4).regime == "wide"
    assert ba.plan(1, 1, ba.INT32_MAX).regime == "scalar"
    assert ba.plan(2, 1, ba.INT32_MAX).regime == "wide"


@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 12, 49, 64, 196, 784, 2048,
                               3136, 134144, 2 ** 31 - 1])
def test_magic_division_at_the_32_bit_border(d):
    m, s = _lib.magic(d)
    assert 0 < m < 2 ** 32
    top = 2 ** 31 - 1
    q = [0, 1, d - 1, d, d + 1, top - 1, top]
    q += list(range(max(0, top - 3 * d), top, max(1, d // 7)))[:5000]
    q = np.array([v for v in q if 0 <= v <= top], dtype=np.uint64)
    got = _lib.quotient(q, np.uint64(m), np.uint64(s))
    np.testing.assert_array_equal(got, q // np.uint64(d))


# -- multibox_target: the cluster plan ----------------------------------------
def _coverage(p, a):
    """Which anchors each (rank, thread, j) of the kernel takes."""
    seen = np.zeros(a, np.int64)
    for rank in range(mbt.CLUSTER):
        a0 = rank * p.span
        count = max(0, min(p.span, a - a0))
        for tid in range(mbt.THREADS):
            l0 = min(tid * p.apt, count)
            l1 = min(l0 + p.apt, count)
            seen[a0 + l0:a0 + l1] += 1
    return seen


@pytest.mark.parametrize("a, g", [(8096, 16), (1237, 33), (301, 6), (3, 1),
                                  (1, 1), (20000, 40), (5, 2), (2048, 4),
                                  (2049, 4), (4096, 8), (4097, 8)])
def test_mbt_plan_covers_every_anchor_once(a, g):
    """Each anchor taken by exactly one thread of one block, also on each
    side of the spans where a thread's share of anchors grows."""
    p = mbt.plan(a, g)
    assert p.span * mbt.CLUSTER >= a > (p.span - 1) * mbt.CLUSTER
    assert p.apt * mbt.THREADS >= p.span > (p.apt - 1) * mbt.THREADS
    assert p.smem == mbt.OBJECT_BYTES * g + mbt.ANCHOR_BYTES * p.span
    np.testing.assert_array_equal(_coverage(p, a), np.ones(a, np.int64))


def test_mbt_plan_at_ssd_training():
    """SSD-300's 8096 anchors in clusters of 2 blocks of 1024 threads:
    4048 anchors a block, four a thread, the shared memory past the
    default 48 KB (the kernel opts in) and well below the H100's."""
    p = mbt.plan(8096, 16)
    assert (mbt.CLUSTER, mbt.THREADS, p.span, p.apt) == (2, 1024, 4048, 4)
    assert 48 * 1024 < p.smem <= mbt.SMEM_LIMIT


def test_mbt_plan_with_the_last_block_short_or_empty():
    """A = 1237: blocks of 619 and 618 anchors; A = 3: of 2 and 1; A = 1:
    the last block has none, and still takes part in the cluster's
    barriers."""
    for a, counts in ((1237, [619, 618]), (3, [2, 1]), (1, [1, 0])):
        p = mbt.plan(a, 1)
        assert [max(0, min(p.span, a - r * p.span))
                for r in range(mbt.CLUSTER)] == counts
        np.testing.assert_array_equal(_coverage(p, a), np.ones(a, np.int64))


# -- the packed structs against each .cu --------------------------------------
def _c_fields(source, struct_name="Packed"):
    """The field names of ``struct_name`` in ``source`` in order, the
    struct format its comment states and its static_assert's count."""
    text = (CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct_name, text, re.S)[1]
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip() for n in
                      re.sub(r"^(unsigned long long|long long|double)\s+",
                             "", decl).split(",")]
    fmt = re.search(r'struct format "(=[^"]+)"', text)[1]
    count = int(re.search(r"sizeof\(%s\) == (\d+) \* 8" % struct_name,
                          text)[1])
    return names, fmt, count


class _Captured(Exception):
    pass


def _capture(monkeypatch, entry):
    """Run a wrapper's launch on CPU tensors up to ``launch_packed`` and
    return the struct bytes it would hand the C entry (stream 7)."""
    got = {}

    def launch_packed(t, fn, pack, *args):
        got["bytes"] = pack(*args, 7)
        raise _Captured

    class Lib:
        pass

    setattr(Lib, entry, None)
    monkeypatch.setattr(_lib, "launch_packed", launch_packed)
    monkeypatch.setattr(_lib, "library", lambda: Lib)
    return got


def test_bn_act_packed_struct_matches_the_source(monkeypatch):
    names, fmt, count = _c_fields("bn_act.cu")
    assert struct.calcsize(fmt) == 8 * count == 8 * len(names)
    assert fmt == ba._PACK.__self__.format
    got = _capture(monkeypatch, "mxt_bn_act_f32")
    x = torch.randn(2, 6, 4, 4)
    stats = [torch.randn(6) for _ in range(4)]
    p = ba.plan(2, 6, 16)
    with pytest.raises(_Captured):
        ba.run_plan(p, x, *stats, 1e-5, True, 0.2)
    f = dict(zip(names, struct.unpack(fmt, got["bytes"])))
    assert f["x"] == x.data_ptr() and f["mean"] == stats[0].data_ptr()
    assert f["beta"] == stats[3].data_ptr()
    assert (f["n"], f["c"], f["hw"]) == (2, 6, 16)
    assert f["eps"] == 1e-5 and f["fix_gamma"] == 1 and f["slope"] == 0.2
    assert f["regime"] == ba.REGIMES.index("vec")
    assert (f["threads"], f["grid"], f["d_magic"], f["d_shift"],
            f["c_magic"], f["c_shift"]) == (p.threads, p.grid, p.d_magic,
                                            p.d_shift, p.c_magic, p.c_shift)
    assert f["stream"] == 7 and names[-1] == "stream"
    with pytest.raises(_Captured):
        ba.run_plan(p, x, *stats, 1e-5, False, None)
    f = dict(zip(names, struct.unpack(fmt, got["bytes"])))
    assert f["slope"] == -1.0 and f["fix_gamma"] == 0


def test_mbt_packed_struct_matches_the_source(monkeypatch):
    names, fmt, count = _c_fields("multibox_target.cu")
    assert struct.calcsize(fmt) == 8 * count == 8 * len(names)
    assert fmt == mbt._PACK.__self__.format
    got = _capture(monkeypatch, "mxt_multibox_target_f32")
    anc, label, cls_pred, params = CS.mbt_case("random")
    ins = [torch.from_numpy(t) for t in (anc, label, cls_pred)]
    view = ins[2].transpose(1, 2).contiguous().transpose(1, 2)
    p = mbt.plan(300, 6)
    with pytest.raises(_Captured):
        mbt.run_plan(p, ins[0], ins[1], view, *CS.mbt_args(params))
    f = dict(zip(names, struct.unpack(fmt, got["bytes"])))
    assert f["anchors"] == ins[0].data_ptr() and f["bg"] == view.data_ptr()
    assert (f["n"], f["a"], f["g"], f["w"]) == (3, 300, 6, 5)
    assert (f["sn"], f["sa"]) == (view.stride(0), view.stride(2)) == \
        (1800, 6)
    assert (f["thr"], f["ignore"], f["ratio"], f["neg_thr"]) == \
        (0.5, -1.0, 3.0, 0.5)
    assert (f["v0"], f["v1"], f["v2"], f["v3"]) == (0.1, 0.1, 0.2, 0.2)
    assert (f["min_neg"], f["mining"]) == (0, 1)
    assert (f["span"], f["apt"], f["smem"]) == tuple(p)
    assert f["stream"] == 7 and names[-1] == "stream"


# -- bn_act_plain against the JAX package ---------------------------------------
def _jax_bn_act(x, mean, var, gamma, beta, eps, fix_gamma, slope):
    bn = jreg.get("BatchNorm")
    outs, _ = bn.apply([jnp.asarray(a) for a in (x, gamma, beta, mean, var)],
                       bn.parse_params({"eps": eps, "fix_gamma": fix_gamma}),
                       JOpMode(is_train=False))
    y = outs[0]
    if slope is None:
        return np.asarray(y)
    if slope == 0:
        return np.asarray(jax.nn.relu(y))
    act = jreg.get("LeakyReLU")
    outs, _ = act.apply([y], act.parse_params({"act_type": "leaky",
                                               "slope": slope}),
                        JOpMode(is_train=False))
    return np.asarray(outs[0])


def _bn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    x0 = x[:, 0].reshape(-1)  # exact zeros of both signs at channel 0
    x0[0::3] = 0.0
    x0[1::3] = -0.0
    x[:, 0] = x0.reshape(x[:, 0].shape)
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean[0], beta[0] = 0.0, -0.0
    return [x, mean, rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32), beta]


@pytest.mark.parametrize("shape", [(4, 16, 8, 8), (4, 32, 4, 4),
                                   (3, 8, 16, 16), (2, 5, 7, 7), (3, 6)])
@pytest.mark.parametrize("slope", [0.2, 0.0, None])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_bn_act_plain_matches_the_reference(shape, slope, fix_gamma):
    """DCGAN-like narrow shapes (and 7x7, rank 2): BatchNorm over given
    statistics, then LeakyReLU(slope), the ReLU, or nothing."""
    ins = _bn_inputs(shape, seed=sum(shape) + int(10 * (slope or 0)))
    want = _jax_bn_act(*ins, 1e-5 + 1e-12, fix_gamma, slope)
    t = [torch.from_numpy(a) for a in ins]
    before = ba.LAUNCHES.value
    got = ba.bn_act(*t, 1e-5 + 1e-12, fix_gamma, slope)
    np.testing.assert_allclose(got.numpy(), want, **BN_TOL)
    assert ba.LAUNCHES.value == before  # the plain version never counts
    # the kernel's own order, which the card holds it to bit for bit
    order = CS.bn_act_parent_order(torch, *t, 1e-5 + 1e-12, fix_gamma,
                                   slope).numpy()
    np.testing.assert_allclose(order, want, **BN_TOL)
    pre = CS.bn_act_parent_order(torch, *t, 1e-5 + 1e-12, fix_gamma,
                                 None).numpy()
    assert (pre == 0).any() and np.signbit(pre[pre == 0]).any()
    np.testing.assert_array_equal(np.signbit(order[pre == 0]),
                                  np.signbit(pre[pre == 0]))
    if slope == 0:  # the ReLU: +0.0 below 0
        assert (order[pre < 0] == 0).all()
        assert not np.signbit(order[pre < 0]).any()


def test_parent_order_rounds_the_square_root_and_division_once():
    """The reference's ``1 / sqrt(var + eps)`` is the correctly rounded
    float32 square root, then the correctly rounded quotient, over a
    million variances (PyTorch's own float32 square root on the CPU is off
    by an ulp for some of them, so the kernel would not match it)."""
    rng = np.random.default_rng(7)
    var = torch.from_numpy(rng.uniform(0.5, 1.5, 1 << 20).astype(np.float32))
    x = torch.ones(1, var.numel())
    zero = torch.zeros_like(var)
    inv = CS.bn_act_parent_order(torch, x, zero, var, torch.ones_like(var),
                                 zero, 2e-5, False, None)[0]
    v = (var + np.float32(2e-5)).numpy().astype(np.float64)
    root = np.sqrt(v).astype(np.float32)
    want = (1.0 / root.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(inv.numpy(), want)


def test_parent_order_keeps_signed_zeros_and_the_relu_zero():
    """-0.0 pre-activations stay -0.0 under every activation; a negative
    one gives +0.0 under the ReLU and slope * t under the leaky ReLU."""
    x = torch.tensor([0.0, -0.0, -2.0, 3.0]).reshape(1, 1, 4)
    z, o, mz = torch.zeros(1), torch.ones(1), torch.tensor([-0.0])
    for slope, low in ((None, -2.0), (0.0, 0.0), (0.5, -1.0)):
        y = CS.bn_act_parent_order(torch, x, z, o, o, mz, 0.0, False,
                                   slope)[0, 0].numpy()
        assert y.tolist() == [0.0, -0.0, low, 3.0]
        assert np.signbit(y).tolist() == [False, True, low < 0, False]


# -- multibox_target_plain against the JAX package ----------------------------
def _targets_both(anc, label, cls_pred, raw):
    jop = jreg.get("MultiBoxTarget")
    jouts, _ = jop.apply([jnp.asarray(anc), jnp.asarray(label),
                          jnp.asarray(cls_pred)], jop.parse_params(raw),
                         JOpMode(is_train=True))
    ins = [torch.from_numpy(t.copy()) for t in (anc, label, cls_pred)]
    got = mbt.multibox_target_plain(*ins, *CS.mbt_args(raw))
    return [np.asarray(o) for o in jouts], [o.numpy() for o in got]


@pytest.mark.parametrize("name", CS.MBT_EDGES + (
    "a padded row after an object whose best anchor is anchor 0",
    "mining off"))
@pytest.mark.parametrize("mining", [True, False])
def test_mbt_plain_matches_the_reference_at_the_cluster_edges(name, mining):
    case = CS.mbt_edge_case if name in CS.MBT_EDGES else CS.mbt_case
    anc, label, cls_pred, raw = case(name)
    raw = dict(raw, negative_mining_ratio=3.0 if mining else -1.0) \
        if (raw["negative_mining_ratio"] > 0) != mining else raw
    (jl, jm, jc), (pl, pm, pc) = _targets_both(anc, label, cls_pred, raw)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, **LOC_TOL)
    assert (jc > 0).any(), "no matched anchor: the case tests nothing"


def _plain(name):
    anc, label, cls_pred, raw = CS.mbt_edge_case(name)
    got = mbt.multibox_target_plain(
        *(torch.from_numpy(t) for t in (anc, label, cls_pred)),
        *CS.mbt_args(raw))
    return anc, label, cls_pred, raw, got[2].numpy()


def test_mbt_edge_cases_reach_their_edges():
    """The ties at K* (0.0 and -0.0 keys) straddle the blocks' borders with
    some of them dropped; an object's best anchor lies in the last block;
    max_neg is 0 in every image, then A or more; G = 1 with A = 1 leaves
    the second block empty; A = 1237 with G = 33 takes three sweeps."""
    _a, _l, cls_pred, _r, cls_t = _plain(CS.MBT_EDGES[0])
    span = mbt.plan(301, 6).span
    bg = cls_pred[:, 0, :]
    crossing = False
    for b in range(cls_t.shape[0]):
        zero = bg[b] == 0
        kept = np.nonzero(zero & (cls_t[b] == 0))[0]
        dropped = np.nonzero(zero & (cls_t[b] == -1))[0]
        crossing |= bool(len(kept) and len(dropped) and kept.max() >= span
                         and np.signbit(bg[b][kept]).any()
                         and (~np.signbit(bg[b][kept])).any())
    assert crossing
    anc, label, _c, _r, cls_t = _plain(CS.MBT_EDGES[1])
    assert cls_t[0, 298] > 0 and cls_t[1, 299] > 0
    assert 298 >= (mbt.CLUSTER - 1) * mbt.plan(300, 4).span
    *_x, cls_t = _plain(CS.MBT_EDGES[2])
    assert not (cls_t == 0).any() and (cls_t == -1).any()
    *_x, cls_t = _plain(CS.MBT_EDGES[3])
    assert not (cls_t == -1).any() and (cls_t == 0).any()
    anc, label, *_x = _plain(CS.MBT_EDGES[4])
    assert anc.shape[1] == 1 and label.shape[1] == 1
    assert mbt.plan(1, 1).span * (mbt.CLUSTER - 1) >= anc.shape[1]
    anc, label, *_x = _plain(CS.MBT_EDGES[5])
    assert anc.shape[1] % mbt.plan(1237, 33).span and label.shape[1] > 32
    # the forced candidates: anchor 0 is the corner object's best anchor,
    # matched, though its best IoU is below the mining threshold; in the
    # first image of the first case every candidate is kept (K* is +inf),
    # in the second case K* is 0.0's key, anchor 0's too
    for name in CS.MBT_EDGES[6:]:
        anc, label, cls_pred, raw, cls_t = _plain(name)
        assert (cls_t[:, 0] > 0).all()
        iou = iou_matrix(torch.from_numpy(anc[0]),
                         torch.from_numpy(label[0, :, 1:5])).numpy()
        assert iou[0].max() < raw["negative_mining_thresh"]
    *_x, cls_t = _plain(CS.MBT_EDGES[6])
    assert not (cls_t[0] == -1).any() or (cls_t[0] == 0).sum() > 200
    anc, label, cls_pred, raw, cls_t = _plain(CS.MBT_EDGES[7])
    assert (cls_pred[:, 0, 0] == 0).all()


# -- the kernel's cluster algorithm, modelled ---------------------------------
def _ordered_key(v):
    u = v.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _model_cls_target(anc, label, cls_pred, raw, cluster):
    """``cls_target`` as ``multibox_target.cu`` reaches it with ``cluster``
    blocks an image. Column maxima per block, then across the ranks (first
    index on ties); each anchor's mining key computed before the forced
    matches are known, and every block correcting for them afterwards from
    the forced anchors alone (each the last object row's choice): each
    byte of K* from the blocks' histograms of those keys, added, with each
    forced candidate moved to +inf; the ties at K* kept in index order
    from the lower ranks' count (their last histograms' bin, corrected the
    same way). The IoUs are the plain version's (the same arithmetic)."""
    inf = np.uint32(0xFF800000)
    a = anc.shape[1]
    n, g = label.shape[:2]
    span = -(-a // cluster)
    owner = np.arange(a) // span
    f32 = np.float32
    thr, neg_thr = f32(raw["overlap_threshold"]), \
        f32(raw["negative_mining_thresh"])
    mining = raw["negative_mining_ratio"] > 0
    out = np.empty((n, a), f32)
    for b in range(n):
        valid = label[b, :, 0] >= 0
        iou = iou_matrix(torch.from_numpy(anc[0]),
                         torch.from_numpy(label[b, :, 1:5])).numpy()
        iou = np.where(valid[None, :], iou, f32(-1))
        best_anc = np.zeros(g, np.int64)
        for j in range(g):
            if not valid[j]:
                continue
            parts = []
            for r in range(cluster):
                col = iou[r * span:min(a, (r + 1) * span), j]
                if len(col):
                    i = int(np.argmax(col))
                    parts.append((col[i], r * span + i))
            best_anc[j] = max(parts, key=lambda p: (p[0], -p[1]))[1]
        best_g = np.argmax(iou, 1)
        best = iou[np.arange(a), best_g]
        thr_m = best >= thr
        stale_cand = ~thr_m & (best < neg_thr)
        key = np.where(stale_cand & mining,
                       _ordered_key(cls_pred[b, 0].copy()), inf)
        # the forced anchors, each by the last object row that chose it
        forced = np.zeros(a, bool)
        fk = []  # (anchor, the key it had) of each forced candidate
        num_pos = int(thr_m.sum())
        for j in range(g):
            an = best_anc[j]
            if valid[j] and not (best_anc[j + 1:] == an).any():
                forced[an] = True
                if not thr_m[an]:
                    num_pos += 1
                    if mining and stale_cand[an]:
                        fk.append((an, key[an]))
        matched = forced | thr_m
        mg = best_g.copy()
        for an in np.nonzero(forced)[0]:
            hits = [j for j in range(g) if best_anc[j] == an and valid[j]]
            vals = (iou[an, hits] + f32(2)).astype(f32)
            mg[an] = hits[int(np.argmax(vals))]
        cls = np.where(matched, label[b, mg, 0] + f32(1), f32(0))
        if mining:
            cand = ~matched & (best < neg_thr)
            true_key = np.where(forced, inf, key)
            max_neg = max(int(f32(raw["negative_mining_ratio"])
                              * f32(num_pos)),
                          raw["minimum_negative_samples"])
            keep = np.zeros(a, bool)
            if max_neg >= a:
                keep = cand.copy()
            elif max_neg > 0:
                # each byte of K* from the blocks' histograms of the keys
                # computed before the forced matches, added, with each
                # forced candidate moved to +inf
                blocks = [key[s_ * span:min(a, (s_ + 1) * span)]
                          for s_ in range(cluster)]
                prefix, pmask, r = 0, 0, max_neg - 1
                for shift in (24, 16, 8, 0):
                    last = [np.bincount((ks[(ks & np.uint32(pmask))
                                            == prefix] >> shift) & 255,
                                        minlength=256) for ks in blocks]
                    hist = sum(last)
                    for _an, k0 in fk:
                        for kk, d in ((k0, -1), (inf, 1)):
                            if kk & np.uint32(pmask) == prefix:
                                hist[(kk >> shift) & 255] += d
                    cum = np.cumsum(hist)
                    d = int(np.searchsorted(cum, r, side="right"))
                    r -= int(cum[d - 1]) if d else 0
                    prefix |= d << shift
                    pmask |= 255 << shift
                take, kstar = r + 1, np.uint32(prefix)
                for rk in range(cluster):
                    lo, hi = rk * span, min(a, (rk + 1) * span)
                    at = sum(int(h_[kstar & 255]) for h_ in last[:rk])
                    for an, k0 in fk:
                        if owner[an] < rk:
                            at += int(kstar == inf) - int(k0 == kstar)
                    assert at == int((true_key[:lo] == kstar).sum())
                    for an in range(lo, hi):
                        keep[an] = cand[an] and (
                            true_key[an] < kstar or (true_key[an] == kstar
                                                     and at < take))
                        at += true_key[an] == kstar
            cls = np.where(matched, cls,
                           np.where(keep, f32(0), f32(raw["ignore_label"])))
        out[b] = cls
    return out


@pytest.mark.parametrize("name", CS.MBT_CASES + CS.MBT_EDGES)
def test_the_cluster_model_matches_the_plain_version(name):
    case = (CS.mbt_case if name in CS.MBT_CASES else CS.mbt_edge_case)(name)
    anc, label, cls_pred, raw = case
    want = mbt.multibox_target_plain(
        *(torch.from_numpy(t) for t in (anc, label, cls_pred)),
        *CS.mbt_args(raw))[2].numpy()
    got = _model_cls_target(anc, label, cls_pred, raw, mbt.CLUSTER)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
