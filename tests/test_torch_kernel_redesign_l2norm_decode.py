"""The redesigned ``l2norm_channel`` and ``multibox_decode`` wrappers on the
CPU, where they take their plain versions: both plain versions against the
live JAX package (``_l2_normalization`` in mode ``channel`` times the
scale; ``jax.nn.softmax``, ``_decode_boxes`` and the foreground
``argmax``/``max`` of ``_multibox_detection``); ``chip_smoke``'s model of
the forward kernel's order of rounding (which the card holds the kernel to
bit for bit) against the plain version, and its square root and quotient
each rounded once, checked in exact rational arithmetic; both planners at
their borders, each position or anchor covered exactly once; both packed
argument structs against the layout each ``.cu`` states; the decode's
choice of body for each stride pattern and its outputs as views of one
allocation; that ``chip_smoke``'s edge inputs reach their edges; and NaN
wherever a position's norm is NaN or 0, as the reference gives it.

Inputs come from numpy with a seed. Tolerances: the normalization within
``chip_smoke.L2_RTOL`` 1e-5 relative and ``L2_ATOL`` 1e-6 times the scale
(the channel sums run in other orders); the decode's scores and boxes
within ``DECODE_RTOL`` 1e-6 / ``DECODE_ATOL`` 1e-7, class ids exact
wherever the two best probabilities are further apart than that (the
softmax's sum and ``exp`` may round an ulp apart). Planners, structs and
layouts are exact.
"""

import importlib.util
import math
import re
import struct
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import defs_contrib as jcontrib
from mxnet_tpu.ops import defs_nn as jnn

from mxnet_tpu_torch.kernels import _lib
from mxnet_tpu_torch.kernels import l2norm_channel as l2
from mxnet_tpu_torch.kernels import multibox_decode as dec

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mxnet_tpu_torch" / "csrc"
EPS = 1e-10  # models/ssd.py's L2Normalization eps
VAR = (0.1, 0.1, 0.2, 0.2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(scope="module", autouse=True)
def _jax_ready():
    """Start JAX's CPU backend once, outside the tests' own time."""
    jnp.zeros(1).block_until_ready()


def _randn(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _l2_close(got, want, scale):
    torch.testing.assert_close(got, want, rtol=CS.L2_RTOL,
                               atol=CS.L2_ATOL * scale)


# -- the plain versions against the JAX package ----------------------------
@pytest.mark.parametrize("shape", [(2, 512, 3, 5), (3, 1, 4, 4),
                                   (2, 3, 5, 7), (2, 513, 2, 3)])
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_l2norm_plain_matches_the_reference(shape, scale):
    x = _randn(shape, sum(shape))
    want = jnn._l2_normalization([jnp.asarray(x)],
                                 {"eps": EPS, "mode": "channel"}, None)
    want = np.array(want * scale if scale != 1.0 else want)
    got = l2.l2norm_channel_plain(torch.from_numpy(x), EPS, scale)
    _l2_close(got, torch.from_numpy(want), scale)


def _decode_inputs(seed, n=2, c1=21, a=300):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1.5, (n, a, c1)).astype(np.float32)
    loc = rng.normal(0, 1, (n, 4 * a)).astype(np.float32)
    lo = rng.uniform(0, 0.8, (1, a, 2))
    anchors = np.concatenate(
        [lo, lo + rng.uniform(0.02, 0.5, (1, a, 2))], 2).astype(np.float32)
    return logits, loc, anchors


def _reference_decode(cls, loc, anchors, clip, softmax):
    """The JAX package's per-anchor steps on (n, C+1, A) scores."""
    prob = jax.nn.softmax(jnp.asarray(cls), axis=1) if softmax else \
        jnp.asarray(cls)
    fg = prob[:, 1:]
    a = cls.shape[2]
    boxes = np.stack([np.asarray(jcontrib._decode_boxes(
        jnp.asarray(loc[b].reshape(a, 4)), jnp.asarray(anchors[0]), VAR,
        clip)) for b in range(cls.shape[0])])
    return (boxes, np.asarray(jnp.max(fg, axis=1)),
            np.asarray(jnp.argmax(fg, axis=1)), np.asarray(fg))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("view", ["transposed", "class-major"])
def test_decode_plain_matches_the_reference(clip, softmax, view):
    logits, loc, anchors = _decode_inputs(7 + clip + 2 * softmax)
    cls_t = torch.from_numpy(logits).transpose(1, 2)  # the SSD paths' view
    if not softmax:
        cls_t = dec.channel_softmax(cls_t)
    if view == "class-major":
        cls_t = cls_t.contiguous()
    cls = cls_t.numpy()
    boxes, score, cls_id = dec.multibox_decode_plain(
        cls_t, torch.from_numpy(loc), torch.from_numpy(anchors), VAR, clip,
        softmax)
    w_boxes, w_score, w_id, fg = _reference_decode(cls, loc, anchors, clip,
                                                   softmax)
    tol = dict(rtol=CS.DECODE_RTOL, atol=CS.DECODE_ATOL)
    np.testing.assert_allclose(score.numpy(), w_score, **tol)
    np.testing.assert_allclose(boxes.numpy(), w_boxes, **tol)
    top2 = np.sort(fg, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > CS.DECODE_RTOL * top2[:, 1] + \
        CS.DECODE_ATOL
    assert clear.mean() > 0.99 and cls_id.dtype == torch.int32
    np.testing.assert_array_equal(cls_id.numpy()[clear], w_id[clear])


@pytest.mark.parametrize("case", range(2))
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_l2norm_gives_nan_where_the_reference_does(case, scale):
    """``chip_smoke.l2_nan_edges`` (a NaN among zeros, a column of zeros at
    eps 0; on chip and in two passes): the reference, the plain version and
    ``chip_smoke.l2norm_order`` give NaN in every channel of both positions
    and nowhere else, and agree within the limits elsewhere."""
    gen = torch.Generator().manual_seed(31 + case)
    what, x, eps = CS.l2_nan_edges(torch, gen, torch.device("cpu"))[case]
    assert l2.plan(x.shape[1]).regime == ("onchip", "two_pass")[case]
    want = jnn._l2_normalization([jnp.asarray(x.numpy())],
                                 {"eps": eps, "mode": "channel"}, None)
    want = torch.from_numpy(np.array(want * scale if scale != 1.0 else want))
    nan = torch.zeros(x.shape, dtype=torch.bool)
    nan[0, :, 1, 2] = nan[1, :, 2, 4] = True
    for got in (l2.l2norm_channel_plain(x, eps, scale),
                CS.l2norm_order(torch, x, eps, scale), want):
        assert torch.equal(torch.isnan(got), nan), what
        _l2_close(got[~nan], want[~nan], scale)


# -- the forward kernel's order of rounding, modelled ------------------------
@pytest.mark.parametrize("shape", [(2, 512, 3, 5), (3, 1, 5, 7),
                                   (4, 17, 3, 3), (2, 513, 2, 3), (5, 3),
                                   (1, 1000, 1, 1)])
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_order_model_within_the_limits_of_the_plain_version(shape, scale):
    x = torch.from_numpy(_randn(shape, 3 * sum(shape), 2.0))
    _l2_close(CS.l2norm_order(torch, x, EPS, scale),
              l2.l2norm_channel_plain(x, EPS, scale), scale)


def _half_ulp(v):
    """Half the gap between float32 ``v`` and its next float32 up."""
    v = np.float32(v)
    return Fraction((np.nextafter(v, np.float32(np.inf)) - v).item()) / 2


def test_order_model_rounds_the_square_root_and_quotient_once():
    """The model's norm and quotient are the correctly rounded float32
    results of its own float32 sum, checked in exact rational arithmetic:
    the exact square root and quotient lie within half an ulp."""
    x = torch.from_numpy(_randn((2, 37, 4, 5), 11, 3.0))
    q = CS.l2norm_order(torch, x, EPS, 1.0)
    n, c = x.shape[:2]
    xs = x.reshape(n, c, -1)
    part = torch.zeros(n, 16, xs.shape[2])
    for j0 in range(0, c, 16):
        v = xs[:, j0:j0 + 16]
        part[:, :v.shape[1]] = part[:, :v.shape[1]] + v * v
    total = torch.zeros(n, 1, xs.shape[2])
    for j in range(16):
        total = total + part[:, j:j + 1]
    total = total + torch.tensor(EPS, dtype=torch.float32)
    checked = 0
    for b in range(n):
        for p in range(xs.shape[2]):
            t = Fraction(total[b, 0, p].item())
            # the norm the quotients imply: the model's own, recomputed
            norm = np.float32(math.sqrt(total[b, 0, p].item()))
            h = _half_ulp(norm)
            nf = Fraction(norm.item())
            assert (nf - h) ** 2 <= t <= (nf + h) ** 2
            for k in range(c):
                got = Fraction(q.reshape(n, c, -1)[b, k, p].item())
                exact = Fraction(xs[b, k, p].item()) / nf
                assert abs(got - exact) <= _half_ulp(abs(got))
                checked += 1
    assert checked == x.numel()


# -- the planners ------------------------------------------------------------
@pytest.mark.parametrize("c, regime, k", [
    (1, "onchip", 1), (16, "onchip", 1), (17, "onchip", 2),
    (512, "onchip", 32), (513, "two_pass", 0)])
def test_plan_at_its_borders(c, regime, k):
    assert l2.plan(c) == (regime, k)
    assert l2.bwd_plan(c) == l2.plan(c)


@pytest.mark.parametrize("c", [1, 3, 16, 17, 21, 512])
def test_plan_takes_every_channel_once(c):
    """Slice y's thread takes channels y + 16 j for j < k below C: every
    channel exactly once, in each slice in increasing order."""
    k = l2.plan(c).k
    taken = [y + l2.SLICES * j for y in range(l2.SLICES) for j in range(k)
             if y + l2.SLICES * j < c]
    assert sorted(taken) == list(range(c))
    assert l2.SLICES * k >= c and (k == 1 or l2.SLICES * k // 2 < c)


@pytest.mark.parametrize("positions, pos", [
    (1369, 16), (8 * 1369, 32), (32 * 1369, 64), (1, 16),
    (l2.NARROW_BELOW - 1, 16), (l2.NARROW_BELOW, 32),
    (l2.WIDE_FROM - 1, 32), (l2.WIDE_FROM, 64), (33, 16)])
def test_tile_and_grid_cover_every_position_once(positions, pos):
    """SSD serving at buckets 1 and 8, training at 32, and each side of the
    narrow and the wide tile's borders: the blocks take every (n, h*w)
    position exactly once."""
    assert l2.tile(positions) == pos and pos in l2.TILES
    grid = -(-positions // pos)  # csrc/l2norm_channel.cu's grid
    seen = np.zeros(positions, np.int64)
    for b in range(grid):
        seen[b * pos:min((b + 1) * pos, positions)] += 1
    np.testing.assert_array_equal(seen, np.ones(positions, np.int64))
    assert (grid - 1) * pos < positions <= grid * pos


@pytest.mark.parametrize("n, threads", [(1, 128), (8, 128), (32, 128),
                                        (3, 128)])
def test_decode_plan_covers_every_anchor_once(n, threads):
    """SSD-300's 8096 anchors at serving buckets 1 and 8, at training's
    batch 32 and at a batch whose last block is short: blocks of
    ``threads`` anchors, every anchor exactly once, the staged rows within
    the shared-memory limit."""
    a, c1 = 8096, 21
    p = dec.plan(n, c1, a, (a * c1, 1, c1), True)
    assert (p.body, p.threads) == ("rows", threads)
    seen = np.zeros(n * a, np.int64)
    for b in range(p.grid):
        seen[b * p.threads:min((b + 1) * p.threads, n * a)] += 1
    np.testing.assert_array_equal(seen, np.ones(n * a, np.int64))
    assert p.smem == p.threads * c1 * 4 <= dec.SMEM_LIMIT
    assert p.threads % 32 == 0 and p.grid == -(-n * a // p.threads)


@pytest.mark.parametrize("c1, threads, body", [
    (21, 128, "rows"), (81, 128, "rows"), (97, 64, "rows"),
    (384, 32, "rows"), (385, 128, "wide"), (1001, 128, "wide")])
def test_decode_plan_fits_the_classes_in_shared_memory(c1, threads, body):
    p = dec.plan(4, c1, 9000, (9000 * c1, 1, c1), True)
    assert (p.body, p.threads) == (body, threads)
    assert p.smem <= dec.SMEM_LIMIT and (body == "wide") == (p.smem == 0)


# -- the decode's body for each stride pattern -------------------------------
@pytest.mark.parametrize("n, c1, a, strides, aligned, want", [
    (8, 21, 8096, (8096 * 21, 1, 21), True, "rows"),  # the SSD paths
    (8, 21, 8096, (8096 * 21, 1, 21), False, "strided"),  # off alignment
    (8, 21, 8096, (8096 * 21, 8096, 1), True, "strided"),  # class-major
    (8, 21, 8096, (8096 * 21, 8096, 1), False, "strided"),
    (8, 21, 8096, (8096 * 24, 1, 24), True, "strided"),  # wider rows
    (8, 21, 8096, (8101 * 21, 1, 21), True, "strided"),  # padded images
    (1, 21, 8096, (8101 * 21, 1, 21), True, "rows"),  # one image of them
    (2, 3, 5, (15, 5, 1), True, "strided"), (2, 3, 5, (1, 2, 6), True,
                                             "strided")])
def test_decode_body_for_each_stride_pattern(n, c1, a, strides, aligned,
                                             want):
    assert dec.body(n, c1, a, strides, aligned) == want
    assert dec.plan(n, c1, a, strides, aligned).body == want


def test_chip_smokes_decode_views_reach_each_body():
    """``chip_smoke.decode_views``' layouts take the bodies they stand for
    (the misaligned one one float off a 16-byte boundary)."""
    gen = torch.Generator().manual_seed(3)
    views = CS.decode_views(torch, gen, torch.device("cpu"), 3, 77)
    bodies = {}
    for what, cls, loc, anc in views:
        assert cls.shape == (3, 21, 77) and loc.shape == (3, 308)
        assert anc.shape == (1, 77, 4)
        bodies[what] = dec.plan(*cls.shape, cls.stride(),
                                cls.data_ptr() % 16 == 0).body
    assert bodies["transposed"] in ("rows", "strided")
    assert bodies == {"transposed": bodies["transposed"],
                      "class-major": "strided",
                      "rows of C+4": "strided", "padded images": "strided",
                      "off alignment": "strided"}


def test_decode_outputs_are_views_of_one_allocation():
    boxes, score, cls_id = dec.outputs(3, 77, torch.device("cpu"))
    assert boxes.shape == (3, 77, 4) and score.shape == (3, 77)
    assert cls_id.shape == (3, 77) and cls_id.dtype == torch.int32
    assert all(t.is_contiguous() for t in (boxes, score, cls_id))
    base = boxes.untyped_storage().data_ptr()
    assert score.untyped_storage().data_ptr() == base
    assert cls_id.untyped_storage().data_ptr() == base
    assert boxes.data_ptr() == base and boxes.data_ptr() % 16 == 0
    assert score.data_ptr() == base + 3 * 77 * 16
    assert cls_id.data_ptr() == base + 3 * 77 * 20


def test_chip_smokes_l2_edges_reach_their_edges():
    edges = CS.l2_edges()
    cs_ = {s[1] for s in edges}
    assert {1, 3, 16, 17, 512, 513} <= cs_
    assert any(len(s) == 2 for s in edges)
    assert any(len(s) > 2 and math.prod(s[2:]) == 1 for s in edges)
    # 32-position blocks straddling two images, odd H*W
    assert any(math.prod(s[2:]) % 32 and s[0] > 1 and
               math.prod(s[2:]) % 2 for s in edges if len(s) > 2)
    # each side of the narrow and the wide tile's borders at SSD's C
    tiles = {l2.tile(s[0] * math.prod(s[2:])) for s in edges if s[1] == 512}
    assert tiles == {l2.NARROW_POSITIONS, l2.POSITIONS, l2.WIDE_POSITIONS}


# -- the packed structs against each .cu --------------------------------------
def _c_fields(source):
    """The field names of ``Packed`` in ``source`` in order, the struct
    format its comment states and its static_assert's count."""
    text = (CSRC / source).read_text()
    body = re.search(r"struct Packed \{(.*?)\};", text, re.S)[1]
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip() for n in
                      re.sub(r"^(unsigned long long|long long|double)\s+",
                             "", decl).split(",")]
    fmt = re.search(r'struct format "(=[^"]+)"', text)[1]
    count = int(re.search(r"sizeof\(Packed\) == (\d+) \* 8", text)[1])
    return names, fmt, count


class _Captured(Exception):
    pass


def _capture(monkeypatch, entry):
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


def test_l2norm_packed_struct_matches_the_source(monkeypatch):
    names, fmt, count = _c_fields("l2norm_channel.cu")
    assert struct.calcsize(fmt) == 8 * count == 8 * len(names)
    assert fmt == l2._PACK.__self__.format
    got = _capture(monkeypatch, "mxt_l2norm_channel_f32")
    x = torch.randn(3, 21, 5, 7)
    with pytest.raises(_Captured):
        l2.run_plan(l2.plan(21), 16, x, 1e-10, 20.0)
    f = dict(zip(names, struct.unpack(fmt, got["bytes"])))
    assert f["x"] == x.data_ptr() and f["y"] != x.data_ptr()
    assert (f["n"], f["c"], f["hw"]) == (3, 21, 35)
    assert (f["eps"], f["scale"]) == (1e-10, 20.0)
    assert (f["regime"], f["k"], f["pos"]) == (0, 2, 16)
    assert f["stream"] == 7 and names[-1] == "stream"
    with pytest.raises(_Captured):
        l2.run_plan(l2.plan(600), 32, torch.randn(1, 600, 2), 1e-10)
    f = dict(zip(names, struct.unpack(fmt, got["bytes"])))
    assert (f["regime"], f["k"], f["scale"]) == (1, 0, 1.0)


def test_decode_packed_struct_matches_the_source(monkeypatch):
    names, fmt, count = _c_fields("multibox_decode.cu")
    assert struct.calcsize(fmt) == 8 * count == 8 * len(names)
    assert fmt == dec._PACK.__self__.format
    got = _capture(monkeypatch, "mxt_multibox_decode_f32")
    logits, loc, anchors = _decode_inputs(5, n=3, a=77)
    cls = torch.from_numpy(logits).transpose(1, 2)
    loc_t, anc_t = torch.from_numpy(loc), torch.from_numpy(anchors)
    p = dec.plan(3, 21, 77, cls.stride(), True)
    lay = dec._layout(cls, (cls.dtype, cls.shape, cls.stride(), -1, True))
    with pytest.raises(_Captured):
        dec._launch(cls, cls.data_ptr(), loc_t.data_ptr(), anc_t.data_ptr(),
                    lay[2], lay[3], lay[4], (0.1, 0.2, 0.3, 0.4), False,
                    True)
    f = dict(zip(names, struct.unpack(fmt, got["bytes"])))
    assert (f["cls"], f["loc"], f["anchors"]) == (
        cls.data_ptr(), loc_t.data_ptr(), anc_t.data_ptr())
    assert f["score"] - f["boxes"] == 3 * 77 * 16
    assert f["cls_id"] - f["score"] == 3 * 77 * 4
    assert (f["sn"], f["sc"], f["sa"]) == cls.stride() == (77 * 21, 1, 21)
    assert (f["n"], f["c1"], f["a"]) == (3, 21, 77)
    assert (f["v0"], f["v1"], f["v2"], f["v3"]) == (0.1, 0.2, 0.3, 0.4)
    assert (f["clip"], f["softmax"]) == (0, 1)
    assert (f["body"], f["threads"], f["grid"], f["smem"]) == (
        dec.BODIES.index(p.body), p.threads, p.grid, p.smem)
    assert f["stream"] == 7 and names[-1] == "stream"
