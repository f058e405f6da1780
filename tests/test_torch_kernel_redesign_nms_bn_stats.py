"""The redesigned ``nms`` and ``bn_stats`` wrappers on the CPU, where they
take their plain versions: both planners exactly at each border, against
the H100's limits as constants and against any limits they are given; the
per-class decomposition ``nms`` rests on, and the kernels' algorithm (the
segment routes, the 64-box chain with diagonal words, the rows written
once) modelled in torch, against ``nms_plain`` and the JAX package's
``_nms_keep``; and ``bn_stats_plain`` at the planner's border shapes
against the JAX package's BatchNorm training statistics and moving update.

Inputs come from numpy with a seed. Tolerances: ``nms`` bit for bit (the
same IoU arithmetic and comparisons in float32 on both sides). The
statistics, float32 on both sides, summed in other orders: rtol 1e-5 /
atol 1e-6 (the card's limits for the kernel against its plain version),
plus the anchored formula's cancellation (``dmean`` the distance of the
batch mean from the anchor): ``4 * 2**-23 * |dmean|`` on the mean and the
moving mean (``m0 + dmean`` rounds to an ulp of ``dmean``, which a sum in
another order moves; it matters only with a stale anchor) and
``8 * 2**-23 * dmean**2`` on the variance and the moving variance;
``kvar`` exactly.
"""

import functools
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import defs_contrib as jcontrib
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

from mxnet_tpu_torch.kernels import bn_act_bwd as bwd_mod
from mxnet_tpu_torch.kernels import bn_stats as stats_mod
from mxnet_tpu_torch.kernels import nms as nms_mod

# the limits the C side reported on an NVIDIA H100 80GB HBM3: the dynamic
# shared memory a segment block of nms may take (nms.device_limits), and
# the largest cluster of the statistics kernel (bn_stats.device_limits)
H100_NMS_SMEM = 229856
H100_CLUSTER = 16
L_MAX = nms_mod.plan(1, 8096, 20, False, H100_NMS_SMEM).lmax  # 256 boxes
SSD_A = 8096
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6


# -- nms.plan ----------------------------------------------------------------
def test_nms_l_max_on_the_h100():
    assert nms_mod.seg_bytes(64) == 33 * 64 + 8
    assert L_MAX == nms_mod.ONCHIP == 256
    assert nms_mod.seg_bytes(L_MAX) == 8480 <= H100_NMS_SMEM
    assert nms_mod.seg_limit(H100_NMS_SMEM) > L_MAX


def _words(a):
    return -(-a // 64)


@pytest.mark.parametrize("a, longs", [
    (1, False), (63, False), (64, False), (65, False), (L_MAX - 1, False),
    (L_MAX, False), (L_MAX + 1, True), (SSD_A, True), (27712, True)])
def test_nms_plan_at_l_max(a, longs):
    """Anchors per image on each side of L_max: a segment can exceed L_max
    only when A does, and only then are the mask and chain kernels launched
    and the scratch allocated."""
    p = nms_mod.plan(32, a, 20, False, H100_NMS_SMEM)
    assert p.lmax == L_MAX and p.launches == (3 if longs else 1)
    assert p.cap == min(L_MAX, _words(a) * 64)
    assert p.smem == nms_mod.seg_bytes(p.cap) <= H100_NMS_SMEM
    assert (p.segments, p.threads) == (20, nms_mod.THREADS)
    if longs:
        assert p.mask_blocks == nms_mod.MASK_BLOCKS
        assert p.scratch == 32 * a * 24 + 32 * _words(a) * a * 8 + 32 * 20 * 16
    else:
        assert p.mask_blocks == p.scratch == 0


@pytest.mark.parametrize("classes, force, segments", [
    (20, False, 20), (20, True, 1), (None, False, 1), (None, True, 1),
    (1, False, 1), (3, False, 3)])
def test_nms_plan_segments(classes, force, segments):
    """Segments by class only without force and with the class count; the
    whole image otherwise."""
    p = nms_mod.plan(8, SSD_A, classes, force, H100_NMS_SMEM)
    assert p.segments == segments and p.launches == 3


def test_nms_plan_limits_the_mask_kernels_table():
    """Past MAX_ENTRIES (image, class) segments a call takes whole images;
    past MAX_ENTRIES images, or 64 * MAX_WORDS anchors, with long segments
    possible, it is refused."""
    n = nms_mod.MAX_ENTRIES // 20
    assert nms_mod.plan(n, SSD_A, 20, False, H100_NMS_SMEM).segments == 20
    assert nms_mod.plan(n + 1, SSD_A, 20, False,
                        H100_NMS_SMEM).segments == 1
    assert nms_mod.plan(nms_mod.MAX_ENTRIES, 100, 20, False,
                        H100_NMS_SMEM).launches == 1
    for n, a in ((nms_mod.MAX_ENTRIES, SSD_A),
                 (1, 64 * nms_mod.MAX_WORDS + 1)):
        with pytest.raises(Exception):
            nms_mod.plan(n, a, 20, False, H100_NMS_SMEM)


def test_nms_plan_without_work():
    for n, a in ((0, SSD_A), (8, 0)):
        assert nms_mod.plan(n, a, 20, False, H100_NMS_SMEM).launches == 0


@pytest.mark.parametrize("smem", [nms_mod.seg_bytes(64),
                                  nms_mod.seg_bytes(64) + 1000,
                                  nms_mod.seg_bytes(448), 49152, 232448])
def test_nms_plan_follows_the_limit_it_is_given(smem):
    lmax = min(nms_mod.ONCHIP, nms_mod.seg_limit(smem))
    assert lmax % 64 == 0 and nms_mod.seg_bytes(lmax) <= smem
    for a in (lmax, lmax + 1):
        p = nms_mod.plan(2, a, 5, False, smem)
        assert p.lmax == lmax and p.launches == (3 if a > lmax else 1)
        assert p.smem <= smem
    with pytest.raises(Exception):
        nms_mod.plan(2, 100, 5, False, nms_mod.seg_bytes(64) - 1)


# -- the kernels' division-free threshold test, in exact arithmetic ------------
def _f32(x):
    """``x`` (a Fraction) rounded to the nearest float32, ties to even
    (normal range)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scale = Fraction(2) ** (23 - e)
    n = x * scale
    q, r = divmod(n.numerator, n.denominator)
    if 2 * r > n.denominator or (2 * r == n.denominator and q % 2):
        q += 1
    return sign * Fraction(q) / scale


def _kernel_above(inter, uni, t):
    """csrc/nms.cu's suppresses() after the IoU's operands: d = fma(-t,
    uni, inter) against uni * h (1 +- 2^-22), each rounded once, decides
    fl(inter / uni) > t where the margin does; None where it divides."""
    ft = Fraction(float(t))
    h = (Fraction(float(np.nextafter(np.float32(t), np.float32(np.inf))))
         - ft) / 2
    d = _f32(inter - ft * uni)
    if d > _f32(uni * h * (1 + Fraction(1, 2 ** 22))):
        return True
    if d < _f32(uni * h * (1 - Fraction(1, 2 ** 22))):
        return False
    return None


@pytest.mark.parametrize("t", [0.45, 0.5, 0.3, 0.25, 1 / 3, 0.7])
def test_nms_threshold_test_without_the_division(t):
    """Where the kernel's margin decides, it decides as the float32
    division and comparison do: on random operands, on IoUs an ulp or less
    around t and around the rounding midpoint t + ulp(t) / 2, and at
    ties."""
    rng = np.random.default_rng(int(t * 1000))
    t32 = np.float32(t)
    ft = Fraction(float(t32))
    cases = []
    for _ in range(300):
        uni = np.float32(rng.uniform(1e-3, 2))
        cases.append((np.float32(rng.uniform(0, 1) * uni), uni))
        cases.append((np.float32(0), uni))  # boxes that do not intersect
        for k in (-2, -1, 0, 1, 2):  # inter near t * uni, q near t and m
            base = Fraction(float(uni)) * ft * (1 + Fraction(k, 2 ** 25))
            cases.append((np.float32(float(base)), uni))
    decided = 0
    for inter, uni in cases:
        fi, fu = Fraction(float(inter)), Fraction(float(uni))
        want = _f32(fi / fu) > ft
        got = _kernel_above(fi, fu, t32)
        if got is not None:
            decided += 1
            assert got == want, (inter, uni, t)
    assert decided > 0.9 * len(cases)


# -- the kernels' algorithm, modelled in torch --------------------------------
def _resolve(sup, left):
    """The kernels' resolve of one chunk: ``sup`` its (len, len) upper
    suppression matrix, ``left`` the boxes earlier chunks did not remove.
    Boxes no box of the chunk suppresses are kept and remove what they
    suppress; the rest in order."""
    left = left.clone()
    sure = left & ~sup.any(0)
    keep = sure.clone()
    left &= ~(sure | sup[sure].any(0))
    for b in range(left.numel()):
        if left[b]:
            keep[b] = True
            left &= ~sup[b]
    return keep


def _chain(boxes, cls, thr, by_class):
    """The kernels' chain over one segment's boxes in order: diagonal words
    within each 64-box chunk, warp 0's resolve against what earlier chunks
    removed, then every later box not yet removed against the chunk's kept
    boxes only."""
    n = boxes.shape[0]
    t = torch.tensor(thr, dtype=torch.float32)
    removed = torch.zeros(n, dtype=torch.bool)
    keep = torch.zeros(n, dtype=torch.bool)
    for base in range(0, n, 64):
        chunk = slice(base, min(base + 64, n))
        sup = nms_mod.iou_matrix(boxes[chunk], boxes[chunk]) > t
        if by_class:
            sup &= cls[chunk, None] == cls[None, chunk]
        keep[chunk] = _resolve(torch.triu(sup, diagonal=1), ~removed[chunk])
        kept = keep[chunk].nonzero()[:, 0] + base
        later = torch.arange(min(base + 64, n), n)
        later = later[~removed[later]]
        if kept.numel() and later.numel():
            hit = nms_mod.iou_matrix(boxes[kept], boxes[later]) > t
            if by_class:
                hit &= cls[kept, None] == cls[None, later]
            removed[later] |= hit.any(0)
    return keep


def _mask_chain(boxes, cls, thr, by_class):
    """The long route: every upper-triangle suppression word (the mask
    kernel's tiles), then chunk by chunk the resolve from the diagonal
    words and the OR of the kept rows' later words into the removed
    bitmap (the chain kernel)."""
    n = boxes.shape[0]
    t = torch.tensor(thr, dtype=torch.float32)
    sup = nms_mod.iou_matrix(boxes, boxes) > t
    if by_class:
        sup &= cls[:, None] == cls[None, :]
    sup = torch.triu(sup, diagonal=1)
    removed = torch.zeros(n, dtype=torch.bool)
    keep = torch.zeros(n, dtype=torch.bool)
    for base in range(0, n, 64):
        end = min(base + 64, n)
        keep[base:end] = _resolve(sup[base:end, base:end], ~removed[base:end])
        kept = keep[base:end].nonzero()[:, 0] + base
        if kept.numel():
            removed[end:] |= sup[kept, end:].any(0)
    return keep


def _kernel_model(boxes, score, cls_id, order, thr, nms_thr, force, classes,
                  lmax):
    """The rows the kernels write under the plan for an L_max of ``lmax``
    (the shared memory of exactly such a segment), and how often
    each row is written: block 0 of an image writes its invalid anchors'
    rows; each segment of at most L_max boxes is chained by its segment
    block, each longer one by the mask and chain kernels; a valid class id
    outside [0, classes) makes the image one segment."""
    n, a = score.shape
    p = nms_mod.plan(n, a, classes, force, nms_mod.seg_bytes(lmax), lmax)
    assert p.lmax == lmax
    out = torch.full((n, a, 6), float("nan"))
    writes = torch.zeros((n, a), dtype=torch.int64)
    t32 = torch.tensor(thr, dtype=torch.float32)
    routes = {"segment": 0, "large": 0}
    for img in range(n):
        o = order[img]
        valid = score[img][o] > t32
        c = cls_id[img][o]
        s = p.segments
        oob = s > 1 and bool(((c < 0) | (c >= s))[valid].any())
        if s == 1 or oob:
            members = [valid]
        else:
            members = [valid & (c == k) for k in range(s)]
        whole = s == 1 or oob
        for mem in members:
            pos = mem.nonzero()[:, 0]
            by_class = not force and whole
            if pos.numel() > p.cap:
                assert p.launches == 3
                routes["large"] += 1
                keep = _mask_chain(boxes[img][o[pos]], c[pos], nms_thr,
                                   by_class)
            else:
                routes["segment"] += 1
                keep = _chain(boxes[img][o[pos]], c[pos], nms_thr, by_class)
            anc = o[pos]
            out[img, anc, 0] = torch.where(keep, c[pos].float(),
                                           torch.tensor(-1.0))
            writes[img, anc] += 1
        inv = o[~valid]
        out[img, inv, 0] = -1.0
        writes[img, inv] += 1
        out[img, :, 1] = score[img]
        out[img, :, 2:] = boxes[img]
    return out, writes, routes


def _grid(rng, n, a, classes, levels=4):
    x1 = rng.integers(0, 10, (n, a, 2)) / 16
    wh = rng.integers(1, 6, (n, a, 2)) / 16
    boxes = np.concatenate([x1, x1 + wh], 2).astype(np.float32)
    score = np.linspace(0.2, 0.8, levels, dtype=np.float32)[
        rng.integers(0, levels, (n, a))]
    score[:, ::9] = np.float32(0.01)
    cls_id = rng.integers(0, classes, (n, a)).astype(np.int32)
    return boxes, score, cls_id


def _tensors(boxes, score, cls_id):
    b, s, c = (torch.from_numpy(np.ascontiguousarray(t))
               for t in (boxes, score, cls_id))
    return b, s, c, torch.argsort(-s, dim=1, stable=True)


def _cases():
    """(name, inputs, classes) on grid boxes whose IoUs sit at 1/2, 1/3
    and 1/4 exactly, with tied scores: 1, 3 and 20 classes, one class
    holding every anchor, an image with no valid box, continuous boxes."""
    rng = np.random.default_rng(41)
    cases = []
    for classes in (1, 3, 20):
        cases.append((f"{classes} classes", _grid(rng, 3, 300, classes),
                      classes))
    boxes, score, _ = _grid(rng, 2, 300, 3)
    cases.append(("one class holding every anchor",
                  (boxes, score, np.full((2, 300), 2, np.int32)), 3))
    boxes, score, cls_id = _grid(rng, 2, 300, 3)
    score[1] = rng.uniform(0, 0.01, 300).astype(np.float32)
    score[1, ::5] = np.float32(0.01)
    cases.append(("an image with no valid box", (boxes, score, cls_id), 3))
    lo = rng.uniform(0, 0.7, (2, 300, 2))
    cont = np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (2, 300, 2))], 2)
    pairs = np.repeat(rng.uniform(0.02, 1, (2, 150)), 2, axis=1)
    cases.append(("continuous boxes, scores tied in pairs",
                  (cont.astype(np.float32), pairs.astype(np.float32),
                   rng.integers(0, 4, (2, 300)).astype(np.int32)), 4))
    return cases


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_case_keep(case, nms_thr):
    """The JAX package's keep mask on ``CASES[case]``, without force."""
    _name, (boxes, score, cls_id), _classes = CASES[case]
    return _jax_keep(boxes, score, cls_id, 0.01, nms_thr, False)


def _jax_keep(boxes, score, cls_id, thr, nms_thr, force):
    """``_nms_keep`` of the JAX package, image by image, on the CPU."""
    keep = []
    for b in range(score.shape[0]):
        keep.append(np.asarray(jcontrib._nms_keep(
            jnp.asarray(boxes[b]), jnp.asarray(score[b]),
            jnp.asarray(score[b] > np.float32(thr)), nms_thr, force,
            jnp.asarray(cls_id[b]))))
    return np.stack(keep)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("nms_thr", [0.5, 0.25])
def test_nms_splits_exactly_by_class(case, nms_thr):
    """Without force, ``keep_sorted`` on each class's own sub-sequence of
    the sorted valid boxes gives ``nms_plain``'s keep mask, and the JAX
    package's ``_nms_keep``, bit for bit."""
    _name, (boxes, score, cls_id), classes = CASES[case]
    ins = _tensors(boxes, score, cls_id)
    want = nms_mod.nms_plain(*ins, 0.01, nms_thr, False)
    split = torch.full(score.shape, -1.0)
    for img in range(score.shape[0]):
        o = ins[3][img]
        valid = ins[1][img][o] > torch.tensor(0.01)
        for k in range(classes):
            pos = o[valid & (ins[2][img][o] == k)]
            keep = nms_mod.keep_sorted(ins[0][img][pos],
                                       torch.ones(pos.numel(), dtype=bool),
                                       ins[2][img][pos], nms_thr, False)
            split[img, pos[keep]] = float(k)
    assert torch.equal(split, want[..., 0])
    jkeep = _jax_case_keep(case, nms_thr)
    assert np.array_equal(jkeep, want[..., 0].numpy() >= 0)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("force, classes_arg", [(False, True), (True, True),
                                                (False, False)])
@pytest.mark.parametrize("lmax", [64, 128, 320])
def test_nms_kernel_model_matches_plain_and_jax(case, force, classes_arg,
                                                lmax):
    """The kernels' algorithm at a small L_max (64 and 128: segments of 300
    boxes exceed it, and one class holding every anchor takes the long
    route; 320: every segment fits), by class, forced and as whole images:
    the rows of ``nms_plain`` bit for bit, each row written exactly once,
    and the keep mask of the JAX package's ``_nms_keep``."""
    _name, (boxes, score, cls_id), classes = CASES[case]
    ins = _tensors(boxes, score, cls_id)
    cl = classes if classes_arg else None
    got, writes, routes = _kernel_model(*ins, 0.01, 0.5, force, cl, lmax)
    want = nms_mod.nms_plain(*ins, 0.01, 0.5, force, cl)
    assert torch.equal(got, want)
    assert bool((writes == 1).all())
    if lmax == 320:
        assert routes["large"] == 0
    if force and lmax < 300:
        assert routes["large"] >= 1
    if not force:
        jkeep = _jax_case_keep(case, 0.5)
        assert np.array_equal(jkeep, want[..., 0].numpy() >= 0)


def test_nms_kernel_model_on_class_ids_out_of_range():
    """A valid anchor whose class id lies outside [0, classes) makes its
    image one segment (the class test in the IoU test): the rows are
    still the plain version's, and an image without one keeps its class
    segments."""
    rng = np.random.default_rng(43)
    boxes, score, cls_id = _grid(rng, 3, 200, 3)
    cls_id[0, 5] = 3
    cls_id[1, 7] = -1
    score[0, 5] = score[1, 7] = np.float32(0.8)
    ins = _tensors(boxes, score, cls_id)
    for lmax in (64, 256):
        got, writes, routes = _kernel_model(*ins, 0.01, 0.5, False, 3,
                                            lmax)
        assert torch.equal(got, nms_mod.nms_plain(*ins, 0.01, 0.5, False))
        assert bool((writes == 1).all())
        assert sum(routes.values()) == 2 + 3  # two whole images, 3 classes


def test_nms_wrapper_takes_the_plain_version_on_the_cpu():
    boxes, score, cls_id = _grid(np.random.default_rng(44), 2, 100, 3)
    ins = _tensors(boxes, score, cls_id)
    before = nms_mod.LAUNCHES.value
    for cl in (None, 3):
        assert torch.equal(nms_mod.nms(*ins, 0.01, 0.5, False, cl),
                           nms_mod.nms_plain(*ins, 0.01, 0.5, False))
    assert nms_mod.LAUNCHES.value == before
    meta = nms_mod.nms(*(t.to("meta") for t in ins), 0.01, 0.5, False, 3)
    assert meta.shape == (2, 100, 6) and meta.device.type == "meta"


# -- bn_stats.plan --------------------------------------------------------------
T = stats_mod.BLOCK_TARGET  # 65536 elements


@pytest.mark.parametrize("m, regime, cluster", [
    (T - 1, "block", 1), (T, "block", 1), (T + 1, "cluster", 2),
    (2 * T + 1, "cluster", 3), (H100_CLUSTER * T, "cluster", 16),
    (H100_CLUSTER * T + 1, "cluster", 16), (2 ** 31 - 1, "cluster", 16)])
def test_bn_stats_plan_at_the_block_and_cluster_limits(m, regime, cluster):
    """One launch at every m < 2**31: a block up to the target, a cluster
    of ceil(m / target) blocks beyond, 16 (each past the target, up to
    1024 threads) past 16 targets; nothing bounds a block's shared
    memory."""
    p = stats_mod.plan(1, 3, m, H100_CLUSTER)
    assert (p.regime, p.cluster, p.launches) == (regime, cluster, 1)
    assert p.chunk % 4 == 0 and p.chunk * p.cluster >= m
    assert p.chunk * (p.cluster - 1) < m
    assert p.grid == 3 * p.cluster
    assert p.group % 32 == 0 and p.threads <= bwd_mod.MAX_THREADS
    if m > H100_CLUSTER * T:
        assert p.chunk > T and p.group == bwd_mod.MAX_THREADS
    assert stats_mod.plan(1, 3, 2 ** 31, H100_CLUSTER).regime == "two_phase"


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_bn_stats_plan_follows_the_cluster_limit_it_is_given(cluster):
    for m in (T, T + 1, cluster * T, cluster * T + 1, 401408):
        p = stats_mod.plan(1, 5, m, cluster)
        want = min(cluster, -(-m // T))
        assert p.cluster == want and p.launches == 1
        assert p.regime == ("block" if want == 1 else "cluster")
        assert p.chunk * p.cluster >= m


@pytest.mark.parametrize("n, c, hw, cpb, group", [
    (32, 2048, 49, 4, 64),    # ResNet's 7x7 stage: 1568 elements
    (32, 512, 49, 4, 64),
    (64, 512, 16, 8, 32),     # DCGAN's (64, 512, 4, 4)
    (1, 3, 16, 3, 32),        # N = 1, C = 3, a 4x4 plane
    (2, 3, 1, 3, 32),         # two elements a channel
    (32, 1024, 196, 1, 256),  # the 14x14 stage: 6272
    (32, 512, 784, 1, 512),   # the 28x28 stage: 25088, at most 512
])
def test_bn_stats_plan_packs_small_channels(n, c, hw, cpb, group):
    p = stats_mod.plan(n, c, hw, H100_CLUSTER)
    assert p.regime == "block"
    assert (p.channels_per_block, p.group) == (cpb, group)
    assert p.grid == -(-c // cpb)


RESNET = [(32, 64, 112, 112), (32, 64, 56, 56), (32, 256, 56, 56),
          (32, 128, 56, 56), (32, 128, 28, 28), (32, 512, 28, 28),
          (32, 256, 28, 28), (32, 256, 14, 14), (32, 1024, 14, 14),
          (32, 512, 14, 14), (32, 512, 7, 7), (32, 2048, 7, 7)]
DCGAN = [(64, 128, 16, 16), (64, 256, 8, 8), (64, 512, 4, 4),
         (64, 64, 32, 32)]


def test_bn_stats_plans_one_launch_at_every_path_shape():
    """ResNet-50's 12 training shapes at batch 32 and DCGAN's BatchNorm
    inputs: one launch a call, so 50 and 13 a step; bn0's 401408-element
    channels a 7-block cluster, at least a block an SM."""
    for n, c, h, w in RESNET + DCGAN:
        p = stats_mod.plan(n, c, h * w, H100_CLUSTER)
        assert p.launches == 1 and p.regime in ("block", "cluster")
    bn0 = stats_mod.plan(32, 64, 112 * 112, H100_CLUSTER)
    assert (bn0.regime, bn0.cluster, bn0.grid) == ("cluster", 7, 448)


# -- bn_stats_plain against the JAX package -----------------------------------
BN_SHAPES = [(1, 3, T), (1, 3, T + 1), (1, 2, 4 * T + 1),
             (2, 3, 7, 7), (4, 5, 4, 4), (1, 3, 5, 5), (3, 7, 1, 1),
             (5, 3)]


def _jax_stats(x, mm, mv, momentum):
    bn = jreg.get("BatchNorm")
    params = bn.parse_params({"momentum": momentum, "fix_gamma": False})
    c = x.shape[1]
    outs, aux = bn.apply([jnp.asarray(x), jnp.ones(c), jnp.zeros(c),
                          jnp.asarray(mm), jnp.asarray(mv)], params,
                         JOpMode(is_train=True))
    return [np.asarray(t) for t in (outs[1], outs[2], aux[0], aux[1])]


@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("stale", [False, True])
def test_bn_stats_plain_matches_jax_at_the_borders(shape, stale):
    """Mean, variance and the moving update of ``bn_stats_plain`` against
    the JAX package's BatchNorm in training, with the anchor near the
    batch mean or 30 standard deviations off; a constant channel (the
    first) has raw == 0 exactly, so ``kvar`` 0.5 and variance 0."""
    rng = np.random.default_rng(sum(shape) + stale)
    c = shape[1]
    bshape = (1, c) + (1,) * (len(shape) - 2)
    sd = rng.uniform(0.5, 2.0, c).astype(np.float32)
    mu = rng.uniform(-1, 1, c).astype(np.float32)
    x = (rng.standard_normal(shape) * sd.reshape(bshape)
         + mu.reshape(bshape)).astype(np.float32)
    x[:, 0] = np.float32(1.5)
    mm = (mu + (-30 * sd if stale else 0.1 * sd)).astype(np.float32)
    mm[0] = np.float32(1.0)  # x - m0 = 0.5: every partial sum exact
    mv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    want = _jax_stats(x, mm, mv, 0.9)
    tm, tv = torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy())
    got = stats_mod.bn_stats(torch.from_numpy(x), tm, tv, 0.9)
    dmean = np.abs(want[0] - mm)
    cancel_m, cancel_v = 4 * 2.0 ** -23 * dmean, 8 * 2.0 ** -23 * dmean ** 2
    for g, w, extra in ((got[0], want[0], cancel_m),
                        (got[1], want[1], cancel_v), (tm, want[2], cancel_m),
                        (tv, want[3], cancel_v)):
        err = np.abs(g.numpy() - w)
        assert bool((err <= STAT_ATOL + extra + STAT_RTOL * np.abs(w)).all())
    # kvar: the clamp's derivative at raw, as jax.grad takes it
    raw = jnp.asarray(got[1].numpy())  # raw where positive: var == raw
    assert float(got[1][0]) == 0.0 and float(want[1][0]) == 0.0
    assert float(got[2][0]) == 0.5
    dclamp = jax.vmap(jax.grad(lambda r: jnp.maximum(r, 0.0)))
    kvar = np.array(dclamp(raw))
    kvar[0] = np.asarray(jax.grad(lambda r: jnp.maximum(r, 0.0))(0.0))
    assert np.array_equal(got[2].numpy(), kvar)


def test_bn_stats_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(45).standard_normal(
        (4, 3, 5, 5)).astype(np.float32))
    mm, mv = torch.zeros(3), torch.ones(3)
    mm2, mv2 = mm.clone(), mv.clone()
    before = stats_mod.LAUNCHES.value
    got = stats_mod.bn_stats(x, mm, mv, 0.9)
    want = stats_mod.bn_stats_plain(x, mm2, mv2, 0.9)
    assert stats_mod.LAUNCHES.value == before
    for g, w in zip(got + (mm, mv), want + (mm2, mv2)):
        assert torch.equal(g, w)
    assert math.isclose(float(got[2].min()), 1.0)
